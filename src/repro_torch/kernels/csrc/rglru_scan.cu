// RG-LRU gated linear recurrence (Griffin): forward for training, and its
// backward, as chunk-parallel scans.
//
// Forward: replaces the Pallas TPU kernel repro/kernels/rglru_scan.py
// (rglru_scan, pallas_call at :60).  Same function, elementwise over the
// channels D, with the state in f32 from zero:
//   g_t = sqrt(clip(1 - a_t^2, 0, 1))
//   h_t = a_t h_{t-1} + g_t x_t
// x, a (B,T,D) in the compute dtype (f32 or bf16) -> h (B,T,D) in x's
// dtype.  Any T and any D: the TPU kernel pads both to its tile, this one
// stops at T and masks the channel tail.  On request it also writes the
// f32 state at the end of every CK-step chunk, ck (B, ceil(T/CK), D),
// which the backward restarts from.
//
// Backward: the TPU package has none (it trains through autodiff of the
// lax.scan in its plain version); this is the gradient of the forward,
// given dy = dL/dh, walking t from T-1 down to 0 with c_T = 0:
//   dh_t = dy_t + c_{t+1}          (c_{t+1} = a_{t+1} dh_{t+1})
//   dx_t = g_t dh_t
//   da_t = dh_t (h_{t-1} - a_t x_t / g_t)     where 1 - a_t^2 > 0
//   da_t = dh_t h_{t-1}                       where 1 - a_t^2 <= 0
// h_{t-1} is rebuilt from the checkpoints, never recovered by dividing by
// a (a reaches ~0.002 at initialisation and 0 after underflow).  The
// value at g = 0: there the clip is saturated, so g does not depend on a
// and the gate term is 0.  bf16 rounds every a >= 0.998046875 to 1.0, and
// autodiff of the plain version then gives da = -inf (0 * inf = NaN where
// x = 0) through sqrt'(0); this kernel gives the clip's own derivative, 0,
// and so a finite da = dh h_{t-1}.  dx and da come back in x's dtype.
//
// Bound on the H100: bytes.  The forward does ~6 FLOPs a step on 2 inputs
// read and 1 output written (f32 or bf16: ~1 FLOP per byte against the
// card's 20 f32 FLOPs per byte), the backward ~10 FLOPs on 3 inputs and 2
// outputs.  The checkpoints (4 bytes a channel every CK steps) are this
// design's own traffic, not the function's, and are left out of its bound.
//
// Design: chunk-parallel.  A chunk of CK steps acts on the state as
// h -> P h + H, with P the product of its a and H its walk from zero, and
// these pairs compose; nothing is divided, so a = 0 is exact.  A thread is
// one (b, unit, chunk), a unit being the channels of one 4-byte word (two
// in bf16, one in f32).  A block holds `slots` chunks of `lanes` units:
// all the chunks of its channels when T <= MAX_SLOTS * CK (the training
// shape, B4 T512 D2560 bf16: 640 blocks of 8 units x 32 chunks, 163,840
// threads of 16 steps, against 10,240 threads of 512 steps in a
// sequential walk), and longer sequences window by window, the state (the
// adjoint) carried between windows in shared memory.  The block stages its
// window's rows of every input in shared memory, [CK][slots][lanes] words,
// with 16-byte cp.async.cg copies (through L2 only; 4-byte copies through
// L1 made the backward 1.5x slower) when the rows are 16-byte aligned,
// each thread its own elements otherwise; every load in flight at once,
// no register held for it, each input byte read from device memory once.  A
// chunk's steps past T are staged as a = 1, x = dy = 0, steps that leave
// every state and product exactly as they are, so no walk tests its
// steps against T (dropping those tests and the staging's integer
// divisions took 9 % off the forward and ~15 % off the backward):
//   rglru_fwd_kernel  walk the chunk from zero: (P, H) to shared memory;
//                     one barrier; fold the earlier chunks' pairs of the
//                     window into the start state (at most slots - 1
//                     multiply-adds, in chunk order, from the carry of the
//                     window before), write the end state P h + H as
//                     checkpoint c, walk the chunk again and write h;
//   rglru_bwd_kernel  rebuild the states at the chunk's SUB-step
//                     boundaries forward from checkpoint c - 1 (zero for
//                     c = 0) and the product P in step order; walk the
//                     adjoint down from zero for the chunk's local carry
//                     Q = a_{t0} dh_{t0}; one barrier; fold the later
//                     chunks' (P, Q) of the window into the carry c_in
//                     from the chunk after this one (from the last chunk
//                     down, from the carry of the window after); walk down
//                     again from c_in, each SUB-step piece's states h_{t-1}
//                     and gates rebuilt into registers from its boundary
//                     first, and write dx and da.
// A checkpoint is the fold's value, the very start state the next chunk's
// forward walk used, so the backward's h_{t-1} are the forward's own bits.
// The arithmetic is rounded step by step (__fmul_rn / __fadd_rn, no FMA
// contraction) in the plain version's order inside a chunk; the results
// differ from a sequential walk only by the fold's reassociation.  Every
// output element is written once by one thread, with no atomics: both
// directions are deterministic, run to run.  The inputs are read through
// (b, t) strides: no transposes.  CK = 16 measured best on the H100 (32
// and 64 keep fewer blocks resident for their shared memory and
// registers).
#include "common.cuh"

namespace {

constexpr int CK = 16;       // chunk: steps a thread walks; checkpoint interval
constexpr int SUB = 4;       // backward: steps whose states sit in registers
constexpr int MAX_SLOTS = 32;  // chunks a block holds at once (a window)
constexpr int MAX_THREADS = 256;
static_assert(CK % SUB == 0, "the backward rebuilds whole SUB-step pieces");

// element strides of one (B, T, D) tensor; the channel dim is unit
struct Strides {
  long long b, t;
};

// the launch numbers of one direction (nin staged inputs) at one T
struct Cfg {
  int slots, lanes, threads, smem;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

Cfg config(int T, int vec, int nin) {
  Cfg c;
  c.slots = cdiv(T, CK) < MAX_SLOTS ? cdiv(T, CK) : MAX_SLOTS;
  c.lanes = c.slots <= 8 ? 32 : c.slots <= 16 ? 16 : 8;
  c.threads = c.lanes * c.slots;
  // staged inputs [nin][CK][threads] words, the chunk pairs [2][vec][threads]
  // and the window carry [2][vec][lanes], all 4 bytes
  c.smem = 4 * (nin * CK * c.threads + 2 * vec * c.threads + 2 * vec * c.lanes);
  return c;
}

// one 4-byte word of channels: two bf16 or one f32
template <typename T>
struct Unit;
template <>
struct Unit<float> {
  static constexpr int V = 1;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  __device__ static uint32_t pack(const float* f) {
    return __float_as_uint(f[0]);
  }
};
template <>
struct Unit<__nv_bfloat16> {
  static constexpr int V = 2;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(const float* f) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[1])) << 16);
  }
};

__device__ __forceinline__ float gate(float a) {
  return sqrtf(fminf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f), 1.f));
}

// h -> a h + g x, rounded as the plain version rounds it
__device__ __forceinline__ float step(float h, float a, float x) {
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(gate(a), x));
}

// how an input's rows are staged: 16-byte pieces (cp.async.cg, through L2
// only) by the block, or element loads by each thread
enum { kElems = 0, kPieces = 1 };

// a block's place: lanes x slots = nt threads, this thread's lane and slot,
// its first channel d0 (nd of its V channels live), the block's first
// channel d_tile, the chunks nc, T and D
struct Geo {
  int lanes, slots, nt, lane, slot, d0, nd, d_tile, nc, T, D;
};

// one input's rows of the window from chunk c0 (src: its batch row) into
// dst, [CK][slots][lanes] words, row (s, slot) holding step s of chunk
// c0 + slot: 16-byte pieces spread over the block (a thread keeps one
// piece column and one chunk, and steps 4 rows at a time), or the
// elements of this thread's own n words.  A chunk's steps past T get
// `pad` (x and dy 0, a 1: steps that leave the state, the product and the
// adjoint exactly as they are), so that the walks need no guard.
template <typename T>
__device__ __forceinline__ void stage_rows(uint32_t* dst, const T* src,
                                           Strides st, int mode,
                                           const Geo& g, int c0, int n,
                                           uint32_t pad) {
  constexpr int V = Unit<T>::V;
  if (mode == kPieces) {
    // nt threads over rows of lanes / 4 pieces: 4 * slots rows at a time
    const int q4 = g.lanes / 4, r0 = threadIdx.x / q4, q = threadIdx.x % q4;
    const int sl = r0 % g.slots, t0 = (c0 + sl) * CK;
    const int d = g.d_tile + q * 4 * V;
    const int nv = min(4 * V, g.D - d);
    if (c0 + sl < g.nc) {
      const T* p = src + (long long)t0 * st.t + d;
      for (int s = r0 / g.slots; s < CK && t0 + s < g.T; s += 4) {
        const uint32_t dsm = static_cast<uint32_t>(__cvta_generic_to_shared(
            dst + (s * g.slots + sl) * g.lanes + q * 4));
        asm volatile(
            "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dsm),
            "l"(nv > 0 ? p + (long long)s * st.t : src),
            "r"(nv > 0 ? nv * (int)sizeof(T) : 0));
      }
    }
  } else {
    const T* p = src + (long long)(c0 + g.slot) * CK * st.t + g.d0;
    for (int s = 0; s < n; ++s) {
      T* e = reinterpret_cast<T*>(dst + s * g.nt + g.slot * g.lanes + g.lane);
#pragma unroll
      for (int v = 0; v < V; ++v)
        e[v] = v < g.nd ? p[(long long)s * st.t + v] : from_f32<T>(0.f);
    }
  }
  if (n > 0)
    for (int s = n; s < CK; ++s) dst[s * g.nt + g.slot * g.lanes + g.lane] = pad;
}

// the word of V ones
template <typename T>
__device__ __forceinline__ uint32_t ones() {
  float f[Unit<T>::V];
#pragma unroll
  for (int v = 0; v < Unit<T>::V; ++v) f[v] = 1.f;
  return Unit<T>::pack(f);
}

// every staged row of the window in place, for every thread of the block
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// the first nd values of f to dst: one 4-byte store, or element stores
template <typename T>
__device__ __forceinline__ void put(T* dst, const float* f, int nd,
                                    bool vec) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(dst) = Unit<T>::pack(f);
  } else {
#pragma unroll
    for (int v = 0; v < Unit<T>::V; ++v)
      if (v < nd) dst[v] = from_f32<T>(f[v]);
  }
}

// flags: bit i set when input i (x, a, dy) is staged in 16-byte pieces;
// kVecOut: the outputs take 4-byte words
enum { kVecOut = 8 };
__device__ __forceinline__ int mode_of(int flags, int i) {
  return (flags >> i) & 1;
}

// the resident blocks an SM that ptxas is held to: the bf16 forward at 48
// registers, five blocks (its shared memory allows six; 64 registers kept
// four, 2 % slower); the bf16 backward at 80, three (its shared memory
// allows four; at 64 registers it spills); f32 (parity checks only) at
// one, so that no register spills
template <typename T>
constexpr int fwd_min_blocks() {
  return sizeof(T) == 2 ? 5 : 1;
}

template <typename T>
constexpr int bwd_min_blocks() {
  return sizeof(T) == 2 ? 3 : 1;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, fwd_min_blocks<T>())
    rglru_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                     T* __restrict__ y, float* __restrict__ ck, int T_,
                     int D, Strides sx, Strides sa, int lanes, int slots,
                     int flags) {
  constexpr int V = Unit<T>::V;
  extern __shared__ uint32_t smem[];
  const int nt = lanes * slots, tid = threadIdx.x;
  const int lane = tid % lanes, slot = tid / lanes;
  const int d0 = (blockIdx.x * lanes + lane) * V;
  const int b = blockIdx.y;
  const int nc = cdiv(T_, CK);
  const int nd = d0 < D ? min(V, D - d0) : 0;  // live channels of the unit
  const Geo g{lanes, slots, nt, lane, slot, d0, nd,
              (int)blockIdx.x * lanes * V, nc, T_, D};
  uint32_t* xs = smem;                          // [CK][nt]
  uint32_t* as = xs + CK * nt;                  // [CK][nt]
  float* Ps = reinterpret_cast<float*>(as + CK * nt);  // [V][nt]
  float* Hs = Ps + V * nt;                             // [V][nt]
  float* carry = Hs + V * nt;                          // [2][V][lanes]
  const T* xb = x + b * sx.b;
  const T* ab = a + b * sa.b;
  T* yb = y + (long long)b * T_ * D + d0;
  for (int w = 0, c0 = 0; c0 < nc; ++w, c0 += slots) {
    const int c = c0 + slot;
    const int t0 = c * CK;
    const int n = (c < nc && nd) ? min(CK, T_ - t0) : 0;
    stage_rows(xs, xb, sx, mode_of(flags, 0), g, c0, n, 0u);
    stage_rows(as, ab, sa, mode_of(flags, 1), g, c0, n, ones<T>());
    stage_wait();
    // the chunk's pair: its walk from zero and the product of its a
    float P[V], H[V];
#pragma unroll
    for (int v = 0; v < V; ++v) P[v] = 1.f, H[v] = 0.f;
    if (n > 0) {
#pragma unroll
      for (int s = 0; s < CK; ++s) {
        float xf[V], af[V];
        Unit<T>::unpack(xs[s * nt + tid], xf);
        Unit<T>::unpack(as[s * nt + tid], af);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          H[v] = step(H[v], af[v], xf[v]);
          P[v] = __fmul_rn(P[v], af[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      Ps[v * nt + tid] = P[v];
      Hs[v * nt + tid] = H[v];
    }
    __syncthreads();
    if (n > 0) {
      // the start state: the window's carry, then the earlier chunks folded
      float h[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        h[v] = w ? carry[((w & 1) * V + v) * lanes + lane] : 0.f;
      for (int j = 0; j < slot; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          h[v] = __fadd_rn(__fmul_rn(Ps[v * nt + j * lanes + lane], h[v]),
                           Hs[v * nt + j * lanes + lane]);
      }
      // the end state, one fold step on: checkpoint c, the next window's
      // carry
      float e[V];
#pragma unroll
      for (int v = 0; v < V; ++v) e[v] = __fadd_rn(__fmul_rn(P[v], h[v]), H[v]);
      if (ck != nullptr) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (v < nd) ck[((long long)b * nc + c) * D + d0 + v] = e[v];
      }
      if (slot == slots - 1) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          carry[(((w + 1) & 1) * V + v) * lanes + lane] = e[v];
      }
#pragma unroll
      for (int s = 0; s < CK; ++s) {
        float xf[V], af[V];
        Unit<T>::unpack(xs[s * nt + tid], xf);
        Unit<T>::unpack(as[s * nt + tid], af);
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = step(h[v], af[v], xf[v]);
        if (s < n) put(yb + (long long)(t0 + s) * D, h, nd, flags & kVecOut);
      }
    }
    __syncthreads();  // the pairs, the carry and the rows are read before reuse
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, bwd_min_blocks<T>())
    rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                     const float* __restrict__ ck, const T* __restrict__ dy,
                     T* __restrict__ dx, T* __restrict__ da, int T_, int D,
                     Strides sx, Strides sa, Strides sdy, int lanes,
                     int slots, int flags) {
  constexpr int V = Unit<T>::V;
  constexpr int NS = CK / SUB;
  extern __shared__ uint32_t smem[];
  const int nt = lanes * slots, tid = threadIdx.x;
  const int lane = tid % lanes, slot = tid / lanes;
  const int d0 = (blockIdx.x * lanes + lane) * V;
  const int b = blockIdx.y;
  const int nc = cdiv(T_, CK);
  const int nd = d0 < D ? min(V, D - d0) : 0;
  const Geo g{lanes, slots, nt, lane, slot, d0, nd,
              (int)blockIdx.x * lanes * V, nc, T_, D};
  uint32_t* xs = smem;                          // [CK][nt]
  uint32_t* as = xs + CK * nt;                  // [CK][nt]
  uint32_t* ys = as + CK * nt;                  // [CK][nt] (dy)
  float* Ps = reinterpret_cast<float*>(ys + CK * nt);  // [V][nt]
  float* Qs = Ps + V * nt;                             // [V][nt]
  float* carry = Qs + V * nt;                          // [2][V][lanes]
  const T* xb = x + b * sx.b;
  const T* ab = a + b * sa.b;
  const T* yb = dy + b * sdy.b;
  const long long o = (long long)b * T_ * D + d0;  // dx, da: contiguous
  const int nw = cdiv(nc, slots);
  for (int w = nw - 1; w >= 0; --w) {
    const int c0 = w * slots;
    const int c = c0 + slot;
    const int t0 = c * CK;
    const int n = (c < nc && nd) ? min(CK, T_ - t0) : 0;
    stage_rows(xs, xb, sx, mode_of(flags, 0), g, c0, n, 0u);
    stage_rows(as, ab, sa, mode_of(flags, 1), g, c0, n, ones<T>());
    stage_rows(ys, yb, sdy, mode_of(flags, 2), g, c0, n, 0u);
    // the start state h_{t0-1}: checkpoint c - 1, zero for the first chunk
    float hb[NS][V], P[V], Q[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      hb[0][v] = (c > 0 && v < nd) ? ck[((long long)b * nc + c - 1) * D + d0 + v]
                                   : 0.f;
      P[v] = 1.f;
      Q[v] = 0.f;
    }
    stage_wait();
    if (n > 0) {
      // forward: the states before each SUB-step piece, P in step order
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        float h[V];
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = hb[k][v];
#pragma unroll
        for (int s = k * SUB; s < (k + 1) * SUB; ++s) {
          float xf[V], af[V];
          Unit<T>::unpack(xs[s * nt + tid], xf);
          Unit<T>::unpack(as[s * nt + tid], af);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (k + 1 < NS) h[v] = step(h[v], af[v], xf[v]);
            P[v] = __fmul_rn(P[v], af[v]);
          }
        }
        if (k + 1 < NS) {
#pragma unroll
          for (int v = 0; v < V; ++v) hb[k + 1][v] = h[v];
        }
      }
      // backward from zero: the chunk's local carry out Q = a_{t0} dh_{t0}
#pragma unroll
      for (int s = CK - 1; s >= 0; --s) {
        float af[V], yf[V];
        Unit<T>::unpack(as[s * nt + tid], af);
        Unit<T>::unpack(ys[s * nt + tid], yf);
#pragma unroll
        for (int v = 0; v < V; ++v)
          Q[v] = __fmul_rn(af[v], __fadd_rn(yf[v], Q[v]));
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      Ps[v * nt + tid] = P[v];
      Qs[v * nt + tid] = Q[v];
    }
    __syncthreads();
    if (n > 0) {
      // c_in = a_{t1+1} dh_{t1+1}: the window's carry, then the later
      // chunks folded from the last one down
      const int last = min(slots, nc - c0) - 1;
      float cin[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        cin[v] = w + 1 < nw ? carry[((w & 1) * V + v) * lanes + lane] : 0.f;
      for (int j = last; j > slot; --j) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          cin[v] = __fadd_rn(__fmul_rn(Ps[v * nt + j * lanes + lane], cin[v]),
                             Qs[v * nt + j * lanes + lane]);
      }
      if (slot == 0 && w > 0) {  // the carry into the window before
#pragma unroll
        for (int v = 0; v < V; ++v)
          carry[(((w + 1) & 1) * V + v) * lanes + lane] =
              __fadd_rn(__fmul_rn(P[v], cin[v]), Q[v]);
      }
      // down again from c_in, piece by piece, each piece's h_{t-1} rebuilt
      // from its boundary state
#pragma unroll
      for (int k = NS - 1; k >= 0; --k) {
        float hp[SUB][V], gp[SUB][V];  // h_{t-1} and g_t of the piece
#pragma unroll
        for (int v = 0; v < V; ++v) hp[0][v] = hb[k][v];
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          const int t = k * SUB + s;
          float xf[V], af[V];
          Unit<T>::unpack(xs[t * nt + tid], xf);
          Unit<T>::unpack(as[t * nt + tid], af);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            gp[s][v] = gate(af[v]);
            if (s + 1 < SUB)
              hp[s + 1][v] = __fadd_rn(__fmul_rn(af[v], hp[s][v]),
                                       __fmul_rn(gp[s][v], xf[v]));
          }
        }
#pragma unroll
        for (int s = SUB - 1; s >= 0; --s) {
          const int t = k * SUB + s;
          float xf[V], af[V], yf[V], gx[V], ga[V];
          Unit<T>::unpack(xs[t * nt + tid], xf);
          Unit<T>::unpack(as[t * nt + tid], af);
          Unit<T>::unpack(ys[t * nt + tid], yf);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float dh = __fadd_rn(yf[v], cin[v]);
            const float g = gp[s][v];
            const float dgx =
                g > 0.f ? __fdiv_rn(__fmul_rn(af[v], xf[v]), g) : 0.f;
            gx[v] = __fmul_rn(g, dh);
            ga[v] = __fmul_rn(dh, __fsub_rn(hp[s][v], dgx));
            cin[v] = __fmul_rn(af[v], dh);
          }
          if (t < n) {
            put(dx + o + (long long)(t0 + t) * D, gx, nd, flags & kVecOut);
            put(da + o + (long long)(t0 + t) * D, ga, nd, flags & kVecOut);
          }
        }
      }
    }
    __syncthreads();  // the pairs, the carry and the rows are read before reuse
  }
}

template <typename T>
struct Tag {
  using type = T;
};

template <typename F>
int with_elem(int dtype, F&& f) {
  switch (dtype) {
    case kF32:
      return f(Tag<float>{});
    case kBF16:
      return f(Tag<__nv_bfloat16>{});
  }
  return (int)cudaErrorInvalidValue;
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[2 * i], st[2 * i + 1]};
}

// how a tensor's rows are staged: 16-byte pieces when its base and (b, t)
// strides are 16-byte aligned, else element loads
template <typename E>
int mode(const void* p, Strides s) {
  const long long e = sizeof(E);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b * e % 16 == 0 &&
                 s.t * e % 16 == 0
             ? kPieces
             : kElems;
}

template <typename E>
int vec_of() {
  return (int)(4 / sizeof(E));
}

// allow the kernel smem bytes of dynamic shared memory (past 48 KB)
template <typename K>
int launchable(K kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// blocks of one direction resident on an SM at once, -1 on an error
template <typename E>
int resident(int dir, const Cfg& c) {
  int n = -1;
  auto query = [&](auto kern) {
    if (launchable(kern, c.smem) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, c.threads,
                                                      c.smem))
      n = -1;
  };
  if (dir) query(rglru_bwd_kernel<E>);
  else query(rglru_fwd_kernel<E>);
  return n;
}

bool bad_shape(int B, int T, int D, int chunk) {
  return B <= 0 || B > 65535 || T <= 0 || D <= 0 || chunk != CK;
}

}  // namespace

// The chunk: the steps a thread walks, and the checkpoint interval.
extern "C" int rglru_scan_ck() { return CK; }

// The built launch numbers at sequence length T, for the wrapper's plan to
// be held to: dir 0 forward, 1 backward; what 0: dynamic shared-memory
// bytes a block, 1: threads a block, 2: chunks a block holds at once
// (slots), 3: units a block (lanes), 4: channels a unit, 5: the backward's
// piece of states kept in registers (SUB), 6: blocks resident on an SM
// (the occupancy calculator's, on the current device).
extern "C" int rglru_scan_tiles(int dir, int dtype, int T, int what) {
  return with_elem(dtype, [&](auto tag) -> int {
    using E = typename decltype(tag)::type;
    if (T <= 0 || dir < 0 || dir > 1 || what < 0 || what > 6) return -1;
    const Cfg c = config(T, vec_of<E>(), dir ? 3 : 2);
    if (what == 6) return resident<E>(dir, c);
    const int vals[6] = {c.smem, c.threads, c.slots, c.lanes, vec_of<E>(),
                         SUB};
    return vals[what];
  });
}

// strides: 4 values, (b, t) in elements for x and a; the channel dim is
// contiguous in both.  y (B, T, D) contiguous in x's dtype; ck (B,
// ceil(T / chunk), D) contiguous f32 or null.  chunk must equal
// rglru_scan_ck().
extern "C" int rglru_scan_fwd(const void* x, const void* a, void* y,
                              float* ck, int dtype, int B, int T, int D,
                              int chunk, const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, D, chunk)) return (int)cudaErrorInvalidValue;
  return with_elem(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    const Strides sx = strides_at(st, 0), sa = strides_at(st, 1);
    const int vec = vec_of<E>();
    const Cfg c = config(T, vec, 2);
    const int flags = mode<E>(x, sx) | mode<E>(a, sa) << 1 |
                      (D % vec == 0 ? kVecOut : 0);
    auto kern = rglru_fwd_kernel<E>;
    if (int err = launchable(kern, c.smem)) return err;
    kern<<<dim3(cdiv(cdiv(D, vec), c.lanes), B), c.threads, c.smem, s>>>(
        static_cast<const E*>(x), static_cast<const E*>(a),
        static_cast<E*>(y), ck, T, D, sx, sa, c.lanes, c.slots, flags);
    return (int)cudaGetLastError();
  });
}

// strides: 6 values, (b, t) in elements for x, a and dy; the channel dim
// is contiguous in all three.  ck: the forward's checkpoints (B,
// ceil(T / chunk), D) contiguous f32; dx, da (B, T, D) contiguous in x's
// dtype.
extern "C" int rglru_scan_bwd(const void* x, const void* a, const float* ck,
                              const void* dy, void* dx, void* da, int dtype,
                              int B, int T, int D, int chunk,
                              const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, D, chunk)) return (int)cudaErrorInvalidValue;
  return with_elem(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    const Strides sx = strides_at(st, 0), sa = strides_at(st, 1),
                  sdy = strides_at(st, 2);
    const int vec = vec_of<E>();
    const Cfg c = config(T, vec, 3);
    const int flags = mode<E>(x, sx) | mode<E>(a, sa) << 1 |
                      mode<E>(dy, sdy) << 2 | (D % vec == 0 ? kVecOut : 0);
    auto kern = rglru_bwd_kernel<E>;
    if (int err = launchable(kern, c.smem)) return err;
    kern<<<dim3(cdiv(cdiv(D, vec), c.lanes), B), c.threads, c.smem, s>>>(
        static_cast<const E*>(x), static_cast<const E*>(a), ck,
        static_cast<const E*>(dy), static_cast<E*>(dx), static_cast<E*>(da),
        T, D, sx, sa, sdy, c.lanes, c.slots, flags);
    return (int)cudaGetLastError();
  });
}
