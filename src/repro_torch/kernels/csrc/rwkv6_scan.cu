// RWKV-6 WKV recurrence: forward for training, and its backward, as
// chunk-parallel scans.
//
// Forward: replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py
// (rwkv6_scan, pallas_call at :73).  Same function: per (batch, head) an
// (hd, hd) f32 state S, from zero,
//   y_t[j]       = sum_i r_t[i] (S_t[i,j] + u[i] k_t[i] v_t[j])
//   S_{t+1}[i,j] = w_t[i] S_t[i,j] + k_t[i] v_t[j]
// with r, k, v (B,T,H,hd) in the compute dtype (f32 or bf16), the decay w
// (B,T,H,hd) in f32 (the model computes it in f32 and it stays so: a bf16
// decay would change the recurrence), u (H,hd) f32, y (B,T,H,hd) in r's
// dtype.  Any T: the TPU kernel pads T with w = 1, this one stops at T.
// On request it also writes the state S_t at every CK-th step, t = 0, CK,
// 2 CK, ... (B,H,ceil(T/CK),hd,hd) f32, which the backward restarts from.
//
// Backward: the TPU package has none (it trains through autodiff of the
// lax.scan in its plain version).  With G_t = dL/dS_t, G_T = 0,
//   G_t     = diag(w_t) G_{t+1} + r_t dy_t^T
//   dr_t[i] = sum_j S_t[i,j] dy_t[j]     + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_{t+1}[i,j] v_t[j] + u[i] r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_{t+1}[i,j] k_t[i] + (r_t . (u * k_t)) dy_t[j]
//   dw_t[i] = sum_j G_{t+1}[i,j] S_t[i,j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
// dr, dk, dv come back in r's dtype, dw and du in f32.
//
// Bound on the H100: per (b, h, t) the forward does ~5 hd^2 f32 FLOPs on
// 4 hd elements read and hd written (~80 FLOP per byte at hd 64, against
// the CUDA cores' 20 FLOP per byte): operations-bound, ~14 hd^2 a step for
// the backward.  The checkpoints are this design's own traffic, not the
// function's, and are left out of the bound.
//
// Design: chunk-parallel.  Every element S[i,j] recurs on its own (w and k
// index the row, v the column), and a chunk of CK steps acts on the state
// as S -> a_c (.) S + dS_c, with a_c = prod w (per row) and dS_c the chunk's
// walk from zero.  So no block walks more than CK steps, and every kernel
// of a pass has one block per (chunk, slice, h, b), 4096 at B4 T512 H32
// hd64 against the 128 chains of a sequential walk:
//   rwkv6_fwd_sum_kernel  (a_c, dS_c) of every chunk to scratch, one warp
//                         per 16-column slice;
//   rwkv6_fwd_kernel      each chunk folds the summaries before it into its
//                         start state (at most nc-1 elementwise steps),
//                         writes it as checkpoint c, walks its CK steps and
//                         emits y; one warp holds a slice of 16 columns and
//                         every row, so y (a sum over rows) is whole in it.
// The backward is the same in reverse time on G (G -> A_c (.) G + dG_c):
//   rwkv6_bwd_sum_kernel  each chunk's (A_c, dG_c) walked backward from 0;
//   rwkv6_bwd_dv_kernel   the forward's walk run backward on G in column
//                         slices: dv, whole in the block;
//   rwkv6_bwd_kernel      16-row slices: G at the chunk's end folded from
//                         the later chunks, S_t rebuilt from the checkpoint
//                         in two levels (the states at the SEG-step segment
//                         boundaries, then each SUB-step sub-chunk's states
//                         in shared memory), walked backward: dr, dk, dw
//                         (sums over the columns, whole in the block) and
//                         du's per-(b, chunk) f64 partials;
//   rwkv6_du_kernel       du = the partials summed over (b, chunk) in a
//                         fixed order in f64, rounded to f32 once.
// The column kernels stage TS steps at a time in shared memory as f32,
// the backward walk SEG steps; every load of a tile is issued before the
// first is used.  A lane holds 32 (column kernels) or 16 (backward walk)
// elements of the state, so that the rows' and columns' values it reads
// from shared memory serve several elements.  What bounds them on the
// card is latency at the occupancy their registers and shared memory
// allow, hence the launch bounds and the backward's 4-step sub-chunks.
// Nothing is divided by w (w = exp(-exp(x)) is exactly 0 in f32 for large
// x): dw comes from S_t and G_{t+1} directly.  The results differ from a
// sequential walk only by reassociation.  Every output element is written
// once by one thread, with no atomics: deterministic run to run.  Every
// kernel reads the (B,T,H,hd) layout through strides (16-byte aligned
// rows, head dim contiguous): no transposes.  All arithmetic is f32 on
// the CUDA cores; bf16 is only the I/O type.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int CK = 64;        // chunk: steps a block walks; checkpoint interval
constexpr int SEG = 16;       // backward: steps staged at once, level-1 states
constexpr int SUB = 4;        // backward: sub-chunk whose states sit in smem
constexpr int TS = 8;         // steps staged a tile in the column kernels
constexpr int SUM_COLS = 16;  // columns of a summary block
constexpr int WALK_COLS = 16; // columns of a forward / dv walk block
constexpr int BWD_ROWS = 16;  // rows of a backward walk block
constexpr unsigned FULL = 0xffffffffu;
// blocks an SM the bf16 kernels are compiled for (their registers): the
// most that ptxas fits without a spill (the walks spill at 14); the f32
// ones, whose loads take twice the registers, are not bounded
template <typename T>
constexpr int SUM_BLOCKS = sizeof(T) == 2 ? 16 : 1;
template <typename T>
constexpr int WALK_BLOCKS = sizeof(T) == 2 ? 12 : 1;
template <typename T>
constexpr int BWD_BLOCKS = sizeof(T) == 2 ? 8 : 1;

// element strides of one (B, T, H, hd) tensor; the head dim is unit
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ long long at(const Strides& s, int b, long long t,
                                        int h) {
  return (long long)b * s.b + t * s.t + (long long)h * s.h;
}

// 8 consecutive head-dim elements (16-byte aligned) as loaded, converted
// to f32 later: a tile's loads are all issued before the first is used
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ Raw8<float> fetch8(const float* p) {
  return {*reinterpret_cast<const float4*>(p),
          *reinterpret_cast<const float4*>(p + 4)};
}
__device__ __forceinline__ Raw8<__nv_bfloat16> fetch8(
    const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}

__device__ __forceinline__ void unpack(const float4& a, float* x) {
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
}

__device__ __forceinline__ void cvt8(const Raw8<float>& r, float (&x)[8]) {
  unpack(r.a, x);
  unpack(r.b, x + 4);
}
__device__ __forceinline__ void cvt8(const Raw8<__nv_bfloat16>& r,
                                     float (&x)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    x[2 * e] = f.x, x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// A staged row vector in shared memory.  A lane reads R consecutive rows;
// when R >= 8 the groups of R rows sit 4 floats apart, so that the 8 lanes
// of a quarter-warp reading 8 groups hit distinct banks.
template <int R>
__host__ __device__ constexpr int prow(int i) {
  return R >= 8 ? i + (i / R) * 4 : i;
}
template <int HD, int R>
__host__ __device__ constexpr int row_len() {
  return prow<R>(HD);
}

// rows g*R .. g*R + R - 1 of a staged row vector
template <int R>
__device__ __forceinline__ void load_rows(const float* src, int g,
                                          float (&x)[R]) {
  const float* p = src + prow<R>(g * R);
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int m = 0; m < R / 4; ++m)
      unpack(*reinterpret_cast<const float4*>(p + 4 * m), x + 4 * m);
  } else if constexpr (R == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

// Sum each of x[0..N) over the L lanes that differ in the lane bits below
// L, splitting the values among them: at each level a lane pair keeps one
// half and sends the other, then (one value left) plain butterfly steps.
// On return x[0 .. max(N/L, 1)) holds the sums of the values numbered
// split_base<N, L>(lane) + e.
template <int N, int n, int O, int L>
__device__ __forceinline__ void reduce_split(float (&x)[N], int lane,
                                             unsigned mask) {
  if constexpr (O < L) {
    if constexpr (n > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int e = 0; e < n / 2; ++e) {
        const float keep = up ? x[e + n / 2] : x[e];
        const float send = up ? x[e] : x[e + n / 2];
        x[e] = keep + __shfl_xor_sync(mask, send, O);
      }
      reduce_split<N, n / 2, O * 2, L>(x, lane, mask);
    } else {
      x[0] += __shfl_xor_sync(mask, x[0], O);
      reduce_split<N, 1, O * 2, L>(x, lane, mask);
    }
  }
}
template <int N, int L>
__device__ __forceinline__ int split_base(int lane) {
  int base = 0;
#pragma unroll
  for (int o = 1, n = N; o < L && n > 1; o <<= 1, n >>= 1)
    if (lane & o) base += n / 2;
  return base;
}

// step t of walk position p in a chunk [t0, t0 + n), backward when REV
template <bool REV>
__device__ __forceinline__ long long walk_step(int t0, int n, int p) {
  return REV ? (long long)t0 + n - 1 - p : (long long)t0 + p;
}

// ---------------------------------------------------------------------------
// Chunk summaries: one warp per (chunk, 16-column slice, h, b).  From a
// zero state walk the chunk's steps (backward in time when REV) of
//   X <- diag(w_t) X + bv_t cv_t^T
// and keep a = prod w_t per row: (k, v) for the forward's S, (r, dy) for
// the backward's G.  Lane = (column quad cq, row group g of HD/8 rows).
// Writes dS to scratch[b, h, c] as an (HD, HD) block followed by a (HD).
// Every chunk is summarised (the forward never reads the last one's, the
// backward never the first one's) so that the grid has as many blocks as
// the walks'.
// ---------------------------------------------------------------------------
template <typename T, int HD, bool REV>
__device__ __forceinline__ void chunk_summary(
    const T* __restrict__ bv, const T* __restrict__ cv,
    const float* __restrict__ w, float* __restrict__ summ, int T_, int H,
    int nc, Strides sb, Strides sc, Strides sw) {
  constexpr int R = HD / 8, LEN = row_len<HD, R>(), NSL = HD / SUM_COLS,
                NQ = HD / 8, IT = (TS * NQ + 31) / 32;
  __shared__ __align__(16) float bs[TS][LEN];
  __shared__ __align__(16) float ws[TS][LEN];
  __shared__ __align__(16) float cs[TS][SUM_COLS];
  const int lane = threadIdx.x, g = lane % 8, cq = lane / 8, q = lane % NQ;
  const int js = blockIdx.x % NSL, c = blockIdx.x / NSL;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CK, n = min(CK, T_ - t0);
  float S[R][4], a[R];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    a[e] = 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) S[e][j] = 0.f;
  }
  Raw8<T> rb[IT], rc;
  Raw8<float> rw[IT];
  auto fetch = [&](int p0) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int p = (it * 32 + lane) / NQ;
      if (p < TS && p0 + p < n) {
        const long long t = walk_step<REV>(t0, n, p0 + p);
        rb[it] = fetch8(bv + at(sb, b, t, h) + 8 * q);
        rw[it] = fetch8(w + at(sw, b, t, h) + 8 * q);
      }
    }
    const int p = lane / 2, half = lane % 2;
    if (p < TS && p0 + p < n)
      rc = fetch8(cv + at(sc, b, walk_step<REV>(t0, n, p0 + p), h) +
                  js * SUM_COLS + 8 * half);
  };
  for (int p0 = 0; p0 < n; p0 += TS) {
    const int m = min(TS, n - p0);
    fetch(p0);
    __syncwarp();  // the previous tile is consumed
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int p = (it * 32 + lane) / NQ;
      if (p < m) {
        float x[8];
        cvt8(rb[it], x);
        store8(&bs[p][prow<R>(8 * q)], x);
        cvt8(rw[it], x);
        store8(&ws[p][prow<R>(8 * q)], x);
      }
    }
    {
      const int p = lane / 2, half = lane % 2;
      if (p < m) {
        float x[8];
        cvt8(rc, x);
        store8(&cs[p][8 * half], x);
      }
    }
    __syncwarp();
#pragma unroll 2
    for (int tt = 0; tt < m; ++tt) {
      float bb[R], ww[R], cc[4];
      load_rows<R>(bs[tt], g, bb);
      load_rows<R>(ws[tt], g, ww);
      unpack(*reinterpret_cast<const float4*>(&cs[tt][4 * cq]), cc);
#pragma unroll
      for (int e = 0; e < R; ++e) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          S[e][j] = fmaf(ww[e], S[e][j], bb[e] * cc[j]);
        a[e] *= ww[e];
      }
    }
  }
  float* dst = summ + ((long long)(b * H + h) * nc + c) * (HD * HD + HD);
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int i = g * R + e;
    *reinterpret_cast<float4*>(dst + i * HD + js * SUM_COLS + 4 * cq) =
        make_float4(S[e][0], S[e][1], S[e][2], S[e][3]);
    if (js == 0 && cq == 0) dst[HD * HD + i] = a[e];
  }
}

// ---------------------------------------------------------------------------
// Chunk walks: one warp per (chunk, 16-column slice, h, b).  The start
// state is the fold of the summaries of the chunks before this one in walk
// order; then for each step (backward in time when REV)
//   out_t[j] = sum_i av_t[i] X[i,j] + (sum_i av_t[i] u[i] bv_t[i]) cv_t[j]
//   X       <- diag(w_t) X + bv_t cv_t^T
// Forward: (av, bv, cv) = (r, k, v), out y, X = S (checkpoint written when
// ckpt is given).  Backward: (k, r, dy), out dv, X = G.  Lane = (column
// quad cq, row group g of HD/8 rows); out is summed over the 8 row groups.
// ---------------------------------------------------------------------------
template <typename T, int HD, bool REV>
__device__ __forceinline__ void chunk_walk(
    const T* __restrict__ av, const T* __restrict__ bv,
    const T* __restrict__ cv, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ summ,
    T* __restrict__ out, float* __restrict__ ckpt, int T_, int H, int nc,
    Strides sa, Strides sb, Strides sc, Strides sw, Strides so) {
  constexpr int R = HD / 8, LEN = row_len<HD, R>(), NSL = HD / WALK_COLS,
                NQ = HD / 8, IT = (TS * NQ + 31) / 32;
  __shared__ __align__(16) float as[TS][LEN];
  __shared__ __align__(16) float bs[TS][LEN];
  __shared__ __align__(16) float ws[TS][LEN];
  __shared__ __align__(16) float cs[TS][WALK_COLS];
  __shared__ float bon[TS];
  const int lane = threadIdx.x, g = lane % 8, cq = lane / 8, q = lane % NQ;
  const int js = blockIdx.x % NSL, c = blockIdx.x / NSL;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CK, n = min(CK, T_ - t0);
  const int col = js * WALK_COLS + 4 * cq;
  Raw8<T> ra[IT], rb[IT], rc;
  Raw8<float> rw[IT];
  auto fetch = [&](int p0) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int p = (it * 32 + lane) / NQ;
      if (p < TS && p0 + p < n) {
        const long long t = walk_step<REV>(t0, n, p0 + p);
        ra[it] = fetch8(av + at(sa, b, t, h) + 8 * q);
        rb[it] = fetch8(bv + at(sb, b, t, h) + 8 * q);
        rw[it] = fetch8(w + at(sw, b, t, h) + 8 * q);
      }
    }
    const int p = lane / 2, half = lane % 2;
    if (p < TS && p0 + p < n)
      rc = fetch8(cv + at(sc, b, walk_step<REV>(t0, n, p0 + p), h) +
                  js * WALK_COLS + 8 * half);
  };
  float uq[8];  // u on the rows this lane stages
#pragma unroll
  for (int e = 0; e < 8; ++e) uq[e] = u[h * HD + 8 * q + e];
  float X[R][4];
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int j = 0; j < 4; ++j) X[e][j] = 0.f;
  const long long bh = (long long)(b * H + h) * nc;
  const int nfold = REV ? nc - 1 - c : c;
#pragma unroll 2
  for (int f = 0; f < nfold; ++f) {
    const float* src = summ + (bh + (REV ? nc - 1 - f : f)) * (HD * HD + HD);
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int i = g * R + e;
      const float ai = src[HD * HD + i];
      float d[4];
      unpack(*reinterpret_cast<const float4*>(src + i * HD + col), d);
#pragma unroll
      for (int j = 0; j < 4; ++j) X[e][j] = fmaf(ai, X[e][j], d[j]);
    }
  }
  if (ckpt) {
    float* dst = ckpt + (bh + c) * HD * HD;
#pragma unroll
    for (int e = 0; e < R; ++e)
      *reinterpret_cast<float4*>(dst + (g * R + e) * HD + col) =
          make_float4(X[e][0], X[e][1], X[e][2], X[e][3]);
  }
  // the output column this lane writes after the reduction
  const int jo = split_base<4, 8>(lane);
  for (int p0 = 0; p0 < n; p0 += TS) {
    const int m = min(TS, n - p0);
    fetch(p0);
    __syncwarp();  // the previous tile is consumed
    // the rows of av, bv, w and each step's bonus, NQ lanes a step
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int p = (it * 32 + lane) / NQ;
      float x = 0.f;
      if (p < m) {
        float xa[8], xb[8], xw[8];
        cvt8(ra[it], xa);
        cvt8(rb[it], xb);
        cvt8(rw[it], xw);
        store8(&as[p][prow<R>(8 * q)], xa);
        store8(&bs[p][prow<R>(8 * q)], xb);
        store8(&ws[p][prow<R>(8 * q)], xw);
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(xa[e] * uq[e], xb[e], x);
      }
#pragma unroll
      for (int off = 1; off < NQ; off <<= 1)
        x += __shfl_xor_sync(FULL, x, off);
      if (p < m && q == 0) bon[p] = x;
    }
    {
      const int p = lane / 2, half = lane % 2;
      if (p < m) {
        float x[8];
        cvt8(rc, x);
        store8(&cs[p][8 * half], x);
      }
    }
    __syncwarp();
#pragma unroll 2
    for (int tt = 0; tt < m; ++tt) {
      float aa[R], bb[R], ww[R], cc[4], y[4] = {0.f, 0.f, 0.f, 0.f};
      load_rows<R>(as[tt], g, aa);
      load_rows<R>(bs[tt], g, bb);
      load_rows<R>(ws[tt], g, ww);
      unpack(*reinterpret_cast<const float4*>(&cs[tt][4 * cq]), cc);
#pragma unroll
      for (int e = 0; e < R; ++e) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[j] = fmaf(aa[e], X[e][j], y[j]);
          X[e][j] = fmaf(ww[e], X[e][j], bb[e] * cc[j]);
        }
      }
      reduce_split<4, 4, 1, 8>(y, lane, FULL);
      if (g < 4) {
        const long long t = walk_step<REV>(t0, n, p0 + tt);
        const float cj = jo == 0 ? cc[0] : jo == 1 ? cc[1] : jo == 2 ? cc[2]
                                                                     : cc[3];
        out[at(so, b, t, h) + col + jo] = from_f32<T>(fmaf(bon[tt], cj, y[0]));
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(32, SUM_BLOCKS<T>)
    rwkv6_fwd_sum_kernel(const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ w, float* __restrict__ summ,
                         int T_, int H, int nc, Strides sk, Strides sv,
                         Strides sw) {
  chunk_summary<T, HD, false>(k, v, w, summ, T_, H, nc, sk, sv, sw);
}

template <typename T, int HD>
__global__ void __launch_bounds__(32, WALK_BLOCKS<T>)
    rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ summ, T* __restrict__ y,
                     float* __restrict__ ckpt, int T_, int H, int nc,
                     Strides sr, Strides sk, Strides sv, Strides sw,
                     Strides sy) {
  chunk_walk<T, HD, false>(r, k, v, w, u, summ, y, ckpt, T_, H, nc, sr, sk,
                           sv, sw, sy);
}

template <typename T, int HD>
__global__ void __launch_bounds__(32, SUM_BLOCKS<T>)
    rwkv6_bwd_sum_kernel(const T* __restrict__ r, const T* __restrict__ dy,
                         const float* __restrict__ w, float* __restrict__ summ,
                         int T_, int H, int nc, Strides sr, Strides sdy,
                         Strides sw) {
  chunk_summary<T, HD, true>(r, dy, w, summ, T_, H, nc, sr, sdy, sw);
}

template <typename T, int HD>
__global__ void __launch_bounds__(32, WALK_BLOCKS<T>)
    rwkv6_bwd_dv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ dy, const float* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ summ, T* __restrict__ dv,
                        int T_, int H, int nc, Strides sr, Strides sk,
                        Strides sdy, Strides sw, Strides sdv) {
  chunk_walk<T, HD, true>(k, r, dy, w, u, summ, dv, nullptr, T_, H, nc, sk,
                          sr, sdy, sw, sdv);
}

// ---------------------------------------------------------------------------
// Backward walk: one block per (chunk, 16-row slice, h, b) of BWD_ROWS / 2
// * Q threads, Q = HD/8 column groups: thread (row pair rp, group q) holds
// rows 2rp, 2rp+1 of the slice and columns 4q..4q+3, HD/2+4q..HD/2+4q+3,
// 16 elements of G and of S.  Two rows a thread halve the columns' bytes
// each element reads from shared memory; 4-step sub-chunks keep a block at
// 27.7 KB of it and 128 registers, 8 blocks (16 warps) an SM.
// ---------------------------------------------------------------------------
template <int HD>
__host__ __device__ constexpr int bwd_threads() {
  return BWD_ROWS / 2 * (HD / 8);
}

template <int HD>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  // states [SUB][4][threads] float4; r, k, w [SEG][BWD_ROWS] each; v and
  // dy [SEG][HD] each; v . dy [SEG]
  return sizeof(float) * (SUB * 16 * bwd_threads<HD>() +
                          3 * SEG * BWD_ROWS + 2 * SEG * HD + SEG);
}

template <typename T, int HD>
__global__ void __launch_bounds__(bwd_threads<HD>(), BWD_BLOCKS<T>)
    rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ summ,
                     const T* __restrict__ dy, T* __restrict__ dr,
                     T* __restrict__ dk, float* __restrict__ dw,
                     double* __restrict__ du_part, int T_, int H, int nc,
                     Strides sr, Strides sk, Strides sv, Strides sw,
                     Strides sdy, Strides sdr, Strides sdk, Strides sdw) {
  constexpr int Q = HD / 8, NT = bwd_threads<HD>(), NSL = HD / BWD_ROWS;
  constexpr int NB = CK / SEG;
  constexpr unsigned MASK = NT >= 32 ? FULL : (1u << NT) - 1u;
  static_assert(Q == 2 || Q == 8, "head dims 16 and 64");
  static_assert(SEG % SUB == 0, "a segment is whole sub-chunks");
  extern __shared__ __align__(16) float smem[];
  float4* st = reinterpret_cast<float4*>(smem);  // [SUB][4][NT]
  float* rs_ = smem + SUB * 16 * NT;             // [SEG][BWD_ROWS]
  float* ks_ = rs_ + SEG * BWD_ROWS;
  float* ws_ = ks_ + SEG * BWD_ROWS;
  float* vs = ws_ + SEG * BWD_ROWS;              // [SEG][HD]
  float* dys = vs + SEG * HD;                    // [SEG][HD]
  float* vd = dys + SEG * HD;                    // [SEG]
  const int tid = threadIdx.x, rp = tid / Q, q = tid % Q;
  const int rs = blockIdx.x % NSL, c = blockIdx.x / NSL;
  const int h = blockIdx.y, b = blockIdx.z;
  const int il = 2 * rp, i0 = rs * BWD_ROWS + il;  // rows i0, i0 + 1
  const int j0 = 4 * q, j1 = HD / 2 + 4 * q;
  const int t0 = c * CK, n = min(CK, T_ - t0), nseg = (n + SEG - 1) / SEG;
  const float u0 = u[h * HD + i0], u1 = u[h * HD + i0 + 1];
  const long long bh = (long long)(b * H + h) * nc;

  // this thread's 8 columns of a row vector (smem or global)
  auto cols = [&](const float* src, float (&x)[8]) {
    unpack(*reinterpret_cast<const float4*>(src + j0), x);
    unpack(*reinterpret_cast<const float4*>(src + j1), x + 4);
  };
  // its 16 elements of an (HD, HD) f32 block: rows i0, i0 + 1
  auto block16 = [&](const float* src, float (&x)[16]) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      unpack(*reinterpret_cast<const float4*>(src + (i0 + m) * HD + j0),
             x + 8 * m);
      unpack(*reinterpret_cast<const float4*>(src + (i0 + m) * HD + j1),
             x + 8 * m + 4);
    }
  };
  // G at the chunk's end: the later chunks' summaries folded in reverse
  float G[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) G[e] = 0.f;
#pragma unroll 1
  for (int cc = nc - 1; cc > c; --cc) {
    const float* src = summ + (bh + cc) * (HD * HD + HD);
    const float a0 = src[HD * HD + i0], a1 = src[HD * HD + i0 + 1];
    float d[16];
    block16(src, d);
#pragma unroll
    for (int e = 0; e < 16; ++e) G[e] = fmaf(e < 8 ? a0 : a1, G[e], d[e]);
  }
  // S at the segment boundaries t0 + SEG s (s = 0: the checkpoint), in a
  // small local array: written once, read once per segment; the loops stay
  // rolled so that the kernel's code stays small
  float Sb[NB][16];
  block16(ckpt + (bh + c) * HD * HD, Sb[0]);

  auto seg_len = [&](int s) { return min(SEG, n - SEG * s); };
  // stage(s): segment s's loads (this slice's rows of r, k, w; every
  // column of v and dy), all issued first, then stored in shared memory
  // as f32 with v . dy per step
  auto stage = [&](int s) {
    constexpr int IR = (2 * SEG + NT - 1) / NT, IC = (SEG * Q + NT - 1) / NT;
    const long long ts = t0 + SEG * s;
    const int ns = seg_len(s);
    Raw8<T> rr[IR], rk[IR], rv[IC], rd[IC];
    Raw8<float> rw[IR];
#pragma unroll
    for (int it = 0; it < IR; ++it) {
      const int idx = it * NT + tid, p = idx / 2, half = idx % 2;
      if (p < ns) {
        const int off = rs * BWD_ROWS + 8 * half;
        rr[it] = fetch8(r + at(sr, b, ts + p, h) + off);
        rk[it] = fetch8(k + at(sk, b, ts + p, h) + off);
        rw[it] = fetch8(w + at(sw, b, ts + p, h) + off);
      }
    }
#pragma unroll
    for (int it = 0; it < IC; ++it) {
      const int idx = it * NT + tid, p = idx / Q, qq = idx % Q;
      if (p < ns) {
        rv[it] = fetch8(v + at(sv, b, ts + p, h) + 8 * qq);
        rd[it] = fetch8(dy + at(sdy, b, ts + p, h) + 8 * qq);
      }
    }
    __syncthreads();  // the previous segment is consumed
#pragma unroll
    for (int it = 0; it < IR; ++it) {
      const int idx = it * NT + tid, p = idx / 2, half = idx % 2;
      if (p < ns) {
        float x[8];
        cvt8(rr[it], x);
        store8(rs_ + p * BWD_ROWS + 8 * half, x);
        cvt8(rk[it], x);
        store8(ks_ + p * BWD_ROWS + 8 * half, x);
        cvt8(rw[it], x);
        store8(ws_ + p * BWD_ROWS + 8 * half, x);
      }
    }
#pragma unroll
    for (int it = 0; it < IC; ++it) {
      const int idx = it * NT + tid, p = idx / Q, qq = idx % Q;
      float x = 0.f;
      if (p < ns) {
        float xv[8], xd[8];
        cvt8(rv[it], xv);
        cvt8(rd[it], xd);
        store8(vs + p * HD + 8 * qq, xv);
        store8(dys + p * HD + 8 * qq, xd);
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(xv[e], xd[e], x);
      }
#pragma unroll
      for (int o = 1; o < Q; o <<= 1) x += __shfl_xor_sync(MASK, x, o);
      if (p < ns && qq == 0) vd[p] = x;
    }
    __syncthreads();
  };
  // one step of S: S <- w_p S + k_p v_p on this thread's elements
  auto advance = [&](float (&S)[16], int p) {
    const float2 kk = *reinterpret_cast<const float2*>(ks_ + p * BWD_ROWS + il);
    const float2 ww = *reinterpret_cast<const float2*>(ws_ + p * BWD_ROWS + il);
    float vv[8];
    cols(vs + p * HD, vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      S[e] = fmaf(ww.x, S[e], kk.x * vv[e]);
      S[8 + e] = fmaf(ww.y, S[8 + e], kk.y * vv[e]);
    }
  };

  // level 1: the states at the segment boundaries
  {
    float S[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) S[e] = Sb[0][e];
#pragma unroll 1
    for (int s = 0; s + 1 < nseg; ++s) {  // only the last segment is ragged
      stage(s);
#pragma unroll 1
      for (int p = 0; p < SEG; ++p) advance(S, p);
#pragma unroll
      for (int e = 0; e < 16; ++e) Sb[s + 1][e] = S[e];
    }
  }
  // level 2: each segment, last first, in SUB-step sub-chunks, the later
  // first, each rebuilt and then walked backward
  double du0 = 0.0, du1 = 0.0;
  const int base = split_base<8, Q>(tid);
  T* dr_p = dr + at(sdr, b, 0, h) + i0;
  T* dk_p = dk + at(sdk, b, 0, h) + i0;
  float* dw_p = dw + at(sdw, b, 0, h) + i0;
#pragma unroll 1
  for (int s = nseg - 1; s >= 0; --s) {
    stage(s);
    const int ns = seg_len(s);
#pragma unroll 1
    for (int sc = SEG / SUB - 1; sc >= 0; --sc) {
      const int p0 = SUB * sc, nn = min(SUB, ns - p0);
      if (nn <= 0) continue;
      // the sub-chunk's start, rebuilt from the segment's, then each of
      // its states into shared memory (each thread stores and reads back
      // only its own; in registers they would cost occupancy)
      float S0[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) S0[e] = Sb[s][e];
#pragma unroll 1
      for (int p = 0; p < p0; ++p) advance(S0, p);
#pragma unroll 1
      for (int p = 0; p < nn; ++p) {
        if (p) advance(S0, p0 + p - 1);
#pragma unroll
        for (int qd = 0; qd < 4; ++qd)
          st[(p * 4 + qd) * NT + tid] = make_float4(
              S0[4 * qd], S0[4 * qd + 1], S0[4 * qd + 2], S0[4 * qd + 3]);
      }
#pragma unroll 1
      for (int p = nn - 1; p >= 0; --p) {
        const int pp = p0 + p;
        const float2 rr2 = *reinterpret_cast<const float2*>(rs_ + pp * BWD_ROWS + il);
        const float2 kk = *reinterpret_cast<const float2*>(ks_ + pp * BWD_ROWS + il);
        const float2 ww = *reinterpret_cast<const float2*>(ws_ + pp * BWD_ROWS + il);
        float vv[8], dd[8];
        cols(vs + pp * HD, vv);
        cols(dys + pp * HD, dd);
        // (dr, dk, dw) partials of rows i0 and i0 + 1, then 2 unused
        float y[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          const int m = qd / 2;
          const float rm = m ? rr2.y : rr2.x, wm = m ? ww.y : ww.x;
          float sv[4];
          unpack(st[(p * 4 + qd) * NT + tid], sv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * (qd % 2) + e;
            float& g = G[4 * qd + e];
            y[3 * m] = fmaf(sv[e], dd[j], y[3 * m]);          // dr
            y[3 * m + 1] = fmaf(g, vv[j], y[3 * m + 1]);      // dk
            y[3 * m + 2] = fmaf(g, sv[e], y[3 * m + 2]);      // dw
            g = fmaf(wm, g, rm * dd[j]);
          }
        }
        reduce_split<8, 8, 1, Q>(y, tid, MASK);
        const float bb = vd[pp];
        const long long t = t0 + SEG * s + pp;
#pragma unroll
        for (int e = 0; e < 8 / Q; ++e) {
          const int idx = base + e, m = idx / 3, kind = idx % 3;
          if (idx < 6) {
            const float um = m ? u1 : u0, rm = m ? rr2.y : rr2.x,
                        km = m ? kk.y : kk.x;
            if (kind == 0)
              dr_p[t * sdr.t + m] = from_f32<T>(y[e] + um * km * bb);
            else if (kind == 1)
              dk_p[t * sdk.t + m] = from_f32<T>(y[e] + um * rm * bb);
            else
              dw_p[t * sdw.t + m] = y[e];
          }
        }
        du0 += (double)(rr2.x * kk.x * bb);
        du1 += (double)(rr2.y * kk.y * bb);
      }
    }
  }
  if (q == 0) {
    double* dst = du_part + ((long long)(b * nc + c) * H + h) * HD + i0;
    dst[0] = du0;
    dst[1] = du1;
  }
}

// du[h, i] = sum over (b, chunk), in that order, of the f64 partials
__global__ void rwkv6_du_kernel(const double* __restrict__ du_part,
                                float* __restrict__ du, int parts, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  double x = 0.0;
  for (int p = 0; p < parts; ++p) x += du_part[(long long)p * n + idx];
  du[idx] = (float)x;
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

template <typename F>
int with_hd(int hd, F&& f) {
  switch (hd) {
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
  }
  return (int)cudaErrorInvalidValue;
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

int static_smem(const void* kern) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  return err ? -(int)err : (int)attr.sharedSizeBytes;
}

bool bad_shape(int B, int T, int H, int chunk) {
  return B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535 || chunk != CK;
}

}  // namespace

extern "C" int rwkv6_scan_ck() { return CK; }

// The built kernels' numbers, for the wrapper's plan to be held to:
// kernel 0 fwd_sum, 1 fwd, 2 bwd_sum, 3 bwd_dv, 4 bwd (all bf16 at head
// dim hd); what 0: shared-memory bytes (static, or the dynamic size the
// launch asks for), 1: threads a block, 2: columns (rows for 4) a block.
extern "C" int rwkv6_scan_tiles(int kernel, int hd, int what) {
  return with_hd(hd, [&](auto hdc) -> int {
    constexpr int HD = decltype(hdc)::value;
    using E = __nv_bfloat16;
    const void* kerns[4] = {(const void*)rwkv6_fwd_sum_kernel<E, HD>,
                            (const void*)rwkv6_fwd_kernel<E, HD>,
                            (const void*)rwkv6_bwd_sum_kernel<E, HD>,
                            (const void*)rwkv6_bwd_dv_kernel<E, HD>};
    const int widths[5] = {SUM_COLS, WALK_COLS, SUM_COLS, WALK_COLS,
                           BWD_ROWS};
    if (kernel < 0 || kernel > 4) return -1;
    if (what == 0)
      return kernel == 4 ? (int)bwd_smem_bytes<HD>()
                         : static_smem(kerns[kernel]);
    if (what == 1) return kernel == 4 ? bwd_threads<HD>() : 32;
    if (what == 2) return widths[kernel];
    return -1;
  });
}

// strides: 15 values, (b, t, h) in elements for r, k, v, w, y in that
// order; the head dim is contiguous and every row 16-byte aligned.  u:
// (H, hd) f32 contiguous; ckpt: (B, H, ceil(T/CK), hd, hd) f32 or null;
// summ: f32 scratch of B*H*ceil(T/CK)*hd*(hd+1) floats (unused when T <=
// CK); chunk: the wrapper's plan's chunk, which must be CK.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const float* w, const float* u, void* y,
                              float* ckpt, float* summ, int dtype, int B,
                              int T, int H, int hd, int chunk,
                              const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, H, chunk)) return (int)cudaErrorInvalidValue;
  const int nc = (T + CK - 1) / CK;
  return with_elem(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      const E *er = static_cast<const E*>(r), *ek = static_cast<const E*>(k),
              *ev = static_cast<const E*>(v);
      if (nc > 1) {
        rwkv6_fwd_sum_kernel<E, HD>
            <<<dim3(nc * (HD / SUM_COLS), H, B), 32, 0, s>>>(
                ek, ev, w, summ, T, H, nc, strides_at(st, 1),
                strides_at(st, 2), strides_at(st, 3));
        const int err = (int)cudaGetLastError();
        if (err) return err;
      }
      rwkv6_fwd_kernel<E, HD><<<dim3(nc * (HD / WALK_COLS), H, B), 32, 0, s>>>(
          er, ek, ev, w, u, summ, static_cast<E*>(y), ckpt, T, H, nc,
          strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
          strides_at(st, 3), strides_at(st, 4));
      return (int)cudaGetLastError();
    });
  });
}

// strides: 27 values, (b, t, h) in elements for r, k, v, w, dy, dr, dk,
// dv, dw in that order; the head dim is contiguous and every row 16-byte
// aligned.  u: (H, hd) f32; ckpt: the forward's checkpoints; summ: f32
// scratch as for the forward; du_part: (B, ceil(T/CK), H, hd) f64 scratch;
// du: (H, hd) f32.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const float* ckpt, const void* dy, void* dr,
                              void* dk, void* dv, float* dw, float* summ,
                              double* du_part, float* du, int dtype, int B,
                              int T, int H, int hd, int chunk,
                              const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, H, chunk)) return (int)cudaErrorInvalidValue;
  const int nc = (T + CK - 1) / CK;
  return with_elem(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      const E *er = static_cast<const E*>(r), *ek = static_cast<const E*>(k),
              *ev = static_cast<const E*>(v), *edy = static_cast<const E*>(dy);
      int err;
      if (nc > 1) {
        rwkv6_bwd_sum_kernel<E, HD>
            <<<dim3(nc * (HD / SUM_COLS), H, B), 32, 0, s>>>(
                er, edy, w, summ, T, H, nc, strides_at(st, 0),
                strides_at(st, 4), strides_at(st, 3));
        if ((err = (int)cudaGetLastError())) return err;
      }
      rwkv6_bwd_dv_kernel<E, HD>
          <<<dim3(nc * (HD / WALK_COLS), H, B), 32, 0, s>>>(
              er, ek, edy, w, u, summ, static_cast<E*>(dv), T, H, nc,
              strides_at(st, 0), strides_at(st, 1), strides_at(st, 4),
              strides_at(st, 3), strides_at(st, 7));
      if ((err = (int)cudaGetLastError())) return err;
      auto kern = rwkv6_bwd_kernel<E, HD>;
      const size_t smem = bwd_smem_bytes<HD>();
      err = (int)cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      kern<<<dim3(nc * (HD / BWD_ROWS), H, B), bwd_threads<HD>(), smem, s>>>(
          er, ek, ev, w, u, ckpt, summ, edy, static_cast<E*>(dr),
          static_cast<E*>(dk), dw, du_part, T, H, nc, strides_at(st, 0),
          strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
          strides_at(st, 4), strides_at(st, 5), strides_at(st, 6),
          strides_at(st, 8));
      if ((err = (int)cudaGetLastError())) return err;
      const int n = H * HD;
      rwkv6_du_kernel<<<(n + 255) / 256, 256, 0, s>>>(du_part, du, B * nc, n);
      return (int)cudaGetLastError();
    });
  });
}
