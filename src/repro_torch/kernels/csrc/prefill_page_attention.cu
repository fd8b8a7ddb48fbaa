// Chunked-prefill GQA attention: one prompt chunk's queries against the
// gathered ring context of its earlier chunks plus the chunk's own keys,
// masked by absolute position.
//
// Replaces the Pallas TPU kernel repro/kernels/page_gather.py
// (prefill_page_attention, :107, pallas_call at :157, body _prefill_kernel
// :66-102).  Same function: q (B,C,H,hd), k_ctx/v_ctx (B,L,KV,hd),
// k_new/v_new (B,C,KV,hd), ctx_pos (B,L) int32 (negative = dead slot),
// q_pos (B,C) int32 -> (B,C,H,hd) in q's dtype.  Key j is live for query
// row i iff 0 <= kpos_j <= qpos_i and, with a window, kpos_j > qpos_i -
// window; scale hd^-0.5; online softmax in f32; probabilities of dead
// keys are re-masked to 0 (an all-dead tile would otherwise add
// exp(NEG_INF - NEG_INF) = 1 per slot) and the denominator is clamped at
// 1e-30, so a row with no live key writes 0.
//
// Bound on the H100: bytes at the serving shapes.  A chunk of C tokens
// over a ring of L slots does 4 * hd * H * (live pairs) FLOPs, at most
// 4 * hd * H * C * (L + C), on (C*(2H + 2KV) + 2*L*KV) * hd * elem bytes:
// at llama3.2-1b's heads (H 32, KV 8, hd 64) about 2*C FLOP per byte
// when the ring is full, so C = 128 sits near the card's ~295 bf16
// FLOP/byte ridge and smaller chunks below it.  This kernel runs its
// products on the CUDA cores in f32 and is far from either bound.
//
// Design (simple and right first; no tensor cores yet):
// * Grid: one block per (tile of BR = 32 query rows, kv head, batch row).
//   The rows of a kv head are its query group times the chunk, ordered
//   token-major (row r = token r / group, head kvh * group + r % group),
//   so a tile spans the whole group for a run of chunk tokens and reads
//   each K/V tile once for all of it, as the decode kernel does.  The
//   Pallas grid puts all group * C rows of a kv head in one program, 8
//   programs at B = 1: here C = 128 gives 128 blocks on the 132 SMs.
// * No concatenation: the key axis is walked as ctx slots 0..L-1, then
//   the chunk's keys 0..C-1, in 64-key tiles read through strides from
//   the two sources (a tile may straddle them).  The wrapper allocates
//   only the output.
// * Masking by position, never by index: a ring slot's position is not
//   its index once the ring wraps.  A tile is skipped only when no key in
//   it is live for any row of the block, judged from the block's least
//   and greatest query position (a superset of the live pairs); dead
//   slots are never loaded.
// * 128 threads: 8 row groups of 4 rows x 16 lanes; each thread owns a
//   4x4 patch of the 32x64 score tile and a 4 x (HD/16) patch of the
//   accumulator; tiles sit in shared memory as f32 with rows padded to
//   HD+1 floats, so column walks are free of bank conflicts.
// * Few blocks share an SM (one at C = 128, B = 1), so little else hides
//   device-memory latency: each thread issues its tile loads 8 at a time,
//   all in flight before the first store to shared memory.
// Tensor cores (mma/wgmma) and reading the pages in place (which removes
// the page_gather before each chunk) are later work.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BR = 32;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads: 8 row groups x 16 lanes
constexpr int LOADS = 8; // K/V tile loads in flight per thread
static_assert(BR * 32 % (NT * LOADS) == 0 && BK * 32 % (NT * LOADS) == 0,
              "tile loads must divide evenly");

// element strides of one (B, S, heads, hd) tensor; the head dim is unit
struct Strides {
  long long b, s, h;
};

template <int HD>
constexpr size_t smem_bytes() {
  // Qs [BR][HD+1], Ks [BK][HD+1], Vs [BK][HD], Ps [BR][BK+1] f32,
  // row positions [BR] and key positions [BK] int32
  return sizeof(float) *
             (BR * (HD + 1) + BK * (HD + 1) + BK * HD + BR * (BK + 1)) +
         sizeof(int) * (BR + BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) prefill_page_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kctx,
    const T* __restrict__ vctx, const T* __restrict__ knew,
    const T* __restrict__ vnew, const int* __restrict__ ctx_pos,
    const int* __restrict__ q_pos, T* __restrict__ o, int C, int L, int hd,
    int group, Strides sq, Strides skc, Strides svc, Strides skn,
    Strides svn, Strides so, long long cps, long long qps, float scale,
    int window) {
  constexpr int DPT = HD / 16;  // accumulator dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BR * (HD + 1);
  float* Vs = Ks + BK * (HD + 1);
  float* Ps = Vs + BK * HD;
  int* qp_s = reinterpret_cast<int*>(Ps + BR * (BK + 1));
  int* kp_s = qp_s + BR;

  const int r0 = blockIdx.x * BR;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int R = group * C;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // lane within the row group
  const int* cpos = ctx_pos + b * cps;
  const int* qpos = q_pos + b * qps;

  // the block's query rows and their positions (-1: past the last row)
  const T zero = from_f32<T>(0.f);
  for (int i0 = tid; i0 < BR * HD; i0 += NT * LOADS) {
    T x[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * NT;
      const int r = r0 + i / HD, d = i % HD;
      x[u] = zero;
      if (r < R && d < hd) {
        const int t = r / group, h = kvh * group + r % group;
        x[u] = q[b * sq.b + t * sq.s + h * sq.h + d];
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * NT;
      Qs[(i / HD) * (HD + 1) + i % HD] = to_f32(x[u]);
    }
  }
  if (tid < BR) qp_s[tid] = r0 + tid < R ? qpos[(r0 + tid) / group] : -1;
  __syncthreads();
  int qmin = INT_MAX, qmax = -1;
  for (int i = 0; i < BR; ++i) {
    if (qp_s[i] < 0) continue;
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const T* kcb = kctx + b * skc.b + kvh * skc.h;
  const T* vcb = vctx + b * svc.b + kvh * svc.h;
  const T* knb = knew + b * skn.b + kvh * skn.h;
  const T* vnb = vnew + b * svn.b + kvh * svn.h;
  const int T_all = L + C;

  for (int k0 = 0; k0 < T_all; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps/kp_s are no longer read
    bool any = false;
    if (tid < BK) {
      const int j = k0 + tid;
      const int kp = j < L ? cpos[j] : (j < T_all ? qpos[j - L] : -1);
      kp_s[tid] = kp;
      any = kp >= 0 && kp <= qmax && (window <= 0 || kp > qmin - window);
    }
    if (!__syncthreads_or(any)) continue;  // no live pair in this tile

    // LOADS loads of K and of V in flight per thread before any store: a
    // loop that stored each element before loading the next would wait a
    // full device-memory latency per element.  The raw elements wait in
    // registers and are converted at the store, since the bf16 conversion
    // (inline assembly) would otherwise sit between consecutive loads.
    for (int i0 = tid; i0 < BK * HD; i0 += NT * LOADS) {
      T kx[LOADS], vx[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * NT;
        const int r = i / HD, d = i % HD, j = k0 + r;
        kx[u] = zero;
        vx[u] = zero;
        if (kp_s[r] >= 0 && d < hd) {
          if (j < L) {
            kx[u] = kcb[(long long)j * skc.s + d];
            vx[u] = vcb[(long long)j * svc.s + d];
          } else {
            kx[u] = knb[(long long)(j - L) * skn.s + d];
            vx[u] = vnb[(long long)(j - L) * svn.s + d];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * NT;
        Ks[(i / HD) * (HD + 1) + i % HD] = to_f32(kx[u]);
        Vs[i] = to_f32(vx[u]);
      }
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qp_s[ty * 4 + i];
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kp_s[tx + 16 * j];
        live[j] = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
        sc[i][j] = live[j] ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= R) continue;
    const int t = r / group, h = kvh * group + r % group;
    T* ob = o + b * so.b + t * so.s + h * so.h;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[d] = from_f32<T>(acc[i][j] * inv);
    }
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

template <typename F>
int with_hd(int hd, F&& f) {
  if (hd <= 32) return f(std::integral_constant<int, 32>{});
  if (hd <= 64) return f(std::integral_constant<int, 64>{});
  if (hd <= 128) return f(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

// strides: 20 values in elements: (b, s, h) for q, k_ctx, v_ctx, k_new,
// v_new, o in that order (the head dim is contiguous in all six), then the
// batch strides of ctx_pos and q_pos (their position axis is contiguous).
extern "C" int prefill_page_attention_fwd(
    const void* q, const void* k_ctx, const void* v_ctx, const void* k_new,
    const void* v_new, const void* ctx_pos, const void* q_pos, void* o,
    int dtype, int B, int C, int L, int H, int KV, int hd,
    const long long* st, float scale, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_elem(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      auto kern = prefill_page_attention_kernel<T, HD>;
      const size_t smem = smem_bytes<HD>();
      int err = (int)cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      const int group = H / KV;
      const dim3 grid((group * C + BR - 1) / BR, KV, B);
      kern<<<grid, NT, smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_ctx),
          static_cast<const T*>(v_ctx), static_cast<const T*>(k_new),
          static_cast<const T*>(v_new), static_cast<const int*>(ctx_pos),
          static_cast<const int*>(q_pos), static_cast<T*>(o), C, L, hd,
          group, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
          strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), st[18],
          st[19], scale, window);
      return (int)cudaGetLastError();
    });
  });
}
