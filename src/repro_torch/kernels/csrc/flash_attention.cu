// Causal / sliding-window GQA flash attention: forward for prefill and
// training, and its backward for training.
//
// Forward: replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :114).  Same function: q (B,S,H,hd),
// k/v (B,S,KV,hd) -> (B,S,H,hd) in q's dtype; scale hd^-0.5; kv head =
// h / (H/KV); online softmax in f32; keys masked by kpos < S, causal
// kpos <= qpos and window kpos > qpos - window.  Sq == Sk only.  On request
// it also writes the rows' log-sum-exp lse (B,H,S) in f32 (the scaled
// scores' domain), which the backward needs; serving passes no lse buffer
// and pays nothing for it.
//
// Backward: the TPU package has none (it trains through autodiff of its
// plain attention); this is the gradient of the forward above, given dO:
//   P  = exp(scale * q.k - lse)        (recomputed, never stored)
//   D  = rowsum(dO * O)
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = scale dS^T Q,  dQ = scale dS K
// with the GQA group's q heads summed into their kv head's dK and dV.
//
// Bound on the H100: a causal prefill does 4 * hd * H * B * S(S+1)/2 FLOPs
// on B*S*(2H+2KV)*hd*elem bytes (q, k, v read, o written), about 0.4*S
// FLOP/byte for llama3.2-1b's heads against the card's ~295 in bf16: bytes
// bound the ideal forward below S ~ 740, operations above.  The backward
// recomputes the scores and does four more products of the same size,
// 2.5x the forward's FLOPs.  These kernels, on the CUDA cores without
// tensor cores, are far from either bound.
//
// Design (simple and right first; no tensor cores yet).  Blocks of 256
// threads; every tile is staged in shared memory as f32 with rows padded
// to HD+1 floats so that column walks are free of bank conflicts; each
// thread owns a 4x4 patch of a 64x64 score tile and a 4 x (HD/16) patch of
// an accumulator, so a row's reductions are 16-lane shuffles.  Tiles
// entirely above the diagonal (or entirely behind the window) are never
// visited; probabilities of dead keys are re-masked to 0.  Every kernel
// reads the (B,S,H,hd) layout through strides: no transposes.
//   forward: one block per (64-row q tile, q head, batch row) loops over
//     64-key tiles with m, l and the accumulator in registers;
//   backward (a) one warp per (batch, head, row): D = rowsum(dO * O);
//   backward (b) one block per (64-key tile, kv head, batch row) loops over
//     every q head of the group and every live q tile, accumulating dK and
//     dV in registers, so the group is reduced inside the block;
//   backward (c) one block per (64-row q tile, q head, batch row) loops over
//     the live key tiles, accumulating dQ in registers.
// Every output element is written once by one thread, with no atomics: the
// backward is deterministic, run to run.  Making the products mma/wgmma is
// a later PR's work.
//
// Head dims 32, 64, 128 and 256 (recurrentgemma: 10 q heads over 1 kv
// head).  The forward keeps its 64 x 64 tiles at 256: 213,760 bytes of
// shared memory (of the 232,448 a block may opt into) and a 4 x 16
// accumulator a thread.  The backward's 64-row tiles would need 296,960
// bytes at 256, and the dK/dV kernel 2 x 4 x 16 = 128 f32 accumulators a
// thread, so at 256 the rows that carry accumulators drop to 32
// (bwd_rows): the dK/dV kernel walks 64-query tiles over a 32-key tile
// (214,528 bytes; dK and dV 2 x 16 each a thread, a 2 x 4 score patch),
// the dQ kernel 64-key tiles under a 32-row q tile (205,952 bytes; dQ 2 x
// 16 a thread).  The head dims up to 128 keep the 64 x 64 tiles, and so
// their bits.  The GQA group need not be a power of two: the dK/dV
// kernel loops over the group's q heads (10 at 256) inside the block.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 row groups x 16 lanes

// element strides of one (B, S, heads, hd) tensor; the head dim is unit
struct Strides {
  long long b, s, h;
};

template <int HD>
constexpr size_t fwd_smem_bytes() {
  // Qs [BQ][HD+1], Ks [BK][HD+1], Vs [BK][HD], Ps [BQ][BK+1], all f32
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

// the backward's tile rows where its accumulators live: the dK/dV
// kernel's keys and the dQ kernel's queries.  64 up to head dim 128; 32 at
// 256, where 64-row f32 tiles would need 296,960 bytes of shared memory
// and 2 x 4 x 16 = 128 f32 accumulators a thread in the dK/dV kernel
template <int HD>
constexpr int bwd_rows() {
  return HD > 128 ? 32 : 64;
}

template <int HD, int KR, int QR>
constexpr size_t dkdv_smem_bytes() {
  // K and V [KR][HD+1], Q and dO [QR][HD+1], P and dS [KR][QR+1], lse and
  // D rows
  return sizeof(float) * (2 * KR * (HD + 1) + 2 * QR * (HD + 1) +
                          2 * KR * (QR + 1) + 2 * QR);
}

template <int HD, int QR, int KR>
constexpr size_t dq_smem_bytes() {
  // Q and dO [QR][HD+1], K and V [KR][HD+1], dS [QR][KR+1], lse and D rows
  return sizeof(float) * (2 * QR * (HD + 1) + 2 * KR * (HD + 1) +
                          QR * (KR + 1) + 2 * QR);
}

constexpr size_t MAX_SMEM = 232448;  // a block's opt-in limit on sm_90
static_assert(fwd_smem_bytes<256>() <= MAX_SMEM, "forward tiles at hd 256");
static_assert(dkdv_smem_bytes<256, bwd_rows<256>(), BQ>() <= MAX_SMEM,
              "dK/dV tiles at hd 256");
static_assert(dq_smem_bytes<256, bwd_rows<256>(), BK>() <= MAX_SMEM,
              "dQ tiles at hd 256");

__device__ __forceinline__ bool is_live(int qpos, int kpos, int S,
                                        int causal, int window) {
  return kpos < S && qpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// rows [r0, r0+R) of one head of a (B,S,heads,hd) tensor into an
// [R][HD+1] f32 tile, zero past S and past hd
template <typename T, int HD, int R = 64>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int S,
                                          int hd) {
  for (int i = threadIdx.x; i < R * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = r0 + r;
    dst[r * (HD + 1) + d] =
        (s < S && d < hd) ? to_f32(src[(long long)s * ss + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int hd, int group,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, int causal, int window) {
  constexpr int DPT = HD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (HD + 1);
  float* Vs = Ks + BK * (HD + 1);
  float* Ps = Vs + BK * HD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // lane within the row group

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  load_tile<T, HD>(Qs, qb, sq.s, q0, S, hd);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q0 - window + 1) / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < S && d < hd;
      Ks[r * (HD + 1) + d] = in ? to_f32(kb[(long long)s * sk.s + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[(long long)s * sv.s + d]) : 0.f;
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
      const int qpos = q0 + ty * 4 + i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < S && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
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

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[(long long)s * so.s + d] = from_f32<T>(acc[i][j] * inv);
    }
    // every lane of the row group holds the same m and l
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * S + s] = m[i] + logf(l[i]);
  }
}

// (a) D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in f32; one warp
// per row
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                         float* __restrict__ D, int B, int S, int H, int hd,
                         Strides so, Strides sdo) {
  const long long row = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= (long long)B * H * S) return;
  const int lane = threadIdx.x & 31;
  const int s = (int)(row % S);
  const int h = (int)((row / S) % H);
  const int b = (int)(row / ((long long)S * H));
  const T* ob = o + b * so.b + s * so.s + h * so.h;
  const T* db = dout + b * sdo.b + s * sdo.s + h * sdo.h;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f32(ob[d]), to_f32(db[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

// (b) dK and dV of one KR-key tile of one kv head, summed over the group
template <typename T, int HD, int KR, int QR>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, T* __restrict__ dk,
                          T* __restrict__ dv, int S, int H, int hd,
                          int group, Strides sq, Strides sk, Strides sv,
                          Strides sdo, Strides sdk, Strides sdv, float scale,
                          int causal, int window) {
  constexpr int DPT = HD / 16;
  constexpr int KPT = KR / 16;  // keys per thread
  constexpr int QPT = QR / 16;  // queries per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + KR * (HD + 1);
  float* Qs = Vs + KR * (HD + 1);
  float* dOs = Qs + QR * (HD + 1);
  float* Ps = dOs + QR * (HD + 1);   // [key][query]
  float* dSs = Ps + KR * (QR + 1);   // [key][query]
  float* lse_s = dSs + KR * (QR + 1);
  float* D_s = lse_s + QR;

  const int k0 = blockIdx.x * KR;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // keys ty*KPT .. ty*KPT+KPT-1
  const int tx = tid & 15;  // queries tx + 16*j; dims tx + 16*j

  load_tile<T, HD, KR>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, hd);
  load_tile<T, HD, KR>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, hd);

  float adk[KPT][DPT], adv[KPT][DPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  // live queries of this key tile: qpos >= kpos (causal) and
  // qpos < kpos + window
  const int q_begin = causal ? (k0 / QR) * QR : 0;
  const int q_end = window > 0 ? min(S, k0 + KR - 1 + window) : S;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* db = dout + b * sdo.b + h * sdo.h;
    const float* lse_b = lse + ((long long)b * H + h) * S;
    const float* D_b = D + ((long long)b * H + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += QR) {
      __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs are not read
      load_tile<T, HD, QR>(Qs, qb, sq.s, q0, S, hd);
      load_tile<T, HD, QR>(dOs, db, sdo.s, q0, S, hd);
      if (tid < QR) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse_b[s] : 0.f;
        D_s[tid] = s < S ? D_b[s] : 0.f;
      }
      __syncthreads();

      float sc[KPT][QPT], dp[KPT][QPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[KPT], vv[KPT], qv[QPT], gv[QPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          kv[i] = Ks[(ty * KPT + i) * (HD + 1) + d];
          vv[i] = Vs[(ty * KPT + i) * (HD + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          qv[j] = Qs[(tx + 16 * j) * (HD + 1) + d];
          gv[j] = dOs[(tx + 16 * j) * (HD + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i)
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int kpos = k0 + ty * KPT + i;
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const int c = tx + 16 * j;
          const float p = is_live(q0 + c, kpos, S, causal, window)
                              ? expf(sc[i][j] * scale - lse_s[c])
                              : 0.f;
          Ps[(ty * KPT + i) * (QR + 1) + c] = p;
          dSs[(ty * KPT + i) * (QR + 1) + c] = p * (dp[i][j] - D_s[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < QR; ++c) {
        float pv[KPT], sv_[KPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          pv[i] = Ps[(ty * KPT + i) * (QR + 1) + c];
          sv_[i] = dSs[(ty * KPT + i) * (QR + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float g = dOs[c * (HD + 1) + tx + 16 * j];
          const float qq = Qs[c * (HD + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < KPT; ++i) {
            adv[i][j] = fmaf(pv[i], g, adv[i][j]);
            adk[i][j] = fmaf(sv_[i], qq, adk[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * sdk.b + kvh * sdk.h;
  T* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int s = k0 + ty * KPT + i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d >= hd) continue;
      dkb[(long long)s * sdk.s + d] = from_f32<T>(adk[i][j] * scale);
      dvb[(long long)s * sdv.s + d] = from_f32<T>(adv[i][j]);
    }
  }
}

// (c) dQ of one QR-row q tile of one q head
template <typename T, int HD, int QR, int KR>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, T* __restrict__ dq,
                        int S, int H, int hd, int group, Strides sq,
                        Strides sk, Strides sv, Strides sdo, Strides sdq,
                        float scale, int causal, int window) {
  constexpr int DPT = HD / 16;
  constexpr int QPT = QR / 16;  // queries per thread
  constexpr int KPT = KR / 16;  // keys per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + QR * (HD + 1);
  float* Ks = dOs + QR * (HD + 1);
  float* Vs = Ks + KR * (HD + 1);
  float* dSs = Vs + KR * (HD + 1);   // [query][key]
  float* lse_s = dSs + QR * (KR + 1);
  float* D_s = lse_s + QR;

  const int q0 = blockIdx.x * QR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // queries ty*QPT .. ty*QPT+QPT-1
  const int tx = tid & 15;  // keys tx + 16*j; dims tx + 16*j

  load_tile<T, HD, QR>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, hd);
  load_tile<T, HD, QR>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, hd);
  if (tid < QR) {
    const int s = q0 + tid;
    const long long r = ((long long)b * H + h) * S + s;
    lse_s[tid] = s < S ? lse[r] : 0.f;
    D_s[tid] = s < S ? D[r] : 0.f;
  }
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  float acc[QPT][DPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(S, q0 + QR) : S;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q0 - window + 1) / KR) * KR;

  for (int k0 = k_begin; k0 < k_end; k0 += KR) {
    __syncthreads();  // the previous tile's Ks/Vs/dSs are no longer read
    load_tile<T, HD, KR>(Ks, kb, sk.s, k0, S, hd);
    load_tile<T, HD, KR>(Vs, vb, sv.s, k0, S, hd);
    __syncthreads();

    float sc[QPT][KPT], dp[QPT][KPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[QPT], gv[QPT], kv[KPT], vv[KPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        qv[i] = Qs[(ty * QPT + i) * (HD + 1) + d];
        gv[i] = dOs[(ty * QPT + i) * (HD + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (HD + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int r = ty * QPT + i;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int c = tx + 16 * j;
        const float p = is_live(q0 + r, k0 + c, S, causal, window)
                            ? expf(sc[i][j] * scale - lse_s[r])
                            : 0.f;
        dSs[r * (KR + 1) + c] = p * (dp[i][j] - D_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < KR; ++c) {
      float sv_[QPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
        sv_[i] = dSs[(ty * QPT + i) * (KR + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kk = Ks[c * (HD + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < QPT; ++i) acc[i][j] = fmaf(sv_[i], kk, acc[i][j]);
      }
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int s = q0 + ty * QPT + i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dqb[(long long)s * sdq.s + d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: dispatch on element type and padded head dim
// ---------------------------------------------------------------------------

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
  if (hd <= 256) return f(std::integral_constant<int, 256>{});
  return (int)cudaErrorInvalidValue;
}

template <typename K>
int allow_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

// strides: 12 values, (b, s, h) in elements for q, k, v, o in that order;
// the head dim is contiguous in all four.  lse: (B, H, S) f32 or null.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int B, int S, int H, int KV,
                                   int hd, const long long* st, float scale,
                                   int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_elem(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      auto kern = flash_fwd_kernel<T, HD>;
      const size_t smem = fwd_smem_bytes<HD>();
      int err = allow_smem(kern, smem);
      if (err) return err;
      const dim3 grid((S + BQ - 1) / BQ, H, B);
      kern<<<grid, NT, smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<float*>(lse), S, hd, H / KV, strides_at(st, 0),
          strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), scale,
          causal, window);
      return (int)cudaGetLastError();
    });
  });
}

// strides: 24 values, (b, s, h) in elements for q, k, v, o, dO, dq, dk, dv
// in that order; the head dim is contiguous in all eight.  lse: (B, H, S)
// f32 from the forward; D: (B, H, S) f32 scratch.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* D, void* dq, void* dk, void* dv,
                                   int dtype, int B, int S, int H, int KV,
                                   int hd, const long long* st, float scale,
                                   int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_elem(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                  sv = strides_at(st, 2), so = strides_at(st, 3),
                  sdo = strides_at(st, 4), sdq = strides_at(st, 5),
                  sdk = strides_at(st, 6), sdv = strides_at(st, 7);
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    const float* tlse = static_cast<const float*>(lse);
    float* tD = static_cast<float*>(D);

    const long long rows = (long long)B * H * S;
    flash_bwd_dot_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)),
                              NT, 0, s>>>(static_cast<const T*>(o), tdo, tD,
                                          B, S, H, hd, so, sdo);
    int err = (int)cudaGetLastError();
    if (err) return err;

    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      constexpr int R = bwd_rows<HD>();
      size_t smem = dkdv_smem_bytes<HD, R, BQ>();
      auto kv_kern = flash_bwd_dkdv_kernel<T, HD, R, BQ>;
      int e = allow_smem(kv_kern, smem);
      if (e) return e;
      kv_kern<<<dim3((S + R - 1) / R, KV, B), NT, smem, s>>>(
          tq, tk, tv, tdo, tlse, tD, static_cast<T*>(dk),
          static_cast<T*>(dv), S, H, hd, H / KV, sq, sk, sv, sdo, sdk, sdv,
          scale, causal, window);
      e = (int)cudaGetLastError();
      if (e) return e;
      smem = dq_smem_bytes<HD, R, BK>();
      auto q_kern = flash_bwd_dq_kernel<T, HD, R, BK>;
      e = allow_smem(q_kern, smem);
      if (e) return e;
      q_kern<<<dim3((S + R - 1) / R, H, B), NT, smem, s>>>(
          tq, tk, tv, tdo, tlse, tD, static_cast<T*>(dq), S, H, hd, H / KV,
          sq, sk, sv, sdo, sdq, scale, causal, window);
      return (int)cudaGetLastError();
    });
  });
}
