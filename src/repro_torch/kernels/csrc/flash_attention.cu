// Causal / sliding-window GQA flash attention: forward for prefill and
// training, and its backward for training; both also take the vision
// model's non-causal cross-attention (Sq != Sk), which it serves and trains
// through.
//
// Forward: replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :114).  Same function: q (B,Sq,H,hd),
// k/v (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype; scale hd^-0.5; kv head =
// h / (H/KV); online softmax in f32; keys masked by kpos < Sk, causal
// kpos <= qpos and window kpos > qpos - window (the wrapper takes Sq != Sk
// only non-causal and unwindowed: the vision model's xattn, a prompt or
// one decode row against 1600 media tokens; the Pallas kernel masks keys
// by the query length there, which is wrong).  On request it also writes
// the rows' log-sum-exp lse (B,H,Sq) in f32 (the scaled scores' domain),
// which the backward needs; serving passes no lse buffer and pays nothing
// for it.
//
// Backward: the TPU package has none (it trains through autodiff of its
// plain attention); this is the gradient of the forward above, given dO,
// at Sq == Sk and, non-causal and unwindowed, at Sq != Sk (the xattn
// layers' q rows of text against Sk media keys):
//   P  = exp(scale * q.k - lse)        (recomputed, never stored)
//   D  = rowsum(dO * O)
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = scale dS^T Q,  dQ = scale dS K
// with the GQA group's q heads summed into their kv head's dK and dV.  D,
// lse and the dQ grid run over Sq rows, the dK/dV grid and its scratch
// over Sk keys.  A zero-filled q row past Sq (or key past Sk) is not dead
// by itself: it scores 0, and exp(0 - lse) is not 0; every tail tile
// takes the per-element mask of both lengths, and lse and D past Sq are
// never read.  At Sq != Sk (non-causal) no tile is skipped.
//
// Bound on the H100: a causal prefill does 4 * hd * H * B * S(S+1)/2 FLOPs
// on B*S*(2H+2KV)*hd*elem bytes (q, k, v read, o written), about 0.4*S
// FLOP/byte for llama3.2-1b's heads against the card's ~295 in bf16: bytes
// bound the ideal forward below S ~ 740, operations above.  The backward
// recomputes the scores and does four more products of the same size,
// 2.5x the forward's FLOPs.
//
// Two element types, two designs; neither falls back to the other.
//
// f32: the CUDA cores (tensor cores take f32 only as TF32, which would
// move the f32 results the tests hold to 2e-5 and 1e-4).  Blocks of 256
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
// Head dims 64, 128 and 256 (smaller ones zero-padded to 64: the same
// bits as a 32-wide tile, see with_hd).  The forward keeps 64 x 64 tiles
// at 256 (213,760 bytes of shared memory); the backward's accumulating
// rows drop to 32 at 256 (bwd_rows): 214,528 bytes for dK/dV, 205,952 for
// dQ.
//
// bf16: the tensor cores, f32 accumulators (hopper_mma.cuh).  Tiles stay
// bf16 in shared memory, 64-column blocks of 128-byte rows under the
// 128-byte swizzle, filled by 16-byte cp.async (zero past S and past hd;
// the wrapper demands 16-byte aligned pointers and strides).  The streamed
// tiles go through a two-stage ring: tile t+1's copies are issued before
// tile t's products.  Head dims 64, 128, 256 (smaller ones zero-padded to
// 64).  The masks, skipped tiles and re-masking are the f32 kernels'; a
// tile with no dead (query, key) pair skips the per-element mask.
//   forward: one warpgroup (128 threads) per (64-row q tile, q head, batch
//     row), the q tiles with the most live keys launched first.  S = Q K^T
//     is wgmma m64nBKk16 with Q and K K-major in shared memory (BK = 64
//     keys, 32 at hd 256 so that two blocks fit an SM); the online softmax
//     runs on S's registers (exp2 with the scale folded into log2 e); P is
//     split in registers into two bf16 A operands, P_hi = bf16(P) and P_lo
//     = bf16(P - P_hi), of O += P V: two wgmma m64nHDk16 with V MN-major
//     (transposed) in shared memory.  The split adds half the tensor work
//     again and keeps P to ~16 bits: with P rounded once to bf16,
//     llama3.2-1b's first-token logits from the whole prompt moved to a
//     normalized 0.0225 from the chunked path's (whose attention keeps P
//     in f32), past serving's 2e-2 gate.  Q is re-read from shared memory
//     for every key tile, never held in registers: at hd 256 the O
//     accumulator alone is 128 registers a thread.
//   backward: the products run on mma.sync m16n8k16 with ldmatrix, not
//     wgmma.  Of the five, only S^T = K Q^T and dP^T = V dO^T have the
//     operand layout wgmma takes from shared memory as it is staged; dV +=
//     P^T dO and dK += dS^T Q need P^T and dS^T as A operands, which leave
//     a wgmma accumulator in the wrong layout for its register A and would
//     go through shared memory anyway, and dQ += dS K needs K transposed.
//     A warpgroup's 64 x hd dK and dV accumulators are 2 x 128 registers a
//     thread at hd 256, over the 255 limit; eight mma.sync warps split a
//     64 x hd tile into (16 rows) x (hd/2 columns) each, so dK and dV take
//     2 x 64 at hd 256, and ldmatrix.trans reads dO, Q and K transposed
//     straight from the swizzled tiles.  P and dS are rounded to bf16 in
//     shared memory between the two halves of each step.
//   backward (a) as f32: D = rowsum(dO * O), one warp per row;
//   backward (b) one block per (64-key tile, chunk of hpb q heads of a kv
//     head's group, batch row), streaming the chunk's live (q head, q
//     tile) pairs: f32 partial dK, dV into (B, Sk, KV * group/hpb, hd)
//     scratch.  Blocks per batch row: ceil(Sk/64) * H/hpb; the wrapper
//     picks hpb from (Sk, H, KV) alone, never from B (132+ blocks at the
//     training shapes: 320 at recurrentgemma's B4 S512, 1024 at llama's);
//   backward (b') sums each kv head's partials in a fixed order into dK
//     (times the scale) and dV in bf16;
//   backward (c) one block per (64-row q tile, q head, batch row)
//     streaming the live 64-key tiles: dQ (the longest q tiles first).
// The backward's rounded P and dS are held to autograd at a normalized 2e-2
// with margin (tests/test_torch_flash_plan.py emulates both roundings).
// No output is written by two threads and no atomics are used: the
// backward is deterministic, run to run, and a row's result does not
// depend on B or on the other rows of the launch.
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper_mma.cuh"

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

__device__ __forceinline__ bool is_live(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  return kpos < Sk && qpos < Sq && (!causal || kpos <= qpos) &&
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
                     float* __restrict__ lse, int Sq, int Sk, int hd,
                     int group, Strides sq, Strides sk, Strides sv,
                     Strides so, float scale, int causal, int window) {
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

  load_tile<T, HD>(Qs, qb, sq.s, q0, Sq, hd);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // non-causal (Sq != Sk included): every key tile, none skipped
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q0 - window + 1) / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < Sk && d < hd;
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
        live[j] = kpos < Sk && (!causal || kpos <= qpos) &&
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
    if (s >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[(long long)s * so.s + d] = from_f32<T>(acc[i][j] * inv);
    }
    // every lane of the row group holds the same m and l
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * Sq + s] = m[i] + logf(l[i]);
  }
}

// (a) D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in f32 over the
// B*H*Sq query rows; one warp per row
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                         float* __restrict__ D, int B, int Sq, int H, int hd,
                         Strides so, Strides sdo) {
  const long long row = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= (long long)B * H * Sq) return;
  const int lane = threadIdx.x & 31;
  const int s = (int)(row % Sq);
  const int h = (int)((row / Sq) % H);
  const int b = (int)(row / ((long long)Sq * H));
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

// (b) dK and dV of one KR-key tile of one kv head, summed over the group:
// the q tiles walk Sq, the key tiles Sk
template <typename T, int HD, int KR, int QR>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, T* __restrict__ dk,
                          T* __restrict__ dv, int Sq, int Sk, int H, int hd,
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

  load_tile<T, HD, KR>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, Sk, hd);
  load_tile<T, HD, KR>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, Sk, hd);

  float adk[KPT][DPT], adv[KPT][DPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  // live queries of this key tile: qpos >= kpos (causal) and
  // qpos < kpos + window (Sq == Sk there); non-causal, every q tile
  const int q_begin = causal ? (k0 / QR) * QR : 0;
  const int q_end = window > 0 ? min(Sq, k0 + KR - 1 + window) : Sq;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* db = dout + b * sdo.b + h * sdo.h;
    const float* lse_b = lse + ((long long)b * H + h) * Sq;
    const float* D_b = D + ((long long)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += QR) {
      __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs are not read
      load_tile<T, HD, QR>(Qs, qb, sq.s, q0, Sq, hd);
      load_tile<T, HD, QR>(dOs, db, sdo.s, q0, Sq, hd);
      if (tid < QR) {
        const int s = q0 + tid;
        lse_s[tid] = s < Sq ? lse_b[s] : 0.f;
        D_s[tid] = s < Sq ? D_b[s] : 0.f;
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
          // a zero-filled row past Sq would score 0, not -inf: masked
          const float p = is_live(q0 + c, kpos, Sq, Sk, causal, window)
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
    if (s >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d >= hd) continue;
      dkb[(long long)s * sdk.s + d] = from_f32<T>(adk[i][j] * scale);
      dvb[(long long)s * sdv.s + d] = from_f32<T>(adv[i][j]);
    }
  }
}

// (c) dQ of one QR-row q tile of one q head: the q tiles walk Sq, the key
// tiles Sk
template <typename T, int HD, int QR, int KR>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, T* __restrict__ dq,
                        int Sq, int Sk, int H, int hd, int group, Strides sq,
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

  load_tile<T, HD, QR>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq, hd);
  load_tile<T, HD, QR>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, hd);
  if (tid < QR) {
    const int s = q0 + tid;
    const long long r = ((long long)b * H + h) * Sq + s;
    lse_s[tid] = s < Sq ? lse[r] : 0.f;
    D_s[tid] = s < Sq ? D[r] : 0.f;
  }
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  float acc[QPT][DPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // non-causal (Sq != Sk included): every key tile, none skipped
  const int k_end = causal ? min(Sk, q0 + QR) : Sk;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q0 - window + 1) / KR) * KR;

  for (int k0 = k_begin; k0 < k_end; k0 += KR) {
    __syncthreads();  // the previous tile's Ks/Vs/dSs are no longer read
    load_tile<T, HD, KR>(Ks, kb, sk.s, k0, Sk, hd);
    load_tile<T, HD, KR>(Vs, vb, sv.s, k0, Sk, hd);
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
        // a zero-filled key past Sk would score 0, not -inf: masked
        const float p = is_live(q0 + r, k0 + c, Sq, Sk, causal, window)
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
    if (s >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dqb[(long long)s * sdq.s + d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores (design note at the top)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int TC_ROWS = 64;     // a forward block's q rows; backward tiles
constexpr int FWD_TC_NT = 128;  // the forward: one warpgroup
constexpr int BWD_TC_NT = 256;  // the backward: eight warps

// the forward's keys a tile: 32 at head dim 256 keeps two blocks an SM
template <int HD>
__host__ __device__ constexpr int fwd_tc_keys() {
  return HD > 128 ? 32 : 64;
}

// a swizzled bf16 tile of 64 rows by HD: HD * 128 bytes.  The +1024 of
// each kernel's bytes aligns the first tile to 1024 bytes (the swizzle's
// period), which dynamic shared memory does not promise.
template <int HD>
constexpr size_t fwd_tc_smem() {
  // Q, then two stages of (K, V)
  return 1024 + HD * 128 + 2 * 2 * fwd_tc_keys<HD>() * HD * 2;
}
template <int HD>
constexpr size_t dkdv_tc_smem() {
  // K, V; two stages of (Q, dO, lse, D); P^T and dS^T
  return 1024 + 2 * HD * 128 + 2 * (2 * HD * 128 + 2 * TC_ROWS * 4) +
         2 * TC_ROWS * TC_ROWS * 2;
}
template <int HD>
constexpr size_t dq_tc_smem() {
  // Q, dO; two stages of (K, V); dS
  return 1024 + 2 * HD * 128 + 2 * 2 * HD * 128 + TC_ROWS * TC_ROWS * 2;
}
static_assert(fwd_tc_smem<256>() <= MAX_SMEM, "bf16 forward at hd 256");
static_assert(dkdv_tc_smem<256>() <= MAX_SMEM, "bf16 dK/dV at hd 256");
static_assert(dq_tc_smem<256>() <= MAX_SMEM, "bf16 dQ at hd 256");

// whether a q tile [q0, q0+rows) by key tile [k0, k0+cols) holds a dead
// (query, key) pair: else its elements skip the per-element mask
__device__ __forceinline__ bool tile_has_dead(int q0, int rows, int k0,
                                              int cols, int Sq, int Sk,
                                              int causal, int window) {
  return q0 + rows > Sq || k0 + cols > Sk ||
         (causal && k0 + cols > q0 + 1) ||
         (window > 0 && k0 <= q0 + rows - 1 - window);
}

__device__ __forceinline__ uint32_t align1024(void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

template <int BK>
__device__ __forceinline__ void wgmma_scores(float* s, uint64_t da,
                                             uint64_t db, int accum) {
  if constexpr (BK == 32) wgmma_ss_n32(s, da, db, accum);
  else wgmma_ss_n64(s, da, db, accum);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// forward: one warpgroup per (64-row q tile, q head, batch row).  S = Q K^T
// by wgmma from shared memory, the online softmax on S's registers, P as
// two bf16 register A operands of O += P V (V MN-major); K/V tiles through
// a two-stage cp.async ring
template <int HD>
__global__ void __launch_bounds__(FWD_TC_NT)
    flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int hd,
                        int group, Strides sq, Strides sk, Strides sv,
                        Strides so, float scale_log2, int causal,
                        int window) {
  constexpr int BK = fwd_tc_keys<HD>();
  constexpr int NS = BK / 2;  // score registers a thread
  constexpr int NO = HD / 2;  // output registers a thread
  constexpr uint32_t TILE = BK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = align1024(smem_raw);
  const uint32_t KVs = Qs + HD * 128;  // stage st: K at +2*st*TILE, V after

  // the last q tiles, the ones with the most live keys, start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  // non-causal (Sq != Sk included): every key tile, none skipped
  const int k_end = causal ? min(Sk, q0 + TC_ROWS) : Sk;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // rows past Sq and keys past Sk are zero-filled, never read
  load_tile_async<TC_ROWS, HD, FWD_TC_NT>(Qs, qb, sq.s, q0, Sq, hd);
  load_tile_async<BK, HD, FWD_TC_NT>(KVs, kb, sk.s, k_begin, Sk, hd);
  load_tile_async<BK, HD, FWD_TC_NT>(KVs + TILE, vb, sv.s, k_begin, Sk, hd);
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile t is in; every warp is done with tile t-1
    if (t + 1 < n_tiles) {
      const uint32_t nxt = KVs + ((t + 1) & 1) * 2 * TILE;
      load_tile_async<BK, HD, FWD_TC_NT>(nxt, kb, sk.s, k0 + BK, Sk, hd);
      load_tile_async<BK, HD, FWD_TC_NT>(nxt + TILE, vb, sv.s, k0 + BK, Sk,
                                         hd);
      cp_async_commit();
    }
    const uint32_t Ks = KVs + (t & 1) * 2 * TILE, Vs = Ks + TILE;

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_scores<BK>(
          s, wgmma_desc(Qs + (kk >> 2) * (TC_ROWS * 128) + (kk & 3) * 32, 0),
          wgmma_desc(Ks + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 0), kk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<NS>(s);

    float mx[2] = {NEG_INF, NEG_INF};
    if (tile_has_dead(q0, TC_ROWS, k0, BK, Sq, Sk, causal, window)) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int qpos = row0 + 8 * ((j >> 1) & 1);
        const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        s[j] = is_live(qpos, kpos, Sq, Sk, causal, window)
                   ? s[j] * scale_log2
                   : NEG_INF;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] *= scale_log2;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P = P_hi + P_lo, two bf16 A operands: P_hi = bf16(P), P_lo =
    // bf16(P - P_hi), so P V is summed from P to ~16 bits, not 8
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      const int i = (j >> 1) & 1;
      // dead keys are re-masked: a row with no live key yet has m = NEG_INF
      const float p0 = s[j] > 0.5f * NEG_INF ? exp2f(s[j] - m[i]) : 0.f;
      const float p1 = s[j + 1] > 0.5f * NEG_INF ? exp2f(s[j + 1] - m[i]) : 0.f;
      l[i] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      p_hi[j >> 3][(j >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[j >> 3][(j >> 1) & 3] =
          pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] *= alpha[(j >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = wgmma_desc(Vs + kk * 16 * 128, BK * 128);
      wgmma_pv<HD>(acc, p_hi[kk], dv);
      wgmma_pv<HD>(acc, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<NO>(acc);
  }

  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int j = 0; j < NO; j += 2) {
    const int i = (j >> 1) & 1;
    const int s_ = row0 + 8 * i;
    const int d = 8 * (j >> 2) + 2 * (lane & 3);
    if (s_ < Sq && d < hd) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)s_ * so.s + d) =
          __floats2bfloat162_rn(acc[j] * inv, acc[j + 1] * inv);
    }
  }
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s_ = row0 + 8 * i;
      if (s_ < Sq)
        lse[((long long)b * gridDim.y + h) * Sq + s_] =
            (m[i] + log2f(l[i])) * LN2;
    }
  }
}

// backward (b), bf16: f32 partial dK and dV of one 64-key tile (of Sk)
// over hpb q heads of one kv head's group (a chunk), walking their q tiles
// (of Sq); partial index blockIdx.y = kvh * split + chunk of the (B, Sk,
// KV * split, hd) f32 scratch.  Eight warps:
// for the products over the head dim (S^T = K Q^T, dP^T = V dO^T) warp w
// takes keys 16 (w % 4) and queries 32 (w / 4); P^T and dS^T go to shared
// memory in bf16; for the products over the queries (dV += P^T dO, dK +=
// dS^T Q) warp w takes keys 16 (w % 4) and head dims HD/2 (w / 4).
template <int HD>
__global__ void __launch_bounds__(BWD_TC_NT)
    flash_bwd_dkdv_kernel_tc(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ D,
                             float* __restrict__ dkp, float* __restrict__ dvp,
                             int Sq, int Sk, int H, int hd, int group, int hpb,
                             Strides sq, Strides sk, Strides sv, Strides sdo,
                             float scale_log2, int causal, int window) {
  constexpr int R = TC_ROWS;
  constexpr uint32_t TILE = HD * 128;
  constexpr uint32_t STAGE = 2 * TILE + 2 * R * 4;
  constexpr int NB = HD / 16;  // n8 blocks of a warp's HD/2 columns
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Ks = align1024(smem_raw), Vs = Ks + TILE;
  const uint32_t St = Vs + TILE;  // stage st: Q, dO, lse, D at St+st*STAGE
  const uint32_t Ps = St + 2 * STAGE, dSs = Ps + R * R * 2;
  const float* stage_f = reinterpret_cast<const float*>(
      smem_raw + (St - smem_u32(smem_raw)));

  const int k0 = blockIdx.x * R;
  const int split = group / hpb;
  const int kvh = blockIdx.y / split;
  const int h_first = kvh * group + (blockIdx.y % split) * hpb;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp & 3) * 16;  // this warp's keys
  const int wc = warp >> 2;        // its half of the queries / head dims

  // causal and windowed only at Sq == Sk; non-causal, every q tile
  const int q_begin = causal ? (k0 / R) * R : 0;
  const int q_end = window > 0 ? min(Sq, k0 + R - 1 + window) : Sq;
  const int nq = (q_end - q_begin + R - 1) / R;
  const int n_tiles = hpb * nq;

  // tile t: q head h_first + t / nq, queries q_begin + (t % nq) * R
  auto load_q_tile = [&](int t, uint32_t st) {
    const int h = h_first + t / nq, q0 = q_begin + (t % nq) * R;
    load_tile_async<R, HD, BWD_TC_NT>(st, q + b * sq.b + h * sq.h, sq.s, q0,
                                      Sq, hd);
    load_tile_async<R, HD, BWD_TC_NT>(st + TILE, dout + b * sdo.b + h * sdo.h,
                                      sdo.s, q0, Sq, hd);
    const int i = threadIdx.x;
    if (i < 2 * R) {
      // lse and D past Sq are never read from memory: zero-filled
      const int s_ = q0 + (i % R);
      const float* src = (i < R ? lse : D) + ((long long)b * H + h) * Sq;
      cp_async4(st + 2 * TILE + i * 4, s_ < Sq ? src + s_ : src, s_ < Sq);
    }
  };

  load_tile_async<R, HD, BWD_TC_NT>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0,
                                    Sk, hd);
  load_tile_async<R, HD, BWD_TC_NT>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0,
                                    Sk, hd);
  load_q_tile(0, St);
  cp_async_commit();

  float adk[NB][4], adv[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) adk[n][j] = adv[n][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + (t % nq) * R;
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t-1
    if (t + 1 < n_tiles) {
      load_q_tile(t + 1, St + ((t + 1) & 1) * STAGE);
      cp_async_commit();
    }
    const uint32_t Qs = St + (t & 1) * STAGE, dOs = Qs + TILE;
    const float* lse_s = stage_f + (t & 1) * (STAGE / 4) + 2 * TILE / 4;
    const float* D_s = lse_s + R;

    // S^T and dP^T: keys wr..wr+15 by queries 32 wc..32 wc+31
    float st_[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) st_[n][j] = dpt[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<R>(ak, Ks, wr, 16 * kk, lane);
      frag_a<R>(av, Vs, wr, 16 * kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t bq[4], bo[4];
        frag_b_nk<R>(bq, Qs, 32 * wc + 16 * n2, 16 * kk, lane);
        frag_b_nk<R>(bo, dOs, 32 * wc + 16 * n2, 16 * kk, lane);
        mma_bf16(st_[2 * n2], ak, bq);
        mma_bf16(st_[2 * n2 + 1], ak, bq + 2);
        mma_bf16(dpt[2 * n2], av, bo);
        mma_bf16(dpt[2 * n2 + 1], av, bo + 2);
      }
    }
    // a q row past Sq scores 0 against every key (zero-filled), and
    // exp(0 - 0) is not 0: the tail tiles take the per-element mask
    const bool edge = tile_has_dead(q0, R, k0, R, Sq, Sk, causal, window);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int r = wr + (lane >> 2) + 8 * (j >> 1);
        const int c = 32 * wc + 8 * n + 2 * (lane & 3);
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live =
              !edge || is_live(q0 + c + e, k0 + r, Sq, Sk, causal, window);
          p[e] = live ? exp2f(st_[n][j + e] * scale_log2 -
                              lse_s[c + e] * LOG2E)
                      : 0.f;
          ds[e] = p[e] * (dpt[n][j + e] - D_s[c + e]);
        }
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(Ps + swz<R>(r, c)),
                     "r"(pack_bf16(p[0], p[1])));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dSs + swz<R>(r, c)),
                     "r"(pack_bf16(ds[0], ds[1])));
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: keys wr..wr+15 by head dims wc * HD/2..
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t ap[4], as[4];
      frag_a<R>(ap, Ps, wr, 16 * kk, lane);
      frag_a<R>(as, dSs, wr, 16 * kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t bo[4], bq[4];
        const int n0 = wc * (HD / 2) + 16 * n2;
        frag_b_kn<R>(bo, dOs, n0, 16 * kk, lane);
        frag_b_kn<R>(bq, Qs, n0, 16 * kk, lane);
        mma_bf16(adv[2 * n2], ap, bo);
        mma_bf16(adv[2 * n2 + 1], ap, bo + 2);
        mma_bf16(adk[2 * n2], as, bq);
        mma_bf16(adk[2 * n2 + 1], as, bq + 2);
      }
    }
  }

  const long long P = (long long)gridDim.y;  // partials a (b, s)
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int s_ = k0 + wr + (lane >> 2) + 8 * (j >> 1);
      const int d = wc * (HD / 2) + 8 * n + 2 * (lane & 3);
      if (s_ >= Sk || d >= hd) continue;
      const long long off =
          (((long long)b * Sk + s_) * P + blockIdx.y) * hd + d;
      *reinterpret_cast<float2*>(dkp + off) = make_float2(adk[n][j],
                                                          adk[n][j + 1]);
      *reinterpret_cast<float2*>(dvp + off) = make_float2(adv[n][j],
                                                          adv[n][j + 1]);
    }
}

// backward (b'), bf16: dK = scale * sum and dV = sum of a kv head's split
// partials, in a fixed order, over the B*Sk*KV key rows; one thread per two
// head dims
__global__ void __launch_bounds__(NT)
    flash_bwd_reduce_kernel(const float* __restrict__ dkp,
                            const float* __restrict__ dvp,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int B, int Sk, int KV, int hd, int split,
                            Strides sdk, Strides sdv, float scale) {
  const int hp = hd / 2;
  const long long n = (long long)B * Sk * KV * hp;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    const int d = 2 * (int)(i % hp);
    const int kvh = (int)((i / hp) % KV);
    const long long bs = i / ((long long)hp * KV);  // b * Sk + s
    const int s_ = (int)(bs % Sk), b = (int)(bs / Sk);
    const float* pk = dkp + ((bs * KV + kvh) * split) * hd + d;
    const float* pv = dvp + ((bs * KV + kvh) * split) * hd + d;
    float2 sk_ = make_float2(0.f, 0.f), sv_ = make_float2(0.f, 0.f);
    for (int c = 0; c < split; ++c) {
      const float2 a = *reinterpret_cast<const float2*>(pk + c * hd);
      const float2 w = *reinterpret_cast<const float2*>(pv + c * hd);
      sk_.x += a.x;
      sk_.y += a.y;
      sv_.x += w.x;
      sv_.y += w.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(dk + b * sdk.b + s_ * sdk.s +
                                       kvh * sdk.h + d) =
        __floats2bfloat162_rn(sk_.x * scale, sk_.y * scale);
    *reinterpret_cast<__nv_bfloat162*>(dv + b * sdv.b + s_ * sdv.s +
                                       kvh * sdv.h + d) =
        __floats2bfloat162_rn(sv_.x, sv_.y);
  }
}

// backward (c), bf16: dQ of one 64-row q tile (of Sq) of one q head,
// walking the 64-key tiles (of Sk).  Eight warps:
// for S = Q K^T and dP = dO V^T warp w takes rows 16 (w % 4) and keys
// 32 (w / 4); dS goes to shared memory in bf16; for dQ += dS K warp w
// takes rows 16 (w % 4) and head dims HD/2 (w / 4).  K/V tiles through a
// two-stage cp.async ring.
template <int HD>
__global__ void __launch_bounds__(BWD_TC_NT)
    flash_bwd_dq_kernel_tc(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ D, bf16* __restrict__ dq,
                           int Sq, int Sk, int H, int hd, int group, Strides sq,
                           Strides sk, Strides sv, Strides sdo, Strides sdq,
                           float scale, float scale_log2, int causal,
                           int window) {
  constexpr int R = TC_ROWS;
  constexpr uint32_t TILE = HD * 128;
  constexpr int NB = HD / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = align1024(smem_raw), dOs = Qs + TILE;
  const uint32_t St = dOs + TILE;  // stage st: K, V at St + 2 * st * TILE
  const uint32_t dSs = St + 4 * TILE;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp & 3) * 16;  // this warp's rows
  const int wc = warp >> 2;        // its half of the keys / head dims
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  // non-causal (Sq != Sk included): every key tile, none skipped
  const int k_end = causal ? min(Sk, q0 + R) : Sk;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / R) * R : 0;
  const int n_tiles = (k_end - k_begin + R - 1) / R;

  load_tile_async<R, HD, BWD_TC_NT>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq,
                                    hd);
  load_tile_async<R, HD, BWD_TC_NT>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s,
                                    q0, Sq, hd);
  load_tile_async<R, HD, BWD_TC_NT>(St, kb, sk.s, k_begin, Sk, hd);
  load_tile_async<R, HD, BWD_TC_NT>(St + TILE, vb, sv.s, k_begin, Sk, hd);
  cp_async_commit();

  float lse_r[2], D_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s_ = q0 + wr + (lane >> 2) + 8 * i;
    const long long r = ((long long)b * H + h) * Sq + s_;
    lse_r[i] = s_ < Sq ? lse[r] * LOG2E : 0.f;
    D_r[i] = s_ < Sq ? D[r] : 0.f;
  }
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * R;
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t-1
    if (t + 1 < n_tiles) {
      const uint32_t nxt = St + ((t + 1) & 1) * 2 * TILE;
      load_tile_async<R, HD, BWD_TC_NT>(nxt, kb, sk.s, k0 + R, Sk, hd);
      load_tile_async<R, HD, BWD_TC_NT>(nxt + TILE, vb, sv.s, k0 + R, Sk, hd);
      cp_async_commit();
    }
    const uint32_t Ks = St + (t & 1) * 2 * TILE, Vs = Ks + TILE;

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[n][j] = dp[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a<R>(aq, Qs, wr, 16 * kk, lane);
      frag_a<R>(ao, dOs, wr, 16 * kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t bk[4], bv[4];
        frag_b_nk<R>(bk, Ks, 32 * wc + 16 * n2, 16 * kk, lane);
        frag_b_nk<R>(bv, Vs, 32 * wc + 16 * n2, 16 * kk, lane);
        mma_bf16(sc[2 * n2], aq, bk);
        mma_bf16(sc[2 * n2 + 1], aq, bk + 2);
        mma_bf16(dp[2 * n2], ao, bv);
        mma_bf16(dp[2 * n2 + 1], ao, bv + 2);
      }
    }
    // a key past Sk scores 0 against every row (zero-filled), and exp(0 -
    // lse) is not 0: the tail tiles take the per-element mask
    const bool edge = tile_has_dead(q0, R, k0, R, Sq, Sk, causal, window);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int i = j >> 1;
        const int r = wr + (lane >> 2) + 8 * i;
        const int c = 32 * wc + 8 * n + 2 * (lane & 3);
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live =
              !edge || is_live(q0 + r, k0 + c + e, Sq, Sk, causal, window);
          const float p =
              live ? exp2f(sc[n][j + e] * scale_log2 - lse_r[i]) : 0.f;
          ds[e] = p * (dp[n][j + e] - D_r[i]);
        }
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dSs + swz<R>(r, c)),
                     "r"(pack_bf16(ds[0], ds[1])));
      }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t as[4];
      frag_a<R>(as, dSs, wr, 16 * kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t bk[4];
        frag_b_kn<R>(bk, Ks, wc * (HD / 2) + 16 * n2, 16 * kk, lane);
        mma_bf16(acc[2 * n2], as, bk);
        mma_bf16(acc[2 * n2 + 1], as, bk + 2);
      }
    }
  }

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int s_ = q0 + wr + (lane >> 2) + 8 * (j >> 1);
      const int d = wc * (HD / 2) + 8 * n + 2 * (lane & 3);
      if (s_ < Sq && d < hd)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)s_ * sdq.s + d) =
            __floats2bfloat162_rn(acc[n][j] * scale, acc[n][j + 1] * scale);
    }
}

// ---------------------------------------------------------------------------
// host side: dispatch on element type and padded head dim
// ---------------------------------------------------------------------------

// the padded head dim: 64, 128 or 256.  Both element types pad head dims
// below 64 to 64; for f32 that gives the bits of a 32-wide tile (the
// padded dims add exact zeros after the live ones, and each output
// element is summed in the same order), and the f32 forward's 32-wide
// instantiation spilled 12 bytes.
template <typename F>
int with_hd(int hd, F&& f) {
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

// shared-memory bytes of a kernel: kind 0 the forward, 1 the dK/dV
// kernel, 2 the dQ kernel, for an element type and a head dim (the
// wrapper's plan states the same numbers); 0 for what is not built
extern "C" int flash_attention_smem(int dtype, int hd, int kind) {
  int bytes = 0;
  if (dtype == kF32) {
    with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      constexpr int R = bwd_rows<HD>();
      const size_t b[3] = {fwd_smem_bytes<HD>(), dkdv_smem_bytes<HD, R, BQ>(),
                           dq_smem_bytes<HD, R, BK>()};
      if (kind >= 0 && kind < 3) bytes = (int)b[kind];
      return 0;
    });
  } else if (dtype == kBF16) {
    with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      const size_t b[3] = {fwd_tc_smem<HD>(), dkdv_tc_smem<HD>(),
                           dq_tc_smem<HD>()};
      if (kind >= 0 && kind < 3) bytes = (int)b[kind];
      return 0;
    });
  }
  return bytes;
}

// strides: 12 values, (b, s, h) in elements for q, k, v, o in that order;
// the head dim is contiguous in all four.  q and o hold Sq rows, k and v
// Sk (Sq != Sk non-causal and unwindowed only: the wrapper checks).  lse:
// (B, H, Sq) f32 or null.  bf16 needs 16-byte aligned pointers and strides
// and hd % 8 == 0 (the wrapper checks).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int B, int Sq, int Sk, int H,
                                   int KV, int hd, const long long* st,
                                   float scale, int causal, int window,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), so = strides_at(st, 3);
  if (dtype == kF32) {
    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      auto kern = flash_fwd_kernel<float, HD>;
      const size_t smem = fwd_smem_bytes<HD>();
      int err = allow_smem(kern, smem);
      if (err) return err;
      const dim3 grid((Sq + BQ - 1) / BQ, H, B);
      kern<<<grid, NT, smem, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o),
          static_cast<float*>(lse), Sq, Sk, hd, H / KV, sq, sk, sv, so,
          scale, causal, window);
      return (int)cudaGetLastError();
    });
  }
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  return with_hd(hd, [&](auto hdc) {
    constexpr int HD = decltype(hdc)::value;
    auto kern = flash_fwd_kernel_tc<HD>;
    const size_t smem = fwd_tc_smem<HD>();
    int err = allow_smem(kern, smem);
    if (err) return err;
    const dim3 grid((Sq + TC_ROWS - 1) / TC_ROWS, H, B);
    kern<<<grid, FWD_TC_NT, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), Sq, Sk, hd, H / KV, sq, sk, sv, so,
        scale * LOG2E, causal, window);
    return (int)cudaGetLastError();
  });
}

// strides: 24 values, (b, s, h) in elements for q, k, v, o, dO, dq, dk, dv
// in that order; the head dim is contiguous in all eight.  q, o, dO and dq
// hold Sq rows, k, v, dk and dv Sk (Sq != Sk non-causal and unwindowed
// only: the wrapper checks).  lse: (B, H, Sq) f32 from the forward; D:
// (B, H, Sq) f32 scratch.  bf16 only: dkp and dvp (B, Sk, KV * H/KV/hpb,
// hd) f32 scratch for the partial dK and dV of chunks of hpb q heads (hpb
// divides H/KV); f32 passes null and 0.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* D, void* dq, void* dk, void* dv,
                                   void* dkp, void* dvp, int dtype, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   int hpb, const long long* st, float scale,
                                   int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), so = strides_at(st, 3),
                sdo = strides_at(st, 4), sdq = strides_at(st, 5),
                sdk = strides_at(st, 6), sdv = strides_at(st, 7);
  const int group = H / KV;
  const float* tlse = static_cast<const float*>(lse);
  float* tD = static_cast<float*>(D);
  const long long rows = (long long)B * H * Sq;
  const unsigned dot_blocks = (unsigned)((rows + NT / 32 - 1) / (NT / 32));

  if (dtype == kF32) {
    using T = float;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    flash_bwd_dot_kernel<T><<<dot_blocks, NT, 0, s>>>(
        static_cast<const T*>(o), tdo, tD, B, Sq, H, hd, so, sdo);
    int err = (int)cudaGetLastError();
    if (err) return err;
    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      constexpr int R = bwd_rows<HD>();
      size_t smem = dkdv_smem_bytes<HD, R, BQ>();
      auto kv_kern = flash_bwd_dkdv_kernel<T, HD, R, BQ>;
      int e = allow_smem(kv_kern, smem);
      if (e) return e;
      kv_kern<<<dim3((Sk + R - 1) / R, KV, B), NT, smem, s>>>(
          tq, tk, tv, tdo, tlse, tD, static_cast<T*>(dk),
          static_cast<T*>(dv), Sq, Sk, H, hd, group, sq, sk, sv, sdo, sdk,
          sdv, scale, causal, window);
      e = (int)cudaGetLastError();
      if (e) return e;
      smem = dq_smem_bytes<HD, R, BK>();
      auto q_kern = flash_bwd_dq_kernel<T, HD, R, BK>;
      e = allow_smem(q_kern, smem);
      if (e) return e;
      q_kern<<<dim3((Sq + R - 1) / R, H, B), NT, smem, s>>>(
          tq, tk, tv, tdo, tlse, tD, static_cast<T*>(dq), Sq, Sk, H, hd,
          group, sq, sk, sv, sdo, sdq, scale, causal, window);
      return (int)cudaGetLastError();
    });
  }
  if (dtype != kBF16 || hpb < 1 || group % hpb)
    return (int)cudaErrorInvalidValue;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  float* tdkp = static_cast<float*>(dkp);
  float* tdvp = static_cast<float*>(dvp);
  flash_bwd_dot_kernel<bf16><<<dot_blocks, NT, 0, s>>>(
      static_cast<const bf16*>(o), tdo, tD, B, Sq, H, hd, so, sdo);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return with_hd(hd, [&](auto hdc) {
    constexpr int HD = decltype(hdc)::value;
    const int split = group / hpb;
    const int k_tiles = (Sk + TC_ROWS - 1) / TC_ROWS;
    const int q_tiles = (Sq + TC_ROWS - 1) / TC_ROWS;
    auto kv_kern = flash_bwd_dkdv_kernel_tc<HD>;
    int e = allow_smem(kv_kern, dkdv_tc_smem<HD>());
    if (e) return e;
    kv_kern<<<dim3(k_tiles, KV * split, B), BWD_TC_NT, dkdv_tc_smem<HD>(),
              s>>>(tq, tk, tv, tdo, tlse, tD, tdkp, tdvp, Sq, Sk, H, hd,
                   group, hpb, sq, sk, sv, sdo, scale * LOG2E, causal,
                   window);
    e = (int)cudaGetLastError();
    if (e) return e;
    const long long pairs = (long long)B * Sk * KV * (hd / 2);
    const unsigned red_blocks =
        (unsigned)std::min<long long>((pairs + NT - 1) / NT, 132 * 16);
    flash_bwd_reduce_kernel<<<red_blocks, NT, 0, s>>>(
        tdkp, tdvp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sk,
        KV, hd, split, sdk, sdv, scale);
    e = (int)cudaGetLastError();
    if (e) return e;
    auto q_kern = flash_bwd_dq_kernel_tc<HD>;
    e = allow_smem(q_kern, dq_tc_smem<HD>());
    if (e) return e;
    q_kern<<<dim3(q_tiles, H, B), BWD_TC_NT, dq_tc_smem<HD>(), s>>>(
        tq, tk, tv, tdo, tlse, tD, static_cast<bf16*>(dq), Sq, Sk, H, hd,
        group, sq, sk, sv, sdo, sdq, scale, scale * LOG2E, causal, window);
    return (int)cudaGetLastError();
  });
}
