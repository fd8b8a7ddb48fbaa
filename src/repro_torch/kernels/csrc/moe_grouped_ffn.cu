// Grouped mixture-of-experts SwiGLU FFN over one-hot dispatched token groups.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_matmul.py
// (moe_grouped_ffn, :64, pallas_call at :77, body _moe_kernel :33).  Same
// function for any bool dispatch (G, g, E, C) and f32 combine (G, g, E, C):
//   xin_e = dispatch_e^T x,  y_e = (silu(xin_e wg_e) * (xin_e wu_e)) wd_e,
//   out   = sum_e combine_e y_e,
// with x (G, g, d), wg/wu (E, d, f), wd (E, f, d) and out (G, g, d) in x's
// dtype.  Every product accumulates in f32, the combine weights stay f32,
// and the output is rounded once.  Its gradient, moe_grouped_ffn_bwd, is
// the last part of this file (the TPU package has none: JAX trains
// through autodiff of its plain version).
//
// Bound on the H100: bytes at the serving shapes.  Each expert with a token
// costs 3 * d * f weight elements (mixtral: 352 MB of bf16), read once; its
// C slots cost 6 * d * f FLOPs each.  A decode batch (C = 3) and a 128-token
// chunk (C = 40) sit far below the ~295 FLOP/byte ridge, and even a
// 512-token prompt (C = 160, ~128 live slots per expert: 361 GFLOP against
// 2.8 GB of weights, ~128 FLOP/byte) stays bytes-bound on the tensor cores.
//
// The TPU kernel keeps one expert's whole (d, f) matrices in VMEM; at
// mixtral's width one matrix is 117 MB, so the design is new.  Four
// launches:
// (1) dispatch: one block per (slot, expert, group) and 512-column chunk
//     of d finds the slot's tokens with warp ballots (in token order) and
//     writes its part of xin (G, E, C, d) and a liveness flag per slot.  The bool dispatch is read on the
//     device: no host synchronisation and no index list.
// (2) up: H = silu(xin wg) * (xin wu) into scratch (G, E, C, f).
// (3) down: Y = H wd into f32 scratch (KS, G, E, C, d), f split in KS
//     parts (a number fixed by the shapes) where the tiles alone would
//     leave the SMs idle, as at decode.
// (4) combine: one block per token and 512-column chunk of d sums
//     combine * Y over (expert, slot) in index order and over the KS parts
//     in order.
// No atomics anywhere: a token's output bits do not depend on the other
// tokens of its group (when nothing is dropped).  A block whose slots hold
// no token returns before loading anything, so an expert without tokens
// costs no weight traffic.
//
// Two element types, two designs for (2) and (3):
// * bf16 (moe_mma_kernel), on the tensor cores: each product is computed
//   transposed, out^T = W^T A^T, so 64 of the weight's output columns
//   are the M side of a warpgroup's wgmma m64nNk16 and the block's slots
//   (a tile of N = 8 to 160, the narrowest built width that holds C) its
//   N side: a decode batch's 3 slots fill an n8 tile, not a 64-row one.
//   A block of two warpgroups streams 32 KB of weights a stage (64 deep:
//   128 columns of wg and of wu in (2), 256 of wd in (3)) with its slots'
//   activation tile through a ring of 4-6 stages in shared memory,
//   filled by 16-byte cp.async (raw bf16, zero fill past the edges and
//   for slots with no token) two to four stages ahead of the products,
//   and keeps one stage's wgmma group running while it waits for the
//   next.  The weights are stored
//   with the output columns contiguous: 128-byte-swizzled [64][64] blocks
//   are the MN-major A operand as they land, the slots' [N][64] tile the
//   K-major B operand.  One block an SM.  xin is bf16 (exact for a slot with one token; rounded once
//   for several), H is computed in f32 and rounded once to bf16 for the
//   down product, and the down product's partials and the combine stay
//   f32.  The slot tile is the fastest grid index, so the blocks that
//   read one weight tile for several slot tiles (prompts past 160 slots)
//   run together and share it in L2.
// * f32 (moe_gemm_kernel), on the CUDA cores: one block per (128-wide
//   column tile, 8/32/64 slots, group and expert, split) loops over the
//   depth in 32-deep chunks, each thread keeping its share of the next
//   chunk in flight in registers; xin and H are f32.  TF32 would move its
//   1e-4 results, so it stays off the tensor cores.
#include <cuda.h>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

// ---- (1) dispatch -------------------------------------------------------

constexpr int NT1 = 128;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float4& v);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float4& v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// xin in O: f32 for the CUDA-core products, x's bf16 for the tensor
// cores (a sum over several tokens rounded once)
template <typename T, typename O>
__global__ void __launch_bounds__(NT1) moe_dispatch_kernel(
    const unsigned char* __restrict__ disp, const T* __restrict__ x,
    O* __restrict__ xin, int* __restrict__ live, int g, int E, int C,
    int d) {
  extern __shared__ unsigned masks[];  // one ballot word per 32 tokens
  // blockIdx.x: the slot and one 512-column chunk of d (the ballots are
  // repeated for each chunk)
  const int nchunk = (d + NT1 * 4 - 1) / (NT1 * 4);
  const int c = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk;
  const int e = blockIdx.y, grp = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long EC = (long long)E * C;
  const unsigned char* col = disp + (long long)grp * g * EC + e * C + c;
  const int nw = (g + 31) / 32;
  int any = 0;
  for (int w = warp; w < nw; w += NT1 / 32) {  // warp-uniform bounds
    const int t = w * 32 + lane;
    const unsigned m = __ballot_sync(0xffffffffu, t < g && col[t * EC]);
    if (lane == 0) masks[w] = m;
    any |= m != 0u;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0 && chunk == 0)
    live[((long long)grp * E + e) * C + c] = any ? 1 : 0;
  if (!any) return;
  const T* xb = x + (long long)grp * g * d;
  O* out = xin + (((long long)grp * E + e) * C + c) * d;
  const int j = (chunk * NT1 + threadIdx.x) * 4;  // 4 columns a thread
  if (j >= d) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w = 0; w < nw; ++w) {  // tokens in increasing order
    for (unsigned m = masks[w]; m; m &= m - 1) {
      const int t = w * 32 + __ffs(m) - 1;
      const float4 v = load4(xb + (long long)t * d + j);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  store4<O>(out + j, acc);
}

// ---- (2) up and (3) down in f32, on the CUDA cores -----------------------

constexpr int NT = 256;   // 8 warps
constexpr int TY = 8;     // one warp per group of RM rows
constexpr int RN = 4;     // columns per thread
constexpr int FT = 32 * RN;  // 128 columns per block
constexpr int DK = 32;    // depth of one chunk

__device__ __forceinline__ void store_vec(float* dst, const uint4& v, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&v);
}
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// out[split][ge][c][n] = sum over k in the split of A[ge][c][k] W1[e][k][n];
// GATED: H = silu(A W1) * (A W2) instead (one split).  Rows whose slot
// holds no token are neither read nor written.
// The launch bound names one block an SM: with the thread count alone
// ptxas spills 8 bytes at RM 4; the arithmetic, and so the bits, do not
// depend on it.
template <typename T, int RM, bool GATED>
__global__ void __launch_bounds__(NT, 1) moe_gemm_kernel(
    const float* __restrict__ A, const T* __restrict__ W1,
    const T* __restrict__ W2, const int* __restrict__ live,
    float* __restrict__ out, float* __restrict__ save_a,
    float* __restrict__ save_b, int GE, int E, int C, int K, int N,
    int chunks_per_split, long long split_stride) {
  constexpr int CT = TY * RM;             // slots per block
  constexpr int NMAT = GATED ? 2 : 1;
  constexpr int VEC = 16 / sizeof(T);     // weight elements per 16 bytes
  constexpr int NVB = DK * FT / VEC / NT; // weight vectors per thread, matrix
  constexpr int NA4 = CT * DK / 4;        // float4s of the A tile
  constexpr int NVA = (NA4 + NT - 1) / NT;
  constexpr int AST = CT + 4;             // A tile row stride (floats)
  static_assert(DK * FT % (VEC * NT) == 0, "weight tile must divide evenly");
  __shared__ __align__(16) float As[DK * AST];   // [k][slot]
  __shared__ __align__(16) float Bs[NMAT][DK * FT];  // [k][column]
  __shared__ int live_s[CT];

  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int ge = blockIdx.z % GE, split = blockIdx.z / GE, e = ge % E;
  const int c0 = blockIdx.y * CT, n0 = blockIdx.x * FT;
  if (tid < CT) live_s[tid] = c0 + tid < C ? live[(long long)ge * C + c0 + tid] : 0;
  if (!__syncthreads_or(tid < CT && live_s[tid])) return;  // no token here
  bool rows_live = false;
#pragma unroll
  for (int i = 0; i < RM; ++i) rows_live |= live_s[ty * RM + i] != 0;

  const int k_begin = split * chunks_per_split * DK;
  const int k_end = min(K, k_begin + chunks_per_split * DK);
  const float* Ab = A + (long long)ge * C * K;
  const T* Wb[NMAT];
  Wb[0] = W1 + (long long)e * K * N;
  if constexpr (GATED) Wb[NMAT - 1] = W2 + (long long)e * K * N;

  float acc[NMAT][RM][RN];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[m][i][j] = 0.f;

  // the next chunk, raw, in registers: every load of a chunk is issued
  // before the first store, and the stores wait for the current products
  float4 ra[NVA];
  uint4 rb[NMAT][NVB];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < NVA; ++u) {
      const int i = tid + u * NT;
      const int r = i / (DK / 4), k = k0 + (i % (DK / 4)) * 4;
      ra[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < NA4 && live_s[r] && k < k_end)
        ra[u] = load4(Ab + (long long)(c0 + r) * K + k);
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int u = 0; u < NVB; ++u) {
        const int i = tid + u * NT;
        const int k = k0 + i / (FT / VEC), n = n0 + (i % (FT / VEC)) * VEC;
        rb[m][u] = make_uint4(0u, 0u, 0u, 0u);
        if (k < k_end && n < N)
          rb[m][u] = *reinterpret_cast<const uint4*>(Wb[m] + (long long)k * N + n);
      }
  };

  load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += DK) {
    __syncthreads();  // the previous chunk's tiles are no longer read
#pragma unroll
    for (int u = 0; u < NVA; ++u) {
      const int i = tid + u * NT;
      if (i < NA4) {
        const int r = i / (DK / 4), kq = (i % (DK / 4)) * 4;
        As[(kq + 0) * AST + r] = ra[u].x;
        As[(kq + 1) * AST + r] = ra[u].y;
        As[(kq + 2) * AST + r] = ra[u].z;
        As[(kq + 3) * AST + r] = ra[u].w;
      }
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int u = 0; u < NVB; ++u) {
        const int i = tid + u * NT;
        store_vec(&Bs[m][(i / (FT / VEC)) * FT + (i % (FT / VEC)) * VEC],
                  rb[m][u], T{});
      }
    __syncthreads();
    if (k0 + DK < k_end) load(k0 + DK);
    if (!rows_live) continue;
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      float a[RM];
      if constexpr (RM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&As[kk * AST + ty * RM + i]);
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[kk * AST + ty * RM + i];
      }
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[m][kk * FT + tx * RN]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[m][i][0] = fmaf(a[i], b.x, acc[m][i][0]);
          acc[m][i][1] = fmaf(a[i], b.y, acc[m][i][1]);
          acc[m][i][2] = fmaf(a[i], b.z, acc[m][i][2]);
          acc[m][i][3] = fmaf(a[i], b.w, acc[m][i][3]);
        }
      }
    }
  }

  const int n = n0 + tx * RN;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (!live_s[r]) continue;
    float4 o;
    const long long at = ((long long)ge * C + c0 + r) * N + n;
    if constexpr (GATED) {
      if (save_a != nullptr) {  // the pre-activations, for the backward
        *reinterpret_cast<float4*>(save_a + at) = make_float4(
            acc[0][i][0], acc[0][i][1], acc[0][i][2], acc[0][i][3]);
        *reinterpret_cast<float4*>(save_b + at) = make_float4(
            acc[NMAT - 1][i][0], acc[NMAT - 1][i][1], acc[NMAT - 1][i][2],
            acc[NMAT - 1][i][3]);
      }
      o = make_float4(silu(acc[0][i][0]) * acc[NMAT - 1][i][0],
                      silu(acc[0][i][1]) * acc[NMAT - 1][i][1],
                      silu(acc[0][i][2]) * acc[NMAT - 1][i][2],
                      silu(acc[0][i][3]) * acc[NMAT - 1][i][3]);
    } else {
      o = make_float4(acc[0][i][0], acc[0][i][1], acc[0][i][2], acc[0][i][3]);
    }
    *reinterpret_cast<float4*>(out + split * split_stride + at) = o;
  }
}

// ---- (2) up and (3) down in bf16, on the tensor cores ---------------------

constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int TC_K = 64;         // depth of one stage
// weight bytes of one stage: four [TC_K][64] column blocks, 8 KB each.
// Up: 128 columns of wg and of wu (blocks 2m + c); down: 256 columns of
// wd (blocks c).  Each warpgroup multiplies two of them a stage.
constexpr int TC_BLOCK = TC_K * 64 * 2;
constexpr int TC_WBYTES = 4 * TC_BLOCK;

// weight output columns a block covers
__host__ __device__ constexpr int tc_cols(bool gated) {
  return gated ? 128 : 256;
}

// bytes of one stage: the weight blocks and the slots' activation tile
__host__ __device__ constexpr int tc_stage_bytes(int slots) {
  return TC_WBYTES + slots * TC_K * 2;
}

// ring depth: as many stages (at most 6) as fit 220 KB of dynamic shared
// memory, one block an SM (a deep ring a block streams faster, at decode
// too, than two blocks of half the depth); the wrapper's plan states the
// same rule
__host__ __device__ constexpr int tc_stages(int slots) {
  const int n = (220 * 1024 - 1024) / tc_stage_bytes(slots);
  return n < 6 ? n : 6;
}

// dynamic shared memory of moe_mma_kernel: the ring on a 1024-byte
// boundary
__host__ __device__ constexpr int tc_smem(int slots) {
  return 1024 + tc_stages(slots) * tc_stage_bytes(slots);
}

__device__ __forceinline__ uint32_t align1024(void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

// out^T (N x slots) = W^T (N x K) A^T (K x slots), for the block's
// tc_cols(GATED) columns n0.. of W (E, K, N) (expert ge % E) and SLOTS
// slots c0.. of A (GE, C, K), on wgmma m64nSLOTSk16: a weight block is
// the MN-major A operand, the slots' tile, shared by all four products
// of a stage, the K-major B operand.  GATED: warpgroup w multiplies
// columns n0 + 64 w.. of W1 and of W2 and writes H = bf16(silu(A W1) *
// (A W2)) into (GE, C, N); else it multiplies columns n0 + 128 w.. of
// W1 and writes the f32 partial over this split's part of K into out +
// split * split_stride, (GE, C, N).  Slots without a token are
// zero-filled, never read, not written.
template <int SLOTS, bool GATED>
__global__ void __launch_bounds__(TC_THREADS) moe_mma_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W1,
    const __nv_bfloat16* __restrict__ W2, const int* __restrict__ live,
    void* __restrict__ out, __nv_bfloat16* __restrict__ save_a,
    __nv_bfloat16* __restrict__ save_b, int GE, int E, int C, int K, int N,
    int chunks_per_split, long long split_stride) {
  constexpr int STAGES = tc_stages(SLOTS);
  constexpr int SB = tc_stage_bytes(SLOTS);
  constexpr int NA = SLOTS / 2;  // accumulators a thread, a product
  constexpr int WCOLS = GATED ? 128 : 256;  // columns of one matrix a stage
  static_assert(SLOTS % 8 == 0 && SLOTS <= 256 && SB % 1024 == 0 &&
                STAGES >= 3 && tc_cols(GATED) == WCOLS, "tiles");
  extern __shared__ unsigned char smem_raw[];
  __shared__ int live_s[SLOTS];
  const uint32_t base = align1024(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int c0 = blockIdx.x * SLOTS, n0 = blockIdx.y * WCOLS;
  const int ge = blockIdx.z % GE, split = blockIdx.z / GE, e = ge % E;
  bool any = false;
  for (int i = tid; i < SLOTS; i += TC_THREADS) {
    live_s[i] = c0 + i < C ? live[(long long)ge * C + c0 + i] : 0;
    any |= live_s[i] != 0;
  }
  if (!__syncthreads_or(any)) return;  // no token in this slot tile

  const int k_begin = split * chunks_per_split * TC_K;
  const int k_end = min(K, k_begin + chunks_per_split * TC_K);
  const int nk = (k_end - k_begin + TC_K - 1) / TC_K;
  const __nv_bfloat16* Ab = A + (long long)ge * C * K;
  const __nv_bfloat16* W1b = W1 + (long long)e * K * N;
  const __nv_bfloat16* W2b = (GATED ? W2 : W1) + (long long)e * K * N;

  // chunk kt of the depth into stage kt % STAGES: weight rows k
  // ([k][n], 32 chunks of 16 bytes a row: WCOLS columns of each of the
  // 4 * 64 / WCOLS matrices) and the slots' rows ([slot][k]), swizzled
  auto load = [&](int kt) {
    const int k0 = k_begin + kt * TC_K;
    const uint32_t st = base + (kt % STAGES) * SB;
#pragma unroll
    for (int u = 0; u < TC_K * 32 / TC_THREADS; ++u) {
      const int i = tid + u * TC_THREADS;
      const int r = i / 32, q = i % 32;
      const int m = q / (WCOLS / 8), c = (q % (WCOLS / 8)) * 8;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < k_end && n < N;
      const __nv_bfloat16* w = m ? W2b : W1b;
      cp_async16(st + m * (WCOLS / 64) * TC_BLOCK + swz<TC_K>(r, c),
                 ok ? w + (long long)k * N + n : w, ok);
    }
#pragma unroll
    for (int u = 0; u < (SLOTS * TC_K / 8 + TC_THREADS - 1) / TC_THREADS;
         ++u) {
      const int i = tid + u * TC_THREADS;
      if (i < SLOTS * TC_K / 8) {
        const int r = i / (TC_K / 8), c = (i % (TC_K / 8)) * 8;
        const bool ok = live_s[r] && k0 + c < k_end;
        cp_async16(st + TC_WBYTES + swz<SLOTS>(r, c),
                   ok ? Ab + (long long)(c0 + r) * K + k0 + c : Ab, ok);
      }
    }
  };

  // the warpgroup's two weight blocks: wg's of W1 and W2 (up), or
  // 2 wg and 2 wg + 1 of W1 (down)
  const int blk[2] = {GATED ? wg : 2 * wg, GATED ? 2 + wg : 2 * wg + 1};
  float acc[2][NA];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[q][j] = 0.f;

  // AHEAD chunks in flight ahead of the one multiplied, while the
  // products of the one before run on (one wgmma group left pending):
  // the ring holds AHEAD + 2 stages
  constexpr int AHEAD = STAGES - 2;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<AHEAD - 1>();  // chunk kt has landed (this thread's part)
    fence_proxy_async();
    // ... every thread's; the products of chunk kt - 2 are done
    __syncthreads();
    if (kt + AHEAD < nk) load(kt + AHEAD);
    cp_async_commit();
    const uint32_t wt = base + (kt % STAGES) * SB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_K / 16; ++kk) {
      // 16 rows (2048 bytes) of a weight block, 32 bytes of each slot
      const uint64_t db = wgmma_desc(wt + TC_WBYTES + kk * 32, 0);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        wgmma_ss_mn<SLOTS>(
            acc[q], wgmma_desc(wt + blk[q] * TC_BLOCK + kk * 2048, 0), db);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait0();
#pragma unroll
  for (int q = 0; q < 2; ++q) fence_regs<NA>(acc[q]);

  // accumulator j of a block's product: column 16 (warp % 4) + lane/4
  // (+8 for j % 4 >= 2) of the weight block, slot c0 + 8 (j / 4) +
  // 2 (lane % 4) + j % 2
  const int n = 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int r = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
    if (!live_s[r]) continue;
    const long long row = ((long long)ge * C + c0 + r) * N;
    const int col = n + 8 * ((j >> 1) & 1);
    if constexpr (GATED) {
      if (n0 + 64 * wg + col < N) {
        static_cast<__nv_bfloat16*>(out)[row + n0 + 64 * wg + col] =
            __float2bfloat16_rn(silu(acc[0][j]) * acc[1][j]);
        if (save_a != nullptr) {  // the pre-activations, for the backward
          save_a[row + n0 + 64 * wg + col] = __float2bfloat16_rn(acc[0][j]);
          save_b[row + n0 + 64 * wg + col] = __float2bfloat16_rn(acc[1][j]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (n0 + 64 * blk[q] + col < N)
          static_cast<float*>(out)[split * split_stride + row + n0 +
                                   64 * blk[q] + col] = acc[q][j];
    }
  }
}

// ---- (4) combine ----------------------------------------------------------

// (launch bound: as for moe_gemm_kernel, the thread count alone spills 8
// bytes)
template <typename T>
__global__ void __launch_bounds__(NT1, 1) moe_combine_kernel(
    const float* __restrict__ comb, const int* __restrict__ live,
    const float* __restrict__ y, T* __restrict__ out, int g, int E, int C,
    int d, int KS, long long split_stride) {
  extern __shared__ unsigned sm[];  // ballot words, then the combine row
  // blockIdx.x: the token and one 512-column chunk of d
  const int nchunk = (d + NT1 * 4 - 1) / (NT1 * 4);
  const int t = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk;
  const int grp = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int EC = E * C, nw = (EC + 31) / 32;
  unsigned* masks = sm;
  float* w_s = reinterpret_cast<float*>(sm + nw);
  const float* crow = comb + ((long long)grp * g + t) * EC;
  const int* lrow = live + (long long)grp * EC;
  for (int w = warp; w < nw; w += NT1 / 32) {  // warp-uniform bounds
    const int j = w * 32 + lane;
    const float cv = j < EC ? crow[j] : 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, cv != 0.f && lrow[min(j, EC - 1)]);
    if (lane == 0) masks[w] = m;
    if (j < EC) w_s[j] = cv;
  }
  __syncthreads();
  const float* yb = y + (long long)grp * EC * d;
  T* ob = out + ((long long)grp * g + t) * d;
  const int col = (chunk * NT1 + threadIdx.x) * 4;  // 4 columns a thread
  if (col >= d) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w = 0; w < nw; ++w) {  // (expert, slot) in index order
    for (unsigned m = masks[w]; m; m &= m - 1) {
      const int j = w * 32 + __ffs(m) - 1;
      const float* yr = yb + (long long)j * d + col;
      float4 v = load4(yr);
      for (int s = 1; s < KS; ++s) {
        const float4 p = load4(yr + s * split_stride);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      const float cw = w_s[j];
      acc.x = fmaf(cw, v.x, acc.x);
      acc.y = fmaf(cw, v.y, acc.y);
      acc.z = fmaf(cw, v.z, acc.z);
      acc.w = fmaf(cw, v.w, acc.w);
    }
  }
  store4<T>(ob + col, acc);
}

template <typename T, int RM, bool GATED>
int launch_gemm(const float* A, const T* W1, const T* W2, const int* live,
                float* out, float* save_a, float* save_b, int G, int E,
                int C, int K, int N, int ks, int chunks_per_split,
                long long split_stride, cudaStream_t s) {
  const int GE = G * E;
  const dim3 grid((N + FT - 1) / FT, (C + TY * RM - 1) / (TY * RM), GE * ks);
  moe_gemm_kernel<T, RM, GATED><<<grid, NT, 0, s>>>(
      A, W1, W2, live, out, save_a, save_b, GE, E, C, K, N,
      chunks_per_split, split_stride);
  return (int)cudaGetLastError();
}

template <typename T, bool GATED>
int gemm_rows(int rm, const float* A, const T* W1, const T* W2,
              const int* live, float* out, float* save_a, float* save_b,
              int G, int E, int C, int K, int N, int ks,
              int chunks_per_split, long long split_stride, cudaStream_t s) {
  switch (rm) {
    case 1:
      return launch_gemm<T, 1, GATED>(A, W1, W2, live, out, save_a, save_b,
                                      G, E, C, K, N, ks, chunks_per_split,
                                      split_stride, s);
    case 4:
      return launch_gemm<T, 4, GATED>(A, W1, W2, live, out, save_a, save_b,
                                      G, E, C, K, N, ks, chunks_per_split,
                                      split_stride, s);
    case 8:
      return launch_gemm<T, 8, GATED>(A, W1, W2, live, out, save_a, save_b,
                                      G, E, C, K, N, ks, chunks_per_split,
                                      split_stride, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int SLOTS, bool GATED>
int launch_mma(const __nv_bfloat16* A, const __nv_bfloat16* W1,
               const __nv_bfloat16* W2, const int* live, void* out,
               __nv_bfloat16* save_a, __nv_bfloat16* save_b, int G,
               int E, int C, int K, int N, int ks, int chunks_per_split,
               long long split_stride, cudaStream_t s) {
  const int smem = tc_smem(SLOTS);
  const auto kernel = moe_mma_kernel<SLOTS, GATED>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  // all of the SM's 228 KB for shared memory: several blocks' rings fit
  // (cp.async.cg does not go through L1)
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err) return err;
  const int GE = G * E;
  const dim3 grid((C + SLOTS - 1) / SLOTS,
                  (N + tc_cols(GATED) - 1) / tc_cols(GATED), GE * ks);
  kernel<<<grid, TC_THREADS, smem, s>>>(A, W1, W2, live, out, save_a,
                                        save_b, GE, E, C, K, N,
                                        chunks_per_split, split_stride);
  return (int)cudaGetLastError();
}

template <bool GATED>
int mma_slots(int nt, const __nv_bfloat16* A, const __nv_bfloat16* W1,
              const __nv_bfloat16* W2, const int* live, void* out,
              __nv_bfloat16* save_a, __nv_bfloat16* save_b, int G,
              int E, int C, int K, int N, int ks, int chunks_per_split,
              long long split_stride, cudaStream_t s) {
#define MOE_SLOTS(n)                                                   \
  case n:                                                              \
    return launch_mma<n, GATED>(A, W1, W2, live, out, save_a, save_b, \
                                G, E, C, K, N, ks, chunks_per_split,  \
                                split_stride, s);
  switch (nt) {
    MOE_SLOTS(8)
    MOE_SLOTS(16)
    MOE_SLOTS(32)
    MOE_SLOTS(48)
    MOE_SLOTS(64)
    MOE_SLOTS(96)
    MOE_SLOTS(128)
    MOE_SLOTS(160)
  }
#undef MOE_SLOTS
  return (int)cudaErrorInvalidValue;
}

// 512-column chunks of d: the dispatch and combine blocks of one slot or
// token each take one
__host__ __device__ int d_chunks(int d) { return (d + NT1 * 4 - 1) / (NT1 * 4); }

template <typename T>
int launch_combine(const float* combine, const int* live, const float* y,
                   T* out, int G, int g, int E, int C, int d, int ks,
                   long long y_split, cudaStream_t s) {
  const int EC = E * C;
  const size_t smem4 =
      sizeof(unsigned) * ((EC + 31) / 32) + sizeof(float) * EC;
  if (smem4 > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        moe_combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem4);
    if (err) return err;
  }
  moe_combine_kernel<T><<<dim3(g * d_chunks(d), G), NT1, smem4, s>>>(
      combine, live, y, out, g, E, C, d, ks, y_split);
  return (int)cudaGetLastError();
}

// the backward's y in bf16 (saved under grad): a slot's row of y summed
// over the KS split partials in order and rounded once (the plain
// version's own out_e), 0 for a slot without a token
__global__ void __launch_bounds__(NT1) moe_save_y_kernel(
    const float* __restrict__ y, const int* __restrict__ live,
    __nv_bfloat16* __restrict__ ybf, int E, int C, int d, int KS,
    long long split_stride) {
  const int nchunk = d_chunks(d);
  const int c = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk;
  const long long slot = ((long long)blockIdx.z * E + blockIdx.y) * C + c;
  const int j = (chunk * NT1 + threadIdx.x) * 4;
  if (j >= d) return;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live[slot]) {
    const float* yr = y + slot * d + j;
    v = load4(yr);
    for (int s = 1; s < KS; ++s) {
      const float4 q = load4(yr + s * split_stride);
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
  }
  store4<__nv_bfloat16>(ybf + slot * d + j, v);
}

// ---- backward -------------------------------------------------------------
//
// moe_grouped_ffn_bwd: the gradient of the function above with respect to
// x, combine and the three weights, from dout (G, g, d) and what the
// forward left: xin, H, the up product's pre-activations a = xin wg and
// b = xin wu (kept under grad), the down product's output y and the
// liveness flags.  No atomics: every output element is written by one
// thread, its sum taken in a fixed order.
//  (B1) dy gather: dy_e[c] = sum_t combine[t, e, c] dout[t] over the tokens
//       with a weight in the slot (token order), for live slots;
//  (B2) dh = dy wd^T, and in its epilogue da = dh * b * silu'(a),
//       db = dh * silu(a);
//  (B3) dxin = da wg^T + db wu^T;
//  (B4) dwd_e = H_e^T dy_e, (B5) dwg_e = xin_e^T da_e and dwu_e =
//       xin_e^T db_e: reductions over the slots of expert e, exact zeros
//       for an expert without a token;
//  (B6) dx gather: dx[t] = sum over the (e, c) that dispatch t of
//       dxin_e[c] (index order; a dropped token gets 0);
//  (B7) dcombine[t, e, c] = dout[t] . y_e[c], 0 at dead slots.
// Bound: operations.  (B2)-(B5) are six products of 2 d f flops a live
// slot (mixtral's training shape, ~4,100 live slots: 2.9 TFLOP), (B7) 2 d
// flops a (token, slot) pair.
//
// bf16: eight launches, the products on the tensor cores.  (B0) lists,
// one block an expert, the expert's slots across the G groups in (group,
// slot) order, the live ones first, with their count and each slot's
// place.  (B1) writes dy in list order (row i of expert e: its i-th
// slot; a dead slot's row zeros), and (B2)'s epilogue da and db the same
// way, so that the operands listed rows would otherwise have to be
// gathered for are plain tiles.  (B2)-(B5) and (B7) are one
// warp-specialised kernel, moe_bwd_tc_kernel<MODE>, on wgmma m64n256k16:
// persistent blocks (one an SM) of three warpgroups walk a static tile
// queue (tile blockIdx.x + i gridDim.x) ordered so that the tiles that
// share a weight tile (B2, B3) or an activation tile (B4, B5) run at once
// and share it in L2.  (B2), (B3) walk an expert's listed rows in 128-row
// tiles, a tile past its count returning at once; (B4), (B5) reduce over
// exactly its live rows, in 64-deep stages.  A dead slot is never read
// (the forward leaves it unwritten, and NaN times a zero row is NaN).
// One producer warp (of a warpgroup at TB_PRODUCER_REGS registers after
// setmaxnreg) fills a ring of TB_STAGES 48 KB stages (128 x 64 of A, 256
// x 64 of B; the loads, not the products, set the pace of a cp.async
// ring here) with the Tensor Memory Accelerator through SWIZZLE_128B
// tensor maps: one box an operand a stage, except the weight gradients'
// A (H or xin at the slots' own rows), whose listed rows are cut into
// runs of consecutive slots and read in boxes of 2^i rows; a box past a
// tensor's edge reads zeros.  Each stage completes on its "full" mbarrier
// by its bytes.  The two consumer warpgroups (TB_CONSUMER_REGS) each
// multiply 64 x 256 outputs, keep one stage's wgmma group in flight, free
// a stage on its "empty" mbarrier, and store their tile while the
// producer fills the next tile's stages: the weight gradients (TB_WG_STAGES
// stages) through shared memory and TMA, so that the store runs on under
// the next tile's products.
// Layouts (each operand in shared memory as it lies in device memory):
//  * dh = dy wd_e^T and dxin = [da | db] [wg_e | wu_e]^T: both operands
//    K-major; dxin is one product of depth 2 f, written once in f32 at the
//    slots' own rows;
//  * dwd_e = H^T dy and [dwg_e | dwu_e] = xin^T [da | db]: both MN-major
//    (the listed slots are the depth; wgmma with both imm-trans bits);
//    a dwg/dwu tile is 128 rows of d by 128 columns of f of each, so the
//    xin tile is read once for both;
//  * dcombine (a group's g x E C) = dout y^T: both K-major, y the
//    forward's output summed over its split and rounded once to bf16 (the
//    plain version's own out_e), 0 at dead slots.
// da, db and dy are bf16 (the f32 values rounded once), dxin and dcombine
// f32, the weight gradients rounded once to bf16.
// f32 runs (B2)-(B5) and (B7) on the CUDA cores (moe_bwd_simt_kernel, nine
// launches: dxin as two products, the second adding to the first; dwg and
// dwu apart; dcombine over y's f32 split partials): 128 x 128 outputs a
// block, 8 x 8 a thread, 16-deep tiles, dead slots zero-filled in each
// load.

constexpr int TB_BM = 128;       // tensor-core tile: output rows
constexpr int TB_BN = 256;       // ... columns (one m64n256 a warpgroup)
constexpr int TB_BK = 64;        // ... depth of one stage
constexpr int TB_STAGES = 4;     // ring of dh, dxin and dcombine
constexpr int TB_WG_STAGES = 3;  // ... of the weight gradients
constexpr int TB_THREADS = 384;  // a producer and two consumer warpgroups
constexpr int TB_A = TB_BM * TB_BK * 2;  // bytes of a stage's A tile
constexpr int TB_B = TB_BN * TB_BK * 2;  // ... B tile
constexpr int TB_OUT = TB_BM * TB_BN * 2;  // a weight-gradient tile (bf16)
constexpr int TB_SMEM = 1024 + TB_STAGES * (TB_A + TB_B);
constexpr int TB_WG_SMEM = 1024 + TB_WG_STAGES * (TB_A + TB_B) + TB_OUT;
constexpr int TB_PRODUCER_REGS = 48;
constexpr int TB_CONSUMER_REGS = 224;
constexpr int ROWS_THREADS = 256;  // (B0): one block an expert
constexpr int SW_BM = 128;       // CUDA-core block: output rows
constexpr int SW_BN = 128;       // ... columns
constexpr int SW_BK = 16;        // ... depth of one tile
constexpr int SW_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int SW_SMEM = 2 * SW_BK * (SW_BM + 4) * 4;
// setmaxnreg moves registers between the warpgroups of a block, within
// what it launched with: 168 a thread at 384 threads (65,536 / 384, in
// steps of 8)
static_assert(TB_PRODUCER_REGS * 128 + TB_CONSUMER_REGS * 256 <=
                  (65536 / TB_THREADS) / 8 * 8 * TB_THREADS,
              "registers of one block");

// the products of moe_bwd_tc_kernel
constexpr int MODE_DH = 0, MODE_DXIN = 1, MODE_DWD = 2, MODE_DWGU = 3,
              MODE_DCOMB = 4;

// the weight gradients: both operands MN-major, a ring of TB_WG_STAGES
// and the tile stored through shared memory
__host__ __device__ constexpr bool wgrad(int mode) {
  return mode == MODE_DWD || mode == MODE_DWGU;
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// a product's tiles: z (expert, or group for dcombine) slowest, then a,
// then b
struct TileGrid {
  int z, a, b;
};

__host__ __device__ inline TileGrid tc_tiles(int mode, int G, int g, int E,
                                             int C, int d, int f) {
  const int GC = G * C;
  switch (mode) {
    case MODE_DH:  // a: columns of f, b: listed rows
      return {E, cdiv(f, TB_BN), cdiv(GC, TB_BM)};
    case MODE_DXIN:  // a: columns of d, b: listed rows
      return {E, cdiv(d, TB_BN), cdiv(GC, TB_BM)};
    case MODE_DWD:  // a: rows of f, b: columns of d
      return {E, cdiv(f, TB_BM), cdiv(d, TB_BN)};
    case MODE_DWGU:  // a: rows of d, b: 128 columns of f of dwg and dwu
      return {E, cdiv(d, TB_BM), cdiv(f, TB_BN / 2)};
    default:  // dcombine, a group: a: slots, b: tokens
      return {G, cdiv(E * C, TB_BN), cdiv(g, TB_BM)};
  }
}

// The bf16 products' operands.  dy, da and db are in list order: (E, G C,
// d or f), row i of expert e its i-th listed slot, rows past the count
// zero as far as a weight gradient reads them (cdiv(count, 64) 64).  The
// tensor maps (SWIZZLE_128B, 64-column boxes) by mode:
//  dh:       a dy (d, G C, E) box 128 rows;  b wd (d, f, E) box 256
//  dxin:     a da, a2 db (f, G C, E) 128;    b wg, b2 wu (f, d, E) 256
//  dwd:      runs H (f, G E C);              b dy (d, G C, E) box 64
//  dwg, dwu: runs xin (d, G E C);            b da, b2 db (f, G C, E) 64
//  dcombine: a dout (d, g, G) box 128;       b y (d, E C, G) 256
// runs[i]: the same tensor in boxes of 2^i rows, i = 0..6, for the
// weight gradients' A, read at the slots' own rows
constexpr int RUN_MAPS = 7;

// o, o2: the weight gradients' outputs, (d, f, E) dwd or (f, d, E) dwg and
// dwu, boxes of 64 x 64, stored from shared memory
struct alignas(64) TcArgs {
  CUtensorMap a, a2, b, b2, runs[RUN_MAPS], o, o2;
  const __nv_bfloat16 *sa, *sb;
  __nv_bfloat16 *da, *db, *dwg, *dwu, *dwd;
  float *dxin, *dcomb;
  // rows: E lists of G C slot indices ((group E + e) C + c, the live
  // slots first), the E counts, then each slot's place in its list
  const int* rows;
  int G, g, E, C, d, f;
};

struct TcTile {
  int z, m0, n0, ne, nk;
  bool live;
};

template <int MODE>
__device__ __forceinline__ TcTile tc_tile(const TcArgs& p, const TileGrid& tg,
                                          int t) {
  TcTile T;
  const int b = t % tg.b, a = (t / tg.b) % tg.a;
  T.z = t / (tg.a * tg.b);
  T.ne = 0;
  if constexpr (MODE != MODE_DCOMB)  // the expert's count of listed rows
    T.ne = p.rows[(long long)p.E * p.G * p.C + T.z];
  if constexpr (MODE == MODE_DH || MODE == MODE_DXIN) {
    T.m0 = b * TB_BM;
    T.n0 = a * TB_BN;
    T.live = T.m0 < T.ne;  // a tile past the expert's rows: nothing
    // dxin: the depth of da wg, then of db wu, each in whole stages
    T.nk = MODE == MODE_DH ? cdiv(p.d, TB_BK) : 2 * cdiv(p.f, TB_BK);
  } else if constexpr (MODE == MODE_DWD || MODE == MODE_DWGU) {
    T.m0 = a * TB_BM;
    T.n0 = b * (MODE == MODE_DWD ? TB_BN : TB_BN / 2);
    T.live = true;  // no rows: the tile is written with zeros
    T.nk = cdiv(T.ne, TB_BK);
  } else {
    T.m0 = b * TB_BM;
    T.n0 = a * TB_BN;
    T.live = true;
    T.nk = cdiv(p.d, TB_BK);
  }
  return T;
}

// one stage of the tile (depth kt) into A (As) and B (Bs) by the producer
// warp (lane 0 the boxes, every lane the listed rows), completing on bar.
// K-major tiles land as [rows][64], MN-major ones as 64-column blocks of
// [64 depth rows][64].
template <int MODE>
__device__ __forceinline__ void tc_load(const TcArgs& p, const TcTile& T,
                                        int kt, uint32_t As, uint32_t Bs,
                                        uint32_t bar, int lane) {
  const int k0 = kt * TB_BK;
  if constexpr (MODE == MODE_DWD || MODE == MODE_DWGU) {
    // A: the stage's 64 listed slots (lane's rows lane and lane + 32) cut
    // into runs of consecutive slots, each run read in boxes of 64, 32,
    // ..., 1 rows by the lane at its start; the rows past the count are
    // one run past the tensor's end (zeros).  Top-k routing fills each
    // group's slots from 0 up, so a stage is one or two runs.
    static_assert(TB_BK == 64, "two depth rows a lane");
    const int* list = p.rows + (long long)T.z * p.G * p.C;
    const int past = p.G * p.E * p.C;
    int slot[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = lane + 32 * h, j = k0 + kr;
      slot[h] = j < T.ne ? list[j] : past + kr;
    }
    const int up0 = __shfl_up_sync(0xffffffffu, slot[0], 1);
    const int up1 = __shfl_up_sync(0xffffffffu, slot[1], 1);
    const int last0 = __shfl_sync(0xffffffffu, slot[0], 31);
    const bool start[2] = {lane == 0 || slot[0] != up0 + 1,
                           slot[1] != (lane == 0 ? last0 : up1) + 1};
    const unsigned long long starts =
        (unsigned long long)__ballot_sync(0xffffffffu, start[1]) << 32 |
        __ballot_sync(0xffffffffu, start[0]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!start[h]) continue;
      const int kr = lane + 32 * h;
      const unsigned long long later =
          kr == 63 ? 0ull : starts >> (kr + 1) << (kr + 1);
      int len = (later ? __ffsll(later) - 1 : 64) - kr;
      int r = kr, at = slot[h];
      while (len > 0) {
        const int lg = 31 - __clz(len);  // the largest power of two in len
#pragma unroll
        for (int blk = 0; blk < TB_BM / 64; ++blk)
          tma_load_2d(As + blk * (TB_BK * 128) + r * 128, &p.runs[lg], bar,
                      T.m0 + 64 * blk, at);
        r += 1 << lg;
        at += 1 << lg;
        len -= 1 << lg;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int blk = 0; blk < TB_BN / 64; ++blk) {
        const int half = TB_BN / 2 / 64;  // dwg/dwu: blocks of da, then db
        const void* map = MODE == MODE_DWGU && blk >= half ? &p.b2 : &p.b;
        const int col = MODE == MODE_DWGU ? T.n0 + 64 * (blk % half)
                                          : T.n0 + 64 * blk;
        tma_load_3d(Bs + blk * (TB_BK * 128), map, bar, col, k0, T.z);
      }
    }
  } else if (lane == 0) {
    if constexpr (MODE == MODE_DH) {
      tma_load_3d(As, &p.a, bar, k0, T.m0, T.z);
      tma_load_3d(Bs, &p.b, bar, k0, T.n0, T.z);
    } else if constexpr (MODE == MODE_DXIN) {  // da wg, then db wu
      const int kf = cdiv(p.f, TB_BK);
      const bool hi = kt >= kf;
      const int k = (hi ? kt - kf : kt) * TB_BK;
      tma_load_3d(As, hi ? &p.a2 : &p.a, bar, k, T.m0, T.z);
      tma_load_3d(Bs, hi ? &p.b2 : &p.b, bar, k, T.n0, T.z);
    } else {
      tma_load_3d(As, &p.a, bar, k0, T.m0, T.z);
      tma_load_3d(Bs, &p.b, bar, k0, T.n0, T.z);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// da = dh b silu'(a), db = dh silu(a) for two neighbouring columns, from
// the pre-activations a, b; at da/db element offset out
template <typename T>
__device__ __forceinline__ void swiglu_grad2(T* da, T* db, float2 a, float2 b,
                                             long long out, float v0,
                                             float v1) {
  const float s0 = 1.f / (1.f + expf(-a.x)), s1 = 1.f / (1.f + expf(-a.y));
  // silu'(a) = s (1 + a (1 - s))
  store2<T>(da + out, v0 * b.x * (s0 * (1.f + a.x * (1.f - s0))),
            v1 * b.y * (s1 * (1.f + a.y * (1.f - s1))));
  store2<T>(db + out, v0 * (a.x * s0), v1 * (a.y * s1));
}

// consumer warpgroup cw's 64 x 256 outputs of the tile: accumulator j of
// thread (warp w, lane l) is row 16 w + l/4 + 8 ((j/2) % 2), column
// 8 (j/4) + 2 (l % 4) + j % 2
template <int MODE>
__device__ __forceinline__ void tc_store(const TcArgs& p, const TcTile& T,
                                         int cw, const float* acc) {
  const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
  const int GC = p.G * p.C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = T.m0 + 64 * cw + 16 * w + (lane >> 2) + 8 * h;
    if constexpr (MODE == MODE_DH) {
      // da, db in list order; the rows past the count that a weight
      // gradient reads are zeros
      if (m >= GC || m >= cdiv(T.ne, TB_BK) * TB_BK) continue;
      const long long out = ((long long)T.z * GC + m) * p.f;
      const long long in =
          m < T.ne ? (long long)p.rows[(long long)T.z * GC + m] * p.f : -1;
#pragma unroll
      for (int q = 0; q < TB_BN / 8; ++q) {
        const int n = T.n0 + 8 * q + 2 * (lane & 3);
        if (n >= p.f) continue;
        if (in < 0) {
          store2<__nv_bfloat16>(p.da + out + n, 0.f, 0.f);
          store2<__nv_bfloat16>(p.db + out + n, 0.f, 0.f);
        } else {
          swiglu_grad2(p.da, p.db, load2(p.sa + in + n),
                       load2(p.sb + in + n), out + n, acc[4 * q + 2 * h],
                       acc[4 * q + 2 * h + 1]);
        }
      }
      continue;
    }
    long long row;  // element offset of the output row
    if constexpr (MODE == MODE_DXIN) {  // dxin at the slot's place
      if (m >= T.ne) continue;
      row = (long long)p.rows[(long long)T.z * GC + m] * p.d;
    } else {
      if (m >= p.g) continue;
      row = ((long long)T.z * p.g + m) * p.E * p.C;
    }
#pragma unroll
    for (int q = 0; q < TB_BN / 8; ++q) {
      const int col = 8 * q + 2 * (lane & 3);
      const float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      if constexpr (MODE == MODE_DXIN) {
        const int n = T.n0 + col;
        if (n < p.d) store2<float>(p.dxin + row + n, v0, v1);
      } else {  // scalar stores: a group's E C columns may be odd
        const int n = T.n0 + col, EC = p.E * p.C;
        if (n < EC) p.dcomb[row + n] = v0;
        if (n + 1 < EC) p.dcomb[row + n + 1] = v1;
      }
    }
  }
}

// a weight-gradient tile: consumer warpgroup cw's 64 x 256 sums, rounded
// to bf16, into its half of the shared tile at out ([4 column blocks][64
// rows][64], swizzled as the maps store it), then to device memory by
// TMA (its thread 0 starts the four boxes; the stores run on while the
// warpgroup starts its next tile, and are waited for, their reads of
// shared memory, before the next tile is written there)
template <int MODE>
__device__ __forceinline__ void tc_store_wgrad(const TcArgs& p,
                                               const TcTile& T, int cw,
                                               const float* acc,
                                               uint32_t out) {
  const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
  out += cw * (TB_OUT / 2);
  if (tid == 0) bulk_wait_read0();
  named_barrier(1 + cw, 128);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * w + (lane >> 2) + 8 * h;
#pragma unroll
    for (int q = 0; q < TB_BN / 8; ++q) {
      const int col = 8 * q + 2 * (lane & 3);
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       out + swz<64>(r, col)),
                   "r"(*reinterpret_cast<const uint32_t*>(&v)));
    }
  }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (tid == 0) {
    const int m = T.m0 + 64 * cw;
#pragma unroll
    for (int blk = 0; blk < TB_BN / 64; ++blk) {
      const int half = TB_BN / 2 / 64;  // dwg/dwu: blocks of dwg, then dwu
      const void* map = MODE == MODE_DWGU && blk >= half ? &p.o2 : &p.o;
      const int col = MODE == MODE_DWGU ? T.n0 + 64 * (blk % half)
                                        : T.n0 + 64 * blk;
      tma_store_3d(map, out + blk * (64 * 128), col, m, T.z);
    }
    bulk_commit();
  }
}

template <int MODE>
__device__ __forceinline__ void tc_epilogue(const TcArgs& p, const TcTile& T,
                                            int cw, const float* acc,
                                            uint32_t out) {
  if constexpr (wgrad(MODE))
    tc_store_wgrad<MODE>(p, T, cw, acc, out);
  else
    tc_store<MODE>(p, T, cw, acc);
}

template <int MODE>
__global__ void __launch_bounds__(TB_THREADS, 1) moe_bwd_tc_kernel(
    const __grid_constant__ TcArgs p) {
  constexpr int TRANS = wgrad(MODE);  // both operands MN-major
  constexpr int STAGES = wgrad(MODE) ? TB_WG_STAGES : TB_STAGES;
  extern __shared__ unsigned char tb_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];  // full, empty
  const uint32_t ring = align1024(tb_raw);
  const uint32_t out = ring + STAGES * (TB_A + TB_B);  // wgrad's tile
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x, role = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);     // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 256);  // the consumers' threads
    }
    fence_mbar_init();
  }
  __syncthreads();
  const TileGrid tg = tc_tiles(MODE, p.G, p.g, p.E, p.C, p.d, p.f);
  const int ntiles = tg.z * tg.a * tg.b;

  if (role == 0) {  // producer: its first warp starts the copies
    reg_dealloc<TB_PRODUCER_REGS>();
    if (tid >= 32) return;
    int it = 0;  // stages started, over all of this block's tiles
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const TcTile T = tc_tile<MODE>(p, tg, t);
      if (!T.live) continue;
      for (int kt = 0; kt < T.nk; ++kt, ++it) {
        const int s = it % STAGES;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        if (tid == 0) mbar_expect_tx(full, TB_A + TB_B);
        __syncwarp();
        const uint32_t As = ring + s * (TB_A + TB_B);
        tc_load<MODE>(p, T, kt, As, As + TB_A, full, tid);
      }
    }
    return;
  }

  reg_alloc<TB_CONSUMER_REGS>();
  const int cw = role - 1;  // rows 64 cw.. of each tile
  float acc[TB_BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const TcTile T = tc_tile<MODE>(p, tg, t);
    if (!T.live) continue;
#pragma unroll
    for (int j = 0; j < TB_BN / 2; ++j) acc[j] = 0.f;
    for (int kt = 0; kt < T.nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t As = ring + s * (TB_A + TB_B), Bs = As + TB_A;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TB_BK / 16; ++kk) {
        uint64_t da, db;
        if constexpr (TRANS) {  // 16 depth rows of 128 bytes a step
          da = wgmma_desc(As + cw * (TB_BK * 128) + kk * 2048, TB_BK * 128);
          db = wgmma_desc(Bs + kk * 2048, TB_BK * 128);
        } else {  // 32 bytes of each row a step
          da = wgmma_desc(As + cw * (64 * 128) + kk * 32, 0);
          db = wgmma_desc(Bs + kk * 32, 0);
        }
        wgmma_ss_n256<TRANS>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // stage it - 1's products are done: free it
      if (kt > 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait0();
    if (T.nk > 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
    fence_regs<TB_BN / 2>(acc);
    tc_epilogue<MODE>(p, T, cw, acc, out);
  }
  // the last tile's stores read shared memory until they finish
  if constexpr (wgrad(MODE))
    if ((tid & 127) == 0) bulk_wait_read0();
}

// (B0): for each expert e, rows[e G C + i] = its i-th slot over (group,
// slot) order, (group E + e) C + c, the live slots first and then the
// dead ones; rows[E G C + e] = the live count; and for each slot,
// rows[E G C + E + slot] = its place i in its expert's list.  One block an
// expert, prefix sums in order.
__global__ void __launch_bounds__(ROWS_THREADS) moe_bwd_rows_kernel(
    const int* __restrict__ live, int* __restrict__ rows, int G, int E,
    int C) {
  __shared__ int warp_n[ROWS_THREADS / 32];
  __shared__ int n_live;
  const int e = blockIdx.x, GC = G * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* list = rows + (long long)e * GC;
  int* place = rows + (long long)E * GC + E;
  // pass 0 lists the live slots, pass 1 the dead ones after them
  for (int pass = 0; pass < 2; ++pass) {
    int base = pass ? n_live : 0;
    for (int i0 = 0; i0 < GC; i0 += ROWS_THREADS) {
      const int i = i0 + threadIdx.x, grp = i / C, c = i % C;
      const int slot = (grp * E + e) * C + c;
      const bool on = i < GC && (live[slot] != 0) == (pass == 0);
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (lane == 0) warp_n[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < ROWS_THREADS / 32; ++w) {
        before += w < warp ? warp_n[w] : 0;
        total += warp_n[w];
      }
      if (on) {
        const int at = base + before + __popc(m & ((1u << lane) - 1u));
        list[at] = slot;
        place[slot] = at;
      }
      base += total;
      __syncthreads();  // warp_n is rewritten by the next round
    }
    if (pass == 0 && threadIdx.x == 0) {
      n_live = base;
      rows[(long long)E * GC + e] = base;
    }
    __syncthreads();
  }
}

// ---- the products in f32, and dcombine in f32, on the CUDA cores -----------

// one operand of a product: element (z, i, k) of A (M x K, i = m) or B
// (N x K, i = n) at p + (zmod ? z % zmod : z) * zs + seg * ss + (KMAJ ?
// i * ld + kk : kk * ld + i), kk the depth index within segment seg (the
// depth is nseg segments of seg_len)
struct Operand {
  const void* p;
  long long zs, ss, ld;
  int zmod;
};

constexpr int LIVE_M = 1, LIVE_N = 2, LIVE_K = 3;  // 0: no liveness
constexpr int EPI_F32 = 0;      // out (f32) = acc
constexpr int EPI_F32_ADD = 1;  // out (f32) += acc
constexpr int EPI_T = 2;        // out (the operands' type) = acc, rounded
constexpr int EPI_SWIGLU = 3;   // out = da, out2 = db from dh = acc, ea = a,
                                // eb = b (the operands' type)

struct Gemm {
  Operand a, b;
  int M, N, seg_len, nseg;
  // slot liveness: live[z * lz + seg * lseg + i], i the row (LIVE_M: m,
  // LIVE_N: n, LIVE_K: kk); rows of a dead slot are zero-filled in the
  // operands, and not written (LIVE_M)
  const int* live;
  long long lz, lseg;
  int live_dim;
  // out element (z, m, n) at z * oz + m * old + n (out, out2, ea, eb)
  void* out;
  void* out2;
  const void* ea;
  const void* eb;
  long long oz, old;
};

__device__ __forceinline__ long long zoff(const Operand& o, int z) {
  return (long long)(o.zmod ? z % o.zmod : z) * o.zs;
}

__device__ __forceinline__ bool slot_live(const Gemm& p, int z, int seg,
                                          int i) {
  return p.live[(long long)z * p.lz + (long long)seg * p.lseg + i] != 0;
}

// the epilogue of one pair of neighbouring outputs (m, n), (m, n + 1), n
// even
template <typename T, int EPI>
__device__ __forceinline__ void epilogue2(const Gemm& p, int z, int m, int n,
                                          float v0, float v1) {
  const long long at = (long long)z * p.oz + (long long)m * p.old + n;
  if constexpr (EPI == EPI_F32 || EPI == EPI_F32_ADD) {
    // scalar stores: dcombine's rows (E C columns) may be odd
    float* o = static_cast<float*>(p.out) + at;
    const bool two = n + 1 < p.N;
    if constexpr (EPI == EPI_F32) {
      o[0] = v0;
      if (two) o[1] = v1;
    } else {
      o[0] += v0;
      if (two) o[1] += v1;
    }
  } else if constexpr (EPI == EPI_T) {
    store2<T>(static_cast<T*>(p.out) + at, v0, v1);
  } else {
    swiglu_grad2<T>(static_cast<T*>(p.out), static_cast<T*>(p.out2),
                    load2<T>(static_cast<const T*>(p.ea) + at),
                    load2<T>(static_cast<const T*>(p.eb) + at), at, v0, v1);
  }
}

template <typename T, bool KMAJ, bool IS_A>
__device__ __forceinline__ float sw_elem(const Gemm& p, const Operand& o,
                                         int z, int i, int seg, int k,
                                         int rows) {
  const int row_live = IS_A ? LIVE_M : LIVE_N;
  bool ok = i < rows && k < p.seg_len;
  if (ok && p.live_dim == LIVE_K) ok = slot_live(p, z, seg, k);
  if (ok && p.live_dim == row_live) ok = slot_live(p, z, 0, i);
  if (!ok) return 0.f;
  const T* base = static_cast<const T*>(o.p) + zoff(o, z) + seg * o.ss;
  return to_f32(base[KMAJ ? (long long)i * o.ld + k : (long long)k * o.ld + i]);
}

template <typename TA, typename TB, bool A_KMAJ, bool B_KMAJ, int EPI>
__global__ void __launch_bounds__(SW_THREADS) moe_bwd_simt_kernel(
    const Gemm p) {
  __shared__ __align__(16) float As[SW_BK][SW_BM + 4];
  __shared__ __align__(16) float Bs[SW_BK][SW_BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * SW_BM, n0 = blockIdx.x * SW_BN;
  if (p.live_dim == LIVE_M) {
    bool any = false;
    for (int i = tid; i < SW_BM; i += SW_THREADS)
      any |= m0 + i < p.M && slot_live(p, z, 0, m0 + i);
    if (!__syncthreads_or(any)) return;
  }
  const int kps = (p.seg_len + SW_BK - 1) / SW_BK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < kps * p.nseg; ++t) {
    const int seg = t / kps, k0 = (t % kps) * SW_BK;
    // 2048 elements of each tile, 8 a thread; neighbouring threads on the
    // operand's contiguous dimension
#pragma unroll
    for (int u = 0; u < SW_BM * SW_BK / SW_THREADS; ++u) {
      const int q = tid + u * SW_THREADS;
      const int ia = A_KMAJ ? q / SW_BK : q % SW_BM;
      const int ka = A_KMAJ ? q % SW_BK : q / SW_BM;
      As[ka][ia] = sw_elem<TA, A_KMAJ, true>(p, p.a, z, m0 + ia, seg, k0 + ka,
                                             p.M);
      const int ib = B_KMAJ ? q / SW_BK : q % SW_BN;
      const int kb = B_KMAJ ? q % SW_BK : q / SW_BN;
      Bs[kb][ib] = sw_elem<TB, B_KMAJ, false>(p, p.b, z, n0 + ib, seg,
                                              k0 + kb, p.N);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SW_BK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // thread (ty, tx) holds rows ty*4.. and 64+ty*4.., columns tx*4.. and
  // 64+tx*4..
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= p.M) continue;
    if (p.live_dim == LIVE_M && !slot_live(p, z, 0, m)) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < p.N)
        epilogue2<TA, EPI>(p, z, m, n, acc[i][j], acc[i][j + 1]);
    }
  }
}

// ---- (B1) and (B6), the gathers -------------------------------------------

// dy of slot (grp, e, c) = sum over tokens t (in order) with
// combine[grp][t][e][c] != 0 of that weight times dout[grp][t].  place
// null (f32): at the slot's own row of (G, E, C, d), live slots only (the
// products zero-fill dead ones); else (bf16) at row place[slot] of
// expert e's G C rows in list order, a dead slot's row written as zeros
template <typename T>
__global__ void __launch_bounds__(NT1) moe_bwd_dy_kernel(
    const float* __restrict__ comb, const int* __restrict__ live,
    const T* __restrict__ dout, T* __restrict__ dy,
    const int* __restrict__ place, int g, int E, int C, int d) {
  extern __shared__ unsigned masks[];  // one ballot word per 32 tokens
  // one block a slot, all of d (the ballots once, not once a chunk)
  const int c = blockIdx.x, e = blockIdx.y, grp = blockIdx.z;
  const long long slot = ((long long)grp * E + e) * C + c;
  const long long out =
      place == nullptr ? slot
                       : (long long)e * gridDim.z * C + place[slot];
  if (!live[slot]) {
    if (place != nullptr)
      for (int j = threadIdx.x * 4; j < d; j += NT1 * 4)
        store4<T>(dy + out * d + j, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long EC = (long long)E * C;
  const float* col = comb + (long long)grp * g * EC + e * C + c;
  const int nw = (g + 31) / 32;
  for (int w = warp; w < nw; w += NT1 / 32) {  // warp-uniform bounds
    const int t = w * 32 + lane;
    const unsigned m = __ballot_sync(0xffffffffu, t < g && col[t * EC] != 0.f);
    if (lane == 0) masks[w] = m;
  }
  __syncthreads();
  const T* db = dout + (long long)grp * g * d;
  for (int j = threadIdx.x * 4; j < d; j += NT1 * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < nw; ++w) {
      for (unsigned m = masks[w]; m; m &= m - 1) {
        const int t = w * 32 + __ffs(m) - 1;
        const float cw = col[t * EC];
        const float4 v = load4(db + (long long)t * d + j);
        acc.x = fmaf(cw, v.x, acc.x);
        acc.y = fmaf(cw, v.y, acc.y);
        acc.z = fmaf(cw, v.z, acc.z);
        acc.w = fmaf(cw, v.w, acc.w);
      }
    }
    store4<T>(dy + out * d + j, acc);
  }
}

// dx[grp][t] = sum over (e, c) in index order with dispatch[grp][t][e][c]
// of dxin[grp][e][c] (f32), rounded once; 0 for a token no slot holds
template <typename T>
__global__ void __launch_bounds__(NT1) moe_bwd_dx_kernel(
    const unsigned char* __restrict__ disp, const int* __restrict__ live,
    const float* __restrict__ dxin, T* __restrict__ dx, int g, int E, int C,
    int d) {
  extern __shared__ unsigned sm[];  // ballot words over the (e, c) row
  const int t = blockIdx.x, grp = blockIdx.y;  // one block a token, all d
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int EC = E * C, nw = (EC + 31) / 32;
  const unsigned char* drow = disp + ((long long)grp * g + t) * EC;
  const int* lrow = live + (long long)grp * EC;
  for (int w = warp; w < nw; w += NT1 / 32) {
    const int j = w * 32 + lane;
    const unsigned m = __ballot_sync(
        0xffffffffu, j < EC && drow[j] && lrow[min(j, EC - 1)]);
    if (lane == 0) sm[w] = m;
  }
  __syncthreads();
  const float* xb = dxin + (long long)grp * EC * d;
  for (int col = threadIdx.x * 4; col < d; col += NT1 * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < nw; ++w) {
      for (unsigned m = sm[w]; m; m &= m - 1) {
        const int j = w * 32 + __ffs(m) - 1;
        const float4 v = load4(xb + (long long)j * d + col);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    store4<T>(dx + ((long long)grp * g + t) * d + col, acc);
  }
}

template <typename TA, typename TB, bool A_KMAJ, bool B_KMAJ, int EPI>
int launch_bw_simt(const Gemm& p, int Z, cudaStream_t s) {
  const dim3 grid((p.N + SW_BN - 1) / SW_BN, (p.M + SW_BM - 1) / SW_BM, Z);
  moe_bwd_simt_kernel<TA, TB, A_KMAJ, B_KMAJ, EPI>
      <<<grid, SW_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

Gemm gemm(Operand a, Operand b, int M, int N, int seg_len, int nseg,
          const int* live, long long lz, long long lseg, int live_dim,
          void* out, long long oz, long long old) {
  Gemm p;
  p.a = a;
  p.b = b;
  p.M = M;
  p.N = N;
  p.seg_len = seg_len;
  p.nseg = nseg;
  p.live = live;
  p.lz = lz;
  p.lseg = lseg;
  p.live_dim = live_dim;
  p.out = out;
  p.out2 = nullptr;
  p.ea = nullptr;
  p.eb = nullptr;
  p.oz = oz;
  p.old = old;
  return p;
}

// the f32 products (B2)-(B5) on the CUDA cores
int bwd_products_f32(const void* dy, const void* wg, const void* wu,
                     const void* wd, const void* xin, const void* h,
                     const void* sa, const void* sb, const int* lv, void* da,
                     void* db, void* dxin, void* dwg, void* dwu, void* dwd,
                     int G, int E, int C, int d, int f, cudaStream_t s) {
  const int GE = G * E;
  const long long Cd = (long long)C * d, Cf = (long long)C * f,
                  df = (long long)d * f;
  // (B2) dh (C x f) = dy (C x d) wd_e^T, wd_e (f x d): both K-major
  Gemm p = gemm(Operand{dy, Cd, 0, d, 0}, Operand{wd, df, 0, d, E}, C, f, d,
                1, lv, C, 0, LIVE_M, da, Cf, f);
  p.out2 = db;
  p.ea = sa;
  p.eb = sb;
  int err = launch_bw_simt<float, float, true, true, EPI_SWIGLU>(p, GE, s);
  if (err) return err;
  // (B3) dxin (C x d) = da wg_e^T, then += db wu_e^T, wg_e (d x f): K-major
  for (int q = 0; q < 2; ++q) {
    p = gemm(Operand{q ? db : da, Cf, 0, f, 0},
             Operand{q ? wu : wg, df, 0, f, E}, C, d, f, 1, lv, C, 0, LIVE_M,
             dxin, Cd, d);
    err = q ? launch_bw_simt<float, float, true, true, EPI_F32_ADD>(p, GE, s)
            : launch_bw_simt<float, float, true, true, EPI_F32>(p, GE, s);
    if (err) return err;
  }
  // (B4) dwd_e (f x d) = H_e^T dy_e over the G x C slots: both slot-major
  // (the depth's rows), one segment a group
  p = gemm(Operand{h, Cf, (long long)E * Cf, f, 0},
           Operand{dy, Cd, (long long)E * Cd, d, 0}, f, d, C, G, lv, C,
           (long long)E * C, LIVE_K, dwd, df, d);
  err = launch_bw_simt<float, float, false, false, EPI_T>(p, E, s);
  if (err) return err;
  // (B5) dwg_e, dwu_e (d x f) = xin_e^T da_e, xin_e^T db_e
  for (int q = 0; q < 2; ++q) {
    p = gemm(Operand{xin, Cd, (long long)E * Cd, d, 0},
             Operand{q ? db : da, Cf, (long long)E * Cf, f, 0}, d, f, C, G,
             lv, C, (long long)E * C, LIVE_K, q ? dwu : dwg, df, f);
    err = launch_bw_simt<float, float, false, false, EPI_T>(p, E, s);
    if (err) return err;
  }
  return 0;
}

template <typename T>
int launch_dy(const float* comb, const int* lv, const T* dout, T* dy,
              const int* place, int G, int g, int E, int C, int d,
              cudaStream_t s) {
  moe_bwd_dy_kernel<T><<<dim3(C, E, G), NT1,
                         sizeof(unsigned) * ((g + 31) / 32), s>>>(
      comb, lv, dout, dy, place, g, E, C, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const unsigned char* disp, const int* lv, const float* dxin,
              T* dx, int G, int g, int E, int C, int d, cudaStream_t s) {
  const size_t smem8 = sizeof(unsigned) * ((E * C + 31) / 32);
  if (smem8 > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        moe_bwd_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem8);
    if (err) return err;
  }
  moe_bwd_dx_kernel<T><<<dim3(g, G), NT1, smem8, s>>>(
      disp, lv, dxin, dx, g, E, C, d);
  return (int)cudaGetLastError();
}

int moe_bwd_f32(const unsigned char* disp, const float* comb,
                const float* dout, const void* wg, const void* wu,
                const void* wd, const void* xin, const void* h,
                const void* sa, const void* sb, const float* y, const int* lv,
                float* dx, float* dcomb, void* dwg, void* dwu, void* dwd,
                float* dy, void* da, void* db, float* dxin, int G, int g,
                int E, int C, int d, int f, int ks, cudaStream_t s) {
  const long long EC = (long long)E * C;
  int err = launch_dy<float>(comb, lv, dout, dy, nullptr, G, g, E, C, d, s);
  if (err) return err;
  err = bwd_products_f32(dy, wg, wu, wd, xin, h, sa, sb, lv, da, db, dxin,
                         dwg, dwu, dwd, G, E, C, d, f, s);
  if (err) return err;
  if ((err = launch_dx<float>(disp, lv, dxin, dx, G, g, E, C, d, s)))
    return err;
  // (B7) dcombine (g x EC) = dout (g x d) y^T, y (EC x d) a group, the ks
  // partials as the depth's segments
  const Gemm p = gemm(Operand{dout, (long long)g * d, 0, d, 0},
                      Operand{y, EC * d, (long long)G * EC * d, d, 0}, g,
                      (int)EC, d, ks, lv, EC, 0, LIVE_N, dcomb,
                      (long long)g * EC, EC);
  return launch_bw_simt<float, float, true, true, EPI_F32>(p, G, s);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry points
// (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor of `rank` (2 or 3) dims {cols, rows[, planes]}, rows of
// cols elements and planes of plane_rows rows, as a SWIZZLE_128B map of
// boxes {64, box_rows[, 1]}; false if the encoding is refused
bool tensor_map(CUtensorMap* map, const void* base, int rank, long long cols,
                long long rows, long long planes, long long plane_rows,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)(plane_rows * cols * 2)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
int launch_tc(const TcArgs& a, int n_sm, cudaStream_t s) {
  const auto kernel = moe_bwd_tc_kernel<MODE>;
  const int smem = wgrad(MODE) ? TB_WG_SMEM : TB_SMEM;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const TileGrid t = tc_tiles(MODE, a.G, a.g, a.E, a.C, a.d, a.f);
  const int n = t.z * t.a * t.b;
  if (n == 0) return 0;
  kernel<<<n < n_sm ? n : n_sm, TB_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// the bf16 backward: (B0), (B1) in list order, the five products, (B6)
int moe_bwd_bf16(const unsigned char* disp, const float* comb,
                 const __nv_bfloat16* dout, const __nv_bfloat16* wg,
                 const __nv_bfloat16* wu, const __nv_bfloat16* wd,
                 const __nv_bfloat16* xin, const __nv_bfloat16* h,
                 const __nv_bfloat16* y, const int* lv, __nv_bfloat16* dy,
                 TcArgs& a, int* rows, __nv_bfloat16* dx, int n_sm,
                 cudaStream_t s) {
  const int G = a.G, g = a.g, E = a.E, C = a.C, d = a.d, f = a.f;
  const long long GC = (long long)G * C, EC = (long long)E * C;
  moe_bwd_rows_kernel<<<E, ROWS_THREADS, 0, s>>>(lv, rows, G, E, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_dy<__nv_bfloat16>(comb, lv, dout, dy, rows + E * GC + E, G,
                                 g, E, C, d, s);
  if (err) return err;
  const int bad = (int)cudaErrorInvalidValue;
  // (B2) dh: dy (list order) against wd
  if (!tensor_map(&a.a, dy, 3, d, GC, E, GC, TB_BM) ||
      !tensor_map(&a.b, wd, 3, d, f, E, f, TB_BN))
    return bad;
  if ((err = launch_tc<MODE_DH>(a, n_sm, s))) return err;
  // (B3) dxin: [da | db] (list order) against [wg | wu]
  if (!tensor_map(&a.a, a.da, 3, f, GC, E, GC, TB_BM) ||
      !tensor_map(&a.a2, a.db, 3, f, GC, E, GC, TB_BM) ||
      !tensor_map(&a.b, wg, 3, f, d, E, d, TB_BN) ||
      !tensor_map(&a.b2, wu, 3, f, d, E, d, TB_BN))
    return bad;
  if ((err = launch_tc<MODE_DXIN>(a, n_sm, s))) return err;
  // (B4) dwd: H's listed rows against dy
  for (int i = 0; i < RUN_MAPS; ++i)
    if (!tensor_map(&a.runs[i], h, 2, f, G * EC, 1, 0, 1 << i)) return bad;
  if (!tensor_map(&a.b, dy, 3, d, GC, E, GC, TB_BK) ||
      !tensor_map(&a.o, a.dwd, 3, d, f, E, f, 64))
    return bad;
  if ((err = launch_tc<MODE_DWD>(a, n_sm, s))) return err;
  // (B5) dwg, dwu: xin's listed rows against [da | db]
  for (int i = 0; i < RUN_MAPS; ++i)
    if (!tensor_map(&a.runs[i], xin, 2, d, G * EC, 1, 0, 1 << i)) return bad;
  if (!tensor_map(&a.b, a.da, 3, f, GC, E, GC, TB_BK) ||
      !tensor_map(&a.b2, a.db, 3, f, GC, E, GC, TB_BK) ||
      !tensor_map(&a.o, a.dwg, 3, f, d, E, d, 64) ||
      !tensor_map(&a.o2, a.dwu, 3, f, d, E, d, 64))
    return bad;
  if ((err = launch_tc<MODE_DWGU>(a, n_sm, s))) return err;
  if ((err = launch_dx<__nv_bfloat16>(disp, lv, a.dxin, dx, G, g, E, C, d,
                                      s)))
    return err;
  // (B7) dcombine: dout against y, a group at a time
  if (!tensor_map(&a.a, dout, 3, d, g, G, g, TB_BM) ||
      !tensor_map(&a.b, y, 3, d, EC, G, EC, TB_BN))
    return bad;
  return launch_tc<MODE_DCOMB>(a, n_sm, s);
}

}  // namespace

// the bf16 slot tiles the library is built for (a wgmma width each)
constexpr int TC_SLOT_TILES[] = {8, 16, 32, 48, 64, 96, 128, 160};

// Dynamic shared-memory bytes (what = 0), ring stages (1) or weight
// columns (2) of the bf16 up (gated != 0) or down product's blocks at
// slot tile nt, -1 for a tile it is not built for: the wrapper's plan
// states the same numbers (checked on the card).
extern "C" int moe_grouped_ffn_tiles(int nt, int gated, int what) {
  for (int t : TC_SLOT_TILES)
    if (t == nt)
      return what == 0 ? tc_smem(nt) : what == 1 ? tc_stages(nt)
                                                 : tc_cols(gated != 0);
  return -1;
}

// dispatch (G, g, E, C) uint8 0/1; combine (G, g, E, C) f32; x (G, g, d);
// wg, wu (E, d, f); wd (E, f, d); out (G, g, d): all contiguous, x, the
// weights and out of one element type.  Scratch from the caller: xin
// (G, E, C, d) and h (G, E, C, f), f32 for f32 and bf16 for bf16; y (ks,
// G, E, C, d) f32; live (G, E, C) int32; save_a, save_b:
// null, or (G, E, C, f) in xin's type for the up product's pre-activations
// xin wg and xin wu (the backward's; written for live slots only); y_save
// (bf16 only): null, or (G, E, C, d) bf16 for the backward's y (summed over
// the split, rounded once; 0 at dead slots).  tile: f32's slots per warp (1,
// 4 or 8), bf16's slot tile (TC_SLOT_TILES); stages: bf16's ring depth
// (as moe_grouped_ffn_tiles gives it; 0 for f32); ks splits f in (3) into
// parts of chunks_per_split chunks (32 deep in f32, 64 in bf16).
extern "C" int moe_grouped_ffn_fwd(
    const void* dispatch, const void* combine, const void* x, const void* wg,
    const void* wu, const void* wd, void* out, void* xin, void* h, void* y,
    void* live, void* save_a, void* save_b, void* y_save, int dtype, int G,
    int g, int E, int C, int d, int f, int tile, int stages, int ks,
    int chunks_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* disp = static_cast<const unsigned char*>(dispatch);
  const float* comb = static_cast<const float*>(combine);
  int* lv = static_cast<int*>(live);
  float* yy = static_cast<float*>(y);
  const long long y_split = (long long)G * E * C * d;
  const size_t smem1 = sizeof(unsigned) * ((g + 31) / 32);
  int err;
  if (dtype == kF32) {
    float* xi = static_cast<float*>(xin);
    float* hh = static_cast<float*>(h);
    moe_dispatch_kernel<float, float>
        <<<dim3(C * d_chunks(d), E, G), NT1, smem1, s>>>(
        disp, static_cast<const float*>(x), xi, lv, g, E, C, d);
    if ((err = (int)cudaGetLastError())) return err;
    err = gemm_rows<float, true>(tile, xi, static_cast<const float*>(wg),
                                 static_cast<const float*>(wu), lv, hh,
                                 static_cast<float*>(save_a),
                                 static_cast<float*>(save_b), G, E, C, d, f,
                                 1, (d + DK - 1) / DK, 0, s);
    if (err) return err;
    err = gemm_rows<float, false>(tile, hh, static_cast<const float*>(wd),
                                  nullptr, lv, yy, nullptr, nullptr, G, E, C,
                                  f, d, ks, chunks_per_split, y_split, s);
    if (err) return err;
    return launch_combine<float>(comb, lv, yy, static_cast<float*>(out), G,
                                 g, E, C, d, ks, y_split, s);
  }
  if (dtype != kBF16 || stages != moe_grouped_ffn_tiles(tile, 1, 1))
    return (int)cudaErrorInvalidValue;
  using B16 = __nv_bfloat16;
  B16* xi = static_cast<B16*>(xin);
  B16* hh = static_cast<B16*>(h);
  moe_dispatch_kernel<B16, B16>
      <<<dim3(C * d_chunks(d), E, G), NT1, smem1, s>>>(
      disp, static_cast<const B16*>(x), xi, lv, g, E, C, d);
  if ((err = (int)cudaGetLastError())) return err;
  err = mma_slots<true>(tile, xi, static_cast<const B16*>(wg),
                        static_cast<const B16*>(wu), lv, hh,
                        static_cast<B16*>(save_a), static_cast<B16*>(save_b),
                        G, E, C, d, f, 1, (d + TC_K - 1) / TC_K, 0, s);
  if (err) return err;
  err = mma_slots<false>(tile, hh, static_cast<const B16*>(wd), nullptr, lv,
                         yy, nullptr, nullptr, G, E, C, f, d, ks,
                         chunks_per_split, y_split, s);
  if (err) return err;
  err = launch_combine<B16>(comb, lv, yy, static_cast<B16*>(out), G, g, E, C,
                            d, ks, y_split, s);
  if (err || y_save == nullptr) return err;
  moe_save_y_kernel<<<dim3(C * d_chunks(d), E, G), NT1, 0, s>>>(
      yy, lv, static_cast<B16*>(y_save), E, C, d, ks, y_split);
  return (int)cudaGetLastError();
}

// The backward's tiles, for the wrapper's plan_bwd to be held to: the
// tensor-core block's rows (what = 0), columns (1), depth (2), stages (3)
// and dynamic shared memory (4), the weight gradients' stages (5) and
// shared memory (6), threads (7), producer and consumer registers (8, 9);
// the CUDA-core block's rows (10), columns (11), depth (12), static shared
// memory (13) and threads (14); the row lists' block threads (15).
extern "C" int moe_grouped_ffn_bwd_tiles(int what) {
  const int v[] = {TB_BM,        TB_BN,            TB_BK,
                   TB_STAGES,    TB_SMEM,          TB_WG_STAGES,
                   TB_WG_SMEM,   TB_THREADS,       TB_PRODUCER_REGS,
                   TB_CONSUMER_REGS, SW_BM,        SW_BN,
                   SW_BK,        SW_SMEM,          SW_THREADS,
                   ROWS_THREADS};
  return what >= 0 && what < 16 ? v[what] : -1;
}

// Tiles of the bf16 product ``mode`` (0 dh, 1 dxin, 2 dwd, 3 dwg and dwu,
// 4 dcombine) at one shape: the z (1), a (2) and b (3) extents of its tile
// queue, or their product (0).
extern "C" int moe_grouped_ffn_bwd_queue(int mode, int G, int g, int E,
                                         int C, int d, int f, int what) {
  const TileGrid t = tc_tiles(mode, G, g, E, C, d, f);
  const int v[] = {t.z * t.a * t.b, t.z, t.a, t.b};
  return what >= 0 && what < 4 ? v[what] : -1;
}

// The backward's row lists alone (its first launch), from live (G, E, C)
// int32 into rows (E G C + E) int32: expert e's live slots (group E + e)
// C + c in (group, slot) order at e G C.., its count at E G C + e; the
// entries past a count are not written.
extern "C" int moe_grouped_ffn_rows(const void* live, void* rows, int G,
                                    int E, int C, void* stream) {
  moe_bwd_rows_kernel<<<E, ROWS_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(live), static_cast<int*>(rows), G, E, C);
  return (int)cudaGetLastError();
}

// dout (G, g, d) in x's type and what the forward kept under grad: xin
// (G, E, C, d) and h (G, E, C, f) in x's type, the pre-activations save_a
// and save_b (G, E, C, f) in x's type, y (bf16: the forward's y_save, (G,
// E, C, d); f32: the split partials, (ks, G, E, C, d)) and live (G, E, C)
// int32 -> dx (G, g, d) in x's type, dcombine (G, g, E, C) f32, dwg, dwu
// (E, d, f) and dwd (E, f, d) in the weights' (x's) type.  Scratch from
// the caller: dy (G, E, C, d), da and db (G, E, C, f) in x's type, dxin
// (G, E, C, d) f32, rows (E G C + E) int32 (bf16; null for f32).  n_sm:
// the persistent products' blocks (the card's SM count).  All contiguous.
extern "C" int moe_grouped_ffn_bwd(
    const void* dispatch, const void* combine, const void* dout,
    const void* wg, const void* wu, const void* wd, const void* xin,
    const void* h, const void* save_a, const void* save_b, const void* y,
    const void* live, void* dx, void* dcombine, void* dwg, void* dwu,
    void* dwd, void* dy, void* da, void* db, void* dxin, void* rows,
    int dtype, int G, int g, int E, int C, int d, int f, int ks, int n_sm,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* disp = static_cast<const unsigned char*>(dispatch);
  const float* comb = static_cast<const float*>(combine);
  const int* lv = static_cast<const int*>(live);
  float* dc = static_cast<float*>(dcombine);
  float* dxi = static_cast<float*>(dxin);
  if (dtype == kF32)
    return moe_bwd_f32(disp, comb, static_cast<const float*>(dout), wg, wu,
                       wd, xin, h, save_a, save_b,
                       static_cast<const float*>(y), lv,
                       static_cast<float*>(dx), dc, dwg, dwu, dwd,
                       static_cast<float*>(dy), da, db, dxi, G, g, E, C, d,
                       f, ks, s);
  if (dtype != kBF16 || rows == nullptr || n_sm < 1)
    return (int)cudaErrorInvalidValue;
  using B16 = __nv_bfloat16;
  TcArgs a;
  a.sa = static_cast<const B16*>(save_a);
  a.sb = static_cast<const B16*>(save_b);
  a.da = static_cast<B16*>(da);
  a.db = static_cast<B16*>(db);
  a.dwg = static_cast<B16*>(dwg);
  a.dwu = static_cast<B16*>(dwu);
  a.dwd = static_cast<B16*>(dwd);
  a.dxin = dxi;
  a.dcomb = dc;
  a.rows = static_cast<const int*>(rows);
  a.G = G;
  a.g = g;
  a.E = E;
  a.C = C;
  a.d = d;
  a.f = f;
  return moe_bwd_bf16(disp, comb, static_cast<const B16*>(dout),
                      static_cast<const B16*>(wg), static_cast<const B16*>(wu),
                      static_cast<const B16*>(wd), static_cast<const B16*>(xin),
                      static_cast<const B16*>(h), static_cast<const B16*>(y),
                      lv, static_cast<B16*>(dy), a, static_cast<int*>(rows),
                      static_cast<B16*>(dx), n_sm, s);
}
