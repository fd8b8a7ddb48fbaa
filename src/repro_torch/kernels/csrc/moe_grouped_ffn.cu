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
int d_chunks(int d) { return (d + NT1 * 4 - 1) / (NT1 * 4); }

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

// ---- backward -------------------------------------------------------------
//
// moe_grouped_ffn_bwd: the gradient of the function above with respect to
// x, combine and the three weights, from dout (G, g, d) and what the
// forward left: xin, H, the up product's pre-activations a = xin wg and
// b = xin wu (kept under grad), the down product's f32 partials y and the
// liveness flags.  Nine launches, no atomics: every output element is
// written by one thread, its sum taken in a fixed order.
//  (B1) dy gather: dy_e[c] = sum_t combine[t, e, c] dout[t] over the tokens
//       with a weight in the slot (token order), for live slots;
//  (B2) dh = dy wd^T, and in its epilogue da = dh * b * silu'(a),
//       db = dh * silu(a);
//  (B3) dxin = da wg^T, then (B4) dxin += db wu^T (f32);
//  (B5) dwd_e = H_e^T dy_e, (B6) dwg_e = xin_e^T da_e, (B7) dwu_e =
//       xin_e^T db_e: each a reduction over all G x C slots of expert e,
//       looped over inside one block (the slots are the products' depth),
//       dead slots zero-filled, so an expert without a token gets exact
//       zeros;
//  (B8) dx gather: dx[t] = sum over the (e, c) that dispatch t of
//       dxin_e[c] (index order; a dropped token gets 0);
//  (B9) dcombine[t, e, c] = dout[t] . y_e[c] in f32 (the ks partials of y
//       are the depth's segments), 0 at dead slots.
// Bound: operations.  (B2)-(B7) are six products of 2 d f flops a live
// slot (mixtral's training shape, ~4,100 live slots: 2.9 TFLOP), (B9) 2 g
// E C d a group.
// bf16 runs (B2)-(B7) on the tensor cores (mma.sync m16n8k16 through
// ldmatrix, f32 accumulators), blocks of 128 x 128 outputs streaming
// 64-deep tiles of both operands through a 3-stage cp.async ring; each
// operand is stored in shared memory as it lies in device memory (the
// reduced dimension contiguous, "K-major", or the output's), in 128-byte
// swizzled rows, and ldmatrix reads it with or without .trans: the
// weights in (B2)-(B4) are read the other way round than the forward
// reads them (dh = dy wd^T takes wd (f, d) with d, the reduced dimension,
// contiguous), and in (B5)-(B7) both operands are slot-major with the
// slots reduced.  da, db and dy are bf16 (the f32 values rounded once),
// dxin and dcombine f32, the weight gradients rounded once to bf16.
// f32, and (B9) in both types, runs on the CUDA cores: 128 x 128 outputs a
// block, 8 x 8 a thread, 16-deep tiles.

constexpr int BW_BM = 128;       // tensor-core block: output rows
constexpr int BW_BN = 128;       // ... columns
constexpr int BW_BK = 64;        // ... depth of one stage
constexpr int BW_STAGES = 3;
constexpr int BW_THREADS = 256;  // 8 warps, 2 (rows) x 4 (columns)
constexpr int BW_TILE = BW_BM * BW_BK * 2;  // bytes of one operand's tile
constexpr int BW_SMEM = 1024 + BW_STAGES * 2 * BW_TILE;
constexpr int SW_BM = 128;       // CUDA-core block: output rows
constexpr int SW_BN = 128;       // ... columns
constexpr int SW_BK = 16;        // ... depth of one tile
constexpr int SW_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int SW_SMEM = 2 * SW_BK * (SW_BM + 4) * 4;
static_assert(BW_BM == BW_BN, "one tile size for both operands");

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

// the epilogue of one pair of neighbouring outputs (m, n), (m, n + 1), n
// even; the bf16 modes need N even (d and f are multiples of 8)
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
    const float2 a = load2<T>(static_cast<const T*>(p.ea) + at);
    const float2 b = load2<T>(static_cast<const T*>(p.eb) + at);
    const float s0 = 1.f / (1.f + expf(-a.x)), s1 = 1.f / (1.f + expf(-a.y));
    // silu'(a) = s (1 + a (1 - s))
    store2<T>(static_cast<T*>(p.out) + at,
              v0 * b.x * (s0 * (1.f + a.x * (1.f - s0))),
              v1 * b.y * (s1 * (1.f + a.y * (1.f - s1))));
    store2<T>(static_cast<T*>(p.out2) + at, v0 * (a.x * s0), v1 * (a.y * s1));
  }
}

// ---- (B2)-(B7) in bf16, on the tensor cores -------------------------------

// one operand's tile of depth tile kt into shared memory at dst: KMAJ,
// [128 rows i][64 k] (swz<128>); else [64 k][128 i] (swz<64>, two 64-wide
// column blocks).  Zero past the edges and for dead slots.
template <bool KMAJ, bool IS_A>
__device__ __forceinline__ void bw_load(const Gemm& p, const Operand& o,
                                        uint32_t dst, int z, int i0, int seg,
                                        int k0, int rows) {
  const __nv_bfloat16* base =
      static_cast<const __nv_bfloat16*>(o.p) + zoff(o, z) + seg * o.ss;
  const int row_live = IS_A ? LIVE_M : LIVE_N;
#pragma unroll
  for (int u = 0; u < BW_BM * BW_BK / 8 / BW_THREADS; ++u) {
    const int q = threadIdx.x + u * BW_THREADS;
    int i, k;
    if constexpr (KMAJ) {
      i = q >> 3;
      k = (q & 7) * 8;
    } else {
      k = q >> 4;
      i = (q & 15) * 8;
    }
    const int gi = i0 + i, gk = k0 + k;
    bool ok = gi < rows && gk < p.seg_len;
    if (ok && p.live_dim == LIVE_K && !KMAJ) ok = slot_live(p, z, seg, gk);
    if (ok && p.live_dim == row_live && KMAJ) ok = slot_live(p, z, 0, gi);
    const long long off = KMAJ ? (long long)gi * o.ld + gk
                               : (long long)gk * o.ld + gi;
    cp_async16(dst + (KMAJ ? swz<BW_BM>(i, k) : swz<BW_BK>(k, i)),
               ok ? base + off : base, ok);
  }
}

template <bool A_KMAJ, bool B_KMAJ, int EPI>
__global__ void __launch_bounds__(BW_THREADS) moe_bwd_mma_kernel(
    const Gemm p) {
  extern __shared__ unsigned char bw_raw[];
  const uint32_t base = align1024(bw_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BW_BM, n0 = blockIdx.x * BW_BN;
  if (p.live_dim == LIVE_M) {  // a tile of dead slots writes nothing
    bool any = false;
    for (int i = tid; i < BW_BM; i += BW_THREADS)
      any |= m0 + i < p.M && slot_live(p, z, 0, m0 + i);
    if (!__syncthreads_or(any)) return;
  }
  const int kps = (p.seg_len + BW_BK - 1) / BW_BK;
  const int nkt = kps * p.nseg;

  auto load = [&](int t) {
    const uint32_t st = base + (t % BW_STAGES) * 2 * BW_TILE;
    const int seg = t / kps, k0 = (t % kps) * BW_BK;
    bw_load<A_KMAJ, true>(p, p.a, st, z, m0, seg, k0, p.M);
    bw_load<B_KMAJ, false>(p, p.b, st + BW_TILE, z, n0, seg, k0, p.N);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < BW_STAGES - 1; ++s) {
    if (s < nkt) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<BW_STAGES - 2>();  // tile t has landed (this thread's)
    __syncthreads();  // ... everyone's, and tile t - 1 is no longer read
    if (t + BW_STAGES - 1 < nkt) load(t + BW_STAGES - 1);
    cp_async_commit();
    const uint32_t As = base + (t % BW_STAGES) * 2 * BW_TILE;
    const uint32_t Bs = As + BW_TILE;
#pragma unroll
    for (int kk = 0; kk < BW_BK; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + 16 * i;
        if constexpr (A_KMAJ)
          frag_a<BW_BM>(af[i], As, m, kk, lane);
        else  // stored [k][m]: ldmatrix.trans gives the row-major fragment
          ldsm_x4_t(af[i], As + swz<BW_BK>(kk + (lane & 7) + ((lane >> 4) << 3),
                                           m + (((lane >> 3) & 1) << 3)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + 16 * j;
        if constexpr (B_KMAJ)
          frag_b_nk<BW_BN>(bf[j], Bs, n, kk, lane);
        else
          frag_b_kn<BW_BK>(bf[j], Bs, n, kk, lane);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], &bf[j >> 1][(j & 1) * 2]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * 64 + 16 * i + (lane >> 2) + 8 * hh;
      if (m >= p.M) continue;
      if (p.live_dim == LIVE_M && !slot_live(p, z, 0, m)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + 8 * j + 2 * (lane & 3);
        if (n < p.N)
          epilogue2<__nv_bfloat16, EPI>(p, z, m, n, acc[i][j][2 * hh],
                                        acc[i][j][2 * hh + 1]);
      }
    }
}

// ---- the products in f32, and (B9), on the CUDA cores ----------------------

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

// ---- (B1) and (B8), the gathers -------------------------------------------

// dy[grp][e][c] = sum over tokens t (in order) with combine[grp][t][e][c]
// != 0 of that weight times dout[grp][t], for live slots (a dead slot's row
// is not written: the products zero-fill it)
template <typename T>
__global__ void __launch_bounds__(NT1) moe_bwd_dy_kernel(
    const float* __restrict__ comb, const int* __restrict__ live,
    const T* __restrict__ dout, T* __restrict__ dy, int g, int E, int C,
    int d) {
  extern __shared__ unsigned masks[];  // one ballot word per 32 tokens
  const int nchunk = (d + NT1 * 4 - 1) / (NT1 * 4);
  const int c = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk;
  const int e = blockIdx.y, grp = blockIdx.z;
  const long long slot = ((long long)grp * E + e) * C + c;
  if (!live[slot]) return;
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
  const int j = (chunk * NT1 + threadIdx.x) * 4;
  if (j >= d) return;
  const T* db = dout + (long long)grp * g * d;
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
  store4<T>(dy + slot * d + j, acc);
}

// dx[grp][t] = sum over (e, c) in index order with dispatch[grp][t][e][c]
// of dxin[grp][e][c] (f32), rounded once; 0 for a token no slot holds
template <typename T>
__global__ void __launch_bounds__(NT1) moe_bwd_dx_kernel(
    const unsigned char* __restrict__ disp, const int* __restrict__ live,
    const float* __restrict__ dxin, T* __restrict__ dx, int g, int E, int C,
    int d) {
  extern __shared__ unsigned sm[];  // ballot words over the (e, c) row
  const int nchunk = (d + NT1 * 4 - 1) / (NT1 * 4);
  const int t = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk;
  const int grp = blockIdx.y;
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
  const int col = (chunk * NT1 + threadIdx.x) * 4;
  if (col >= d) return;
  const float* xb = dxin + (long long)grp * EC * d;
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

template <bool A_KMAJ, bool B_KMAJ, int EPI>
int launch_bw_mma(const Gemm& p, int Z, cudaStream_t s) {
  const auto kernel = moe_bwd_mma_kernel<A_KMAJ, B_KMAJ, EPI>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BW_SMEM);
  if (err) return err;
  const dim3 grid((p.N + BW_BN - 1) / BW_BN, (p.M + BW_BM - 1) / BW_BM, Z);
  kernel<<<grid, BW_THREADS, BW_SMEM, s>>>(p);
  return (int)cudaGetLastError();
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

// (B2)-(B7) and their launches, in element type T (the tensor cores for
// bf16, the CUDA cores for f32)
template <typename T, bool A_KMAJ, bool B_KMAJ, int EPI>
int launch_bw(const Gemm& p, int Z, cudaStream_t s) {
  if constexpr (sizeof(T) == 2)
    return launch_bw_mma<A_KMAJ, B_KMAJ, EPI>(p, Z, s);
  else
    return launch_bw_simt<T, T, A_KMAJ, B_KMAJ, EPI>(p, Z, s);
}

template <typename T>
int bwd_products(const void* dy, const void* wg, const void* wu,
                 const void* wd, const void* xin, const void* h,
                 const void* sa, const void* sb, const int* lv, void* da,
                 void* db, void* dxin, void* dwg, void* dwu, void* dwd, int G,
                 int E, int C, int d, int f, cudaStream_t s) {
  const int GE = G * E;
  const long long Cd = (long long)C * d, Cf = (long long)C * f,
                  df = (long long)d * f;
  // (B2) dh (C x f) = dy (C x d) wd_e^T, wd_e (f x d): both K-major
  Gemm p = gemm(Operand{dy, Cd, 0, d, 0}, Operand{wd, df, 0, d, E}, C, f, d,
                1, lv, C, 0, LIVE_M, da, Cf, f);
  p.out2 = db;
  p.ea = sa;
  p.eb = sb;
  int err = launch_bw<T, true, true, EPI_SWIGLU>(p, GE, s);
  if (err) return err;
  // (B3), (B4) dxin (C x d) = da wg_e^T + db wu_e^T, wg_e (d x f): K-major
  for (int q = 0; q < 2; ++q) {
    p = gemm(Operand{q ? db : da, Cf, 0, f, 0},
             Operand{q ? wu : wg, df, 0, f, E}, C, d, f, 1, lv, C, 0, LIVE_M,
             dxin, Cd, d);
    err = q ? launch_bw<T, true, true, EPI_F32_ADD>(p, GE, s)
            : launch_bw<T, true, true, EPI_F32>(p, GE, s);
    if (err) return err;
  }
  // (B5) dwd_e (f x d) = H_e^T dy_e over the G x C slots: both slot-major
  // (the depth's rows), one segment a group
  p = gemm(Operand{h, Cf, (long long)E * Cf, f, 0},
           Operand{dy, Cd, (long long)E * Cd, d, 0}, f, d, C, G, lv, C,
           (long long)E * C, LIVE_K, dwd, df, d);
  err = launch_bw<T, false, false, EPI_T>(p, E, s);
  if (err) return err;
  // (B6), (B7) dwg_e, dwu_e (d x f) = xin_e^T da_e, xin_e^T db_e
  for (int q = 0; q < 2; ++q) {
    p = gemm(Operand{xin, Cd, (long long)E * Cd, d, 0},
             Operand{q ? db : da, Cf, (long long)E * Cf, f, 0}, d, f, C, G,
             lv, C, (long long)E * C, LIVE_K, q ? dwu : dwg, df, f);
    err = launch_bw<T, false, false, EPI_T>(p, E, s);
    if (err) return err;
  }
  return 0;
}

template <typename T>
int moe_bwd(const unsigned char* disp, const float* comb, const T* dout,
            const void* wg, const void* wu, const void* wd, const void* xin,
            const void* h, const void* sa, const void* sb, const float* y,
            const int* lv, T* dx, float* dcomb, void* dwg, void* dwu,
            void* dwd, T* dy, void* da, void* db, float* dxin, int G, int g,
            int E, int C, int d, int f, int ks, cudaStream_t s) {
  const long long EC = (long long)E * C;
  moe_bwd_dy_kernel<T><<<dim3(C * d_chunks(d), E, G), NT1,
                         sizeof(unsigned) * ((g + 31) / 32), s>>>(
      comb, lv, dout, dy, g, E, C, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = bwd_products<T>(dy, wg, wu, wd, xin, h, sa, sb, lv, da, db, dxin,
                        dwg, dwu, dwd, G, E, C, d, f, s);
  if (err) return err;
  const size_t smem8 = sizeof(unsigned) * ((EC + 31) / 32);
  if (smem8 > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(moe_bwd_dx_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem8);
    if (err) return err;
  }
  moe_bwd_dx_kernel<T><<<dim3(g * d_chunks(d), G), NT1, smem8, s>>>(
      disp, lv, dxin, dx, g, E, C, d);
  if ((err = (int)cudaGetLastError())) return err;
  // (B9) dcombine (g x EC) = dout (g x d) y^T, y (EC x d) a group, the ks
  // partials as the depth's segments
  const Gemm p = gemm(Operand{dout, (long long)g * d, 0, d, 0},
                      Operand{y, EC * d, (long long)G * EC * d, d, 0}, g,
                      (int)EC, d, ks, lv, EC, 0, LIVE_N, dcomb,
                      (long long)g * EC, EC);
  return launch_bw_simt<T, float, true, true, EPI_F32>(p, G, s);
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
// xin wg and xin wu (the backward's; written for live slots only).  tile: f32's slots per warp (1,
// 4 or 8), bf16's slot tile (TC_SLOT_TILES); stages: bf16's ring depth
// (as moe_grouped_ffn_tiles gives it; 0 for f32); ks splits f in (3) into
// parts of chunks_per_split chunks (32 deep in f32, 64 in bf16).
extern "C" int moe_grouped_ffn_fwd(
    const void* dispatch, const void* combine, const void* x, const void* wg,
    const void* wu, const void* wd, void* out, void* xin, void* h, void* y,
    void* live, void* save_a, void* save_b, int dtype, int G, int g, int E,
    int C, int d, int f, int tile, int stages, int ks, int chunks_per_split,
    void* stream) {
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
  return launch_combine<B16>(comb, lv, yy, static_cast<B16*>(out), G, g, E,
                             C, d, ks, y_split, s);
}

// The backward's tiles, for the wrapper's plan_bwd to be held to: the
// tensor-core block's rows (what = 0), columns (1), depth (2), stages (3),
// dynamic shared memory (4) and threads (5); the CUDA-core block's rows
// (6), columns (7), depth (8), static shared memory (9) and threads (10).
extern "C" int moe_grouped_ffn_bwd_tiles(int what) {
  const int v[] = {BW_BM, BW_BN, BW_BK, BW_STAGES, BW_SMEM, BW_THREADS,
                   SW_BM, SW_BN, SW_BK, SW_SMEM, SW_THREADS};
  return what >= 0 && what < 11 ? v[what] : -1;
}

// dout (G, g, d) in x's type and what the forward kept under grad: xin
// (G, E, C, d) and h (G, E, C, f) in x's type, the pre-activations save_a
// and save_b (G, E, C, f) in x's type, y (ks, G, E, C, d) f32 and live
// (G, E, C) int32 -> dx (G, g, d) in x's type, dcombine (G, g, E, C) f32,
// dwg, dwu (E, d, f) and dwd (E, f, d) in the weights' (x's) type.
// Scratch from the caller: dy (G, E, C, d), da and db (G, E, C, f) in x's
// type, dxin (G, E, C, d) f32.  All contiguous.
extern "C" int moe_grouped_ffn_bwd(
    const void* dispatch, const void* combine, const void* dout,
    const void* wg, const void* wu, const void* wd, const void* xin,
    const void* h, const void* save_a, const void* save_b, const void* y,
    const void* live, void* dx, void* dcombine, void* dwg, void* dwu,
    void* dwd, void* dy, void* da, void* db, void* dxin, int dtype, int G,
    int g, int E, int C, int d, int f, int ks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* disp = static_cast<const unsigned char*>(dispatch);
  const float* comb = static_cast<const float*>(combine);
  const int* lv = static_cast<const int*>(live);
  const float* yy = static_cast<const float*>(y);
  float* dc = static_cast<float*>(dcombine);
  float* dxi = static_cast<float*>(dxin);
  if (dtype == kF32)
    return moe_bwd<float>(disp, comb, static_cast<const float*>(dout), wg,
                          wu, wd, xin, h, save_a, save_b, yy, lv,
                          static_cast<float*>(dx), dc, dwg, dwu, dwd,
                          static_cast<float*>(dy), da, db, dxi, G, g, E, C,
                          d, f, ks, s);
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  using B16 = __nv_bfloat16;
  return moe_bwd<B16>(disp, comb, static_cast<const B16*>(dout), wg, wu, wd,
                      xin, h, save_a, save_b, yy, lv, static_cast<B16*>(dx),
                      dc, dwg, dwu, dwd, static_cast<B16*>(dy), da, db, dxi, G,
                      g, E, C, d, f, ks, s);
}
