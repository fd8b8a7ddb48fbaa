// Grouped mixture-of-experts SwiGLU FFN over one-hot dispatched token groups.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_matmul.py
// (moe_grouped_ffn, :64, pallas_call at :77, body _moe_kernel :33).  Same
// function for any bool dispatch (G, g, E, C) and f32 combine (G, g, E, C):
//   xin_e = dispatch_e^T x,  y_e = (silu(xin_e wg_e) * (xin_e wu_e)) wd_e,
//   out   = sum_e combine_e y_e,
// with x (G, g, d), wg/wu (E, d, f), wd (E, f, d) and out (G, g, d) in x's
// dtype.  Every product accumulates in f32, the combine weights stay f32,
// and the output is rounded once.
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
    float* __restrict__ out, int GE, int E, int C, int K, int N,
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
    if constexpr (GATED) {
      o = make_float4(silu(acc[0][i][0]) * acc[NMAT - 1][i][0],
                      silu(acc[0][i][1]) * acc[NMAT - 1][i][1],
                      silu(acc[0][i][2]) * acc[NMAT - 1][i][2],
                      silu(acc[0][i][3]) * acc[NMAT - 1][i][3]);
    } else {
      o = make_float4(acc[0][i][0], acc[0][i][1], acc[0][i][2], acc[0][i][3]);
    }
    *reinterpret_cast<float4*>(out + split * split_stride +
                               ((long long)ge * C + c0 + r) * N + n) = o;
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
    void* __restrict__ out, int GE, int E, int C, int K, int N,
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
      if (n0 + 64 * wg + col < N)
        static_cast<__nv_bfloat16*>(out)[row + n0 + 64 * wg + col] =
            __float2bfloat16_rn(silu(acc[0][j]) * acc[1][j]);
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
                float* out, int G, int E, int C, int K, int N, int ks,
                int chunks_per_split, long long split_stride,
                cudaStream_t s) {
  const int GE = G * E;
  const dim3 grid((N + FT - 1) / FT, (C + TY * RM - 1) / (TY * RM), GE * ks);
  moe_gemm_kernel<T, RM, GATED><<<grid, NT, 0, s>>>(
      A, W1, W2, live, out, GE, E, C, K, N, chunks_per_split, split_stride);
  return (int)cudaGetLastError();
}

template <typename T, bool GATED>
int gemm_rows(int rm, const float* A, const T* W1, const T* W2,
              const int* live, float* out, int G, int E, int C, int K, int N,
              int ks, int chunks_per_split, long long split_stride,
              cudaStream_t s) {
  switch (rm) {
    case 1:
      return launch_gemm<T, 1, GATED>(A, W1, W2, live, out, G, E, C, K, N,
                                      ks, chunks_per_split, split_stride, s);
    case 4:
      return launch_gemm<T, 4, GATED>(A, W1, W2, live, out, G, E, C, K, N,
                                      ks, chunks_per_split, split_stride, s);
    case 8:
      return launch_gemm<T, 8, GATED>(A, W1, W2, live, out, G, E, C, K, N,
                                      ks, chunks_per_split, split_stride, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int SLOTS, bool GATED>
int launch_mma(const __nv_bfloat16* A, const __nv_bfloat16* W1,
               const __nv_bfloat16* W2, const int* live, void* out, int G,
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
  kernel<<<grid, TC_THREADS, smem, s>>>(A, W1, W2, live, out, GE, E, C, K,
                                        N, chunks_per_split, split_stride);
  return (int)cudaGetLastError();
}

template <bool GATED>
int mma_slots(int nt, const __nv_bfloat16* A, const __nv_bfloat16* W1,
              const __nv_bfloat16* W2, const int* live, void* out, int G,
              int E, int C, int K, int N, int ks, int chunks_per_split,
              long long split_stride, cudaStream_t s) {
#define MOE_SLOTS(n)                                                      \
  case n:                                                                 \
    return launch_mma<n, GATED>(A, W1, W2, live, out, G, E, C, K, N, ks, \
                                chunks_per_split, split_stride, s);
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
// G, E, C, d) f32; live (G, E, C) int32.  tile: f32's slots per warp (1,
// 4 or 8), bf16's slot tile (TC_SLOT_TILES); stages: bf16's ring depth
// (as moe_grouped_ffn_tiles gives it; 0 for f32); ks splits f in (3) into
// parts of chunks_per_split chunks (32 deep in f32, 64 in bf16).
extern "C" int moe_grouped_ffn_fwd(
    const void* dispatch, const void* combine, const void* x, const void* wg,
    const void* wu, const void* wd, void* out, void* xin, void* h, void* y,
    void* live, int dtype, int G, int g, int E, int C, int d, int f,
    int tile, int stages, int ks, int chunks_per_split, void* stream) {
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
                                 static_cast<const float*>(wu), lv, hh, G, E,
                                 C, d, f, 1, (d + DK - 1) / DK, 0, s);
    if (err) return err;
    err = gemm_rows<float, false>(tile, hh, static_cast<const float*>(wd),
                                  nullptr, lv, yy, G, E, C, f, d, ks,
                                  chunks_per_split, y_split, s);
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
                        static_cast<const B16*>(wu), lv, hh, G, E, C, d, f, 1,
                        (d + TC_K - 1) / TC_K, 0, s);
  if (err) return err;
  err = mma_slots<false>(tile, hh, static_cast<const B16*>(wd), nullptr, lv,
                         yy, G, E, C, f, d, ks, chunks_per_split, y_split, s);
  if (err) return err;
  return launch_combine<B16>(comb, lv, yy, static_cast<B16*>(out), G, g, E,
                             C, d, ks, y_split, s);
}
