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
// 2.8 GB of weights, ~128 FLOP/byte) stays bytes-bound on the tensor
// cores; this kernel runs its products on the CUDA cores in f32, where the
// prompt is bound by operations instead (>= 5.4 ms at 67 TFLOP/s).
//
// The TPU kernel keeps one expert's whole (d, f) matrices in VMEM; at
// mixtral's width one matrix is 117 MB, so the design is new:
// (1) dispatch: one block per (slot, expert, group) finds the slot's
//     tokens with warp ballots (in token order) and writes xin (G, E, C, d)
//     f32 and a liveness flag per slot.  The bool dispatch is read on the
//     device: no host synchronisation and no index list.
// (2) up: H = silu(xin wg) * (xin wu) into f32 scratch (G, E, C, f); one
//     block per (128-wide f tile, tile of slots, group and expert) loops
//     over d in 32-deep chunks, so each weight tile is read once for all
//     slots of its tile.  A decode batch's 8 experts give 8 x 112 blocks.
// (3) down: Y = H wd into f32 scratch (KS, G, E, C, d); one block per
//     (128-wide d tile, slot tile, group and expert, K split) loops over f.
//     The wrapper splits f in KS parts (a number fixed by the shapes) when
//     the tiles alone would leave the SMs idle, as at decode.
// (4) combine: one block per token sums combine * Y over (expert, slot) in
//     index order and over the KS parts in order.
// No atomics anywhere: a token's output bits do not depend on the other
// tokens of its group (when nothing is dropped).  A block whose slots hold
// no token returns before loading anything, so an expert without tokens
// costs no weight traffic, and a thread whose rows hold no token skips the
// products.  In (2) and (3) each thread keeps its share of the next chunk's
// weight and activation tiles in flight in registers (16-byte loads) while
// the current chunk is multiplied, and converts bf16 to f32 only when it
// stores them to shared memory.  Tensor cores (wgmma) are later work.
#include "common.cuh"

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
__global__ void __launch_bounds__(NT1) moe_dispatch_kernel(
    const unsigned char* __restrict__ disp, const T* __restrict__ x,
    float* __restrict__ xin, int* __restrict__ live, int g, int E, int C,
    int d) {
  extern __shared__ unsigned masks[];  // one ballot word per 32 tokens
  const int c = blockIdx.x, e = blockIdx.y, grp = blockIdx.z;
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
  if (threadIdx.x == 0) live[((long long)grp * E + e) * C + c] = any ? 1 : 0;
  if (!any) return;
  const T* xb = x + (long long)grp * g * d;
  float* out = xin + (((long long)grp * E + e) * C + c) * d;
  for (int j = threadIdx.x * 4; j < d; j += NT1 * 4) {
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
    *reinterpret_cast<float4*>(out + j) = acc;
  }
}

// ---- (2) up and (3) down: A (f32 rows of slots) times expert weights ----

constexpr int NT = 256;   // 8 warps
constexpr int TY = 8;     // one warp per group of RM rows
constexpr int RN = 4;     // columns per thread
constexpr int FT = 32 * RN;  // 128 columns per block
constexpr int DK = 32;    // depth of one chunk

__device__ __forceinline__ void store_vec(float* dst, const uint4& v, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&v);
}
__device__ __forceinline__ void store_vec(float* dst, const uint4& v,
                                          __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// out[split][ge][c][n] = sum over k in the split of A[ge][c][k] W1[e][k][n];
// GATED: H = silu(A W1) * (A W2) instead (one split).  Rows whose slot
// holds no token are neither read nor written.
template <typename T, int RM, bool GATED>
__global__ void __launch_bounds__(NT) moe_gemm_kernel(
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

// ---- (4) combine ----------------------------------------------------------

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

template <typename T>
__global__ void __launch_bounds__(NT1) moe_combine_kernel(
    const float* __restrict__ comb, const int* __restrict__ live,
    const float* __restrict__ y, T* __restrict__ out, int g, int E, int C,
    int d, int KS, long long split_stride) {
  extern __shared__ unsigned sm[];  // ballot words, then the combine row
  const int t = blockIdx.x, grp = blockIdx.y;
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
  for (int col = threadIdx.x * 4; col < d; col += NT1 * 4) {
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

}  // namespace

// dispatch (G, g, E, C) uint8 0/1; combine (G, g, E, C) f32; x (G, g, d);
// wg, wu (E, d, f); wd (E, f, d); out (G, g, d): all contiguous, x, the
// weights and out of one element type.  Scratch from the caller: xin
// (G, E, C, d) f32, h (G, E, C, f) f32, y (ks, G, E, C, d) f32, live
// (G, E, C) int32.  rm (1, 4 or 8) is the slots per warp of the two
// products; ks splits f in (3) into parts of chunks_per_split chunks of 32.
extern "C" int moe_grouped_ffn_fwd(
    const void* dispatch, const void* combine, const void* x, const void* wg,
    const void* wu, const void* wd, void* out, void* xin, void* h, void* y,
    void* live, int dtype, int G, int g, int E, int C, int d, int f, int rm,
    int ks, int chunks_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_elem(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const unsigned char* disp = static_cast<const unsigned char*>(dispatch);
    int* lv = static_cast<int*>(live);
    float* xi = static_cast<float*>(xin);
    float* hh = static_cast<float*>(h);
    float* yy = static_cast<float*>(y);
    const long long y_split = (long long)G * E * C * d;

    const size_t smem1 = sizeof(unsigned) * ((g + 31) / 32);
    moe_dispatch_kernel<T><<<dim3(C, E, G), NT1, smem1, s>>>(
        disp, static_cast<const T*>(x), xi, lv, g, E, C, d);
    int err = (int)cudaGetLastError();
    if (err) return err;

    err = gemm_rows<T, true>(rm, xi, static_cast<const T*>(wg),
                             static_cast<const T*>(wu), lv, hh, G, E, C, d,
                             f, 1, (d + DK - 1) / DK, 0, s);
    if (err) return err;
    err = gemm_rows<T, false>(rm, hh, static_cast<const T*>(wd), nullptr, lv,
                              yy, G, E, C, f, d, ks, chunks_per_split,
                              y_split, s);
    if (err) return err;

    const int EC = E * C;
    const size_t smem4 =
        sizeof(unsigned) * ((EC + 31) / 32) + sizeof(float) * EC;
    if (smem4 > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(
          moe_combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem4);
      if (err) return err;
    }
    moe_combine_kernel<T><<<dim3(g, G), NT1, smem4, s>>>(
        static_cast<const float*>(combine), lv, yy, static_cast<T*>(out), g,
        E, C, d, ks, y_split);
    return (int)cudaGetLastError();
  });
}
