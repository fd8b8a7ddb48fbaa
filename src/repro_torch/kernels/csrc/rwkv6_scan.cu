// RWKV-6 WKV recurrence: forward for training, and its backward.
//
// Forward: replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py
// (rwkv6_scan, pallas_call at :73).  Same function: per (batch, head) an
// (hd, hd) f32 state S, from zero,
//   y_t[j]       = sum_i r_t[i] (S_t[i,j] + u[i] k_t[i] v_t[j])
//   S_{t+1}[i,j] = w_t[i] S_t[i,j] + k_t[i] v_t[j]
// with r, k, v (B,T,H,hd) in the compute dtype (f32 or bf16), the decay w
// (B,T,H,hd) in f32 (the model computes it in f32 and it stays so: a bf16
// decay would change the recurrence), u (H,hd) f32, y (B,T,H,hd) in r's
// dtype.  Any T: the TPU kernel pads T with w = 1, this one loops to T.
// On request it also writes the state S_t at every CK-th step, t = 0, CK,
// 2 CK, ... (B,H,ceil(T/CK),hd,hd) f32, which the backward restarts from.
//
// Backward: the TPU package has none (it trains through autodiff of the
// lax.scan in its plain version); this is the gradient of the forward,
// given dy, walking t from T-1 down to 0 with dS = dS_{t+1} (dS_T = 0):
//   dr_t[i] = sum_j S_t[i,j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j dS[i,j] v_t[j]   + u[i] r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i dS[i,j] k_t[i]   + (r_t . (u * k_t)) dy_t[j]
//   dw_t[i] = sum_j dS[i,j] S_t[i,j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
//   then dS_t = diag(w_t) dS + r_t dy_t^T.
// dw needs S_t and dS_{t+1} at the same step.  The recurrence is never run
// backwards by dividing by w (w = exp(-exp(x)) reaches 0 in f32): each
// chunk of CK steps rebuilds its states S_t from the forward's checkpoint
// into shared memory, then walks the chunk in reverse.  dr, dk, dv come
// back in r's dtype, dw and du in f32.
//
// Bound on the H100: per (b, h, t) the forward does ~5 hd^2 FLOPs (the
// matvec and the rank-1 update) on 4 hd elements read and hd written, so
// at hd 64 (~80 FLOP per byte, f32 on the CUDA cores at 67 TFLOP/s
// against 3.35 TB/s: 20 FLOP per byte) the function is operations-bound.
// The checkpoints (hd^2 f32 every CK steps) are this design's own traffic,
// not the function's, and are left out of its bound.  The backward
// recomputes the states and does four more products, ~14 hd^2 FLOPs a
// step, also operations-bound.  Both are
// far from either bound in practice: the T steps of one (b, h) are a
// chain, so a kernel takes at least T dependent steps; with one block per
// (b, h), B*H = 128 blocks at full width, the card runs every chain at
// once and the time is T times one step's latency.
//
// Design (simple and right first).  One block of hd*R threads per (b, h),
// R = 4 threads per state column (forward) or row (backward), each holding
// hd/R elements of S in registers, strided by R so that a warp's reads of
// a staged row hit distinct banks.  The forward stages TS steps of r, k,
// v, w at a time in shared memory as f32 (coalesced loads, bf16 converted
// at the store); y_t[j] is an R-lane shuffle sum.  The backward holds a
// row's dS in registers; the three row sums (dr, dk, dw) are R-lane
// shuffles, dv's column sum a shuffle over the warp's rows and then an
// ordered sum over the warps in shared memory.  du sums B*T terms (2048 at
// full width, each ~|v.dy|): it is accumulated in f64, per (b, h) in
// registers over t, then over b by a second kernel in a fixed order, and
// rounded to f32 once (an f32 running sum drifts by ~1e-3 there).
// Every output element is written once by one thread, with no atomics:
// both directions are deterministic, run to run.  Every kernel reads the
// (B,T,H,hd) layout through strides: no transposes.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int R = 4;    // threads per state column (fwd) / row (bwd)
constexpr int TS = 32;  // steps staged per shared-memory tile (forward)
constexpr int CK = 8;   // checkpoint interval = the backward's chunk
constexpr unsigned FULL = 0xffffffffu;

// element strides of one (B, T, H, hd) tensor; the head dim is unit
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ long long at(const Strides& s, int b, long long t,
                                        int h) {
  return (long long)b * s.b + t * s.t + (long long)h * s.h;
}

__device__ __forceinline__ float lane_sum(float x) {  // over R = 4 lanes
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD * R)
    rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, T* __restrict__ y,
                     float* __restrict__ ckpt, int T_, int H, Strides sr,
                     Strides sk, Strides sv, Strides sw, Strides sy) {
  constexpr int NT = HD * R, CW = HD / R;
  __shared__ float rs[TS][HD], ks[TS][HD], vs[TS][HD], ws[TS][HD];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int j = tid / R, p = tid % R;  // column j, rows e*R + p
  float S[CW], uu[CW];
#pragma unroll
  for (int e = 0; e < CW; ++e) {
    S[e] = 0.f;
    uu[e] = u[h * HD + e * R + p];
  }
  const int nc = (T_ + CK - 1) / CK;
  float* ck = ckpt ? ckpt + (long long)(b * H + h) * nc * HD * HD : nullptr;
  for (int t0 = 0; t0 < T_; t0 += TS) {
    const int n = min(TS, T_ - t0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < n * HD; idx += NT) {
      const int tt = idx / HD, c = idx % HD;
      const long long t = t0 + tt;
      rs[tt][c] = to_f32(r[at(sr, b, t, h) + c]);
      ks[tt][c] = to_f32(k[at(sk, b, t, h) + c]);
      vs[tt][c] = to_f32(v[at(sv, b, t, h) + c]);
      ws[tt][c] = w[at(sw, b, t, h) + c];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const int t = t0 + tt;
      if (ck && t % CK == 0) {
        float* dst = ck + (long long)(t / CK) * HD * HD;
#pragma unroll
        for (int e = 0; e < CW; ++e) dst[(e * R + p) * HD + j] = S[e];
      }
      const float vj = vs[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        const int i = e * R + p;
        const float ri = rs[tt][i], ki = ks[tt][i];
        acc += ri * (S[e] + uu[e] * ki * vj);
        S[e] = ws[tt][i] * S[e] + ki * vj;
      }
      acc = lane_sum(acc);
      if (p == 0) y[at(sy, b, t, h) + j] = from_f32<T>(acc);
    }
  }
}

template <int HD>
constexpr size_t bwd_smem_bytes() {
  // states [CK][HD/R][HD*R], r k v w dy [CK][HD] each, dv partials
  // [CK][warps][HD], per-step scalars [CK][2]
  return sizeof(float) *
         (CK * HD * HD + 5 * CK * HD + CK * (HD * R / 32) * HD + 2 * CK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD * R)
    rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ ckpt,
                     const T* __restrict__ dy, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dw, double* __restrict__ du_part,
                     int T_, int H, Strides sr, Strides sk, Strides sv,
                     Strides sw, Strides sdy, Strides sdr, Strides sdk,
                     Strides sdv, Strides sdw) {
  constexpr int NT = HD * R, CW = HD / R, NW = NT / 32;
  extern __shared__ float smem[];
  float* states = smem;             // [CK][CW][NT]: S_t of the chunk
  float* rs = states + CK * CW * NT;  // [CK][HD] each
  float* ks = rs + CK * HD;
  float* vs = ks + CK * HD;
  float* ws = vs + CK * HD;
  float* dys = ws + CK * HD;
  float* dvp = dys + CK * HD;       // [CK][NW][HD]: dv per warp
  float* sc = dvp + CK * NW * HD;   // [CK][2]: r.(u*k), v.dy
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int i = tid / R, q = tid % R;  // row i, columns e*R + q
  const int lane = tid % 32, warp = tid / 32;
  const float ui = u[h * HD + i];
  float dS[CW];
#pragma unroll
  for (int e = 0; e < CW; ++e) dS[e] = 0.f;
  double du_acc = 0.0;
  const int nc = (T_ + CK - 1) / CK;
  const float* ck = ckpt + (long long)(b * H + h) * nc * HD * HD;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CK, n = min(CK, T_ - t0);
    __syncthreads();  // the previous chunk's shared memory is consumed
    for (int idx = tid; idx < n * HD; idx += NT) {
      const int s = idx / HD, cc = idx % HD;
      const long long t = t0 + s;
      rs[idx] = to_f32(r[at(sr, b, t, h) + cc]);
      ks[idx] = to_f32(k[at(sk, b, t, h) + cc]);
      vs[idx] = to_f32(v[at(sv, b, t, h) + cc]);
      ws[idx] = w[at(sw, b, t, h) + cc];
      dys[idx] = to_f32(dy[at(sdy, b, t, h) + cc]);
    }
    __syncthreads();
    // the per-step dot products, one warp per step
    for (int s = warp; s < n; s += NW) {
      float a = 0.f, bb = 0.f;
      for (int cc = lane; cc < HD; cc += 32) {
        a += rs[s * HD + cc] * u[h * HD + cc] * ks[s * HD + cc];
        bb += vs[s * HD + cc] * dys[s * HD + cc];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(FULL, a, off);
        bb += __shfl_xor_sync(FULL, bb, off);
      }
      if (lane == 0) {
        sc[2 * s] = a;
        sc[2 * s + 1] = bb;
      }
    }
    // the chunk's states S_{t0} .. S_{t0+n-1}, rebuilt from the checkpoint
    // (each thread stores and later reads only its own elements)
    {
      float S[CW];
      const float* src = ck + (long long)c * HD * HD + i * HD;
#pragma unroll
      for (int e = 0; e < CW; ++e) S[e] = src[e * R + q];
      for (int s = 0; s < n; ++s) {
#pragma unroll
        for (int e = 0; e < CW; ++e) states[(s * CW + e) * NT + tid] = S[e];
        const float wi = ws[s * HD + i], ki = ks[s * HD + i];
#pragma unroll
        for (int e = 0; e < CW; ++e)
          S[e] = wi * S[e] + ki * vs[s * HD + e * R + q];
      }
    }
    __syncthreads();  // the dot products are visible
    for (int s = n - 1; s >= 0; --s) {
      const long long t = t0 + s;
      const float ri = rs[s * HD + i], ki = ks[s * HD + i],
                  wi = ws[s * HD + i];
      const float bb = sc[2 * s + 1];
      float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        const int j = e * R + q;
        const float Se = states[(s * CW + e) * NT + tid];
        const float dyj = dys[s * HD + j], vj = vs[s * HD + j];
        pr += Se * dyj;
        pk += dS[e] * vj;
        pw += dS[e] * Se;
        // dv: this row's term, summed over the warp's rows (lanes of one
        // q are 4 apart), then over the warps after the walk
        float x = dS[e] * ki;
        x += __shfl_xor_sync(FULL, x, 4);
        x += __shfl_xor_sync(FULL, x, 8);
        x += __shfl_xor_sync(FULL, x, 16);
        if (lane < R) dvp[(s * NW + warp) * HD + j] = x;
        dS[e] = wi * dS[e] + ri * dyj;
      }
      pr = lane_sum(pr);
      pk = lane_sum(pk);
      pw = lane_sum(pw);
      du_acc += (double)(ri * ki * bb);
      if (q == 0) {
        dr[at(sdr, b, t, h) + i] = from_f32<T>(pr + ui * ki * bb);
        dk[at(sdk, b, t, h) + i] = from_f32<T>(pk + ui * ri * bb);
        dw[at(sdw, b, t, h) + i] = pw;
      }
    }
    __syncthreads();  // the dv partials are visible
    for (int idx = tid; idx < n * HD; idx += NT) {
      const int s = idx / HD, j = idx % HD;
      float x = 0.f;
#pragma unroll
      for (int wp = 0; wp < NW; ++wp) x += dvp[(s * NW + wp) * HD + j];
      x += sc[2 * s] * dys[idx];
      dv[at(sdv, b, (long long)t0 + s, h) + j] = from_f32<T>(x);
    }
  }
  if (q == 0) du_part[(b * H + h) * HD + i] = du_acc;
}

// du[h, i] = sum over b, in order, of the per-(b, h) partials
__global__ void rwkv6_du_kernel(const double* __restrict__ du_part,
                                float* __restrict__ du, int B, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  double x = 0.0;
  for (int b = 0; b < B; ++b) x += du_part[(long long)b * n + idx];
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

}  // namespace

extern "C" int rwkv6_scan_ck() { return CK; }

// strides: 15 values, (b, t, h) in elements for r, k, v, w, y in that
// order; the head dim is contiguous in all five.  u: (H, hd) f32
// contiguous; ckpt: (B, H, ceil(T/CK), hd, hd) f32 or null.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const float* w, const float* u, void* y,
                              float* ckpt, int dtype, int B, int T, int H,
                              int hd, const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  return with_elem(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      rwkv6_fwd_kernel<E, HD><<<dim3(H, B), HD * R, 0, s>>>(
          static_cast<const E*>(r), static_cast<const E*>(k),
          static_cast<const E*>(v), w, u, static_cast<E*>(y), ckpt, T, H,
          strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
          strides_at(st, 3), strides_at(st, 4));
      return (int)cudaGetLastError();
    });
  });
}

// strides: 27 values, (b, t, h) in elements for r, k, v, w, dy, dr, dk,
// dv, dw in that order; the head dim is contiguous in all nine.  u: (H, hd)
// f32; ckpt: the forward's checkpoints; du_part: (B, H, hd) f64 scratch;
// du: (H, hd) f32.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const float* ckpt, const void* dy, void* dr,
                              void* dk, void* dv, float* dw, double* du_part,
                              float* du, int dtype, int B, int T, int H,
                              int hd, const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  return with_elem(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return with_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      auto kern = rwkv6_bwd_kernel<E, HD>;
      const size_t smem = bwd_smem_bytes<HD>();
      int err = (int)cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      kern<<<dim3(H, B), HD * R, smem, s>>>(
          static_cast<const E*>(r), static_cast<const E*>(k),
          static_cast<const E*>(v), w, u, ckpt, static_cast<const E*>(dy),
          static_cast<E*>(dr), static_cast<E*>(dk), static_cast<E*>(dv), dw,
          du_part, T, H, strides_at(st, 0), strides_at(st, 1),
          strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
          strides_at(st, 5), strides_at(st, 6), strides_at(st, 7),
          strides_at(st, 8));
      err = (int)cudaGetLastError();
      if (err) return err;
      const int n = H * HD;
      rwkv6_du_kernel<<<(n + 255) / 256, 256, 0, s>>>(du_part, du, B, n);
      return (int)cudaGetLastError();
    });
  });
}
