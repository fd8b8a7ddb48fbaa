// RG-LRU gated linear recurrence (Griffin): forward for training, and its
// backward.
//
// Forward: replaces the Pallas TPU kernel repro/kernels/rglru_scan.py
// (rglru_scan, pallas_call at :60).  Same function, elementwise over the
// channels D, with the state in f32 from zero:
//   g_t = sqrt(clip(1 - a_t^2, 0, 1))
//   h_t = a_t h_{t-1} + g_t x_t
// x, a (B,T,D) in the compute dtype (f32 or bf16) -> h (B,T,D) in x's
// dtype.  Any T and any D: the TPU kernel pads both to its tile, this one
// loops to T and masks the channel tail.  On request it also writes every
// f32 state h_t (B,T,D), which the backward reads.
//
// Backward: the TPU package has none (it trains through autodiff of the
// lax.scan in its plain version); this is the gradient of the forward,
// given dy = dL/dh, walking t from T-1 down to 0 with c_T = 0:
//   dh_t = dy_t + c_{t+1}          (c_{t+1} = a_{t+1} dh_{t+1})
//   dx_t = g_t dh_t
//   da_t = dh_t (h_{t-1} - a_t x_t / g_t)     where 1 - a_t^2 > 0
//   da_t = dh_t h_{t-1}                       where 1 - a_t^2 <= 0
// h_{t-1} is read from the forward's f32 states (h_{-1} = 0), never
// recovered by dividing by a (a reaches ~0.002 at initialisation and 0
// after underflow).  The value at g = 0: there the clip is saturated, so
// g does not depend on a and the gate term is 0.  bf16 rounds every
// a >= 0.998046875 to 1.0, and autodiff of the plain version then gives
// da = -inf (0 * inf = NaN where x = 0) through sqrt'(0); this kernel
// gives the clip's own derivative, 0, and so a finite da = dh h_{t-1}.
// dx and da come back in x's dtype.
//
// Bound on the H100: bytes.  The forward does ~6 FLOPs a step on 2 inputs
// read and 1 output written (f32 or bf16: ~1 FLOP per byte against the
// card's 20 f32 FLOPs per byte), the backward ~10 FLOPs on 3 inputs and 2
// outputs.  The f32 states (4 bytes a step) are this design's own traffic,
// not the function's, and are left out of its bound.
//
// Design (simple and right first).  One thread per (b, channel) chain with
// its state in a register; 64 threads a block over 64 neighbouring
// channels, so every load and store of a warp is one contiguous run.  At
// full width B*D = 4*2560 = 10,240 chains, ~2.4 warps an SM, far too few
// to hide the memory's latency by warps: the inputs of a step do not
// depend on h, so each thread loads U steps ahead into registers and
// loads the next U steps before it computes the current ones (double
// buffer), keeping 2U loads of each input in flight.  Every output
// element is written once by one thread, with no atomics: both directions
// are deterministic, run to run.  The arithmetic is rounded step by step
// (__fmul_rn / __fadd_rn, no FMA contraction) in the plain version's
// order.  Every kernel reads the (B,T,D) inputs through (b, t) strides:
// no transposes.
#include "common.cuh"

namespace {

constexpr int NT = 64;      // threads (channels) per block
constexpr int U_FWD = 16;   // steps loaded ahead, forward (2 inputs)
constexpr int U_BWD = 8;    // steps loaded ahead, backward (4 inputs)

// element strides of one (B, T, D) tensor; the channel dim is unit
struct Strides {
  long long b, t;
};

__device__ __forceinline__ float gate(float a) {
  return sqrtf(fminf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f), 1.f));
}

template <typename T>
__global__ void __launch_bounds__(NT)
    rglru_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                     T* __restrict__ y, float* __restrict__ hs, int T_,
                     int D, Strides sx, Strides sa) {
  constexpr int U = U_FWD;
  const int d = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const T* xb = x + b * sx.b + d;
  const T* ab = a + b * sa.b + d;
  const long long o = (long long)b * T_ * D + d;  // y, hs: contiguous
  T xr[U], ar[U], xn[U], an[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < T_) {
      xr[u] = xb[u * sx.t];
      ar[u] = ab[u * sa.t];
    }
  }
  float h = 0.f;
  for (int t0 = 0; t0 < T_; t0 += U) {
    const int t1 = t0 + U;
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the next U steps, in flight
      if (t1 + u < T_) {
        xn[u] = xb[(long long)(t1 + u) * sx.t];
        an[u] = ab[(long long)(t1 + u) * sa.t];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < T_) {
        const float at = to_f32(ar[u]);
        h = __fadd_rn(__fmul_rn(at, h),
                      __fmul_rn(gate(at), to_f32(xr[u])));
        y[o + (long long)t * D] = from_f32<T>(h);
        if (hs != nullptr) hs[o + (long long)t * D] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xr[u] = xn[u];
      ar[u] = an[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                     const float* __restrict__ hs, const T* __restrict__ dy,
                     T* __restrict__ dx, T* __restrict__ da, int T_, int D,
                     Strides sx, Strides sa, Strides sdy) {
  constexpr int U = U_BWD;
  const int d = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const T* xb = x + b * sx.b + d;
  const T* ab = a + b * sa.b + d;
  const T* db = dy + b * sdy.b + d;
  const long long o = (long long)b * T_ * D + d;  // hs, dx, da: contiguous
  // tile k holds steps T-1-k*U-u, u = 0..U-1 (walking down)
  T xr[U], ar[U], yr[U], xn[U], an[U], yn[U];
  float hr[U], hn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = T_ - 1 - u;
    if (t >= 0) {
      xr[u] = xb[(long long)t * sx.t];
      ar[u] = ab[(long long)t * sa.t];
      yr[u] = db[(long long)t * sdy.t];
      hr[u] = t > 0 ? hs[o + (long long)(t - 1) * D] : 0.f;
    }
  }
  float c = 0.f;  // a_{t+1} dh_{t+1}
  for (int t0 = T_ - 1; t0 >= 0; t0 -= U) {
    const int t1 = t0 - U;
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the next U steps down, in flight
      const int t = t1 - u;
      if (t >= 0) {
        xn[u] = xb[(long long)t * sx.t];
        an[u] = ab[(long long)t * sa.t];
        yn[u] = db[(long long)t * sdy.t];
        hn[u] = t > 0 ? hs[o + (long long)(t - 1) * D] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float at = to_f32(ar[u]), xt = to_f32(xr[u]);
        const float dh = __fadd_rn(to_f32(yr[u]), c);
        const float g = gate(at);
        const float dgx = g > 0.f ? __fdiv_rn(__fmul_rn(at, xt), g) : 0.f;
        dx[o + (long long)t * D] = from_f32<T>(__fmul_rn(g, dh));
        da[o + (long long)t * D] =
            from_f32<T>(__fmul_rn(dh, __fsub_rn(hr[u], dgx)));
        c = __fmul_rn(at, dh);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xr[u] = xn[u];
      ar[u] = an[u];
      yr[u] = yn[u];
      hr[u] = hn[u];
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

Strides strides_at(const long long* st, int i) {
  return Strides{st[2 * i], st[2 * i + 1]};
}

}  // namespace

// strides: 4 values, (b, t) in elements for x and a; the channel dim is
// contiguous in both.  y (B, T, D) contiguous in x's dtype; hs (B, T, D)
// contiguous f32 or null.
extern "C" int rglru_scan_fwd(const void* x, const void* a, void* y,
                              float* hs, int dtype, int B, int T, int D,
                              const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return with_elem(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    rglru_fwd_kernel<E><<<dim3((D + NT - 1) / NT, B), NT, 0, s>>>(
        static_cast<const E*>(x), static_cast<const E*>(a),
        static_cast<E*>(y), hs, T, D, strides_at(st, 0), strides_at(st, 1));
    return (int)cudaGetLastError();
  });
}

// strides: 6 values, (b, t) in elements for x, a and dy; the channel dim
// is contiguous in all three.  hs: the forward's f32 states (B, T, D)
// contiguous; dx, da (B, T, D) contiguous in x's dtype.
extern "C" int rglru_scan_bwd(const void* x, const void* a, const float* hs,
                              const void* dy, void* dx, void* da, int dtype,
                              int B, int T, int D, const long long* st,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return with_elem(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    rglru_bwd_kernel<E><<<dim3((D + NT - 1) / NT, B), NT, 0, s>>>(
        static_cast<const E*>(x), static_cast<const E*>(a), hs,
        static_cast<const E*>(dy), static_cast<E*>(dx), static_cast<E*>(da),
        T, D, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2));
    return (int)cudaGetLastError();
  });
}
