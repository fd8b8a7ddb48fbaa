// AdamW's update of one parameter leaf in one pass.
//
// Replaces no TPU kernel: the JAX package's AdamW (repro/optim/optimizers.py)
// is plain array operations that XLA fuses.  The port's plain version
// (kernels/adamw.py, adamw_plain) runs them as ~15 PyTorch passes a leaf,
// each reading and writing leaf-sized f32 temporaries: ~160 bytes a
// parameter where the arithmetic needs 28.
//
// Same arithmetic as the plain version, element by element and in its order:
//   gf = float(g * G(scale))         the clip, rounded in g's dtype (bf16 too)
//   m' = m b1 + gf (1 - b1)
//   v' = v b2 + (gf (1 - b2)) gf
//   p' = P(p - (m'/bc1 / (sqrt(v'/bc2) + eps) + p wd) lr)
// Every product, sum, quotient and root is a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, ...), which the compiler never contracts into an
// FMA, so each element rounds exactly as the plain version's separate passes
// do.  The clip scale and the bias corrections are read through device
// pointers (0-d tensors the optimizer computed on the device): no host
// synchronisation.  (1 - b1) and (1 - b2) come from the caller, computed in
// double and rounded to float as PyTorch rounds a Python scalar.
//
// Bound on the H100: bytes.  p, g, m and v are read once and p', m' and v'
// written once to fresh buffers (the update stays functional): 28 bytes an
// f32 parameter, 32.95 GB for olmo-1b's 1,176,764,416, 9.84 ms at 3.35 TB/s.
//
// Design: a streaming grid-stride loop with no shared memory and no reuse.
// Each thread moves 16-byte vectors of the narrower of p's and g's types (4
// elements for f32 leaves, 8 where either is bf16; m and v as two or four
// float4s), with enough resident blocks on every SM (the occupancy the
// compiler allows) to keep the loads in flight.  The tail past the last whole
// vector, and every element of a leaf whose pointers are not all 16-byte
// aligned, take the same element function one at a time.  Offsets are 64-bit.
#include "common.cuh"

namespace {

constexpr int NT = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps, lr, wd;
};

template <typename T, int N>
struct alignas(16) Pack {
  T x[N];
};

template <typename P, typename G>
__device__ __forceinline__ void adamw_one(P& p, const G g, float& m, float& v,
                                          const bool clip, const G scale,
                                          const float bc1, const float bc2,
                                          const Hyper& h) {
  const float gf =
      clip ? to_f32(from_f32<G>(__fmul_rn(to_f32(g), to_f32(scale))))
           : to_f32(g);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(gf, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(gf, h.omb2), gf));
  float step = __fdiv_rn(m, bc1);
  step = __fdiv_rn(step, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  const float pf = to_f32(p);
  step = __fmul_rn(__fadd_rn(step, __fmul_rn(pf, h.wd)), h.lr);
  p = from_f32<P>(__fsub_rn(pf, step));
}

// elements a thread moves at once: 16 bytes of the narrower leaf type
template <typename P, typename G>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (sizeof(P) < sizeof(G) ? sizeof(P) : sizeof(G));
}

template <typename P, typename G, bool VEC>
__global__ void __launch_bounds__(NT)
    adamw_kernel(const P* __restrict__ p, const G* __restrict__ g,
                 const float* __restrict__ m, const float* __restrict__ v,
                 P* __restrict__ p_out, float* __restrict__ m_out,
                 float* __restrict__ v_out, long long n,
                 const float* __restrict__ scale_ptr,
                 const float* __restrict__ bc1_ptr,
                 const float* __restrict__ bc2_ptr, Hyper h) {
  const bool clip = scale_ptr != nullptr;
  const G scale = from_f32<G>(clip ? *scale_ptr : 1.0f);
  const float bc1 = *bc1_ptr, bc2 = *bc2_ptr;
  const long long stride = (long long)gridDim.x * NT;
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  long long done = 0;
  if (VEC) {
    constexpr int E = vec_elems<P, G>();
    const long long nv = n / E;
    for (long long i = t; i < nv; i += stride) {
      const long long o = i * E;
      Pack<P, E> pv = *reinterpret_cast<const Pack<P, E>*>(p + o);
      const Pack<G, E> gv = *reinterpret_cast<const Pack<G, E>*>(g + o);
      Pack<float, E> mv = *reinterpret_cast<const Pack<float, E>*>(m + o);
      Pack<float, E> vv = *reinterpret_cast<const Pack<float, E>*>(v + o);
#pragma unroll
      for (int k = 0; k < E; ++k)
        adamw_one(pv.x[k], gv.x[k], mv.x[k], vv.x[k], clip, scale, bc1, bc2,
                  h);
      *reinterpret_cast<Pack<P, E>*>(p_out + o) = pv;
      *reinterpret_cast<Pack<float, E>*>(m_out + o) = mv;
      *reinterpret_cast<Pack<float, E>*>(v_out + o) = vv;
    }
    done = nv * E;
  }
  for (long long i = done + t; i < n; i += stride) {
    P pi = p[i];
    float mi = m[i], vi = v[i];
    adamw_one(pi, g[i], mi, vi, clip, scale, bc1, bc2, h);
    p_out[i] = pi;
    m_out[i] = mi;
    v_out[i] = vi;
  }
}

template <typename P, typename G, bool VEC>
int launch(const void* p, const void* g, const void* m, const void* v,
           void* p_out, void* m_out, void* v_out, long long n,
           const void* scale, const void* bc1, const void* bc2,
           const Hyper& h, cudaStream_t stream) {
  auto kernel = adamw_kernel<P, G, VEC>;
  // resident blocks of this instantiation on a full card, found once
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        0);
    if (e != cudaSuccess) return (int)e;
    cap = n_sm * (per_sm > 0 ? per_sm : 1);
  }
  const long long per_thread = VEC ? vec_elems<P, G>() : 1;
  const long long want = (n + per_thread * NT - 1) / (per_thread * NT);
  const int blocks = (int)(want < cap ? want : cap);
  kernel<<<blocks, NT, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const G*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<P*>(p_out), static_cast<float*>(m_out),
      static_cast<float*>(v_out), n, static_cast<const float*>(scale),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2), h);
  return (int)cudaGetLastError();
}

template <typename P, typename G>
int launch_aligned(const void* p, const void* g, const void* m,
                   const void* v, void* p_out, void* m_out, void* v_out,
                   long long n, const void* scale, const void* bc1,
                   const void* bc2, const Hyper& h, cudaStream_t stream) {
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(p) |
      reinterpret_cast<unsigned long long>(g) |
      reinterpret_cast<unsigned long long>(m) |
      reinterpret_cast<unsigned long long>(v) |
      reinterpret_cast<unsigned long long>(p_out) |
      reinterpret_cast<unsigned long long>(m_out) |
      reinterpret_cast<unsigned long long>(v_out);
  if (align % 16 == 0)
    return launch<P, G, true>(p, g, m, v, p_out, m_out, v_out, n, scale, bc1,
                              bc2, h, stream);
  return launch<P, G, false>(p, g, m, v, p_out, m_out, v_out, n, scale, bc1,
                             bc2, h, stream);
}

}  // namespace

// p, g: n elements of p_type / g_type (kF32 or kBF16); m, v: n f32; the three
// outputs fresh buffers of p's, m's and v's types.  scale (nullable: no clip),
// bc1 and bc2: one f32 each on the device.
extern "C" int adamw_fwd(const void* p, const void* g, const void* m,
                         const void* v, void* p_out, void* m_out, void* v_out,
                         long long n, int p_type, int g_type,
                         const void* scale, const void* bc1, const void* bc2,
                         float b1, float omb1, float b2, float omb2,
                         float eps, float lr, float wd, void* stream) {
  if (n <= 0 || bc1 == nullptr || bc2 == nullptr)
    return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, lr, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_type == kF32 && g_type == kF32)
    return launch_aligned<float, float>(p, g, m, v, p_out, m_out, v_out, n,
                                        scale, bc1, bc2, h, s);
  if (p_type == kF32 && g_type == kBF16)
    return launch_aligned<float, __nv_bfloat16>(p, g, m, v, p_out, m_out,
                                                v_out, n, scale, bc1, bc2, h,
                                                s);
  if (p_type == kBF16 && g_type == kF32)
    return launch_aligned<__nv_bfloat16, float>(p, g, m, v, p_out, m_out,
                                                v_out, n, scale, bc1, bc2, h,
                                                s);
  if (p_type == kBF16 && g_type == kBF16)
    return launch_aligned<__nv_bfloat16, __nv_bfloat16>(
        p, g, m, v, p_out, m_out, v_out, n, scale, bc1, bc2, h, s);
  return (int)cudaErrorInvalidValue;
}
