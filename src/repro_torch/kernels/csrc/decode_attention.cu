// Single-token GQA decode attention over a ring / paged-view KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, pallas_call at :102).  Same function: q (B,1,H,hd),
// k/v (B,L,KV,hd), valid (B,L) -> (B,1,H,hd) in q's dtype; scale hd^-0.5;
// probabilities of dead slots are 0 (the Pallas kernel re-masks them at
// :56-58); at least one slot per row is valid.
//
// Bound on the H100: bytes.  Each step reads the live K and V rows once,
// 2 * B * L * KV * hd * 2 bytes in bf16, and does 4 * H * hd FLOPs per
// (row, slot): H/KV FLOPs per byte (4 for llama3.2-1b), far below the
// card's ~295.
//
// Design: one block of 8 warps per (kv head, batch row), so the whole
// query group (H/KV heads) reads each K/V row from device memory once.
// Each key is handled by HD/VEC lanes with one 16-byte vector load each
// (VEC elements), so a warp covers 32*VEC/HD keys per step with fully
// used 16-byte accesses; a dead slot's row is never loaded.  Every lane
// group keeps its own online-softmax state (m, l, acc) in f32 registers;
// the states merge first across the warp with shuffles, then across the
// 8 warps through shared memory.  With B*KV blocks (64 at the serving
// shape) the card is under-filled: splitting L over more blocks
// (flash-decoding) is a later PR's work.
#include "common.cuh"

namespace {

constexpr int NW = 8;  // warps per block

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
  __device__ static void load(const T* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  }
};

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(NW * 32)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ valid,
                  T* __restrict__ o, int L, int group, long long qsb,
                  long long qsh, long long ksb, long long ksl, long long ksh,
                  long long vsb, long long vsl, long long vsh,
                  long long valsb, long long osb, long long osh,
                  float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = HD / VEC;   // lanes per key
  constexpr int KPW = 32 / LPK;   // keys per warp step
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "bad head dim");
  __shared__ float sm_m[NW][GMAX], sm_l[NW][GMAX], sm_acc[NW][GMAX][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPK;  // which key of the warp step
  const int sl = lane % LPK;   // which VEC-slice of the head dim

  float qv[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < group) {
      Vec<T>::load(q + b * qsb + (kvh * group + g) * qsh + sl * VEC, qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[g][e] = 0.f;
    }
  }
  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const uint8_t* vb = valid + b * valsb;
  const T* kb = k + b * ksb + kvh * ksh + sl * VEC;
  const T* vbase = v + b * vsb + kvh * vsh + sl * VEC;
  for (int base = warp * KPW; base < L; base += NW * KPW) {
    const int key = base + sub;
    const bool live = key < L && vb[key] != 0;
    float kf[VEC];
    if (live) {
      Vec<T>::load(kb + key * ksl, kf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
    }
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) part = fmaf(qv[g][e], kf[e], part);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      s[g] = part * scale;
    }
    if (live) {
      float vf[VEC];
      Vec<T>::load(vbase + key * vsl, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float m_new = fmaxf(m[g], s[g]);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s[g] - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  // merge the KPW key-groups of this warp (lanes with equal sl)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), ao = expf(mo - mn);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ac = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ac * ao;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (sl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][sl * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps: one output element per thread
  for (int i = threadIdx.x; i < group * HD; i += NW * 32) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float a = expf(sm_m[w][g] - mx);
      den = fmaf(sm_l[w][g], a, den);
      num = fmaf(sm_acc[w][g][d], a, num);
    }
    o[b * osb + (kvh * group + g) * osh + d] =
        from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD, int GMAX>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* o, int B, int L, int H, int KV, const long long* st,
           float scale, cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_kernel<T, HD, GMAX><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(o), L, H / KV, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_group(const void* q, const void* k, const void* v,
                   const void* valid, void* o, int B, int L, int H, int KV,
                   const long long* st, float scale, cudaStream_t stream) {
  const int group = H / KV;
  if (group <= 4)
    return launch<T, HD, 4>(q, k, v, valid, o, B, L, H, KV, st, scale,
                            stream);
  if (group <= 8)
    return launch<T, HD, 8>(q, k, v, valid, o, B, L, H, KV, st, scale,
                            stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const void* valid, void* o, int B, int L, int H, int KV,
                int hd, const long long* st, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 64:
      return dispatch_group<T, 64>(q, k, v, valid, o, B, L, H, KV, st,
                                   scale, stream);
    case 128:
      return dispatch_group<T, 128>(q, k, v, valid, o, B, L, H, KV, st,
                                    scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides in elements: q (b, h), k (b, l, h), v (b, l, h), valid (b),
// o (b, h); the head dim is contiguous, valid is uint8.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    int dtype, int B, int L, int H, int KV, int hd, long long qsb,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, long long valsb,
    long long osb, long long osh, float scale, void* stream) {
  const long long st[11] = {qsb, qsh, ksb, ksl, ksh, vsb,
                            vsl, vsh, valsb, osb, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_hd<float>(q, k, v, valid, o, B, L, H, KV, hd, st,
                                scale, s);
    case kBF16:
      return dispatch_hd<__nv_bfloat16>(q, k, v, valid, o, B, L, H, KV, hd,
                                        st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
