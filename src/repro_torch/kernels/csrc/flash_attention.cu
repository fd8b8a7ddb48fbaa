// Causal / sliding-window GQA flash attention forward for prefill.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :114).  Same function: q (B,S,H,hd),
// k/v (B,S,KV,hd) -> (B,S,H,hd) in q's dtype; scale hd^-0.5; kv head =
// h / (H/KV); online softmax in f32; keys masked by kpos < S, causal
// kpos <= qpos and window kpos > qpos - window.  Sq == Sk only.
//
// Bound on the H100: a causal prefill does 4 * hd * H * B * S(S+1)/2
// FLOPs on B*S*(2H+2KV)*hd*2 bytes (q, k, v read, o written), about
// 0.4*S FLOP/byte for llama3.2-1b's heads against the card's ~295 in bf16:
// bytes bound the ideal kernel below S ~ 740, operations above.  This
// kernel, on the CUDA cores without tensor cores, is far from either.
//
// Design (simple and right first; no tensor cores yet): one block of 256
// threads per (64-row q tile, q head, batch row).  The q tile and each
// 64-key K/V tile are staged in shared memory as f32; each thread owns a
// 4x4 patch of the 64x64 score tile and a 4 x (HD/16) patch of the output
// accumulator, so the running max m and sum l stay in registers and a row's
// reductions are 16-lane shuffles.  Tiles entirely above the diagonal (or
// entirely behind the window) are never visited; probabilities of dead keys
// are re-masked to 0, so a row whose tile holds no live key adds nothing.
// The kernel reads the (B,S,H,hd) layout through strides: no transposes.
// The products run on the CUDA cores in f32: making them wgmma/mma is a
// later PR's work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 row groups x 16 lanes

template <int HD>
constexpr size_t smem_bytes() {
  // Qs [BQ][HD+1], Ks [BK][HD+1], Vs [BK][HD], Ps [BQ][BK+1], all f32
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S,
                     int hd, int group, long long qsb, long long qss,
                     long long qsh, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, long long osb, long long oss,
                     long long osh, float scale, int causal, int window) {
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

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * (HD + 1) + d] =
        (s < S && d < hd) ? to_f32(qb[(long long)s * qss + d]) : 0.f;
  }

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
      Ks[r * (HD + 1) + d] = in ? to_f32(kb[(long long)s * kss + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[(long long)s * vss + d]) : 0.f;
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

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[(long long)s * oss + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int hd, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, hd, H / KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int hd, const long long* st,
                float scale, int causal, int window, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, S, H, KV, hd, st, scale, causal,
                         window, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, S, H, KV, hd, st, scale, causal,
                         window, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, S, H, KV, hd, st, scale, causal,
                          window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: q (b, s, h), k (b, s, h), v (b, s, h), o (b, s, h) in elements;
// the head dim is contiguous in all four.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int KV, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, float scale, int causal, int window,
    void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_hd<float>(q, k, v, o, B, S, H, KV, hd, st, scale,
                                causal, window, s);
    case kBF16:
      return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, st,
                                        scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
