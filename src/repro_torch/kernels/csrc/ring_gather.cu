// Ring-buffer row gather: the stale read of the ParameterDB delta ring.
//
// Replaces the Pallas TPU kernel repro/kernels/ring_gather.py (ring_gather,
// pallas_call at :54).  Same function, bit for bit: hist (size, N) and a
// scalar idx in [0, size) -> hist[idx] (N,).  The training engine keeps
// each (delay, dtype) group of parameters packed into one such row, so a
// stale read of the whole model is one launch per group.
//
// Bound on the H100: bytes, 2 * N * elem (the row read once and written
// once); there is no arithmetic.  At llama3.2-1b's full width the f32 row
// holds ~1.236e9 elements (4.9 GB), so the copy takes ~2.95 ms at 3.35 TB/s.
//
// Design: the row index lives in device memory and every thread reads it
// there (where the TPU kernel had it prefetched into scalar memory), so the
// caller never synchronises with the host to learn it.  An index outside
// [0, size) traps: it is a bug in the caller's ring pointer, and a loud
// fault beats a silent read of the wrong version.  All offsets are 64-bit:
// at full width idx * N passes 2^31 for idx >= 2.  The copy moves 16-byte
// vectors where the row's byte length and both pointers allow it (the
// engine pads rows to 128 elements, so it always does) and narrower units
// otherwise; a grid-stride loop with four independent loads in flight per
// thread keeps enough bytes moving to cover the memory latency.
#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename V>
__global__ void __launch_bounds__(NT)
    ring_gather_kernel(const V* __restrict__ hist,
                       const int32_t* __restrict__ idx,
                       V* __restrict__ out, int size, long long n) {
  const int row = *idx;
  if (row < 0 || row >= size) __trap();
  const V* __restrict__ src = hist + (long long)row * n;
  const long long stride = (long long)gridDim.x * NT;
  long long t = (long long)blockIdx.x * NT + threadIdx.x;
  for (; t + 3 * stride < n; t += 4 * stride) {
    const V a = src[t], b = src[t + stride], c = src[t + 2 * stride],
            d = src[t + 3 * stride];
    out[t] = a;
    out[t + stride] = b;
    out[t + 2 * stride] = c;
    out[t + 3 * stride] = d;
  }
  for (; t < n; t += stride) out[t] = src[t];
}

int blocks_for(long long n) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      n_sm = 132;
  }
  const long long want = (n + NT - 1) / NT;
  const long long cap = 8LL * n_sm;  // 8 blocks of 256 fill an SM
  return (int)(want < cap ? want : cap);
}

template <typename V>
int launch(const void* hist, const void* idx, void* out, int size,
           long long row_bytes, cudaStream_t stream) {
  const long long n = row_bytes / (long long)sizeof(V);
  ring_gather_kernel<V><<<blocks_for(n), NT, 0, stream>>>(
      static_cast<const V*>(hist), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), size, n);
  return (int)cudaGetLastError();
}

}  // namespace

// hist: size rows of row_bytes each; idx: one int32 on the device; out:
// row_bytes.  The widest unit (16, 8, 4 or 2 bytes) that divides row_bytes
// and both pointers' alignment is used.
extern "C" int ring_gather_fwd(const void* hist, const void* idx, void* out,
                               int size, long long row_bytes, void* stream) {
  if (row_bytes <= 0 || size <= 0 || row_bytes % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long align =
      (unsigned long long)row_bytes |
      reinterpret_cast<unsigned long long>(hist) |
      reinterpret_cast<unsigned long long>(out);
  if (align % 16 == 0) return launch<uint4>(hist, idx, out, size, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(hist, idx, out, size, row_bytes, s);
  if (align % 4 == 0)
    return launch<uint32_t>(hist, idx, out, size, row_bytes, s);
  return launch<uint16_t>(hist, idx, out, size, row_bytes, s);
}
