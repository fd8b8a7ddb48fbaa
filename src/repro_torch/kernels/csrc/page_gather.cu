// Page-table gather: the paged KV cache's logical view.
//
// Replaces the Pallas TPU kernel repro/kernels/page_gather.py
// (page_gather, pallas_call at :57).  Same function, bit for bit:
// pool (P, page, ...) and page_table (B, n_pp) int32 -> out
// (B, n_pp*page, ...) = pool[page_table] with the page axis folded in.
//
// Bound on the H100: bytes, 2x the output (each page row read once and
// written once) plus the table; there is no arithmetic.
//
// Design: one block per (batch row, logical page).  The block reads its own
// page id from the table (where the TPU kernel had the id prefetched into
// scalar memory) and copies the page's contiguous row of
// page*KV*hd*elem bytes with 16-byte vector loads and stores, neighbouring
// threads on neighbouring addresses.  A page id outside [0, P) traps: it is
// a bug in the caller's tables, and a loud fault beats silent garbage.
// Reading pages in place inside decode attention (no materialized view) is
// a later PR's work; this gather stays as its oracle.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
    page_gather_kernel(const uint4* __restrict__ pool,
                       const int32_t* __restrict__ table,
                       uint4* __restrict__ out, int P, long long row_vec) {
  const long long i = blockIdx.x;  // b * n_pp + logical page
  const int page = table[i];
  if (page < 0 || page >= P) __trap();
  const uint4* src = pool + (long long)page * row_vec;
  uint4* dst = out + i * row_vec;
  for (long long t = threadIdx.x; t < row_vec; t += NT) dst[t] = src[t];
}

}  // namespace

// pool: P rows of row_bytes each; table: n_rows int32 page ids;
// out: n_rows rows of row_bytes.  row_bytes must be a multiple of 16.
extern "C" int page_gather_fwd(const void* pool, const void* table,
                               void* out, long long n_rows, int P,
                               long long row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  page_gather_kernel<<<(unsigned)n_rows, NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), static_cast<const int32_t*>(table),
      static_cast<uint4*>(out), P, row_bytes / 16);
  return (int)cudaGetLastError();
}
