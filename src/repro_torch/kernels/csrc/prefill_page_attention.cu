// Chunked-prefill GQA attention: one prompt chunk's queries against the
// ring context of its earlier chunks, read in place from the paged KV
// pools through the page table, plus the chunk's own keys, masked by
// absolute position.
//
// Replaces the Pallas TPU kernel repro/kernels/page_gather.py
// (prefill_page_attention, :107, pallas_call at :157, body _prefill_kernel
// :66-102) together with the page_gather before it (:35, pallas_call at
// :57).  Same function: q (B,C,H,hd); the pools k_pool/v_pool (P,page,KV,hd)
// and page_table (B,n_pp) int32, whose logical view pool[page_table] is the
// ring context (B,L,KV,hd), L = n_pp * page; k_new/v_new (B,C,KV,hd);
// ctx_pos (B,L) int32 (negative = dead slot); q_pos (B,C) int32 ->
// (B,C,H,hd) in q's dtype.  Key j (ring slots, then the chunk's keys) is
// live for query row i iff 0 <= kpos_j <= qpos_i and, with a window,
// kpos_j > qpos_i - window; scale hd^-0.5; online softmax in f32;
// probabilities of dead keys are exactly 0 and the denominator is clamped
// at 1e-30, so a row with no live key writes 0.  Context slot j sits at
// pool[page_table[b, j / page], j % page]; a page id outside [0, P) that
// would be read traps.
//
// Bound on the H100: bytes at the serving shapes.  A chunk of C tokens
// over a ring of L slots does 4 * hd * H * (live pairs) FLOPs, at most
// 4 * hd * H * C * (L + C), on (C*(2H + 2KV) + 2*L*KV) * hd * elem bytes:
// at llama3.2-1b's heads about 2*C FLOP per byte when the ring is full, so
// C = 128 sits near the card's ~295 bf16 FLOP/byte ridge.  Reading the
// pages in place drops the gathered copy of the ring the Pallas path
// writes and reads again (and two page_gather launches a layer a chunk).
//
// Rows.  The rows of a kv head are its query group times the chunk,
// ordered token-major (row r = token r / group, head kvh * group +
// r % group), so a block spans the whole group for a run of chunk tokens
// and reads each K/V tile once for all of it.  A row's result depends only
// on its own query and the keys: not on B, not on the other rows.
//
// Two element types, two designs; neither falls back to the other.
//
// bf16: the tensor cores (mma.sync m16n8k16, hopper_mma.cuh), f32
// accumulators.  One block per (32 packed rows, key split, kv head, batch
// row) of 2 x NKP warps: each of the two 16-row groups has NKP warps, and
// each of those takes its own part of every key tile (NKP = 2 parts of 64
// keys up to head dim 128; 4 of 16 at 256, where a warp's O accumulator
// alone is 128 registers a thread); the parts' (m, l, O) merge through
// shared memory in a fixed order at the end.  At B1 C128 and llama3.2-1b's
// heads that is 128 blocks for the 132 SMs; where the rows give fewer
// (recurrentgemma-2b's one kv head: 40), the wrapper's plan splits the key
// tiles over up to 128 / blocks blocks, from (C, L, H, KV, hd) alone, never
// B: each writes its rows' (O, m, l) in f32 to scratch and the block that
// comes last for those rows merges every split's in split order (so the
// result does not depend on which block that is) through a per-(batch
// row, kv head, row tile) counter it resets to 0.  Before the walk a block
// reads its rows' positions, the table row and its keys' positions once,
// marks the keys live for some row of the block in a bit mask and lists
// the tiles holding one; only those tiles are visited, through a two-stage
// cp.async ring: 16-byte copies from pool[page_table[b, j / page],
// j % page] (or the chunk's own keys) into 128-byte-swizzled bf16 tiles,
// zero-filled for keys dead to the whole block (never read), plus the
// tile's key positions.  S = Q K^T and O += P V per warp; Q is re-read from
// shared memory every tile.  P is split into P_hi = bf16(P) and P_lo =
// bf16(P - P_hi), two A operands of P V, as the flash forward does: P
// rounded once to bf16 moved serving's first-token logits past their 2e-2
// gate there.
//
// f32: the CUDA cores (tensor cores take f32 only as TF32, which would move
// the f32 results the tests hold at 1e-4), the same in-place addressing.
// One block per (32 rows, kv head, batch row) walks the keys in 64-key
// tiles, skipping a tile only when no key in it is live for any row of the
// block; 128 threads, each a 4x4 patch of the 32x64 score tile and a
// 4 x (HD/16) patch of the accumulator; tiles in shared memory as f32 with
// rows padded to HD+1 floats; 8 loads in flight a thread before the first
// store to shared memory.
//
// Head dims up to 256 in both (smaller ones zero-padded to the next of
// 64 / 128 / 256 in bf16, 32 / 64 / 128 / 256 in f32).  C <= L: the
// chunk's keys are scattered into the pools after this kernel, on the
// same stream, so a ring that wraps inside the chunk is still read as it
// was before the chunk.
#include <climits>
#include <type_traits>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 32;     // packed query rows a block (both designs)
constexpr int MAX_SMEM = 232448;  // a block's opt-in limit on sm_90
constexpr float LOG2E = 1.4426950408889634f;

// element strides of one (B, S, heads, hd) tensor or (P, page, heads, hd)
// pool; the head dim is unit
struct Strides {
  long long b, s, h;
};

struct Args {
  Strides sq, skp, svp, skn, svn, so;
  long long pts, cps, qps;  // batch strides: page table, ctx_pos, q_pos
  int C, L, n_pp, page, P, hd, group, window;
  int nsplit;  // key splits over blocks (bf16; 1 in f32)
};

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

// a tile's key parts, one a warp of each of the two 16-row groups: 2 parts
// of 64 keys up to head dim 128; 4 of 16 at 256, where a warp's O
// accumulator alone is 128 registers a thread
template <int HD>
__host__ __device__ constexpr int tc_parts() {
  return HD > 128 ? 4 : 2;
}
template <int HD>
__host__ __device__ constexpr int tc_part_keys() {
  return HD > 128 ? 16 : 64;
}
template <int HD>
__host__ __device__ constexpr int tc_threads() {
  return 64 * tc_parts<HD>();
}

// 1024 (alignment) + Q + two stages of (K, V), then int32 arrays: two
// stages of key positions, the rows' positions, the table row, the live
// bit mask and the live tile list (with its count)
template <int HD>
size_t tc_smem_bytes(int T, int n_pp) {
  constexpr int TK = tc_parts<HD>() * tc_part_keys<HD>();
  const int n_tiles = (T + TK - 1) / TK;
  return 1024 + ROWS * HD * 2 + 2 * 2 * TK * HD * 2 +
         4 * (2 * TK + ROWS + n_pp + n_tiles * TK / 32 + n_tiles + 1);
}

__device__ __forceinline__ uint32_t align1024(void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

template <int HD>
__global__ void __launch_bounds__(tc_threads<HD>(), 1)
    prefill_page_attention_kernel_tc(
        const bf16* __restrict__ q, const bf16* __restrict__ kpool,
        const bf16* __restrict__ vpool, const int* __restrict__ ptab,
        const bf16* __restrict__ knew, const bf16* __restrict__ vnew,
        const int* __restrict__ ctx_pos, const int* __restrict__ q_pos,
        bf16* __restrict__ o, float* __restrict__ part,
        unsigned* __restrict__ counters, Args a, float scale_log2) {
  constexpr int NKP = tc_parts<HD>();
  constexpr int TC_NT = tc_threads<HD>();
  constexpr int BK = tc_part_keys<HD>();  // keys a warp takes from a tile
  constexpr int TK = NKP * BK;            // keys a tile
  constexpr int NO = HD / 2;          // O registers a thread
  constexpr int CPR = HD / 8;         // 16-byte chunks a row
  constexpr uint32_t TILE = TK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = align1024(smem_raw);
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t Qs = base;
  const uint32_t St = Qs + ROWS * HD * 2;  // stage s: K, V at St + 2 s TILE
  int* kpos_s = reinterpret_cast<int*>(gbase + ROWS * HD * 2 + 4 * TILE);
  int* qpos_s = kpos_s + 2 * TK;
  int* pt_s = qpos_s + ROWS;
  const int T = a.L + a.C;
  const int n_tiles = (T + TK - 1) / TK;
  unsigned* bits_s = reinterpret_cast<unsigned*>(pt_s + a.n_pp);
  int* list_s = reinterpret_cast<int*>(bits_s + n_tiles * TK / 32);
  __shared__ int last_s;

  const int r0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y / a.nsplit, split = blockIdx.y % a.nsplit;
  const int b = blockIdx.z;
  const int R = a.group * a.C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 1, kh = warp >> 1;
  const int* cpos = ctx_pos + b * a.cps;
  const int* qpos = q_pos + b * a.qps;
  // this split's key tiles [t_lo, t_hi) and their bit-mask words
  const int tps = (n_tiles + a.nsplit - 1) / a.nsplit;
  const int t_lo = min(n_tiles, split * tps), t_hi = min(n_tiles, t_lo + tps);
  const int w_lo = t_lo * (TK / 32), w_hi = t_hi * (TK / 32);

  // the block's query rows (zero past R and past hd)
  for (int i = tid; i < ROWS * CPR; i += TC_NT) {
    const int r = i / CPR, c = (i % CPR) * 8, rr = r0 + r;
    const bool ok = rr < R && c < a.hd;
    const bf16* src = q;
    if (ok)
      src = q + b * a.sq.b + (rr / a.group) * a.sq.s +
            (kvh * a.group + rr % a.group) * a.sq.h + c;
    cp_async16(Qs + swz<ROWS>(r, c), src, ok);
  }
  cp_async_commit();
  // rows' positions (-1 past R), the table row, the first keys' positions
  constexpr int KPT = 8;  // key positions a thread a pass
  int kp[KPT];
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int j = w_lo * 32 + tid + u * TC_NT;
    kp[u] = j < a.L ? cpos[j] : (j < T ? qpos[j - a.L] : -1);
  }
  int qp_ld = -1;
  if (tid < ROWS && r0 + tid < R) qp_ld = qpos[(r0 + tid) / a.group];
  const int* pt = ptab + b * a.pts;
  for (int i0 = tid; i0 < a.n_pp; i0 += 4 * TC_NT) {
    int x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = i0 + u * TC_NT < a.n_pp ? pt[i0 + u * TC_NT] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * TC_NT < a.n_pp) pt_s[i0 + u * TC_NT] = x[u];
  }
  if (tid < ROWS) qpos_s[tid] = qp_ld;
  __syncthreads();
  int qmin = INT_MAX, qmax = -1;
  for (int i = 0; i < ROWS; ++i) {
    const int p = qpos_s[i];
    if (p < 0) continue;
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
  // bit j of the mask: key j is live for some row of the block (a
  // superset of the live pairs); a warp's 32 consecutive keys are a word
  auto block_live = [&](int p) {
    return p >= 0 && p <= qmax && (a.window <= 0 || p > qmin - a.window);
  };
  for (int pass = 0; (w_lo + pass * KPT * (TC_NT / 32)) < w_hi; ++pass) {
    if (pass > 0) {
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int j = w_lo * 32 + (pass * KPT + u) * TC_NT + tid;
        kp[u] = j < a.L ? cpos[j] : (j < T ? qpos[j - a.L] : -1);
      }
    }
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const int word = w_lo + (pass * KPT + u) * (TC_NT / 32) + warp;
      const unsigned m = __ballot_sync(0xffffffffu, block_live(kp[u]));
      if (lane == 0 && word < w_hi) bits_s[word] = m;
    }
  }
  __syncthreads();
  // the split's tiles holding a live key, in order
  if (warp == 0) {
    int cnt = 0;
    for (int t0 = t_lo; t0 < t_hi; t0 += 32) {
      const int t = t0 + lane;
      bool live = false;
      if (t < t_hi)
        for (int w = 0; w < TK / 32; ++w)
          live = live || bits_s[t * (TK / 32) + w] != 0u;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) list_s[cnt + __popc(m & ((1u << lane) - 1u))] = t;
      cnt += __popc(m);
    }
    if (lane == 0) list_s[n_tiles] = cnt;
  }
  __syncthreads();
  const int n_live = list_s[n_tiles];

  const bf16* kpb = kpool + kvh * a.skp.h;
  const bf16* vpb = vpool + kvh * a.svp.h;
  const bf16* knb = knew + b * a.skn.b + kvh * a.skn.h;
  const bf16* vnb = vnew + b * a.svn.b + kvh * a.svn.h;
  auto issue = [&](int tile, int st) {
    const int tb = tile * TK;
    const uint32_t kd = St + st * 2 * TILE, vd = kd + TILE;
    // not unrolled: hoisted addresses of every copy would cost registers
    // the O accumulator needs at head dim 256
#pragma unroll 1
    for (int i = tid; i < TK * CPR; i += TC_NT) {
      const int r = i / CPR, c = (i % CPR) * 8, j = tb + r;
      const bool live = ((bits_s[j >> 5] >> (j & 31)) & 1u) && c < a.hd;
      const bf16 *ks = knb, *vs = vnb;
      if (live) {
        if (j < a.L) {
          const int pid = pt_s[j / a.page], slot = j % a.page;
          if (pid < 0 || pid >= a.P) __trap();
          ks = kpb + pid * a.skp.b + slot * a.skp.s + c;
          vs = vpb + pid * a.svp.b + slot * a.svp.s + c;
        } else {
          ks = knb + (j - a.L) * a.skn.s + c;
          vs = vnb + (j - a.L) * a.svn.s + c;
        }
      }
      cp_async16(kd + swz<TK>(r, c), ks, live);
      cp_async16(vd + swz<TK>(r, c), vs, live);
    }
    if (tid < TK) {
      const int j = tb + tid;
      int* dst = kpos_s + st * TK + tid;
      if (j < T)
        cp_async4(smem_u32(dst), j < a.L ? cpos + j : qpos + (j - a.L), true);
      else
        *dst = -1;
    }
  };

  if (n_live > 0) {
    issue(list_s[0], 0);
    cp_async_commit();
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int qp[2];
  qp[0] = qpos_s[16 * rg + (lane >> 2)];
  qp[1] = qpos_s[16 * rg + (lane >> 2) + 8];

  for (int it = 0; it < n_live; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it is in; every warp is done with tile it-1
    if (it + 1 < n_live) {
      issue(list_s[it + 1], (it + 1) & 1);
      cp_async_commit();
    }
    const uint32_t Ks = St + (it & 1) * 2 * TILE, Vs = Ks + TILE;
    const int* kp_t = kpos_s + (it & 1) * TK;

    // S = Q K^T: this warp's 16 rows by its half's BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // unrolled by 4, not 16: with every step's ldmatrix addresses live at
    // once the head-dim-256 kernel spilled 64 bytes at 255 registers
#pragma unroll 4
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t af[4];
      frag_a<ROWS>(af, Qs, 16 * rg, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4];
        frag_b_nk<TK>(bk, Ks, kh * BK + 16 * np, 16 * kk, lane);
        mma_bf16(s[2 * np], af, bk);
        mma_bf16(s[2 * np + 1], af, bk + 2);
      }
    }

    // mask by position, scale into the log2 domain, online softmax
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpv = kp_t[kh * BK + 8 * n + 2 * (lane & 3) + (e & 1)];
        const bool live = kpv >= 0 && kpv <= qp[i] &&
                          (a.window <= 0 || kpv > qp[i] - a.window);
        s[n][e] = live ? s[n][e] * scale_log2 : NEG_INF;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P = P_hi + P_lo as A fragments: n8 blocks 2 kk and 2 kk + 1 are the
    // key columns 0-7 and 8-15 of the k16 step kk
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = e >> 1;
        const float p0 =
            s[n][e] > 0.5f * NEG_INF ? exp2f(s[n][e] - m[i]) : 0.f;
        const float p1 =
            s[n][e + 1] > 0.5f * NEG_INF ? exp2f(s[n][e + 1] - m[i]) : 0.f;
        l[i] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const int slot = (n & 1) * 2 + i;
        p_hi[n >> 1][slot] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[n >> 1][slot] =
            pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V: V tile [key][d] read transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bv[4];
        frag_b_kn<TK>(bv, Vs, 16 * np, kh * BK + 16 * kk, lane);
        mma_bf16(acc[2 * np], p_hi[kk], bv);
        mma_bf16(acc[2 * np], p_lo[kk], bv);
        mma_bf16(acc[2 * np + 1], p_hi[kk], bv + 2);
        mma_bf16(acc[2 * np + 1], p_lo[kk], bv + 2);
      }
    }
  }

  // merge the key parts of each row group, part 0 first
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: reuse them
  // part p >= 1 of row group rg: O at xo[(p-1, rg)], (m, l) at xm[(p-1, rg)]
  float* xo = reinterpret_cast<float*>(gbase + ROWS * HD * 2);
  float* xm = xo + (NKP - 1) * 2 * (HD / 8) * 4 * 32;
  if (kh > 0) {
    const int slot = (kh - 1) * 2 + rg;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xo[((slot * (HD / 8) + n) * 4 + e) * 32 + lane] = acc[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xm[((slot * 2 + i) * 2) * 32 + lane] = m[i];
      xm[((slot * 2 + i) * 2 + 1) * 32 + lane] = l[i];
    }
  }
  __syncthreads();
  float mm[2] = {m[0], m[1]}, den[2];
  if (kh == 0) {
#pragma unroll
    for (int p = 1; p < NKP; ++p)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mm[i] = fmaxf(mm[i],
                      xm[((((p - 1) * 2 + rg) * 2 + i) * 2) * 32 + lane]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float w = exp2f(m[i] - mm[i]);
      den[i] = l[i] * w;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * i] *= w;
        acc[n][2 * i + 1] *= w;
      }
    }
#pragma unroll
    for (int p = 1; p < NKP; ++p) {
      const int slot = (p - 1) * 2 + rg;
      float w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        w[i] = exp2f(xm[((slot * 2 + i) * 2) * 32 + lane] - mm[i]);
        den[i] = fmaf(xm[((slot * 2 + i) * 2 + 1) * 32 + lane], w[i], den[i]);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(xo[((slot * (HD / 8) + n) * 4 + e) * 32 + lane],
                           w[e >> 1], acc[n][e]);
    }
  }

  // the output of row group rg from acc / den (warps of part 0)
  auto store_out = [&]() {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = e >> 1;
        const int r = r0 + 16 * rg + (lane >> 2) + 8 * i;
        const int d = 8 * n + 2 * (lane & 3);
        const float inv = 1.f / fmaxf(den[i], 1e-30f);
        if (r < R && d < a.hd) {
          bf16* dst = o + b * a.so.b + (r / a.group) * a.so.s +
                      (kvh * a.group + r % a.group) * a.so.h + d;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[n][e] * inv, acc[n][e + 1] * inv);
        }
      }
    }
  };
  if (a.nsplit == 1) {
    if (kh == 0) store_out();
    return;
  }

  // key splits over blocks: each writes its rows' (O, m, l) in fragment
  // order; the block that comes last for its (batch row, kv head, row
  // tile) merges every split's in split order and resets the counter
  constexpr int PW = (HD / 8) * 4 * 32 + 2 * 2 * 32;  // floats a warp
  const long long cell =
      ((long long)b * (gridDim.y / a.nsplit) + kvh) * gridDim.x + blockIdx.x;
  if (kh == 0) {
    float* pp = part + ((cell * a.nsplit + split) * 2 + rg) * PW;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pp[(n * 4 + e) * 32 + lane] = acc[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pp[(HD / 8) * 128 + (2 * i) * 32 + lane] = mm[i];
      pp[(HD / 8) * 128 + (2 * i + 1) * 32 + lane] = den[i];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(counters + cell, 1u) == (unsigned)(a.nsplit - 1);
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (kh == 0) {
    const float* p0 = part + cell * a.nsplit * 2 * PW + rg * PW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mm[i] = NEG_INF;
      for (int sp = 0; sp < a.nsplit; ++sp)
        mm[i] = fmaxf(mm[i], __ldcg(p0 + sp * 2 * PW + (HD / 8) * 128 +
                                    (2 * i) * 32 + lane));
      den[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const float* ps = p0 + sp * 2 * PW;
      float w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        w[i] = exp2f(__ldcg(ps + (HD / 8) * 128 + (2 * i) * 32 + lane) -
                     mm[i]);
        den[i] = fmaf(__ldcg(ps + (HD / 8) * 128 + (2 * i + 1) * 32 + lane),
                      w[i], den[i]);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(__ldcg(ps + (n * 4 + e) * 32 + lane), w[e >> 1],
                           acc[n][e]);
    }
    store_out();
  }
  if (tid == 0) counters[cell] = 0u;
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BK = 64;    // keys a tile
constexpr int NT = 128;   // threads: 8 row groups x 16 lanes
constexpr int LOADS = 8;  // K/V tile loads in flight a thread
static_assert(ROWS * 32 % (NT * LOADS) == 0 && BK * 32 % (NT * LOADS) == 0,
              "tile loads must divide evenly");

template <int HD>
size_t f32_smem_bytes(int n_pp) {
  // Qs [ROWS][HD+1], Ks [BK][HD+1], Vs [BK][HD], Ps [ROWS][BK+1] f32, row
  // positions [ROWS], key positions [BK] and the table row [n_pp] int32
  return sizeof(float) * (ROWS * (HD + 1) + BK * (HD + 1) + BK * HD +
                          ROWS * (BK + 1)) +
         sizeof(int) * (ROWS + BK + n_pp);
}

template <int HD>
__global__ void __launch_bounds__(NT) prefill_page_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ kpool,
    const float* __restrict__ vpool, const int* __restrict__ ptab,
    const float* __restrict__ knew, const float* __restrict__ vnew,
    const int* __restrict__ ctx_pos, const int* __restrict__ q_pos,
    float* __restrict__ o, Args a, float scale) {
  constexpr int DPT = HD / 16;  // accumulator dims a thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + ROWS * (HD + 1);
  float* Vs = Ks + BK * (HD + 1);
  float* Ps = Vs + BK * HD;
  int* qp_s = reinterpret_cast<int*>(Ps + ROWS * (BK + 1));
  int* kp_s = qp_s + ROWS;
  int* pt_s = kp_s + BK;

  const int r0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.group, L = a.L, C = a.C, hd = a.hd;
  const int R = group * C;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // lane within the row group
  const int* cpos = ctx_pos + b * a.cps;
  const int* qpos = q_pos + b * a.qps;

  // the block's query rows and their positions (-1: past the last row),
  // the table row
  for (int i0 = tid; i0 < ROWS * HD; i0 += NT * LOADS) {
    float x[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * NT;
      const int r = r0 + i / HD, d = i % HD;
      x[u] = 0.f;
      if (r < R && d < hd) {
        const int t = r / group, h = kvh * group + r % group;
        x[u] = q[b * a.sq.b + t * a.sq.s + h * a.sq.h + d];
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * NT;
      Qs[(i / HD) * (HD + 1) + i % HD] = x[u];
    }
  }
  if (tid < ROWS) qp_s[tid] = r0 + tid < R ? qpos[(r0 + tid) / group] : -1;
  const int* pt = ptab + b * a.pts;
  for (int i0 = tid; i0 < a.n_pp; i0 += 4 * NT) {
    int x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = i0 + u * NT < a.n_pp ? pt[i0 + u * NT] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * NT < a.n_pp) pt_s[i0 + u * NT] = x[u];
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = -1;
  for (int i = 0; i < ROWS; ++i) {
    if (qp_s[i] < 0) continue;
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const float* kpb = kpool + kvh * a.skp.h;
  const float* vpb = vpool + kvh * a.svp.h;
  const float* knb = knew + b * a.skn.b + kvh * a.skn.h;
  const float* vnb = vnew + b * a.svn.b + kvh * a.svn.h;
  const int T_all = L + C;

  for (int k0 = 0; k0 < T_all; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps/kp_s are no longer read
    bool any = false;
    if (tid < BK) {
      const int j = k0 + tid;
      const int kp = j < L ? cpos[j] : (j < T_all ? qpos[j - L] : -1);
      kp_s[tid] = kp;
      any = kp >= 0 && kp <= qmax && (a.window <= 0 || kp > qmin - a.window);
    }
    if (!__syncthreads_or(any)) continue;  // no live pair in this tile

    // LOADS loads of K and of V in flight a thread before any store: a
    // loop that stored each element before loading the next would wait a
    // full device-memory latency per element
    for (int i0 = tid; i0 < BK * HD; i0 += NT * LOADS) {
      float kx[LOADS], vx[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * NT;
        const int r = i / HD, d = i % HD, j = k0 + r;
        kx[u] = 0.f;
        vx[u] = 0.f;
        if (kp_s[r] >= 0 && d < hd) {
          if (j < L) {
            const int pid = pt_s[j / a.page], slot = j % a.page;
            if (pid < 0 || pid >= a.P) __trap();
            kx[u] = kpb[pid * a.skp.b + slot * a.skp.s + d];
            vx[u] = vpb[pid * a.svp.b + slot * a.svp.s + d];
          } else {
            kx[u] = knb[(long long)(j - L) * a.skn.s + d];
            vx[u] = vnb[(long long)(j - L) * a.svn.s + d];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * NT;
        Ks[(i / HD) * (HD + 1) + i % HD] = kx[u];
        Vs[i] = vx[u];
      }
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
      const int qp = qp_s[ty * 4 + i];
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kp_s[tx + 16 * j];
        live[j] = kp >= 0 && kp <= qp && (a.window <= 0 || kp > qp - a.window);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= R) continue;
    const int t = r / group, h = kvh * group + r % group;
    float* ob = o + b * a.so.b + t * a.so.s + h * a.so.h;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[d] = acc[i][j] * inv;
    }
  }
}

template <typename K>
int allow_smem(K kern, size_t bytes) {
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

// strides: 21 values in elements: (b, s, h) for q, k_new, v_new and o,
// (page, slot, h) for k_pool and v_pool, in the order q, k_pool, v_pool,
// k_new, v_new, o (the head dim is contiguous in all six), then the batch
// strides of page_table, ctx_pos and q_pos (their second axis is
// contiguous).  L = n_pp * page; P pool pages.  bf16 needs 16-byte aligned
// pointers and (b, s, h) strides and hd % 8 == 0 (the wrapper checks).
// nsplit: key splits over blocks from the wrapper's plan (1 in f32); with
// nsplit > 1, part is f32 scratch of B * KV * row tiles * nsplit * 2 *
// (16 hd_tile + 128) and counters B * KV * row tiles zeroed unsigned ints
// (the kernel leaves them 0).
extern "C" int prefill_page_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* k_new, const void* v_new,
    const void* ctx_pos, const void* q_pos, void* o, void* part,
    void* counters, int dtype, int B, int C, int n_pp, int page, int P,
    int H, int KV, int hd, int nsplit, const long long* st, float scale,
    int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV || C <= 0 || page <= 0 || n_pp <= 0 || hd > 256 ||
      C > n_pp * page || nsplit < 1 || (dtype != kBF16 && nsplit != 1) ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
         strides_at(st, 3), strides_at(st, 4), strides_at(st, 5),
         st[18], st[19], st[20], C, n_pp * page, n_pp, page, P, hd,
         H / KV, window, nsplit};
  const int R = (H / KV) * C;
  const dim3 grid((R + ROWS - 1) / ROWS, KV * nsplit, B);
  const int* pt = static_cast<const int*>(page_table);
  const int* cp = static_cast<const int*>(ctx_pos);
  const int* qp = static_cast<const int*>(q_pos);
  auto run_tc = [&](auto hdc) {
    constexpr int HD = decltype(hdc)::value;
    auto kern = prefill_page_attention_kernel_tc<HD>;
    const size_t smem = tc_smem_bytes<HD>(a.L + C, n_pp);
    int err = allow_smem(kern, smem);
    if (err) return err;
    kern<<<grid, tc_threads<HD>(), smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
        static_cast<const bf16*>(v_pool), pt, static_cast<const bf16*>(k_new),
        static_cast<const bf16*>(v_new), cp, qp, static_cast<bf16*>(o),
        static_cast<float*>(part), static_cast<unsigned*>(counters), a,
        scale * LOG2E);
    return (int)cudaGetLastError();
  };
  auto run_f32 = [&](auto hdc) {
    constexpr int HD = decltype(hdc)::value;
    auto kern = prefill_page_attention_kernel<HD>;
    const size_t smem = f32_smem_bytes<HD>(n_pp);
    int err = allow_smem(kern, smem);
    if (err) return err;
    kern<<<grid, NT, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), pt,
        static_cast<const float*>(k_new), static_cast<const float*>(v_new),
        cp, qp, static_cast<float*>(o), a, scale);
    return (int)cudaGetLastError();
  };
  if (dtype == kBF16) {
    if (hd <= 64) return run_tc(std::integral_constant<int, 64>{});
    if (hd <= 128) return run_tc(std::integral_constant<int, 128>{});
    return run_tc(std::integral_constant<int, 256>{});
  }
  if (dtype == kF32) {
    if (hd <= 32) return run_f32(std::integral_constant<int, 32>{});
    if (hd <= 64) return run_f32(std::integral_constant<int, 64>{});
    if (hd <= 128) return run_f32(std::integral_constant<int, 128>{});
    return run_f32(std::integral_constant<int, 256>{});
  }
  return (int)cudaErrorInvalidValue;
}
