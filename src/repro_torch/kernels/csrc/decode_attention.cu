// Single-token GQA decode attention over a paged KV cache, reading the
// ring's K/V rows in place from the page pools through the page table,
// split over the ring (flash-decoding).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, pallas_call at :102) together with the two
// page_gather calls before it (repro/kernels/page_gather.py, pallas_call
// at :57), as repro/models/attention.py pairs them.  Same function:
// q (B,1,H,hd); the pools k_pool/v_pool (P,page,KV,hd) and page_table
// (B,n_pp) int32, whose logical view pool[page_table] is the ring
// (B,L,KV,hd), L = n_pp * page; valid (B,L) -> (B,1,H,hd) in q's dtype;
// scale hd^-0.5; probabilities of dead slots are exactly 0 (the Pallas
// kernel re-masks them at :56-58); a row with no live slot writes 0.  Ring
// slot j of row b sits at pool[page_table[b, j / page], j % page]; a page
// id of the split outside [0, P) traps, as page_gather's does.  The
// gathered form, decode_attention(q, k, v, valid) over a materialized ring
// (B,L,KV,hd), is the same kernel with one page of L slots a row and no
// table (row b reads page b): the two forms share every instruction but
// the address of a row, so they give the same bits.
//
// Bound on the H100: bytes.  A step reads the live K and V rows once,
// 2 * B * live * KV * hd * elem bytes, and does 4 * H * hd FLOPs per (row,
// live slot): H/KV FLOPs a byte in bf16 (4 for llama3.2-1b, 10 for
// recurrentgemma-2b), far below the card's ~295.  What bounded the first
// design was latency: the Pallas grid walks the ring serially per (batch
// row, kv head), and B * KV such walks (64 at the serving shape) fill half
// of the 132 SMs.
//
// Design, both element types:
// * Grid (split, kv head, batch row).  A split is a fixed range of
//   keys_per_split ring slots; the wrapper's plan picks it from (L, hd,
//   dtype) alone, never from B or the mask, so a row's bits do not depend
//   on the batch (the schedule-invariance claims rest on that).
// * A block of 4 warps serves the whole query group (up to 16 heads) of
//   its kv head, so each K/V row is read from device memory once.  q sits
//   in shared memory, and so, for each key of the split, its live flag and
//   the offsets of its K and V rows in the pools: one thread a key reads
//   the flag and its page's id (the table row's id of key / page) with
//   the two loads in flight together, and computes the offsets once, so
//   the tile loads never divide by the page.  K/V tiles stream through a
//   two-stage cp.async ring of 16-byte copies straight from the pages (a
//   64-key bf16 tile spans 4 pages of 16; an f32 tile at head dim 256, 8
//   keys, half a page); dead slots are zero-filled (never read).  A tile
//   with no live slot skips its arithmetic.  No view of the ring is
//   written: at llama3.2-1b's serving shape (B8 L544 KV8 hd64 bf16) the
//   page_gather pair this replaces copied 2 x 4.46 MB a layer a step,
//   which decode then read back.
// * Each block writes a partial (m, l, acc) in f32 to scratch and counts
//   itself in a per-(batch row, kv head) counter; the block that comes
//   last merges the partials in split order (so the result does not
//   depend on which block that is) and resets the counter to 0.  A dead
//   split has m = NEG_INF, l = 0 and acc = 0, and merges to nothing.
//   One split writes the output directly (finish_split).
// * The partial form (PartOut: a ring split across ranks, whose parts the
//   caller combines) writes the merged state instead of the output: the
//   unnormalised acc (B,1,H,hd) f32, l and m (B,H) f32, m divided by
//   log2 e into the natural-log units of the score (the kernel keeps it
//   in log2 units with the scale folded in); a row with no live slot
//   gives m = -inf, l = 0 and acc = 0.  It reads and merges as the other
//   forms do: only the last store differs.
//
// bf16: the tensor cores (mma.sync m16n8k16, hopper_mma.cuh).  The query
// group is the A operand's 16 rows (zero past the group), so a group of 10
// at head dim 256 costs what a group of 4 does; each warp takes 16 keys
// of every 64-key tile with its own online softmax (exp2, the scale folded
// into log2 e; P split into P_hi + P_lo bf16 operands of P V, as the
// flash forward does), tiles 128-byte swizzled; the four warps' states
// merge in warp order at the end.  On the CUDA cores a group of 10 at head
// dim 256 took 0.094 ms against SDPA's 0.026 (B8 L2048): 2,560 FMAs a key
// for each of 128 threads, one block an SM.
//
// f32: the CUDA cores (tensor cores take f32 only as TF32).  K/V tiles of
// 8 KB; per tile, scores by lanes splitting the head dim into 16-byte
// slices (a shuffle tree per query head), an online softmax by one warp
// per query head, and P V by threads owning (query head, head-dim pairs)
// of the f32 accumulator.
//
// Head dims 64, 128, 256 (16 and 32 are zero-padded to 64); groups up to
// 16 (f32 pads them to 4, 8 or 16).  No atomics touch the result: the
// kernel is deterministic.
#include <type_traits>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int NT = 128;           // threads a block
constexpr int NW = NT / 32;       // warps a block
constexpr int TILE_BYTES = 8192;  // f32: one K (or V) tile
constexpr float LOG2E = 1.4426950408889634f;

// f32: keys a tile
template <int HD>
__host__ __device__ constexpr int tile_keys() {
  return TILE_BYTES / (HD * 4);
}

// the split's K and V row offsets [kps] (64-bit) and live flags [kps],
// after the arithmetic's scratch
size_t split_bytes(int kps) { return 16 * (size_t)kps + ((kps + 15) & ~15); }

// f32: K/V stages, q [GP][HD], scores [GP][TK+1], alpha/m/l [GP], then
// the split's row offsets and flags
template <int HD, int GP>
size_t smem_bytes(int kps) {
  constexpr int TK = tile_keys<HD>();
  return 4 * TILE_BYTES + sizeof(float) * (GP * HD + GP * (TK + 1) + 3 * GP) +
         split_bytes(kps);
}

// element strides: q (b, h); the pools (page, slot, h), for the gathered
// form (b, l, h); the table (b); valid (b); o (b, h)
struct St {
  long long qb, qh, kp, ks, kh, vp, vs, vh, pt, valb, ob, oh;
};

template <int NTH>
__device__ __forceinline__ void load_split(
    const uint8_t* __restrict__ valid, const int* __restrict__ table, int P,
    int page, const St& st, int key0, int nkeys, uint8_t* flags,
    long long* koff, long long* voff) {
  const int b = blockIdx.z, tid = threadIdx.x;
  const int* tb = table != nullptr ? table + b * st.pt : nullptr;
  const uint8_t* vb = valid + b * st.valb + key0;
  for (int j0 = tid; j0 < nkeys; j0 += 4 * NTH) {
    uint8_t x[4];
    int id[4], slot[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * NTH, key = key0 + j, pg = key / page;
      x[u] = 0;
      id[u] = b;
      slot[u] = key - pg * page;
      if (j < nkeys) {
        x[u] = vb[j];
        if (tb != nullptr) id[u] = tb[pg];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * NTH;
      if (j < nkeys) {
        if (id[u] < 0 || id[u] >= P) __trap();
        flags[j] = x[u];
        koff[j] = id[u] * st.kp + slot[u] * st.ks;
        voff[j] = id[u] * st.vp + slot[u] * st.vs;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) out[i] = to_f32(e[i]);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the partial form's outputs (acc == nullptr: the normalised output o):
// acc (b, h) at the strides St gives o, l and m [B][H]
struct PartOut {
  float *acc, *l, *m;
  int H;
};

// a query head's merged state in the partial form: acc over the head dims
// this thread holds, and (its first thread) l and m in natural-log units
template <int HD, int GP>
__device__ __forceinline__ void write_partial(const float* num, float M,
                                              float den, int gp, int tig,
                                              int hd, int group, const St& st,
                                              const PartOut& po) {
  constexpr int TPG = NT / GP;
  constexpr int EPT = HD / TPG;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int h = kvh * group + gp;
  float* ab = po.acc + b * st.ob + (long long)h * st.oh;
#pragma unroll
  for (int e = 0; e < EPT / 2; ++e) {
    const int d = 2 * (tig + TPG * e);
    if (d < hd) store2(ab + d, num[2 * e], num[2 * e + 1]);
  }
  if (tig == 0) {
    const long long i = (long long)b * po.H + h;
    po.l[i] = den;
    po.m[i] = M > 0.5f * NEG_INF ? M / LOG2E : __int_as_float(0xff800000);
  }
}

// the split's keys into shared memory, one thread a key: its live flag
// and the offsets of its K and V rows in the pools (page id from the
// table row, slot key % page; no table: the gathered form, row b is page
// b), the flag and id loads issued together so their latencies overlap.
// The tile loads then read a row's offset instead of dividing by the page
// (a thread issues 4 to 16 row copies a tile, with 4 warps an SM to hide
// their latency).  A page id outside [0, P) traps.
// the end of a block: with one split, the output; else this split's
// partial (acc [group][HD], then m [group], l [group]) and, in the block
// that comes last for its (batch row, kv head), the merge of every split
// in split order and the counter's reset.  Thread (gp, tig) holds acc for
// head dims 2 (tig + TPG e) + {0, 1} of query head gp; m_s, l_s in shared
// memory.
template <typename T, int HD, int GP>
__device__ __forceinline__ void finish_split(
    const float* acc, const float* m_s, const float* l_s, T* __restrict__ o,
    float* __restrict__ part, unsigned* __restrict__ counters, int group,
    int hd, const St& st, const PartOut& po, int* last_s) {
  constexpr int TPG = NT / GP;
  constexpr int EPT = HD / TPG;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int gp = tid / TPG, tig = tid % TPG;
  T* ob = o + b * st.ob + (long long)kvh * group * st.oh;
  if (nsplit == 1) {
    if (gp < group && po.acc != nullptr) {
      write_partial<HD, GP>(acc, m_s[gp], l_s[gp], gp, tig, hd, group, st,
                            po);
    } else if (gp < group) {
      const float inv = 1.f / fmaxf(l_s[gp], 1e-30f);
#pragma unroll
      for (int e = 0; e < EPT / 2; ++e) {
        const int d = 2 * (tig + TPG * e);
        if (d < hd)
          store2(ob + gp * st.oh + d, acc[2 * e] * inv, acc[2 * e + 1] * inv);
      }
    }
    return;
  }

  // this split's partial: acc [group][HD], then m [group], l [group]
  const int pstride = group * (HD + 2);
  const long long row = (long long)b * gridDim.y + kvh;
  float* pb = part + (row * nsplit + split) * pstride;
  if (gp < group) {
#pragma unroll
    for (int e = 0; e < EPT / 2; ++e)
      store2(pb + gp * HD + 2 * (tig + TPG * e), acc[2 * e], acc[2 * e + 1]);
  }
  if (tid < group) {
    pb[group * HD + tid] = m_s[tid];
    pb[group * HD + group + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *last_s = atomicAdd(counters + row, 1u) == (unsigned)(nsplit - 1);
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // the last block merges every split's partial, in split order
  const float* p0 = part + row * nsplit * pstride;
  if (gp < group) {
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s)
      M = fmaxf(M, __ldcg(p0 + s * pstride + group * HD + gp));
    float den = 0.f, num[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) num[e] = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* ps = p0 + s * pstride;
      const float w = exp2f(__ldcg(ps + group * HD + gp) - M);
      den = fmaf(__ldcg(ps + group * HD + group + gp), w, den);
#pragma unroll
      for (int e = 0; e < EPT / 2; ++e) {
        const float2 a = __ldcg(reinterpret_cast<const float2*>(
            ps + gp * HD + 2 * (tig + TPG * e)));
        num[2 * e] = fmaf(a.x, w, num[2 * e]);
        num[2 * e + 1] = fmaf(a.y, w, num[2 * e + 1]);
      }
    }
    if (po.acc != nullptr) {
      write_partial<HD, GP>(num, M, den, gp, tig, hd, group, st, po);
    } else {
      const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
      for (int e = 0; e < EPT / 2; ++e) {
        const int d = 2 * (tig + TPG * e);
        if (d < hd)
          store2(ob + gp * st.oh + d, num[2 * e] * inv,
                 num[2 * e + 1] * inv);
      }
    }
  }
  if (tid == 0) counters[row] = 0u;
}

// f32 on the CUDA cores.  (NT, 1): with NT alone ptxas kept 56-64
// registers and spilled 4-8 bytes in two instantiations
template <int HD, int GP>
__global__ void __launch_bounds__(NT, 1)
    decode_split_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ table,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ o, float* __restrict__ part,
                        unsigned* __restrict__ counters, int L, int page,
                        int P, int hd, int group, int kps, St st,
                        PartOut po, float scale_log2) {
  using T = float;
  constexpr int TK = tile_keys<HD>();
  constexpr int VEC = 16 / sizeof(T);        // elements a 16-byte slice
  constexpr int CPR = HD / VEC;              // slices a row
  constexpr int LPK = CPR < 32 ? CPR : 32;   // lanes a key (scores)
  constexpr int SPL = CPR / LPK;             // slices a lane
  constexpr int KPW = 32 / LPK;              // keys a warp step
  constexpr int TPG = NT / GP;               // threads a query head (P V)
  constexpr int EPT = HD / TPG;              // head dims a thread
  constexpr int RPW = GP / NW;               // softmax rows a warp
  static_assert(TK * HD * (int)sizeof(T) == TILE_BYTES, "tile bytes");
  static_assert(TK % (NW * KPW) == 0 && TK <= 64, "tile keys");
  static_assert(EPT % 2 == 0 && RPW >= 1, "thread mapping");
  constexpr int TILE_ELEMS = TILE_BYTES / sizeof(T);

  extern __shared__ __align__(16) uint8_t smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // stage s: K at 2s, V at 2s+1
  T* qs = reinterpret_cast<T*>(smem + 4 * TILE_BYTES);       // [GP][HD]
  float* ss = reinterpret_cast<float*>(qs + GP * HD);        // [GP][TK+1]
  float* alpha_s = ss + GP * (TK + 1);
  float* m_s = alpha_s + GP;
  float* l_s = m_s + GP;
  long long* koff = reinterpret_cast<long long*>(l_s + GP);   // [kps]
  long long* voff = koff + kps;                                // [kps]
  uint8_t* flags = reinterpret_cast<uint8_t*>(voff + kps);    // [kps]
  __shared__ int last_s;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * kps;
  const int nkeys = min(kps, L - key0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the group's q rows (zero past hd) by cp.async, the split's keys
  const T* qb = q + b * st.qb + (long long)kvh * group * st.qh;
  for (int i = tid; i < group * CPR; i += NT) {
    const int g = i / CPR, c = (i % CPR) * VEC;
    const bool ok = c < hd;
    cp_async16(smem_u32(qs + g * HD + c), ok ? qb + g * st.qh + c : qb, ok);
  }
  cp_async_commit();
  load_split<NT>(valid, table, P, page, st, key0, nkeys, flags, koff, voff);
  __syncthreads();

  const T* kb = k + kvh * st.kh;
  const T* vbase = v + kvh * st.vh;
  auto load_tile = [&](int t, int stage) {
    const uint32_t kd = smem_u32(tiles + 2 * stage * TILE_ELEMS);
    const uint32_t vd = kd + TILE_BYTES;
#pragma unroll 1
    for (int i = tid; i < TK * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * VEC, j = t * TK + r;
      const bool live = j < nkeys && flags[j] != 0 && c < hd;
      cp_async16(kd + i * 16, live ? kb + koff[j] + c : kb, live);
      cp_async16(vd + i * 16, live ? vbase + voff[j] + c : vbase, live);
    }
  };

  const int ntiles = (nkeys + TK - 1) / TK;
  load_tile(0, 0);
  cp_async_commit();

  float mreg[RPW], lreg[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    mreg[i] = NEG_INF;
    lreg[i] = 0.f;
  }
  const int gp = tid / TPG, tig = tid % TPG;  // P V: query head, lane
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    const int jt = t * TK + tid;
    // tile t and q are in; every thread is done with tile t-1
    const bool any =
        __syncthreads_or(tid < TK && jt < nkeys && flags[jt] != 0);
    if (t + 1 < ntiles) {
      load_tile(t + 1, (t + 1) & 1);
      cp_async_commit();
    }
    if (!any) continue;
    const T* Kt = tiles + 2 * (t & 1) * TILE_ELEMS;
    const T* Vt = Kt + TILE_ELEMS;

    // scores: LPK lanes a key, each SPL 16-byte slices of the head dim
#pragma unroll
    for (int j0 = 0; j0 < TK; j0 += NW * KPW) {
      const int jl = j0 + warp * KPW + lane / LPK;
      const int sl = lane % LPK;
      float part_s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) part_s[g] = 0.f;
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const int c = (sl + s * LPK) * VEC;
        float kf[VEC];
        load_vec(Kt + jl * HD + c, kf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g < group) {
            float qf[VEC];
            load_vec(qs + g * HD + c, qf);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              part_s[g] = fmaf(qf[e], kf[e], part_s[g]);
          }
        }
      }
      const int j = t * TK + jl;
      const bool live = j < nkeys && flags[j] != 0;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < group) {
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            part_s[g] += __shfl_xor_sync(0xffffffffu, part_s[g], off);
          if (sl == 0)
            ss[g * (TK + 1) + jl] = live ? part_s[g] * scale_log2 : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp a query head; dead keys get p = 0 exactly
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int g = warp + NW * i;
      if (g < group) {
        float* row = ss + g * (TK + 1);
        const float s0 = lane < TK ? row[lane] : NEG_INF;
        const float s1 = lane + 32 < TK ? row[lane + 32] : NEG_INF;
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(mreg[i], mx);
        const float alpha = exp2f(mreg[i] - m_new);
        const float p0 = s0 > 0.5f * NEG_INF ? exp2f(s0 - m_new) : 0.f;
        const float p1 = s1 > 0.5f * NEG_INF ? exp2f(s1 - m_new) : 0.f;
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        lreg[i] = lreg[i] * alpha + sum;
        mreg[i] = m_new;
        if (lane < TK) row[lane] = p0;
        if (lane + 32 < TK) row[lane + 32] = p1;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // P V: thread (gp, tig) owns head dims 2 (tig + TPG e) + {0, 1}
    if (gp < group) {
      const float a = alpha_s[gp];
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[e] *= a;
      const float* prow = ss + gp * (TK + 1);
#pragma unroll 4
      for (int j = 0; j < TK; ++j) {
        const float p = prow[j];
#pragma unroll
        for (int e = 0; e < EPT / 2; ++e) {
          const float2 vv = load2(Vt + j * HD + 2 * (tig + TPG * e));
          acc[2 * e] = fmaf(p, vv.x, acc[2 * e]);
          acc[2 * e + 1] = fmaf(p, vv.y, acc[2 * e + 1]);
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int g = warp + NW * i;
      if (g < group) {
        m_s[g] = mreg[i];
        l_s[g] = lreg[i];
      }
    }
  }
  __syncthreads();

  finish_split<float, HD, GP>(acc, m_s, l_s, o, part, counters, group, hd,
                              st, po, &last_s);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_TK = 64;  // keys a tile, 16 a warp

// 1024 (alignment) + Q [16][HD] + two stages of (K, V) [TC_TK][HD] bf16;
// after the walk the stages hold the warps' (m, l, O) and the merged O
// [16][HD] in f32; then m, l [16], the split's row offsets and flags
template <int HD>
size_t tc_smem_bytes(int kps) {
  return 1024 + 16 * HD * 2 + 2 * 2 * TC_TK * HD * 2 + 2 * 16 * 4 +
         split_bytes(kps);
}

__device__ __forceinline__ uint32_t align1024(void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

// the query group as the 16 rows of mma.sync m16n8k16 (rows past the group
// zero): each warp takes 16 keys of every 64-key tile, S = Q K^T and O +=
// P V on its own keys with its own online softmax (P split into P_hi +
// P_lo as the flash forward does), so no barrier is needed between the
// products; the four warps' (m, l, O) merge through shared memory in warp
// order at the end, then finish_split as the CUDA-core kernel
template <int HD>
__global__ void __launch_bounds__(NT, 1)
    decode_split_kernel_tc(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const int* __restrict__ table,
                           const uint8_t* __restrict__ valid,
                           bf16* __restrict__ o, float* __restrict__ part,
                           unsigned* __restrict__ counters, int L, int page,
                           int P, int hd, int group, int kps, St st,
                           PartOut po, float scale_log2) {
  constexpr int CPR = HD / 8;              // 16-byte chunks a row
  constexpr uint32_t TILE = TC_TK * HD * 2;
  constexpr int GP = 16;
  constexpr int EPT = HD / (NT / GP);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = align1024(smem_raw);
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t Qs = base;
  const uint32_t Sg = Qs + 16 * HD * 2;  // stage s: K, V at Sg + 2 s TILE
  float* stage_f = reinterpret_cast<float*>(gbase + 16 * HD * 2);
  float* m_s = reinterpret_cast<float*>(gbase + 16 * HD * 2 + 4 * TILE);
  float* l_s = m_s + 16;
  long long* koff = reinterpret_cast<long long*>(l_s + 16);  // [kps]
  long long* voff = koff + kps;                               // [kps]
  uint8_t* flags = reinterpret_cast<uint8_t*>(voff + kps);   // [kps]
  __shared__ int last_s;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * kps;
  const int nkeys = min(kps, L - key0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const bf16* qb = q + b * st.qb + (long long)kvh * group * st.qh;
  for (int i = tid; i < 16 * CPR; i += NT) {
    const int g = i / CPR, c = (i % CPR) * 8;
    const bool ok = g < group && c < hd;
    cp_async16(Qs + swz<16>(g, c), ok ? qb + g * st.qh + c : qb, ok);
  }
  cp_async_commit();
  load_split<NT>(valid, table, P, page, st, key0, nkeys, flags, koff, voff);
  __syncthreads();

  const bf16* kb = k + kvh * st.kh;
  const bf16* vbase = v + kvh * st.vh;
  auto load_tile = [&](int t, int stage) {
    const uint32_t kd = Sg + stage * 2 * TILE, vd = kd + TILE;
#pragma unroll 1
    for (int i = tid; i < TC_TK * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * 8, j = t * TC_TK + r;
      const bool live = j < nkeys && flags[j] != 0 && c < hd;
      cp_async16(kd + swz<TC_TK>(r, c), live ? kb + koff[j] + c : kb,
                 live);
      cp_async16(vd + swz<TC_TK>(r, c), live ? vbase + voff[j] + c : vbase,
                 live);
    }
  };

  const int ntiles = (nkeys + TC_TK - 1) / TC_TK;
  load_tile(0, 0);
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int k_w = 16 * warp;  // this warp's keys in a tile

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    const int jt = t * TC_TK + tid;
    // tile t and q are in; every warp is done with tile t-1
    const bool any =
        __syncthreads_or(tid < TC_TK && jt < nkeys && flags[jt] != 0);
    if (t + 1 < ntiles) {
      load_tile(t + 1, (t + 1) & 1);
      cp_async_commit();
    }
    if (!any) continue;
    const uint32_t Ks = Sg + (t & 1) * 2 * TILE, Vs = Ks + TILE;

    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t af[4], bk[4];
      frag_a<16>(af, Qs, 0, 16 * kk, lane);
      frag_b_nk<TC_TK>(bk, Ks, k_w, 16 * kk, lane);
      mma_bf16(s[0], af, bk);
      mma_bf16(s[1], af, bk + 2);
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t * TC_TK + k_w + 8 * n + 2 * (lane & 3) + (e & 1);
        const bool live = j < nkeys && flags[j] != 0;
        s[n][e] = live ? s[n][e] * scale_log2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
    // P = P_hi + P_lo as the A fragment of one k16 step over the 16 keys
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = e >> 1;
        const float p0 = s[n][e] > 0.5f * NEG_INF ? exp2f(s[n][e] - m[i]) : 0.f;
        const float p1 =
            s[n][e + 1] > 0.5f * NEG_INF ? exp2f(s[n][e + 1] - m[i]) : 0.f;
        l[i] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        p_hi[2 * n + i] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[2 * n + i] =
            pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bv[4];
      frag_b_kn<TC_TK>(bv, Vs, 16 * np, k_w, lane);
      mma_bf16(acc[2 * np], p_hi, bv);
      mma_bf16(acc[2 * np], p_lo, bv);
      mma_bf16(acc[2 * np + 1], p_hi, bv + 2);
      mma_bf16(acc[2 * np + 1], p_lo, bv + 2);
    }
  }

  // merge the warps' states in warp order: warps 1-3 hand theirs over in
  // fragment order, warp 0 merges and lays O out as [16][HD] f32
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free
  float* xo = stage_f;                     // [3][HD/8][4][32]
  float* xm = xo + 3 * (HD / 8) * 4 * 32;  // [3][2][2][32]
  float* fo = xm + 3 * 2 * 2 * 32;         // [16][HD]
  if (warp > 0) {
    const int w = warp - 1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xo[((w * (HD / 8) + n) * 4 + e) * 32 + lane] = acc[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xm[((w * 2 + i) * 2) * 32 + lane] = m[i];
      xm[((w * 2 + i) * 2 + 1) * 32 + lane] = l[i];
    }
  }
  __syncthreads();
  if (warp == 0) {
    float mm[2] = {m[0], m[1]}, den[2];
#pragma unroll
    for (int w = 0; w < 3; ++w)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mm[i] = fmaxf(mm[i], xm[((w * 2 + i) * 2) * 32 + lane]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float a0 = exp2f(m[i] - mm[i]);
      den[i] = l[i] * a0;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * i] *= a0;
        acc[n][2 * i + 1] *= a0;
      }
    }
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      float a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = exp2f(xm[((w * 2 + i) * 2) * 32 + lane] - mm[i]);
        den[i] = fmaf(xm[((w * 2 + i) * 2 + 1) * 32 + lane], a[i], den[i]);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(xo[((w * (HD / 8) + n) * 4 + e) * 32 + lane],
                           a[e >> 1], acc[n][e]);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fo[((lane >> 2) + 8 * (e >> 1)) * HD + 8 * n + 2 * (lane & 3) +
           (e & 1)] = acc[n][e];
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m_s[(lane >> 2) + 8 * i] = mm[i];
        l_s[(lane >> 2) + 8 * i] = den[i];
      }
    }
  }
  __syncthreads();
  const int gp = tid / (NT / GP), tig = tid % (NT / GP);
  float mine[EPT];
#pragma unroll
  for (int e = 0; e < EPT / 2; ++e) {
    const float2 x = load2(fo + gp * HD + 2 * (tig + (NT / GP) * e));
    mine[2 * e] = x.x;
    mine[2 * e + 1] = x.y;
  }
  finish_split<bf16, HD, GP>(mine, m_s, l_s, o, part, counters, group, hd,
                             st, po, &last_s);
}

template <typename K>
int allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int check_plan(int L, int kps, int nsplit, int tile, const void* part,
               const void* counters) {
  if (kps <= 0 || kps % tile || nsplit != (L + kps - 1) / kps ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// the launch's arguments, whichever instantiation takes them
struct Args {
  const void *q, *k, *v, *table, *valid;
  void *o, *part, *counters;
  int B, L, page, P, KV, hd, group, kps, nsplit;
  St st;
  PartOut po;
  float scale_log2;
  cudaStream_t stream;
};

template <int HD, int GP>
int launch_f32(const Args& a) {
  int err = check_plan(a.L, a.kps, a.nsplit, tile_keys<HD>(), a.part,
                       a.counters);
  if (err) return err;
  auto kern = decode_split_kernel<HD, GP>;
  const size_t smem = smem_bytes<HD, GP>(a.kps);
  if ((err = allow_smem(kern, smem))) return err;
  kern<<<dim3(a.nsplit, a.KV, a.B), NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int*>(a.table),
      static_cast<const uint8_t*>(a.valid), static_cast<float*>(a.o),
      static_cast<float*>(a.part), static_cast<unsigned*>(a.counters), a.L,
      a.page, a.P, a.hd, a.group, a.kps, a.st, a.po, a.scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const Args& a) {
  int err = check_plan(a.L, a.kps, a.nsplit, TC_TK, a.part, a.counters);
  if (err) return err;
  auto kern = decode_split_kernel_tc<HD>;
  const size_t smem = tc_smem_bytes<HD>(a.kps);
  if ((err = allow_smem(kern, smem))) return err;
  kern<<<dim3(a.nsplit, a.KV, a.B), NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const int*>(a.table),
      static_cast<const uint8_t*>(a.valid), static_cast<bf16*>(a.o),
      static_cast<float*>(a.part), static_cast<unsigned*>(a.counters), a.L,
      a.page, a.P, a.hd, a.group, a.kps, a.st, a.po, a.scale_log2);
  return (int)cudaGetLastError();
}

template <typename F>
int with_hd(int hd, F&& f) {
  if (hd <= 64) return f(std::integral_constant<int, 64>{});
  if (hd <= 128) return f(std::integral_constant<int, 128>{});
  if (hd <= 256) return f(std::integral_constant<int, 256>{});
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int with_group(int group, F&& f) {
  if (group <= 4) return f(std::integral_constant<int, 4>{});
  if (group <= 8) return f(std::integral_constant<int, 8>{});
  if (group <= 16) return f(std::integral_constant<int, 16>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k, v: the pools (P, page, KV, hd), page_table (B, L / page) int32 ids
// in [0, P) with a contiguous page axis; or, with no table (nullptr), the
// gathered form: k, v (B, L, KV, hd) as B pages of L slots, page == L and
// P == B.  Strides in elements: q (b, h), k (page, slot, h), v (page,
// slot, h), page_table (b), valid (b), o (b, h); the head dim is
// contiguous, valid is uint8 with a contiguous slot axis.  keys_per_split
// and nsplit come from the wrapper's plan (keys_per_split a multiple of
// the tile); with nsplit > 1, part is f32 scratch of B * KV * nsplit *
// group * (hd_tile + 2) and counters B * KV zeroed unsigned ints (the
// kernel leaves them 0).  With acc_out (f32, at o's strides; l_out and
// m_out f32 [B][H]) the partial form writes the merged (acc, l, m) and
// not o.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* valid, void* o, void* part, void* counters, void* acc_out,
    void* l_out, void* m_out, int dtype, int B,
    int L, int H, int KV, int hd, int page, int P, int keys_per_split,
    int nsplit, long long qsb, long long qsh, long long ksp, long long kss,
    long long ksh, long long vsp, long long vss, long long vsh,
    long long ptsb, long long valsb, long long osb, long long osh,
    float scale, void* stream) {
  if (KV <= 0 || H % KV || H / KV > 16 || page <= 0 || L % page || P <= 0 ||
      (page_table == nullptr && (page != L || P != B)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, page_table, valid, o, part, counters, B, L, page, P,
               KV, hd, H / KV, keys_per_split, nsplit,
               St{qsb, qsh, ksp, kss, ksh, vsp, vss, vsh, ptsb, valsb, osb,
                  osh},
               PartOut{static_cast<float*>(acc_out),
                       static_cast<float*>(l_out), static_cast<float*>(m_out),
                       H},
               scale * LOG2E, static_cast<cudaStream_t>(stream)};
  if (dtype == kBF16)
    return with_hd(hd, [&](auto hdc) {
      return launch_tc<decltype(hdc)::value>(a);
    });
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  return with_hd(hd, [&](auto hdc) {
    return with_group(a.group, [&](auto gc) {
      return launch_f32<decltype(hdc)::value, decltype(gc)::value>(a);
    });
  });
}
