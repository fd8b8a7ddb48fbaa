"""Decode and chunked-prefill attention of the port against the JAX package
at recurrent serving's shapes, and the paged prefill entry, on the CPU.

* ``ref.prefill_page_attention`` and ``ref.attention_decode`` (the plain
  versions the CUDA kernels are held to on the card) equal the Pallas
  kernels in interpret mode at head dim 256 with 10 query heads over one
  kv head (recurrentgemma-2b's local layers) and at head dim 16 (its smoke
  config), over a ring that has wrapped, with a window.
* ``ops.prefill_page_attention_paged`` (the chunk path's entry: on the card
  one kernel reading the pools through the page table) equals JAX's
  ``page_gather`` of both pools followed by its Pallas prefill kernel,
  under a shuffled page table.
* ``ops.attention_decode_paged`` (the decode path's entry: on the card one
  kernel reading the pools through the page table) equals JAX's
  ``page_gather`` of both pools followed by its Pallas decode kernel, under
  a shuffled table with an idle row on the junk page, at llama3.2-1b's
  heads and recurrentgemma-2b's local heads; the CPU route launches no
  kernel; the decode kernel's splits, walked over the pages as the kernel
  walks them, read exactly the gathered ring.
* The decode kernel's split plan is a function of (L, hd, dtype) alone,
  and the split-and-merge it plans (partial (m, l, acc) per split, merged
  in split order) gives the plain version's result, with dead splits
  merging to nothing.  (Batch invariance of the kernel's bits is checked
  on the card: CPU einsums are not batch-invariant themselves.)

Tolerances as tests/test_kernels.py: f32 rtol/atol 2e-5, bf16 2e-2.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.page_gather import page_gather as pallas_gather  # noqa
from repro.kernels.page_gather import \
    prefill_page_attention as pallas_prefill  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.page_gather import prefill_plan  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (H, KV, hd): recurrentgemma-2b's local attention and its smoke config
HEADS = [(10, 1, 256), (4, 1, 16)]


def _pair(a: np.ndarray, dtype: str):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _ring_positions(start: int, L: int, B: int) -> np.ndarray:
    """Absolute position of each slot of an L-slot ring just before
    ``start`` lands (-1: never written), as ``ring_positions`` makes it."""
    idx = np.arange(L)
    last = start - 1
    pos = last - np.mod(last - idx, L)
    ctx = np.where(pos >= 0, pos, -1).astype(np.int32)
    return np.broadcast_to(ctx[None], (B, L)).copy()


def _chunk(rng, B, C, L, H, KV, hd, start):
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, C, H, hd), (B, L, KV, hd), (B, L, KV, hd), (B, C, KV, hd),
             (B, C, KV, hd))]
    q_pos = np.broadcast_to(start + np.arange(C, dtype=np.int32)[None],
                            (B, C)).copy()
    return arrs, _ring_positions(start, L, B), q_pos


@pytest.mark.parametrize("H,KV,hd", HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_ref_matches_pallas_at_recurrent_shapes(H, KV, hd, dtype):
    """A chunk of 8 at position 45 over a 16-slot ring (wrapped twice),
    window 12: ring slots behind the window and ahead of the chunk are
    dead."""
    B, C, L, start, window = 2, 8, 16, 45, 12
    arrs, ctx_pos, q_pos = _chunk(np.random.default_rng(0), B, C, L, H, KV,
                                  hd, start)
    t = [_pair(a, dtype) for a in arrs]
    got = ref.prefill_page_attention(
        *[x for x, _ in t], torch.from_numpy(ctx_pos),
        torch.from_numpy(q_pos), window=window)
    want = pallas_prefill(*[y for _, y in t], jnp.asarray(ctx_pos),
                          jnp.asarray(q_pos), window=window, block_k=8,
                          interpret=True)
    assert got.shape == (B, C, H, hd) and got.dtype == t[0][0].dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("H,KV,hd", HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_pallas_at_recurrent_shapes(H, KV, hd, dtype):
    """Per-row ring masks of a 24-slot ring with a window of 10 at
    different positions (one row before the ring filled, one wrapped)."""
    B, L, window = 3, 24, 10
    rng = np.random.default_rng(1)
    q, jq = _pair(rng.standard_normal((B, 1, H, hd), np.float32), dtype)
    k, jk = _pair(rng.standard_normal((B, L, KV, hd), np.float32), dtype)
    v, jv = _pair(rng.standard_normal((B, L, KV, hd), np.float32), dtype)
    pos = np.array([3, 30, 77])
    idx = np.arange(L)[None]
    abs_pos = pos[:, None] - np.mod(pos[:, None] - idx, L)
    valid = (abs_pos >= 0) & (abs_pos > pos[:, None] - window)
    got = ref.attention_decode(q, k, v, torch.from_numpy(valid))
    want = pallas_decode(jq, jk, jv, jnp.asarray(valid), block_k=8,
                         interpret=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("H,KV,hd,window", [(10, 1, 256, 12),
                                            (4, 1, 16, 0), (6, 2, 32, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_matches_jax_gather_then_pallas(H, KV, hd, window,
                                                      dtype):
    """Pools of 13 pages of 4 slots under a shuffled table (two rows of 4
    pages each, a ring of 16): the CPU route of the paged entry against
    JAX's ``page_gather`` of both pools and its Pallas prefill kernel."""
    B, C, page, n_pp, P, start = 2, 8, 4, 4, 13, 29
    rng = np.random.default_rng(2)
    L = n_pp * page
    pools = [rng.standard_normal((P, page, KV, hd)).astype(np.float32)
             for _ in range(2)]
    table = rng.permutation(P)[:B * n_pp].reshape(B, n_pp).astype(np.int32)
    assert not np.array_equal(table.ravel(), np.arange(B * n_pp))
    arrs, ctx_pos, q_pos = _chunk(rng, B, C, L, H, KV, hd, start)
    (q, jq), (kn, jkn), (vn, jvn) = (_pair(arrs[i], dtype) for i in (0, 3, 4))
    (pk, jpk), (pv, jpv) = (_pair(p, dtype) for p in pools)
    tt, jt = torch.from_numpy(table), jnp.asarray(table)
    got = ops.prefill_page_attention_paged(
        q, pk, pv, tt, kn, vn, torch.from_numpy(ctx_pos),
        torch.from_numpy(q_pos), window=window)
    jk = pallas_gather(jpk, jt, interpret=True)
    jv = pallas_gather(jpv, jt, interpret=True)
    want = pallas_prefill(jq, jk, jv, jkn, jvn, jnp.asarray(ctx_pos),
                          jnp.asarray(q_pos), window=window, block_k=8,
                          interpret=True)
    _close(got, want, dtype)
    # the gathered form on the same inputs gives the same bits
    same = ops.prefill_page_attention(
        q, ref.page_gather(pk, tt), ref.page_gather(pv, tt), kn, vn,
        torch.from_numpy(ctx_pos), torch.from_numpy(q_pos), window=window)
    assert torch.equal(got, same)


def test_paged_prefill_runs_no_kernel_on_the_cpu():
    rng = np.random.default_rng(3)
    pool = torch.from_numpy(rng.standard_normal((5, 4, 1, 16), np.float32))
    table = torch.tensor([[3, 1]], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 16), np.float32))
    kn = torch.from_numpy(rng.standard_normal((1, 4, 1, 16), np.float32))
    ctx_pos = torch.tensor([[0, 1, 2, 3, -1, -1, -1, -1]], dtype=torch.int32)
    q_pos = torch.arange(4, 8, dtype=torch.int32)[None]
    before = dict(ops.launches)
    out = ops.prefill_page_attention_paged(q, pool, pool, table, kn, kn,
                                           ctx_pos, q_pos)
    assert ops.launches == before and torch.isfinite(out).all()


def test_decode_plan_reads_only_the_ring_head_dim_and_dtype():
    """No B and no mask in the plan, so a row's split (and bits) is the
    same at every batch size; splits cover the ring in tile multiples."""
    assert list(inspect.signature(dec.plan).parameters) == ["L", "hd",
                                                            "dtype"]
    for dtype in (torch.float32, torch.bfloat16):
        for hd in dec.HEAD_DIMS:
            for L in (1, 40, 127, 128, 129, 544, 1024, 2048, 8191, 65536):
                p = dec.plan(L, hd, dtype)
                assert p == dec.plan(L, hd, dtype)
                kps, n = p["keys_per_split"], p["splits"]
                assert kps % p["tile"] == 0 and kps >= 128
                assert (n - 1) * kps < L <= n * kps
                assert n <= dec.MAX_SPLITS
                assert p["tile"] == (dec.TC_TILE if dtype == torch.bfloat16
                                     else dec.TILE_BYTES // (4 * p["hd_tile"]))
    # the serving ring: 5 splits of 128 at every head dim and dtype
    assert dec.plan(544, 64, torch.bfloat16)["splits"] == 5
    assert dec.plan(2048, 256, torch.bfloat16)["splits"] == 16


def _split_decode(q, k, v, valid):
    """The kernel's arithmetic in f32 on the CPU: each split's online
    softmax (in the log2 domain, dead keys' p = 0), then the merge in split
    order, as ``csrc/decode_attention.cu`` does it."""
    B, _, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    p = dec.plan(L, hd, q.dtype)
    kps = p["keys_per_split"]
    kr = torch.repeat_interleave(k.float(), H // KV, dim=2)
    vr = torch.repeat_interleave(v.float(), H // KV, dim=2)
    s = torch.einsum("bhd,blhd->bhl", q[:, 0].float(), kr) \
        * (hd ** -0.5 * 1.4426950408889634)
    live = valid.expand(B, L)[:, None, :]
    s = torch.where(live, s, torch.full_like(s, -1e30))
    ms, ls, accs = [], [], []
    for s0 in range(0, L, kps):
        sl = s[..., s0:s0 + kps]
        m = sl.max(-1).values
        pr = torch.where(live[..., s0:s0 + kps],
                         torch.exp2(sl - m[..., None]), torch.zeros_like(sl))
        ms.append(m)
        ls.append(pr.sum(-1))
        accs.append(torch.einsum("bhl,blhd->bhd", pr, vr[:, s0:s0 + kps]))
    M = torch.stack(ms).max(0).values
    den, num = torch.zeros_like(M), torch.zeros_like(accs[0])
    for m, l_, a in zip(ms, ls, accs):
        w = torch.exp2(m - M)
        den = den + l_ * w
        num = num + a * w[..., None]
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out[:, None].to(q.dtype)


@pytest.mark.parametrize("L,H,KV,hd", [(544, 8, 2, 64), (300, 10, 1, 256),
                                       (200, 16, 1, 32)])
def test_split_decode_merges_to_the_plain_version(L, H, KV, hd):
    """Rows whose live slots lie in one split only (every other split
    dead), in the last slot only, spread over all splits; no NaN from a
    dead split's exp(NEG_INF - NEG_INF)."""
    B = 4
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, L, KV, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, L, KV, hd), np.float32))
    valid = torch.from_numpy(rng.random((B, L)) < 0.5)
    valid[0] = False
    valid[0, :3] = True                 # split 0 only
    valid[1] = False
    valid[1, L - 1] = True              # the last slot only
    assert dec.plan(L, hd, torch.float32)["splits"] > 1
    got = _split_decode(q, k, v, valid)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.attention_decode(q, k, v, valid),
                               rtol=2e-5, atol=2e-5)


def test_prefill_plan_reads_no_batch_and_splits_only_few_blocks():
    """The chunked-prefill kernel's key split is a function of the chunk's
    shape alone: none at llama3.2-1b's and mixtral-8x7b's serving chunks
    (128 blocks already), three at recurrentgemma-2b's one kv head, none
    in f32; every split gets at least four key tiles."""
    assert list(inspect.signature(prefill_plan).parameters) == [
        "C", "L", "H", "KV", "hd", "dtype"]
    bf = torch.bfloat16
    assert prefill_plan(128, 544, 32, 8, 64, bf)["splits"] == 1
    assert prefill_plan(128, 544, 32, 8, 128, bf)["splits"] == 1
    p = prefill_plan(128, 2048, 10, 1, 256, bf)
    assert (p["row_tiles"], p["tile"], p["key_tiles"], p["splits"]) == \
        (40, 64, 34, 3)
    assert prefill_plan(128, 2048, 10, 1, 256, torch.float32)["splits"] == 1
    for C, L, H, KV, hd in ((8, 16, 4, 1, 16), (16, 544, 32, 8, 64),
                            (24, 40, 4, 1, 16), (128, 8192, 8, 1, 256)):
        p = prefill_plan(C, L, H, KV, hd, bf)
        assert p["key_tiles"] == -(-(L + C) // p["tile"])
        assert 1 <= p["splits"] <= max(1, p["key_tiles"] // 4)
        assert p["splits"] == 1 or \
            p["row_tiles"] * KV * p["splits"] <= 128


def _paged_decode_inputs(rng, B, n_pp, page, H, KV, hd):
    """Pools of B * n_pp + 1 pages (the last one the junk page) under a
    shuffled table; row 0 idle (its whole table on the junk page, pos 0:
    slot 0 live), the other rows at ring positions that have wrapped or
    not, with a window of L - 3 slots."""
    L, P = n_pp * page, B * n_pp + 1
    pools = [rng.standard_normal((P, page, KV, hd)).astype(np.float32)
             for _ in range(2)]
    table = rng.permutation(P - 1)[:B * n_pp].reshape(B, n_pp)
    table = table.astype(np.int32)
    table[0] = P - 1
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    pos = np.array([0] + [int(x) for x in rng.integers(1, 3 * L, B - 1)])
    idx = np.arange(L)[None]
    abs_pos = pos[:, None] - np.mod(pos[:, None] - idx, L)
    valid = (abs_pos >= 0) & (abs_pos > pos[:, None] - (L - 3))
    return q, pools, table, valid


@pytest.mark.parametrize("H,KV,hd", [(32, 8, 64), (10, 1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_jax_gather_then_pallas(H, KV, hd, dtype):
    """Four rows over pools of 4-slot pages (a ring of 24): the CPU route
    of the paged entry against JAX's ``page_gather`` of both pools and
    its Pallas decode kernel, both in interpret mode."""
    B, n_pp, page = 4, 6, 4
    q, pools, table, valid = _paged_decode_inputs(
        np.random.default_rng(5), B, n_pp, page, H, KV, hd)
    assert not np.array_equal(table[1:].ravel() % (B * n_pp),
                              np.arange(B * n_pp)[n_pp:])
    (tq, jq), (pk, jpk), (pv, jpv) = (_pair(a, dtype) for a in (q, *pools))
    tt, jt = torch.from_numpy(table), jnp.asarray(table)
    got = ops.attention_decode_paged(tq, pk, pv, tt,
                                     torch.from_numpy(valid))
    jk = pallas_gather(jpk, jt, interpret=True)
    jv = pallas_gather(jpv, jt, interpret=True)
    want = pallas_decode(jq, jk, jv, jnp.asarray(valid), block_k=8,
                         interpret=True)
    assert got.shape == (B, 1, H, hd) and got.dtype == tq.dtype
    _close(got, want, dtype)
    # the gathered form on the same inputs gives the same bits
    same = ops.attention_decode(tq, ref.page_gather(pk, tt),
                                ref.page_gather(pv, tt),
                                torch.from_numpy(valid))
    assert torch.equal(got, same)


def test_paged_decode_runs_no_kernel_on_the_cpu():
    q, pools, table, valid = _paged_decode_inputs(
        np.random.default_rng(6), 2, 3, 4, 4, 1, 16)
    before = dict(ops.launches)
    out = ops.attention_decode_paged(
        torch.from_numpy(q), *(torch.from_numpy(p) for p in pools),
        torch.from_numpy(table), torch.from_numpy(valid))
    assert ops.launches == before and torch.isfinite(out).all()


@pytest.mark.parametrize("L,page,hd,dtype", [
    (544, 16, 64, torch.bfloat16),     # llama3.2-1b's serving ring
    (2048, 16, 256, torch.float32),    # f32 tiles of 8 keys: half a page
    (300, 20, 64, torch.bfloat16),     # splits starting mid-page
    (300, 1, 32, torch.float32),       # one slot a page
    (544, 544, 64, torch.bfloat16),    # the gathered form: one page a row
])
def test_paged_decode_splits_read_the_gathered_ring(L, page, hd, dtype):
    """Each split of the plan, walked as ``csrc/decode_attention.cu`` walks
    it (the ids of pages key0 // page .. (key0 + nkeys - 1) // page loaded
    once, at most (kps - 1) // page + 2 of them; a key's page id and slot
    from key // page), reads exactly the rows of ``ref.page_gather``'s
    view; the plan reads neither the page nor the table."""
    B, KV = 2, 2
    rng = np.random.default_rng(7)
    n_pp = L // page
    P = B * n_pp + 1
    pool = torch.from_numpy(rng.standard_normal((P, page, KV, 8),
                                                np.float32))
    table = torch.from_numpy(rng.permutation(P)[:B * n_pp].reshape(
        B, n_pp).astype(np.int32))
    view = ref.page_gather(pool, table)
    p = dec.plan(L, hd, dtype)
    kps = p["keys_per_split"]
    for b in range(B):
        rows = []
        for s in range(p["splits"]):
            key0 = s * kps
            nkeys = min(kps, L - key0)
            p0 = key0 // page
            ids = table[b, p0:(key0 + nkeys - 1) // page + 1]
            assert len(ids) <= (kps - 1) // page + 2
            for key in range(key0, key0 + nkeys):
                pg = key // page
                rows.append(pool[ids[pg - p0], key - pg * page])
        assert torch.equal(torch.stack(rows), view[b])
