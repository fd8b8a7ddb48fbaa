"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks its fixture for a GPU and skips without
one (the CPU tests hold the plain versions to the JAX package instead).
Run on a GPU machine with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 rtol/atol 2e-5 and bf16 2e-2, as tests/test_kernels.py
holds the Pallas kernels; the gathers bit for bit.  The attention backward
is held to torch autograd through the plain version in f32: at f32
rtol/atol 1e-4 (sums over up to a few hundred keys in another order); at
bf16 to a normalized max error (max |kernel - ref| / max |ref| per
gradient) of 2e-2, since ``dS = P (dP - D)`` is a difference of nearly
equal terms whose bf16 rounding (of O, dO and the outputs) is relative to
the tensor's scale, not to each element.  The WKV recurrence's backward
is held the same way (f32 at 1e-4, bf16 at a normalized 2e-2), its
forward at the kernel tolerances above and its checkpointed states to
``ref.rwkv6_stateful`` at f32 1e-4; so is the RG-LRU recurrence (its
backward where a < 1, where autograd of the plain version is finite; at
a = 1 it is held to its stated value da = dh h_{t-1}, dx = 0).  Serving's
forms of both recurrences, from a carried state (h0, S0) with the final
state out, are held to ``ref.rglru(x, a, h0)`` and ``ref.rwkv6_stateful``
at f32 1e-4 and bf16 2e-2, at T = 1 included, and a null or zero state to
the stateless call's bits.  AdamW's one-pass kernel is held to its plain
version bit for bit (its round-to-nearest intrinsics contract nothing).
TF32 is off, so the plain versions' f32 products run in full f32.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_paged, decode_attention_partial)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention, flash_attention_bwd, kernel_smem, plan)
from repro_torch.kernels.moe_matmul import (  # noqa: E402
    BWD_TILE_KEYS, SLOT_TILES, TC_PRODUCTS, MoEGroupedFFN, bwd_kernel_queues,
    bwd_kernel_tiles, expert_rows, kernel_tiles,
    moe_grouped_ffn, plan_bwd)
from repro_torch.kernels.moe_matmul import plan as moe_plan  # noqa: E402
from repro_torch.kernels.page_gather import (  # noqa: E402
    page_gather, prefill_page_attention, prefill_page_attention_paged)
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    RGLRUScan, rglru_scan, rglru_scan_bwd)
from repro_torch.kernels.rglru_scan import chunk as lru_chunk  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel_tiles as lru_tiles  # noqa
from repro_torch.kernels.rglru_scan import plan as lru_plan  # noqa: E402
from repro_torch.kernels.ring_gather import ring_gather  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    KERNELS as WKV_KERNELS, RWKV6Scan, chunk, rwkv6_scan, rwkv6_scan_bwd)
from repro_torch.kernels.rwkv6_scan import kernel_tiles as wkv_tiles  # noqa
from repro_torch.kernels.rwkv6_scan import plan as wkv_plan  # noqa: E402
from repro_torch.models.attention import ring_positions  # noqa: E402
from repro_torch.models.moe import route  # noqa: E402

torch.set_num_threads(1)

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("S,H,KV,hd", [
    (64, 4, 4, 32),       # MHA
    (96, 4, 2, 64),       # GQA, ragged tile tail
    (130, 6, 2, 16),      # GQA 3:1, head dim padded inside the kernel
    (33, 2, 1, 128),      # short sequence, head dim 128
    (200, 15, 5, 64),     # smollm-360m heads
    (100, 10, 1, 256),    # recurrentgemma heads: group 10, head dim 256
    (300, 16, 16, 128),   # olmo-1b's heads: group 1, head dim 128
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_flash_attention(gen, S, H, KV, hd, dtype, causal, window):
    q = _randn(gen, (2, S, H, hd), dtype)
    k = _randn(gen, (2, S, KV, hd), dtype)
    v = _randn(gen, (2, S, KV, hd), dtype)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_flash_attention_strided_input(gen):
    """A (B, H, S, hd) tensor transposed to (B, S, H, hd) is read through
    its strides."""
    q = _randn(gen, (2, 8, 70, 64), torch.float32).transpose(1, 2)
    k = _randn(gen, (2, 2, 70, 64), torch.float32).transpose(1, 2)
    v = _randn(gen, (2, 2, 70, 64), torch.float32).transpose(1, 2)
    torch.testing.assert_close(flash_attention(q, k, v),
                               ref.attention(q, k, v),
                               **TOL[torch.float32])


def test_flash_attention_refuses_a_strided_head_dim(gen):
    """Any one of q, k, v with a non-unit head-dim stride is refused (the
    kernel reads the head dim as contiguous)."""
    q = _randn(gen, (1, 8, 2, 64), torch.float32)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    for args in ((strided, q, q), (q, strided, q), (q, q, strided)):
        with pytest.raises(ValueError, match="head dim must be contiguous"):
            flash_attention(*args)


def test_flash_attention_rejects_cross_lengths(gen):
    """Sq != Sk is taken only non-causal and unwindowed (the vision model's
    xattn), forward and backward: causal and windowed calls at such
    lengths are refused by both."""
    q = _randn(gen, (1, 8, 2, 64), torch.float32)
    k = _randn(gen, (1, 16, 2, 64), torch.float32)
    lse = torch.zeros((1, 2, 8), device="cuda")
    for kw in (dict(causal=True), dict(causal=False, window=4),
               dict(causal=True, window=4)):
        with pytest.raises(ValueError, match="Sq != Sk"):
            flash_attention(q, k, k, **kw)
        with pytest.raises(ValueError, match="Sq != Sk"):
            flash_attention_bwd(q, k, k, q, q, lse, **kw)


# the vision model's cross-attention shapes (Sq text rows, Sk media keys),
# heads cut from llama-3.2-vision-11b's 32 / 8 at hd 128 where the card's
# test time asks for it: one decode row, a prompt, ragged key tails past a
# tile (1601, 8, 100) and more rows than keys
CROSS = [
    (8, 1, 1600, 32, 8, 128),
    (1, 300, 1600, 32, 8, 128),
    (2, 1, 1601, 8, 2, 128),
    (2, 77, 8, 4, 2, 16),
    (1, 130, 100, 10, 1, 256),
    (2, 65, 1601, 4, 4, 64),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", CROSS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cross(gen, B, Sq, Sk, H, KV, hd, dtype):
    """Non-causal Sq != Sk against ``ref.attention``; the log-sum-exp too,
    and a forward through ``ops.attention`` under no_grad reaches the
    kernel."""
    q = _randn(gen, (B, Sq, H, hd), dtype)
    k = _randn(gen, (B, Sk, KV, hd), dtype)
    v = _randn(gen, (B, Sk, KV, hd), dtype)
    got, lse = flash_attention(q, k, v, causal=False, with_lse=True)
    want = ref.attention(q, k, v, causal=False)
    assert got.shape == (B, Sq, H, hd) and lse.shape == (B, H, Sq)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float().repeat_interleave(H // KV, dim=2))
    torch.testing.assert_close(lse, torch.logsumexp(scores * hd ** -0.5, -1),
                               rtol=1e-4, atol=1e-4)
    ops.reset_launches()
    with torch.no_grad():
        out = ops.attention(q, k, v, causal=False, window=0)
    assert ops.launches["flash_attention"] == 1
    assert torch.equal(out, got)


def test_flash_attention_cross_gradient_launches_both_kernels(gen):
    """One ``ops.attention`` call with a gradient at Sq != Sk launches one
    forward (with its lse) and one backward, no plain version, and its
    gradients are the kernel's own."""
    q = _randn(gen, (1, 4, 4, 64), torch.bfloat16).requires_grad_()
    k = _randn(gen, (1, 1600, 2, 64), torch.bfloat16).requires_grad_()
    v = _randn(gen, (1, 1600, 2, 64), torch.bfloat16).requires_grad_()
    do = _randn(gen, (1, 4, 4, 64), torch.bfloat16)
    ops.reset_launches()
    out = ops.attention(q, k, v, causal=False, window=0)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert ops.launches["flash_attention"] == 1
    assert ops.launches["flash_attention_bwd"] == 1
    assert sum(ops.launches.values()) == 2
    want = _attn_grads(q, k, v, do, False, 0, kernel=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _bf16_grads_err(got, q, k, v, do, False, 0) <= 2e-2


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", CROSS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cross_bwd(gen, B, Sq, Sk, H, KV, hd, dtype):
    """The backward at non-causal Sq != Sk (ragged tails on both sides:
    Sq 77 and 65 past a 64-row tile, Sk 1601, 8 and 100) against torch
    autograd of ``ref.attention``: f32 at rtol/atol 1e-4, bf16 at a
    normalized 2e-2; dK and dV have the keys' shape."""
    q, do = (_randn(gen, (B, Sq, H, hd), dtype) for _ in range(2))
    k, v = (_randn(gen, (B, Sk, KV, hd), dtype) for _ in range(2))
    got = _attn_grads(q, k, v, do, False, 0, kernel=True)
    want = _attn_grads(q.float(), k.float(), v.float(), do.float(), False,
                       0, kernel=False)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            err = (g.float() - w).abs().max() / w.abs().max()
            assert err <= 2e-2, err


@pytest.mark.parametrize("B,L,H,KV,hd", [
    (3, 40, 4, 2, 64),
    (8, 544, 32, 8, 64),   # the serving shape of llama3.2-1b: 5 splits
    (2, 100, 15, 5, 64),   # smollm-360m heads: group 3
    (2, 77, 16, 2, 128),   # group 8
    (2, 700, 10, 1, 256),  # recurrentgemma-2b's local heads: 6 splits
    (3, 300, 4, 1, 16),    # its smoke config: head dim padded to 64
    (2, 130, 16, 1, 32),   # group 16, a one-slot last split
    (4, 544, 16, 16, 128),  # olmo-1b's heads: group 1, one live tile row
    (4, 544, 32, 32, 64),  # musicgen-large's: group 1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention(gen, B, L, H, KV, hd, dtype):
    q = _randn(gen, (B, 1, H, hd), dtype)
    k = _randn(gen, (B, L, KV, hd), dtype)
    v = _randn(gen, (B, L, KV, hd), dtype)
    valid = torch.rand((B, L), generator=gen, device="cuda") < 0.6
    valid[:, 0] = True                      # at least one live slot per row
    valid[0] = False
    valid[0, L - 1] = True                  # a row with one live slot
    got = decode_attention(q, k, v, valid)
    want = ref.attention_decode(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    shared = torch.ones((L,), dtype=torch.bool, device="cuda")
    torch.testing.assert_close(decode_attention(q, k, v, shared).float(),
                               ref.attention_decode(q, k, v, shared).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("L,H,KV,hd", [(544, 32, 8, 64), (2048, 10, 1, 256),
                                       (1024, 32, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_is_batch_invariant(gen, L, H, KV, hd, dtype):
    """Each row of a batch of 8 gives the bits it gives alone, and two
    calls give the same bits: the split comes from (L, hd, dtype) alone and
    the partials merge in split order, whichever block comes last."""
    B = 8
    q = _randn(gen, (B, 1, H, hd), dtype)
    k = _randn(gen, (B, L, KV, hd), dtype)
    v = _randn(gen, (B, L, KV, hd), dtype)
    n_live = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
    valid = torch.arange(L, device="cuda")[None, :] < n_live[:, None]
    got = decode_attention(q, k, v, valid)
    assert torch.equal(got, decode_attention(q, k, v, valid))
    for b in range(B):
        one = decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                               valid[b:b + 1])
        assert torch.equal(one, got[b:b + 1]), b


def test_decode_attention_dead_splits_merge_to_nothing(gen):
    """Live slots in one split of five only, or in none: finite, and a row
    with no live slot writes 0."""
    B, L, H, KV, hd = 3, 544, 8, 2, 64
    q = _randn(gen, (B, 1, H, hd), torch.bfloat16)
    k = _randn(gen, (B, L, KV, hd), torch.bfloat16)
    v = _randn(gen, (B, L, KV, hd), torch.bfloat16)
    valid = torch.zeros((B, L), dtype=torch.bool, device="cuda")
    valid[0, 300:310] = True
    valid[1, L - 1] = True
    got = decode_attention(q, k, v, valid)
    torch.testing.assert_close(got[:2].float(), ref.attention_decode(
        q[:2], k[:2], v[:2], valid[:2]).float(), **TOL[torch.bfloat16])
    assert torch.equal(got[2], torch.zeros_like(got[2]))


@pytest.mark.parametrize("B,L,H,KV,hd", [
    (8, 544, 32, 8, 64), (4, 2048, 10, 1, 256), (3, 1024, 8, 4, 256),
    (2, 300, 4, 1, 16)])
@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_partial(gen, B, L, H, KV, hd, parts, dtype):
    """The partial form over each part of a ring cut into ``parts`` (rows
    with dead parts included) against ``ops._decode_partial`` (m at f32's
    tolerance), and the parts' combine against the whole-ring kernel."""
    q = _randn(gen, (B, 1, H, hd), dtype)
    k = _randn(gen, (B, L, KV, hd), dtype)
    v = _randn(gen, (B, L, KV, hd), dtype)
    n_live = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
    n_live[0] = 1
    valid = torch.arange(L, device="cuda")[None, :] < n_live[:, None]
    Lp = L // parts
    got = []
    for i in range(parts):
        sl = slice(i * Lp, (i + 1) * Lp)
        part = (q, k[:, sl], v[:, sl], valid[:, sl])
        g = decode_attention_partial(*part)
        w = ops._decode_partial(*part)
        for a, b, tol in zip(g, w, (TOL[dtype], TOL[dtype],
                                    TOL[torch.float32])):
            torch.testing.assert_close(a, b, **tol)
        got.append(g)
    o, l, m = (torch.stack(t) for t in zip(*got))
    out = ops.combine_parts(o, l, m, lambda t: t.amax(0, keepdim=True),
                            lambda t: t.sum(0))
    whole = decode_attention(q, k[:, :parts * Lp], v[:, :parts * Lp],
                             valid[:, :parts * Lp])
    torch.testing.assert_close(out.to(dtype).float(), whole.float(),
                               **TOL[dtype])


def test_decode_attention_refuses(gen):
    q = _randn(gen, (1, 1, 17, 64), torch.float32)
    k = _randn(gen, (1, 8, 1, 64), torch.float32)
    valid = torch.ones((8,), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="group 17"):
        decode_attention(q, k, k, valid)
    q = _randn(gen, (1, 1, 4, 48), torch.float32)
    k = _randn(gen, (1, 8, 1, 48), torch.float32)
    with pytest.raises(ValueError, match="head dim 48"):
        decode_attention(q, k, k, valid)
    q = _randn(gen, (1, 1, 4, 64), torch.bfloat16)
    k = _randn(gen, (1, 8, 1, 65), torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q, k, k, valid)


def _decode_pools(gen, B, n_pp, page, H, KV, hd, dtype):
    """q and pools of B * n_pp + 1 pages (the last the junk page) under a
    shuffled table, and ring masks: row 0 idle (its whole table on the
    junk page, pos 0: slot 0 live), row 1 with no live slot, the others
    random with their last slot live."""
    P = B * n_pp + 1
    q = _randn(gen, (B, 1, H, hd), dtype)
    pk, pv = (_randn(gen, (P, page, KV, hd), dtype) for _ in range(2))
    table = torch.randperm(P - 1, generator=gen, device="cuda")[:B * n_pp]
    table = table.reshape(B, n_pp).to(torch.int32)
    table[0] = P - 1
    L = n_pp * page
    valid = torch.rand((B, L), generator=gen, device="cuda") < 0.6
    valid[:, L - 1] = True
    valid[0] = False
    valid[0, 0] = True
    valid[1] = False
    return q, pk, pv, table, valid


@pytest.mark.parametrize("n_pp,page", [
    (4, 16),     # one split
    (34, 16),    # the serving ring: 5 splits, L not a multiple of a split
    (13, 20),    # splits starting mid-page
])
@pytest.mark.parametrize("hd,H,KV", [(64, 16, 4), (64, 10, 1),
                                     (128, 8, 2), (128, 20, 2),
                                     (256, 4, 1), (256, 10, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_paged(gen, n_pp, page, hd, H, KV, dtype):
    """Pages read in place under a shuffled table give the bits of
    ``decode_attention`` over ``page_gather``'s view, and the plain
    version's result within tolerance; an idle row reads the junk page as
    the gathered form does, and a row with no live slot gives 0."""
    B = 5
    q, pk, pv, table, valid = _decode_pools(gen, B, n_pp, page, H, KV, hd,
                                            dtype)
    got = decode_attention_paged(q, pk, pv, table, valid)
    k, v = page_gather(pk, table), page_gather(pv, table)
    assert torch.equal(got, decode_attention(q, k, v, valid))
    live = [0] + list(range(2, B))
    torch.testing.assert_close(
        got[live].float(),
        ref.attention_decode(q[live], k[live], v[live], valid[live]).float(),
        **TOL[dtype])
    assert torch.equal(got[1], torch.zeros_like(got[1]))


@pytest.mark.parametrize("n_pp,H,KV,hd", [(34, 32, 8, 64),
                                          (128, 10, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_paged_is_batch_invariant(gen, n_pp, H, KV, hd,
                                                   dtype):
    """Each row of a batch of 8 gives alone (its own table row, the same
    pools) the bits it gives inside the batch, and two calls give the same
    bits."""
    B = 8
    q, pk, pv, table, valid = _decode_pools(gen, B, n_pp, 16, H, KV, hd,
                                            dtype)
    got = decode_attention_paged(q, pk, pv, table, valid)
    assert torch.equal(got, decode_attention_paged(q, pk, pv, table, valid))
    for b in range(B):
        one = decode_attention_paged(q[b:b + 1], pk, pv, table[b:b + 1],
                                     valid[b:b + 1])
        assert torch.equal(one, got[b:b + 1]), b


def test_decode_attention_paged_refuses(gen):
    q, pk, pv, table, valid = _decode_pools(gen, 2, 4, 16, 8, 2, 64,
                                            torch.bfloat16)
    ok = (q, pk, pv, table, valid)

    def refused(match, **kw):
        args = dict(zip(("q", "k_pool", "v_pool", "page_table", "valid"),
                        ok), **kw)
        with pytest.raises(ValueError, match=match):
            decode_attention_paged(*args.values())
    refused("page_table", page_table=table.long())
    refused("page_table", page_table=table[:1])
    refused("page_table", page_table=table.t().contiguous().t())
    refused("page_table", page_table=table[0])
    refused("dtypes", v_pool=pv.float())
    refused("shapes", v_pool=pv[:-1])
    refused("vs k", q=q[:, :, :, :32])
    refused("valid", valid=valid[:, :-1])
    refused("group 17", q=_randn(gen, (2, 1, 34, 64), torch.bfloat16))
    refused("16-byte aligned",
            k_pool=_randn(gen, pk.shape[:3] + (65,), torch.bfloat16)[..., 1:],
            v_pool=_randn(gen, pk.shape[:3] + (65,), torch.bfloat16)[..., 1:])
    refused("CUDA tensors", page_table=table.cpu())


def test_decode_attention_paged_traps_on_a_page_outside_the_pool(gen):
    """A page id outside [0, P) is a fault of the caller's tables: the
    kernel traps (in a child process: a trap ends the CUDA context)."""
    code = ("import torch; from repro_torch.kernels.decode_attention import "
            "decode_attention_paged as d; p = torch.zeros((3, 16, 1, 64), "
            "device='cuda'); t = torch.tensor([[0, 3]], dtype=torch.int32, "
            "device='cuda'); d(torch.zeros((1, 1, 4, 64), device='cuda'), "
            "p, p, t, torch.ones(32, dtype=torch.bool, device='cuda')); "
            "torch.cuda.synchronize(); print('no trap')")
    env = {**os.environ,
           "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no trap" not in res.stdout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_page_gather_bit_exact(gen, dtype):
    P, page, KV, hd, B, n_pp = 17, 8, 2, 64, 3, 5
    pool = _randn(gen, (P, page, KV, hd), dtype)
    table = torch.randint(0, P, (B, n_pp), generator=gen, device="cuda",
                          dtype=torch.int32)
    assert torch.equal(page_gather(pool, table), ref.page_gather(pool, table))


def test_ops_route_by_device_and_count_launches(gen):
    q = _randn(gen, (1, 16, 4, 64), torch.bfloat16).requires_grad_()
    k = _randn(gen, (1, 16, 2, 64), torch.bfloat16).requires_grad_()
    pool = _randn(gen, (5, 4, 2, 64), torch.bfloat16)
    table = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    hist = _randn(gen, (3, 256), torch.float32)
    ops.reset_launches()
    ops.attention(q, k, k).sum().backward()
    ops.page_gather(pool, table)
    ops.attention_decode(q[:, :1].detach(), k.detach(), k.detach(),
                         torch.ones((16,), dtype=torch.bool, device="cuda"))
    ops.ring_gather(hist, torch.tensor(1, dtype=torch.int32, device="cuda"))
    ops.prefill_page_attention_paged(*_paged_inputs(
        gen, 1, 8, 4, 4, 4, 2, 64, 5, torch.bfloat16))
    dispatch, *moe = _moe_inputs(gen, 1, 8, 4, 4, 64, 96, torch.bfloat16)
    ops.moe_grouped_ffn(dispatch, *[t.requires_grad_() for t in moe]
                        ).float().sum().backward()
    wkv = [t.requires_grad_() for t in _wkv_inputs(gen, 1, 9, 2, 16,
                                                   torch.bfloat16)]
    ops.rwkv6(*wkv).float().sum().backward()
    x, a = (t.requires_grad_() for t in _lru_inputs(gen, 1, 9, 40,
                                                      torch.bfloat16))
    ops.rglru(x, a).float().sum().backward()
    torch.cuda.synchronize()
    assert ops.launches == {name: 1 for name in _build.KERNELS}
    ref.attention(q, k, k)                  # the plain version never counts
    assert ops.launches["flash_attention"] == 1


@pytest.mark.parametrize("dtype,n", [
    (torch.float32, 1 << 20),     # 16-byte vectors
    (torch.bfloat16, 100_003),    # odd length: 2-byte units
    (torch.bfloat16, 4_098),      # 4-byte units
])
def test_ring_gather_bit_exact(gen, dtype, n):
    hist = _randn(gen, (3, n), dtype)
    for i in range(3):
        idx = torch.tensor(i, dtype=torch.int32, device="cuda")
        assert torch.equal(ring_gather(hist, idx), ref.ring_gather(hist, idx))
    with pytest.raises(ValueError, match="0-d int32"):
        ring_gather(hist, torch.tensor([0], dtype=torch.int32, device="cuda"))


def test_ring_gather_traps_on_an_index_outside_the_ring(gen):
    """An index past the ring is a fault of the caller: the kernel traps
    (in a child process: a trap ends the CUDA context)."""
    code = ("import torch; from repro_torch.kernels.ring_gather import "
            "ring_gather; h = torch.zeros((3, 1024), device='cuda'); "
            "ring_gather(h, torch.tensor(3, dtype=torch.int32, "
            "device='cuda')); torch.cuda.synchronize(); print('no trap')")
    env = {**os.environ,
           "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no trap" not in res.stdout


ADAMW_HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("n,offset", [
    (1, 0), (4, 0), (1_003, 0), (1 << 20, 0),   # tails and 16-byte vectors
    (1_003, 1)])                                # unaligned: one at a time
@pytest.mark.parametrize("clip", [False, True])
def test_adamw_bit_exact(gen, p_dtype, g_dtype, n, offset, clip):
    """Three steps of the one-pass kernel against its plain version: p, m
    and v bit for bit (round-to-nearest intrinsics: nothing contracted)."""
    from repro_torch.kernels.adamw import adamw_kernel, adamw_plain

    def draw(dtype, s):
        buf = torch.randn(n + offset, generator=gen, device="cuda") * s
        return buf[offset:].to(dtype)
    kp = pp = draw(p_dtype, 0.02)
    km = pm = draw(torch.float32, 1e-3)
    kv = pv = draw(torch.float32, 1e-3).abs()
    scale = torch.tensor(0.3721, device="cuda") if clip else None
    for step in range(1, 4):
        g = draw(g_dtype, 1e-2)
        t = torch.tensor(float(step), device="cuda")
        bc1 = 1 - torch.pow(ADAMW_HYPER["b1"], t)
        bc2 = 1 - torch.pow(ADAMW_HYPER["b2"], t)
        kp, km, kv = adamw_kernel(g, km, kv, kp, scale, bc1, bc2,
                                  **ADAMW_HYPER)
        pp, pm, pv = adamw_plain(g, pm, pv, pp, scale, bc1, bc2,
                                 **ADAMW_HYPER)
        for a, b in ((kp, pp), (km, pm), (kv, pv)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_adamw_routes_refuses_and_counts(gen):
    from repro_torch.kernels.adamw import adamw, counts
    x = torch.randn((64, 32), generator=gen, device="cuda")
    one = torch.ones((), device="cuda")
    before = x.clone()
    counts.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = adamw(x, x, x.abs(), x, one, one, one, **ADAMW_HYPER)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (counts.launches, counts.elements) == (1, x.numel())
    assert torch.equal(x, before)
    assert all(o.data_ptr() != x.data_ptr() for o in outs)
    nc = x.t().contiguous().t()
    for args in ((x, x, x, nc), (nc, x, x, x)):
        with pytest.raises(ValueError, match="contiguous"):
            adamw(*args, None, one, one, **ADAMW_HYPER)
    with pytest.raises(ValueError, match="0-d f32"):
        adamw(x, x, x, x, None, one.cpu(), one, **ADAMW_HYPER)
    assert counts.launches == 1


def _attn_grads(q, k, v, do, causal, window, kernel):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    fn = FlashAttention.apply if kernel else (
        lambda *a: ref.attention(*a[:3], causal=a[3], window=a[4]))
    out = fn(q, k, v, causal, window)
    return torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("S,H,KV,hd", [
    (64, 4, 4, 32),       # MHA
    (96, 4, 2, 64),       # GQA, ragged tile tail
    (130, 6, 2, 16),      # GQA 3:1, head dim padded inside the kernel
    (200, 15, 5, 64),     # smollm-360m heads
    (77, 8, 1, 128),      # group 8, head dim 128
    (100, 10, 1, 256),    # recurrentgemma heads: 32-row backward tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_flash_attention_bwd(gen, S, H, KV, hd, dtype, causal, window):
    q = _randn(gen, (2, S, H, hd), dtype)
    k = _randn(gen, (2, S, KV, hd), dtype)
    v = _randn(gen, (2, S, KV, hd), dtype)
    do = _randn(gen, (2, S, H, hd), dtype)
    got = _attn_grads(q, k, v, do, causal, window, kernel=True)
    want = _attn_grads(q.float(), k.float(), v.float(), do.float(), causal,
                       window, kernel=False)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            err = (g.float() - w).abs().max() / w.abs().max()
            assert err <= 2e-2, err


def test_flash_attention_lse_and_strided_bwd(gen):
    """The forward's log-sum-exp equals the plain one; the backward reads
    transposed (B, H, S, hd) inputs through their strides."""
    q = _randn(gen, (2, 8, 70, 64), torch.float32).transpose(1, 2)
    k = _randn(gen, (2, 2, 70, 64), torch.float32).transpose(1, 2)
    out, lse = flash_attention(q, k, k, with_lse=True)
    scores = torch.einsum("bqhd,bkhd->bhqk", q,
                          k.repeat_interleave(4, dim=2)) * 64 ** -0.5
    causal = torch.ones(70, 70, dtype=torch.bool, device="cuda").tril()
    want = torch.logsumexp(scores.masked_fill(~causal, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    do = _randn(gen, (2, 70, 8, 64), torch.float32)
    got = flash_attention_bwd(q, k, k, out, do, lse)
    want = _attn_grads(q, k, k, do, True, 0, kernel=False)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    # k is passed as both k and v: its two gradients add up
    torch.testing.assert_close(got[1] + got[2], want[1] + want[2],
                               rtol=1e-4, atol=1e-4)


def test_ops_attention_gradients_on_cuda(gen):
    """Training through ``ops.attention`` on the card reaches the backward
    kernel: q, k and v all get non-zero gradients equal to the plain
    version's."""
    # weights at the usual 1/sqrt(fan_in) scale keep the scores O(1): with
    # unit weights they reach ~30, the softmax saturates, and both f32
    # gradients carry errors near 1e-5 of their 2e3 scale
    wq, wk, wv = (
        (_randn(gen, (32, n), torch.float32) * 32 ** -0.5).requires_grad_()
        for n in (64, 32, 32))
    x = _randn(gen, (2, 40, 32), torch.float32)

    def loss(attn):
        q = (x @ wq).view(2, 40, 4, 16)
        k = (x @ wk).view(2, 40, 2, 16)
        v = (x @ wv).view(2, 40, 2, 16)
        return (attn(q, k, v, causal=True, window=0) ** 2).sum()

    ops.reset_launches()
    got = torch.autograd.grad(loss(ops.attention), (wq, wk, wv))
    assert ops.launches["flash_attention_bwd"] == 1
    want = torch.autograd.grad(loss(ref.attention), (wq, wk, wv))
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


@pytest.mark.parametrize("Sq,Sk,H,KV,hd,causal", [
    (300, 300, 16, 4, 64, True),
    (77, 1601, 32, 8, 128, False),   # xattn: ragged tails on both sides
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_is_deterministic(gen, Sq, Sk, H, KV, hd, causal,
                                              dtype):
    """Two backward runs give equal bits, at Sq == Sk and at the vision
    model's Sq != Sk."""
    q, do = (_randn(gen, (2, Sq, H, hd), dtype) for _ in range(2))
    k = _randn(gen, (2, Sk, KV, hd), dtype)
    a = _attn_grads(q, k, k, do, causal, 0, kernel=True)
    b = _attn_grads(q, k, k, do, causal, 0, kernel=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_hd256_window_bites(gen):
    """recurrentgemma's local layers at a reduced length: head dim 256, 10
    q heads over 1 kv head, a window of 128 over 700 positions (keys behind
    the window masked, tiles behind it skipped), bf16; forward at 2e-2,
    backward to a normalized 2e-2 and deterministic."""
    q = _randn(gen, (1, 700, 10, 256), torch.bfloat16)
    k = _randn(gen, (1, 700, 1, 256), torch.bfloat16)
    v = _randn(gen, (1, 700, 1, 256), torch.bfloat16)
    do = _randn(gen, (1, 700, 10, 256), torch.bfloat16)
    got = flash_attention(q, k, v, causal=True, window=128)
    want = ref.attention(q, k, v, causal=True, window=128)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    a = _attn_grads(q, k, v, do, True, 128, kernel=True)
    b = _attn_grads(q, k, v, do, True, 128, kernel=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = _attn_grads(q.float(), k.float(), v.float(), do.float(), True,
                       128, kernel=False)
    for g, w in zip(a, want):
        err = (g.float() - w).abs().max() / w.abs().max()
        assert err <= 2e-2, err


def _bf16_grads_err(got, q, k, v, do, causal, window):
    """Normalized max error of kernel gradients against autograd of the
    plain version in f32 on the same bf16 inputs."""
    want = _attn_grads(q.float(), k.float(), v.float(), do.float(), causal,
                       window, kernel=False)
    return max(((g.float() - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("hd,H,KV", [(64, 8, 2), (256, 10, 1)])
def test_flash_attention_is_batch_invariant(gen, hd, H, KV):
    """One batch row alone gives the bits it gives inside a batch of 4,
    forward and backward (the plan never reads B)."""
    S, row = 200, 2
    q, do = (_randn(gen, (4, S, H, hd), torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, (4, S, KV, hd), torch.bfloat16) for _ in range(2))
    full = flash_attention(q, k, v, causal=True, window=48)
    one = flash_attention(q[row:row + 1], k[row:row + 1], v[row:row + 1],
                          causal=True, window=48)
    assert torch.equal(full[row:row + 1], one)
    g_full = _attn_grads(q, k, v, do, True, 48, kernel=True)
    g_one = _attn_grads(q[row:row + 1], k[row:row + 1], v[row:row + 1],
                        do[row:row + 1], True, 48, kernel=True)
    assert all(torch.equal(a[row:row + 1], b) for a, b in zip(g_full, g_one))


def test_flash_attention_bf16_strided_input(gen):
    """bf16 (B, H, S, hd) tensors transposed to (B, S, H, hd): aligned
    strides, read through them, the bits of the contiguous copies, forward
    and backward."""
    q, do = (_randn(gen, (2, 8, 70, 64), torch.bfloat16).transpose(1, 2)
             for _ in range(2))
    k, v = (_randn(gen, (2, 2, 70, 64), torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    got = flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), ref.attention(q, k, v).float(),
                               **TOL[torch.bfloat16])
    dense = [t.contiguous() for t in (q, k, v, do)]
    assert torch.equal(got, flash_attention(*dense[:3]))
    grads = _attn_grads(q, k, v, do, True, 0, kernel=True)
    assert all(torch.equal(a, b) for a, b in zip(
        grads, _attn_grads(*dense, True, 0, kernel=True)))
    assert _bf16_grads_err(grads, q, k, v, do, True, 0) <= 2e-2


def test_flash_attention_refuses_misaligned_bf16(gen):
    """bf16 tiles are copied 16 bytes at a time: a base pointer, a stride
    or a head dim that is not a multiple of 8 elements is refused, forward
    and backward; f32 takes them."""
    q = _randn(gen, (1, 16, 4, 64), torch.bfloat16)
    flat = _randn(gen, (1 + q.numel(),), torch.bfloat16)
    shifted = flat[1:].view(q.shape)                 # base off by 2 bytes
    padded = _randn(gen, (1, 16, 4, 68), torch.bfloat16)[..., :64]
    narrow = _randn(gen, (1, 16, 4, 20), torch.bfloat16)
    for bad in (shifted, padded):
        for args in ((bad, q, q), (q, bad, q), (q, q, bad)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                flash_attention(*args)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(narrow, narrow, narrow)
    o, lse = flash_attention(q, q, q, with_lse=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(q, q, q, o, shifted, lse)
    flash_attention(*(t.float() for t in (narrow, narrow, narrow)))


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 200, 4, 4, 64),      # group 1 (MHA): one partial a kv head
    (2, 200, 15, 5, 64),     # group 3 (smollm-360m heads)
    (2, 300, 10, 1, 256),    # group 10 (recurrentgemma heads)
    (1, 1100, 32, 8, 64),    # group 4, walked two q heads a block
])
def test_flash_attention_bwd_split_and_reduce(gen, B, S, H, KV, hd):
    """bf16 dK/dV as f32 partials per chunk of the group, summed in a fixed
    order: right, and bit-identical run to run."""
    p = plan(S, S, H, KV, hd, torch.bfloat16)
    assert p["split"] * p["heads_per_block"] == H // KV
    if S == 1100:
        assert p["heads_per_block"] == 2
    q, do = (_randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, (B, S, KV, hd), torch.bfloat16) for _ in range(2))
    a = _attn_grads(q, k, v, do, True, 0, kernel=True)
    b = _attn_grads(q, k, v, do, True, 0, kernel=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _bf16_grads_err(a, q, k, v, do, True, 0) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_plan_matches_the_kernels(gen, dtype):
    """The wrapper's plan states the shared memory the CUDA source sizes
    its launches with."""
    for hd in (16, 32, 64, 128, 256):
        p = plan(512, 512, 8, 2, hd, dtype)
        assert kernel_smem(dtype, hd) == {
            kind: p[kind]["smem"] for kind in ("fwd", "dkdv", "dq")}


def _chunk_inputs(gen, B, C, L, H, KV, hd, start, dtype):
    """A chunk at positions start..start+C-1 over a ring of L slots holding
    the positions before it, as ``attention_prefill_paged`` makes them."""
    q = _randn(gen, (B, C, H, hd), dtype)
    k_ctx, v_ctx = (_randn(gen, (B, L, KV, hd), dtype) for _ in range(2))
    k_new, v_new = (_randn(gen, (B, C, KV, hd), dtype) for _ in range(2))
    ctx_pos = ring_positions(start, L, "cuda")[None].expand(B, L)
    q_pos = (start + torch.arange(C, dtype=torch.int32,
                                  device="cuda"))[None].expand(B, C)
    return q, k_ctx, v_ctx, k_new, v_new, ctx_pos, q_pos


def _paged_inputs(gen, B, C, n_pp, page, H, KV, hd, start, dtype):
    """The same chunk with its ring in pools of B * n_pp + 3 pages under a
    shuffled table: (q, k_pool, v_pool, table, k_new, v_new, ctx_pos,
    q_pos)."""
    L = n_pp * page
    q, k_ctx, v_ctx, k_new, v_new, ctx_pos, q_pos = _chunk_inputs(
        gen, B, C, L, H, KV, hd, start, dtype)
    P = B * n_pp + 3
    table = torch.randperm(P, generator=gen, device="cuda")[:B * n_pp]
    table = table.reshape(B, n_pp).to(torch.int32)
    pools = []
    for ctx in (k_ctx, v_ctx):
        pool = _randn(gen, (P, page, KV, hd), dtype)
        pool[table.long()] = ctx.reshape(B, n_pp, page, KV, hd)
        pools.append(pool)
    return (q, pools[0], pools[1], table, k_new, v_new, ctx_pos, q_pos)


# chip_smoke.py's cases at llama3.2-1b's heads (C, L, start, window, dtype):
# an empty ring, dead slots, a wrapped ring, windows, one f32 case
PREFILL_CASES = [
    (128, 544, 0, 0, torch.bfloat16),
    (128, 544, 256, 0, torch.bfloat16),
    (16, 544, 320, 0, torch.bfloat16),
    (128, 1024, 700, 0, torch.bfloat16),
    (128, 544, 900, 0, torch.bfloat16),
    (16, 1024, 1500, 128, torch.bfloat16),
    (128, 544, 300, 128, torch.bfloat16),
    (128, 544, 900, 0, torch.float32),
]


@pytest.mark.parametrize("C,L,start,window,dtype", PREFILL_CASES)
def test_prefill_page_attention_serving_shapes(gen, C, L, start, window,
                                               dtype):
    ins = _chunk_inputs(gen, 1, C, L, 32, 8, 64, start, dtype)
    got = prefill_page_attention(*ins, window=window)
    want = ref.prefill_page_attention(*ins, window=window)
    tol = TOL[dtype] if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("B,C,L,H,KV,hd,start,window", [
    (2, 8, 32, 4, 2, 16, 10, 0),      # GQA, head dim padded in the kernel
    (2, 8, 16, 2, 2, 8, 45, 12),      # MHA, wrapped windowed ring
    (1, 24, 40, 15, 5, 64, 17, 0),    # smollm-360m heads: group 3
    (2, 33, 64, 16, 2, 128, 70, 0),   # group 8, widest head, ragged tiles
    (1, 8, 8, 4, 1, 32, 3, 0),        # C == L
    (1, 128, 544, 16, 16, 128, 172, 0),  # olmo-1b's heads: group 1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_page_attention(gen, B, C, L, H, KV, hd, start, window,
                                dtype):
    ins = _chunk_inputs(gen, B, C, L, H, KV, hd, start, dtype)
    got = prefill_page_attention(*ins, window=window)
    want = ref.prefill_page_attention(*ins, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("B,C,n_pp,page,H,KV,hd,start,window", [
    (1, 128, 34, 16, 32, 8, 64, 256, 0),      # the chunked serving shape
    (1, 128, 34, 16, 32, 8, 128, 900, 0),     # mixtral's heads, wrapped
    (1, 128, 128, 16, 10, 1, 256, 2200, 2048),  # recurrentgemma-2b's local
    (2, 24, 5, 8, 4, 1, 16, 70, 16),          # its smoke config, wrapped
    (2, 33, 4, 16, 16, 2, 128, 100, 0),       # group 8, ragged tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_page_attention_paged(gen, B, C, n_pp, page, H, KV, hd,
                                      start, window, dtype):
    """Pages read in place under a shuffled table against the plain
    version over ``ref.page_gather``; the gathered form (one page of L
    slots a row) gives the same bits."""
    ins = _paged_inputs(gen, B, C, n_pp, page, H, KV, hd, start, dtype)
    q, pk, pv, table, k_new, v_new, ctx_pos, q_pos = ins
    got = prefill_page_attention_paged(*ins, window=window)
    want = ref.prefill_page_attention(
        q, ref.page_gather(pk, table), ref.page_gather(pv, table), k_new,
        v_new, ctx_pos, q_pos, window=window)
    tol = TOL[dtype] if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    view = prefill_page_attention(q, page_gather(pk, table),
                                  page_gather(pv, table), k_new, v_new,
                                  ctx_pos, q_pos, window=window)
    assert torch.equal(got, view)


def test_prefill_page_attention_dead_rows_write_zero(gen):
    """A row with no live key writes 0, not NaN (denominator clamp)."""
    q, k_ctx, v_ctx, k_new, v_new, ctx_pos, q_pos = _chunk_inputs(
        gen, 1, 8, 16, 4, 2, 64, 0, torch.float32)
    ctx_pos = torch.full_like(ctx_pos, -1)
    q_pos = torch.full_like(q_pos, -5)
    out = prefill_page_attention(q, k_ctx, v_ctx, k_new, v_new, ctx_pos,
                                 q_pos)
    assert torch.equal(out, torch.zeros_like(out))


def test_prefill_page_attention_refuses(gen):
    ins = list(_chunk_inputs(gen, 1, 8, 16, 4, 2, 64, 5, torch.float32))
    long = _chunk_inputs(gen, 1, 24, 16, 4, 2, 64, 5, torch.float32)
    with pytest.raises(ValueError, match="longer than the ring"):
        prefill_page_attention(*long)
    bad = list(ins)
    bad[0] = _randn(gen, (1, 8, 3, 64), torch.float32)
    with pytest.raises(ValueError, match="heads"):
        prefill_page_attention(*bad)
    with pytest.raises(ValueError, match="CUDA tensors"):
        prefill_page_attention(*[t.cpu() for t in ins])
    bad = list(ins)
    bad[5] = bad[5].long()
    with pytest.raises(ValueError, match="ctx_pos"):
        prefill_page_attention(*bad)
    paged = list(_paged_inputs(gen, 1, 8, 4, 4, 4, 2, 64, 5,
                               torch.bfloat16))
    bad = list(paged)
    bad[3] = bad[3].long()
    with pytest.raises(ValueError, match="page_table"):
        prefill_page_attention_paged(*bad)
    bad = list(paged)
    bad[0] = _randn(gen, (1, 8, 4, 72), torch.bfloat16)[..., 4:68]
    with pytest.raises(ValueError, match="16-byte aligned"):
        prefill_page_attention_paged(*bad)
    bad = list(paged)
    big = _randn(gen, (9, 4, 2, 264), torch.bfloat16)
    bad[0] = _randn(gen, (1, 8, 4, 264), torch.bfloat16)
    bad[1] = bad[2] = big
    bad[4] = bad[5] = _randn(gen, (1, 8, 2, 264), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 264"):
        prefill_page_attention_paged(*bad)


def test_prefill_page_attention_is_deterministic(gen):
    ins = _chunk_inputs(gen, 1, 128, 544, 32, 8, 64, 900, torch.bfloat16)
    a = prefill_page_attention(*ins, window=128)
    b = prefill_page_attention(*ins, window=128)
    assert torch.equal(a, b)


@pytest.mark.parametrize("C,n_pp,H,KV,hd,start,window", [
    (64, 8, 32, 8, 64, 100, 96),
    (128, 128, 10, 1, 256, 2200, 2048),   # bf16: keys split over 3 blocks
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_page_attention_is_batch_invariant(gen, C, n_pp, H, KV, hd,
                                                   start, window, dtype):
    """A batch row alone gives the bits it gives inside a batch of 3, and
    two calls give the same bits (the key split merges in split order,
    whichever block comes last)."""
    ins = _paged_inputs(gen, 3, C, n_pp, 16, H, KV, hd, start, dtype)
    got = prefill_page_attention_paged(*ins, window=window)
    assert torch.equal(got, prefill_page_attention_paged(*ins,
                                                         window=window))
    for b in range(3):
        one = [t[b:b + 1] for t in ins]
        one[1], one[2] = ins[1], ins[2]        # the pools are shared
        assert torch.equal(prefill_page_attention_paged(*one, window=window),
                           got[b:b + 1])


# ---------------------------------------------------------------------------
# moe_grouped_ffn
# ---------------------------------------------------------------------------

def _moe_routing(gen, G, g, E, C, k=2):
    """Top-k dispatch/combine on the card from random router logits."""
    probs = torch.softmax(torch.randn((G, g, E), generator=gen,
                                      device="cuda"), -1)
    return route(probs, k, C)


def _moe_inputs(gen, G, g, E, C, d, f, dtype, routing=None):
    dispatch, combine = routing or _moe_routing(gen, G, g, E, C)
    x = _randn(gen, (G, g, d), dtype)
    wg = (_randn(gen, (E, d, f), torch.float32) * d ** -0.5).to(dtype)
    wu = (_randn(gen, (E, d, f), torch.float32) * d ** -0.5).to(dtype)
    wd = (_randn(gen, (E, f, d), torch.float32) * f ** -0.5).to(dtype)
    return dispatch, combine, x, wg, wu, wd


def _moe_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL[dtype])
    else:       # normalized as the bf16 checks of the model paths
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * max(want.float().abs().max(), 1.0), err


@pytest.mark.parametrize("G,g,E,C,d,f", [
    (1, 16, 4, 8, 32, 48),          # tests/test_kernels.py's shapes
    (2, 24, 4, 16, 16, 64),
    (1, 32, 8, 10, 64, 96),         # capacity drops
    (1, 8, 8, 3, 256, 512),         # a decode batch: g 8, C 3
    (1, 128, 8, 40, 128, 256),      # a chunk: C 40
    (1, 300, 8, 94, 64, 128),       # a 300-token prompt: 2 slot tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn(gen, G, g, E, C, d, f, dtype):
    ins = _moe_inputs(gen, G, g, E, C, d, f, dtype)
    got = moe_grouped_ffn(*ins)
    assert got.dtype == dtype and got.shape == (G, g, d)
    _moe_close(got, ref.moe_grouped_ffn(*ins), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_edge_cases(gen, dtype):
    """An expert with no token, a token no expert takes (output exactly
    0), and a random dispatch with several tokens in one slot and a
    combine weight on slots the token was not sent to."""
    G, g, E, C, d, f = 1, 16, 4, 8, 64, 96
    dispatch, combine = _moe_routing(gen, G, g, E, C)
    dispatch[..., 2, :] = False               # expert 2 gets no token
    combine[..., 2, :] = 0
    dispatch[:, 5] = False                    # token 5 is dropped everywhere
    combine[:, 5] = 0
    ins = _moe_inputs(gen, G, g, E, C, d, f, dtype, (dispatch, combine))
    got = moe_grouped_ffn(*ins)
    _moe_close(got, ref.moe_grouped_ffn(*ins), dtype)
    assert torch.equal(got[:, 5], torch.zeros_like(got[:, 5]))
    rnd = torch.rand((G, g, E, C), generator=gen, device="cuda")
    dispatch = rnd < 0.15
    dispatch[0, 0, 1, 3] = dispatch[0, 1, 1, 3] = True   # two in one slot
    combine = torch.rand((G, g, E, C), generator=gen, device="cuda")
    ins = _moe_inputs(gen, G, g, E, C, d, f, dtype, (dispatch, combine))
    _moe_close(moe_grouped_ffn(*ins), ref.moe_grouped_ffn(*ins), dtype)


def test_moe_grouped_ffn_rows_do_not_depend_on_the_batch(gen):
    """No atomics and fixed sums: a token's output bits are the same
    whatever the other tokens are and whichever slots it lands in."""
    G, g, E, C, d, f = 1, 8, 8, 2, 256, 512
    ins = list(_moe_inputs(gen, G, g, E, C, d, f, torch.bfloat16))
    outs = []
    for slots, seed in (((0, 0), 1), ((1, 1), 2)):
        disp = torch.zeros((G, g, E, C), dtype=torch.bool, device="cuda")
        comb = torch.zeros((G, g, E, C), device="cuda")
        disp[0, 0, 1, slots[0]] = disp[0, 0, 3, slots[1]] = True
        comb[0, 0, 1, slots[0]], comb[0, 0, 3, slots[1]] = 0.6, 0.4
        other = torch.Generator(device="cuda").manual_seed(seed)
        for t in range(1, g):                # other tokens fill other slots
            e = int(torch.randint(0, E, (), generator=other, device="cuda"))
            c = 1 - slots[0] if e in (1, 3) else t % C
            disp[0, t, e, c] = True
            comb[0, t, e, c] = 1.0
        x = ins[2].clone()
        x[0, 1:] = torch.randn((g - 1, d), generator=other,
                               device="cuda").to(x.dtype)
        outs.append(moe_grouped_ffn(disp, comb, x, *ins[3:])[0, 0])
    assert torch.equal(outs[0], outs[1])


def test_moe_grouped_ffn_is_sync_free_and_refuses(gen):
    ins = _moe_inputs(gen, 1, 8, 8, 2, 64, 96, torch.bfloat16)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe_grouped_ffn(*ins)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _moe_close(out, ref.moe_grouped_ffn(*ins), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        moe_grouped_ffn(*[t.cpu() for t in ins])
    with pytest.raises(ValueError, match="dtypes"):
        moe_grouped_ffn(*ins[:3], ins[3].float(), *ins[4:])
    strided = ins[3].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        moe_grouped_ffn(*ins[:3], strided, *ins[4:])
    with pytest.raises(ValueError, match="MoEGroupedFFN"):
        moe_grouped_ffn(*ins[:3], ins[3].requires_grad_(), *ins[4:])


def _moe_compare():
    """``tools/moe_compare.py``, whose seeded inputs the digests below
    were taken on."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "moe_compare", Path(__file__).resolve().parents[1] / "tools"
        / "moe_compare.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# sha256 (first 16 hex digits) of the f32 route's output at each of
# tools/moe_compare.py's F32_PARITY inputs, as the CUDA-core kernels gave
# them on an H100 (132 SMs) before the bf16 route moved to the tensor
# cores: the f32 kernels' source and bits are to stay as they were
MOE_F32_DIGESTS = {
    (1, 16, 4, 8, 32, 48, 0): "1341fd5baa9f1261",
    (2, 24, 4, 16, 16, 64, 0): "d908ceeb25d61f16",
    (1, 32, 8, 10, 64, 96, 0): "1e801140b8e8e60b",
    (1, 8, 8, 3, 256, 512, 0): "98f4cb7b23613fa9",
    (1, 128, 8, 40, 128, 256, 0): "66adb5b8c200304e",
    (1, 300, 8, 94, 64, 128, 0): "59ca6578120f55ab",
    (1, 16, 4, 8, 64, 96, 1): "10828771a74b355d"}


@pytest.mark.parametrize("shape", sorted(MOE_F32_DIGESTS),
                         ids=lambda s: "x".join(map(str, s)))
def test_moe_grouped_ffn_f32_bits_unchanged(gen, shape):
    """The f32 route gives, bit for bit, the outputs its CUDA-core
    kernels gave before the bf16 redesign (its split of f depends on the
    SM count, so the digests hold for a 132-SM card)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    if n_sm != 132:
        pytest.skip(f"digests taken on 132 SMs, this card has {n_sm}")
    mc = _moe_compare()
    got = moe_grouped_ffn(*mc.parity_inputs(*shape))
    assert mc.digest(got) == MOE_F32_DIGESTS[shape]


def test_moe_plan_matches_the_kernels(gen):
    """The wrapper's plan states the bf16 kernels' shared memory, stages
    and weight columns a block as the built library computes them."""
    built = kernel_tiles()
    for nt in SLOT_TILES:
        p = moe_plan(1, nt, 8, nt, 256, 512, torch.bfloat16, 132)
        assert p["tile"] == nt
        for kind in ("up", "down"):
            k = p[kind]
            assert built[(nt, kind)] == (k["smem"], k["stages"], k["cols"])


def _moe_grads(ins, dout, kernel):
    """(dx, dcombine, dwg, dwu, dwd) of sum(out * dout): through
    ``MoEGroupedFFN`` on the inputs (``kernel``), or through autograd of
    the plain version in f32 on the same values."""
    dispatch, combine, *rest = ins
    if kernel:
        leaves = [t.detach().clone().requires_grad_()
                  for t in (combine, *rest)]
        out = MoEGroupedFFN.apply(dispatch, *leaves)
        g = torch.autograd.grad(out, leaves, dout)
    else:
        leaves = [t.detach().float().requires_grad_()
                  for t in (combine, *rest)]
        out = ref.moe_grouped_ffn(dispatch, *leaves)
        g = torch.autograd.grad(out, leaves, dout.float())
    dcomb, dx, dwg, dwu, dwd = g
    return dx, dcomb, dwg, dwu, dwd


MOE_BWD_NAMES = ("dx", "dcombine", "dwg", "dwu", "dwd")


def _moe_bwd_close(got, want, dtype):
    """f32 at rtol/atol 1e-4 (sums over up to a few hundred slots in
    another order); bf16 to a normalized max error of 2e-2 per gradient
    (dy, da, db rounded once to bf16, as the flash backward is held)."""
    for name, a, b in zip(MOE_BWD_NAMES, got, want):
        assert a.dtype == (torch.float32 if name == "dcombine" else dtype)
        assert a.shape == b.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                       msg=name)
        else:
            err = (a.float() - b).abs().max() / b.abs().max().clamp(
                min=1e-30)
            assert err <= 2e-2, (name, err.item())


@pytest.mark.parametrize("G,g,E,C,d,f", [
    (1, 16, 4, 8, 32, 48),
    (2, 24, 4, 16, 16, 64),
    (1, 32, 8, 10, 64, 96),         # capacity drops
    (1, 128, 8, 40, 128, 256),
    (2, 300, 8, 94, 64, 128),       # slot tiles past one block
    (1, 512, 8, 160, 256, 384),     # two row blocks of slots, ragged
    (2, 200, 8, 50, 256, 320),      # C not a multiple of 64, two groups
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_bwd(gen, G, g, E, C, d, f, dtype):
    ins = _moe_inputs(gen, G, g, E, C, d, f, dtype)
    dout = _randn(gen, (G, g, d), dtype)
    _moe_bwd_close(_moe_grads(ins, dout, True), _moe_grads(ins, dout, False),
                   dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_bwd_edge_cases(gen, dtype):
    """An expert with no token gets exact-zero weight gradients, a token
    no expert takes gets dx exactly 0, and a random dispatch (two tokens
    in one slot, combine weights off the dispatch) against autograd."""
    G, g, E, C, d, f = 1, 16, 4, 8, 64, 96
    dispatch, combine = _moe_routing(gen, G, g, E, C)
    dispatch[..., 2, :] = False               # expert 2 gets no token
    combine[..., 2, :] = 0
    dispatch[:, 5] = False                    # token 5 is dropped
    combine[:, 5] = 0
    ins = _moe_inputs(gen, G, g, E, C, d, f, dtype, (dispatch, combine))
    dout = _randn(gen, (G, g, d), dtype)
    got = _moe_grads(ins, dout, True)
    _moe_bwd_close(got, _moe_grads(ins, dout, False), dtype)
    dx, _, dwg, dwu, dwd = got
    for w in (dwg, dwu, dwd):
        assert torch.equal(w[2], torch.zeros_like(w[2]))
    assert torch.equal(dx[:, 5], torch.zeros_like(dx[:, 5]))
    rnd = torch.rand((G, g, E, C), generator=gen, device="cuda")
    dispatch = rnd < 0.15
    dispatch[0, 0, 1, 3] = dispatch[0, 1, 1, 3] = True   # two in one slot
    combine = torch.rand((G, g, E, C), generator=gen, device="cuda")
    ins = _moe_inputs(gen, G, g, E, C, d, f, dtype, (dispatch, combine))
    _moe_bwd_close(_moe_grads(ins, dout, True), _moe_grads(ins, dout, False),
                   dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_bwd_one_group_and_non_prefix(gen, dtype):
    """An expert live in one group and empty in the other (its weight
    gradients from that group's rows alone), and a non-prefix dispatch
    (live slots scattered through C, dead slots between them) at d 256
    against autograd of the plain version."""
    G, g, E, C, d, f = 2, 96, 4, 40, 256, 384
    dispatch, combine = _moe_routing(gen, G, g, E, C)
    dispatch[1, :, 3] = False                 # expert 3: group 0 only
    combine[1, :, 3] = 0
    ins = _moe_inputs(gen, G, g, E, C, d, f, dtype, (dispatch, combine))
    dout = _randn(gen, (G, g, d), dtype)
    _moe_bwd_close(_moe_grads(ins, dout, True), _moe_grads(ins, dout, False),
                   dtype)
    # each token in a slot of its own, spread over C with gaps
    dispatch = torch.zeros((G, g, E, C), dtype=torch.bool, device="cuda")
    perm = torch.randperm(E * C, generator=gen, device="cuda")[:g]
    for grp in range(G):
        dispatch[grp].view(g, E * C)[torch.arange(g, device="cuda"),
                                     perm] = True
    combine = dispatch.float() * torch.rand((G, g, E, C), generator=gen,
                                            device="cuda")
    ins = _moe_inputs(gen, G, g, E, C, d, f, dtype, (dispatch, combine))
    _moe_bwd_close(_moe_grads(ins, dout, True), _moe_grads(ins, dout, False),
                   dtype)


def test_moe_expert_rows_kernel_equals_plain(gen):
    """The bf16 backward's first kernel lists each expert's live slots
    as its plain version does: top-2 routing with drops, an expert with
    no token, one live in one group only, and a random dispatch."""
    G, g, E, C = 2, 300, 8, 94
    dispatch, _ = _moe_routing(gen, G, g, E, C)
    cases = [dispatch.clone()]
    dispatch[..., 2, :] = False
    dispatch[1, :, 5] = False
    cases.append(dispatch)
    cases.append(torch.rand((G, g, E, C), generator=gen, device="cuda")
                 < 0.004)
    for disp in cases:
        live = disp.any(1).to(torch.int32).contiguous()
        got = expert_rows(live)
        assert torch.equal(got.cpu(), expert_rows(live.cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_bwd_bits_and_counts(gen, dtype):
    """Two backward calls give the same bits (no atomics), the backward
    makes no host synchronisation, and through ``ops.moe_grouped_ffn``
    the forward counts one ``moe_grouped_ffn`` launch and the backward
    one ``moe_grouped_ffn_bwd``."""
    ins = _moe_inputs(gen, 2, 64, 8, 20, 128, 256, dtype)
    dout = _randn(gen, (2, 64, 128), dtype)
    first = _moe_grads(ins, dout, True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = _moe_grads(ins, dout, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    leaves = [t.detach().clone().requires_grad_() for t in ins[1:]]
    ops.reset_launches()
    out = ops.moe_grouped_ffn(ins[0], *leaves)
    assert ops.launches["moe_grouped_ffn"] == 1
    assert ops.launches["moe_grouped_ffn_bwd"] == 0
    out.backward(dout)
    assert ops.launches["moe_grouped_ffn_bwd"] == 1
    with torch.no_grad():
        ops.moe_grouped_ffn(*ins)
    assert ops.launches["moe_grouped_ffn"] == 2
    assert ops.launches["moe_grouped_ffn_bwd"] == 1


def test_moe_plan_bwd_matches_the_kernels(gen):
    """The wrapper's constants and plan_bwd state the backward blocks'
    tiles, stages, shared memory, threads and registers, and the bf16
    products' tile queues, as the built library has them."""
    built = bwd_kernel_tiles()
    p = plan_bwd(2, 1024, 8, 320, 4096, 14336, torch.bfloat16, 132)
    q = plan_bwd(2, 1024, 8, 320, 4096, 14336, torch.float32, 132)
    assert built == dict(zip(BWD_TILE_KEYS, (
        p["tile"]["bm"], p["tile"]["bn"], p["tile"]["bk"],
        p["tile"]["stages"], p["tile"]["smem"], p["tile"]["wg_stages"],
        p["tile"]["wg_smem"], p["tile"]["threads"],
        p["tile"]["producer_regs"], p["tile"]["consumer_regs"],
        q["tile"]["bm"], q["tile"]["bn"], q["tile"]["bk"], q["tile"]["smem"],
        q["tile"]["threads"], p["rows"]["threads"])))
    for shape in ((2, 1024, 8, 320, 4096, 14336), (1, 16, 4, 8, 32, 48),
                  (2, 300, 8, 94, 64, 128)):
        p = plan_bwd(*shape, torch.bfloat16, 132)
        assert bwd_kernel_queues(*shape) == {
            k: p[k]["queue"] for k in TC_PRODUCTS}


# ---------------------------------------------------------------------------
# the RWKV-6 WKV recurrence
# ---------------------------------------------------------------------------

def _wkv_inputs(gen, B, T, H, hd, dtype, decay_mean=0.0):
    """r, k, v in ``dtype``; w = exp(-exp(x)), x ~ N(decay_mean, 1), and u
    in f32, as the model gives them (decay_mean 2: w near 0)."""
    r, k, v = (_randn(gen, (B, T, H, hd), dtype) for _ in range(3))
    x = torch.randn((B, T, H, hd), generator=gen, device="cuda") + decay_mean
    u = torch.randn((H, hd), generator=gen, device="cuda") * 0.1
    return r, k, v, torch.exp(-torch.exp(x)), u


def _wkv_grads(ins, dy, kernel):
    ins = [t.detach().requires_grad_() for t in ins]
    out = RWKV6Scan.apply(*ins) if kernel else ref.rwkv6(*ins)
    return torch.autograd.grad(out, ins, dy)


@pytest.mark.parametrize("B,T,H,hd", [
    (2, 64, 4, 64),       # full-width head dim, T one chunk
    (2, 77, 3, 64),       # ragged T
    (3, 77, 2, 16),       # smoke head dim, ragged T
    (1, 5, 2, 64),        # shorter than one chunk
    (2, 200, 3, 64),      # four chunks, the last ragged
    (1, 513, 2, 16),      # nine chunks, the last one step
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay_mean", [0.0, 2.0])
def test_rwkv6_scan(gen, B, T, H, hd, dtype, decay_mean):
    ins = _wkv_inputs(gen, B, T, H, hd, dtype, decay_mean)
    got = rwkv6_scan(*ins)
    want = ref.rwkv6(*ins)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("T,hd", [(77, 16), (64, 64), (41, 64), (200, 64),
                                  (513, 16)])
def test_rwkv6_scan_checkpoints(gen, T, hd):
    """The state before steps 0, chunk(), 2 chunk(), ... (chunk() = 64: the
    forward folds the chunk summaries into each one) equals the plain
    stateful version's final state over that prefix."""
    assert chunk() == 64
    r, k, v, w, u = _wkv_inputs(gen, 2, T, 3, hd, torch.float32)
    y, ckpt = rwkv6_scan(r, k, v, w, u, with_state=True)
    assert ckpt.shape == (2, 3, -(-T // chunk()), hd, hd)
    torch.testing.assert_close(y, ref.rwkv6(r, k, v, w, u), rtol=1e-4,
                               atol=1e-4)
    S0 = torch.zeros((2, 3, hd, hd), device="cuda")
    for c in range(ckpt.shape[2]):
        t = c * chunk()
        _, want = ref.rwkv6_stateful(r[:, :t], k[:, :t], v[:, :t], w[:, :t],
                                     u, S0)
        torch.testing.assert_close(ckpt[:, :, c], want, rtol=1e-4, atol=1e-4)


def _du_exact(ins, dy):
    """du's closed form sum_{b,t} r k (v . dy) in f64."""
    r, k, v = (t.double() for t in ins[:3])
    return torch.einsum("bthi,bthi,bth->hi", r, k, (v * dy.double()).sum(-1))


@pytest.mark.parametrize("B,T,H,hd", [
    (2, 64, 4, 64), (2, 77, 3, 64), (3, 77, 2, 16), (1, 5, 2, 64),
    (2, 200, 3, 64), (1, 513, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay_mean", [0.0, 2.0])
def test_rwkv6_scan_bwd(gen, B, T, H, hd, dtype, decay_mean):
    """Against torch autograd of the plain version.  du sums B*T terms:
    autograd's f32 running sum drifts past 1e-4 beyond a few hundred of
    them, so du is held to its f64 closed form, and to autograd as well
    where B*T <= 256."""
    ins = _wkv_inputs(gen, B, T, H, hd, dtype, decay_mean)
    dy = _randn(gen, (B, T, H, hd), dtype)
    got = _wkv_grads(ins, dy, kernel=True)
    want = _wkv_grads([t.float() for t in ins], dy.float(), kernel=False)
    for i, (g, w, x) in enumerate(zip(got, want, ins)):
        assert g.dtype == x.dtype and g.shape == w.shape
        if dtype == torch.float32:
            if i < 4 or B * T <= 256:
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            err = (g.float() - w).abs().max() / w.abs().max()
            assert err <= 2e-2, err
    if dtype == torch.float32:
        torch.testing.assert_close(got[4].double(), _du_exact(ins, dy),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hd", [16, 64])
def test_rwkv6_scan_exact_zero_decay(gen, hd):
    """w = 0 exactly at a chunk's first and last step and inside a chunk,
    on every other row: forward, checkpoints and backward stay finite and
    agree with the plain version (nothing is divided by w)."""
    T = 200
    r, k, v, w, u = _wkv_inputs(gen, 2, T, 3, hd, torch.float32)
    w = w.clone()
    for t in (0, 30, 63, 64, 127, 128, 199):
        w[:, t, :, ::2] = 0.0
    y, ckpt = rwkv6_scan(r, k, v, w, u, with_state=True)
    torch.testing.assert_close(y, ref.rwkv6(r, k, v, w, u), rtol=1e-4,
                               atol=1e-4)
    S0 = torch.zeros((2, 3, hd, hd), device="cuda")
    for c in range(ckpt.shape[2]):
        _, want = ref.rwkv6_stateful(*(x[:, :c * 64] for x in (r, k, v, w)),
                                     u, S0)
        torch.testing.assert_close(ckpt[:, :, c], want, rtol=1e-4,
                                   atol=1e-4)
    dy = _randn(gen, (2, T, 3, hd), torch.float32)
    got = _wkv_grads((r, k, v, w, u), dy, kernel=True)
    want = _wkv_grads((r, k, v, w, u), dy, kernel=False)
    assert all(torch.isfinite(g).all() for g in got)
    for g, w_ in zip(got[:4], want[:4]):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[4].double(),
                               _du_exact((r, k, v), dy), rtol=1e-4,
                               atol=1e-4)


def test_rwkv6_scan_unaligned_rows(gen):
    """Rows that do not start on a 16-byte boundary (a view one element
    into its storage) are copied first and give the same results."""
    r, k, v, w, u = _wkv_inputs(gen, 2, 70, 2, 64, torch.bfloat16)
    base = torch.empty(r.numel() + 1, dtype=r.dtype, device="cuda")
    r_off = base[1:].view(r.shape)
    r_off.copy_(r)
    assert r_off.data_ptr() % 16
    assert torch.equal(rwkv6_scan(r_off, k, v, w, u),
                       rwkv6_scan(r, k, v, w, u))


@pytest.mark.parametrize("hd", [16, 64])
def test_rwkv6_plan_matches_the_kernels(gen, hd):
    """The wrapper's plan states the chunk, the shared memory, the threads
    and the slice width of every WKV kernel as the built library has
    them."""
    built = wkv_tiles(hd)
    p = wkv_plan(4, 512, 32, hd)
    assert built["chunk"] == p["chunk"] == chunk()
    for name in WKV_KERNELS:
        k = p[name]
        assert built[name] == (k["smem"], k["threads"], k["width"]), name


def test_rwkv6_scan_strided_and_deterministic(gen):
    """(B, H, T, hd) tensors transposed to (B, T, H, hd) are read through
    their strides; the backward gives the same bits twice."""
    mk = lambda: _randn(gen, (2, 3, 50, 64), torch.float32).transpose(1, 2)
    r, k, v = mk(), mk(), mk()
    w = torch.exp(-torch.exp(mk()))
    u = torch.randn((3, 64), generator=gen, device="cuda") * 0.1
    torch.testing.assert_close(rwkv6_scan(r, k, v, w, u),
                               ref.rwkv6(r, k, v, w, u), rtol=1e-4,
                               atol=1e-4)
    dy = mk()
    a = _wkv_grads((r, k, v, w, u), dy, kernel=True)
    b = _wkv_grads((r, k, v, w, u), dy, kernel=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = _wkv_grads((r, k, v, w, u), dy, kernel=False)
    for g, w_ in zip(a, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)


def test_rwkv6_scan_refuses(gen):
    # T spans two 64-step chunks, so one checkpoint is too few
    r, k, v, w, u = _wkv_inputs(gen, 1, 80, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv6_scan(*(t.cpu() for t in (r, k, v, w, u)))
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan(r, k, v, w.to(torch.bfloat16), u)     # a bf16 decay
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan(r, k, v, w, u.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtypes"):
        rwkv6_scan(r, k.float(), v, w, u)
    strided = r.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="head dim must be contiguous"):
        rwkv6_scan(strided, k, v, w, u)
    with pytest.raises(ValueError, match="head dim 48"):
        rwkv6_scan(*(t[..., :48] for t in (r, k, v, w)),
                   u[:, :48].contiguous())
    y, ckpt = rwkv6_scan(r, k, v, w, u, with_state=True)
    with pytest.raises(ValueError, match="ckpt"):
        rwkv6_scan_bwd(r, k, v, w, u, ckpt[:, :, :1].contiguous(), y)
    with pytest.raises(ValueError, match="dy"):
        rwkv6_scan_bwd(r, k, v, w, u, ckpt, y.float())


def test_ops_rwkv6_trains_through_the_kernels(gen):
    """Training through ``ops.rwkv6`` on the card launches the forward and
    the backward once each, and every input gets the plain version's
    gradient."""
    ins = _wkv_inputs(gen, 2, 40, 2, 16, torch.float32)
    ops.reset_launches()
    got = torch.autograd.grad(
        (ops.rwkv6(*[t.requires_grad_() for t in ins]) ** 2).sum(), ins)
    assert ops.launches["rwkv6_scan"] == 1
    assert ops.launches["rwkv6_scan_bwd"] == 1
    want = torch.autograd.grad((ref.rwkv6(*ins) ** 2).sum(), ins)
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


# serving's shapes: decode steps of 8 rows at rwkv6-1.6b's heads and the
# smoke heads (T = 1: one partial chunk, no summary pass), a ragged prompt
# tail, one whole chunk, four chunks the last ragged, nine the last one
# step
WKV_STATE_CASES = [(8, 1, 32, 64), (2, 1, 4, 16), (1, 37, 32, 64),
                   (2, 64, 3, 64), (1, 200, 3, 16), (2, 513, 2, 64)]


@pytest.mark.parametrize("B,T,H,hd", WKV_STATE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_from_a_state(gen, B, T, H, hd, dtype):
    """From a random S0: y and the state after step T - 1 against
    ``ref.rwkv6_stateful`` (f32 at 1e-4, bf16 at 2e-2), checkpoint 0 is S0
    bit for bit, and the final state is a new tensor, never S0's
    storage."""
    r, k, v, w, u = _wkv_inputs(gen, B, T, H, hd, dtype)
    S0 = torch.randn((B, H, hd, hd), generator=gen, device="cuda") * 0.5
    S0_before = S0.clone()
    y, ckpt, ST = rwkv6_scan(r, k, v, w, u, S0=S0, with_state=True)
    want_y, want_S = ref.rwkv6_stateful(r, k, v, w, u, S0)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(ST, want_S, **tol)
    assert torch.equal(ckpt[:, :, 0], S0) and torch.equal(S0, S0_before)
    assert ST.data_ptr() != S0.data_ptr() and ST.dtype == torch.float32


@pytest.mark.parametrize("T", [1, 77, 200])
def test_rwkv6_scan_null_state_bits(gen, T):
    """S0 = None and S0 = zeros give the bits of the call without a state,
    y and every checkpoint; the final state from zeros is the stateful
    plain version's."""
    ins = _wkv_inputs(gen, 2, T, 3, 64, torch.bfloat16)
    y, ck = rwkv6_scan(*ins, with_state=True)
    zero = torch.zeros((2, 3, 64, 64), device="cuda")
    y1, ck1 = rwkv6_scan(*ins, S0=None, with_state=True)
    y2, ck2, ST = rwkv6_scan(*ins, S0=zero, with_state=True)
    for yy, cc in ((y1, ck1), (y2, ck2)):
        assert torch.equal(y, yy) and torch.equal(ck, cc)
    torch.testing.assert_close(ST, ref.rwkv6_stateful(*ins, zero)[1],
                               **TOL[torch.bfloat16])


def test_ops_rwkv6_stateful_launches_the_kernel(gen):
    """``ops.rwkv6_stateful`` on the card launches the WKV forward once a
    call at every T, 1 included, runs no plain version, and a prompt fed
    in two calls (the state carried) equals it fed in one."""
    r, k, v, w, u = _wkv_inputs(gen, 2, 70, 4, 16, torch.float32)
    S0 = torch.randn((2, 4, 16, 16), generator=gen, device="cuda")
    ops.reset_launches()
    y, S = ops.rwkv6_stateful(r, k, v, w, u, S0)
    y1, S1 = ops.rwkv6_stateful(*(t[:, :69] for t in (r, k, v, w)), u, S0)
    y2, S2 = ops.rwkv6_stateful(*(t[:, 69:] for t in (r, k, v, w)), u, S1)
    assert ops.launches["rwkv6_scan"] == 3
    assert sum(ops.launches.values()) == 3
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(S2, S, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="S0"):
        rwkv6_scan(r, k, v, w, u, S0=S0[:, :2])


# ---------------------------------------------------------------------------
# the RG-LRU recurrence
# ---------------------------------------------------------------------------

def _lru_inputs(gen, B, T, D, dtype, draw="model"):
    """x ~ N(0, 1) and the decay a in ``dtype``: ``model`` draws a as
    recurrentgemma makes it, exp(-8 softplus(lam) sigmoid(z)) with lam ~
    N(0, 0.5^2) per channel and z ~ N(0, 1); ``near1`` puts 1 - a in
    [5e-4, 1e-3] in f32 and in [8e-3, 1.6e-2] in bf16 (whose steps below
    1 are 2^-8: every a >= 0.998046875 rounds to 1); ``sigmoid`` is
    sigmoid(N(0, 1))."""
    x = torch.randn((B, T, D), generator=gen, device="cuda")
    z = torch.randn((B, T, D), generator=gen, device="cuda")
    if draw == "model":
        lam = 0.5 * torch.randn((D,), generator=gen, device="cuda")
        a = torch.exp(-8.0 * torch.nn.functional.softplus(lam)
                      * torch.sigmoid(z))
    elif draw == "near1":
        gap = 1e-3 if dtype == torch.float32 else 1.6e-2
        a = 1.0 - gap * (0.5 + 0.5 * torch.sigmoid(z))
    else:
        a = torch.sigmoid(z)
    return x.to(dtype), a.to(dtype)


def _lru_grads(x, a, dy, kernel):
    ins = [t.detach().requires_grad_() for t in (x, a)]
    out = RGLRUScan.apply(*ins) if kernel else ref.rglru(*ins)[0]
    return torch.autograd.grad(out, ins, dy)


def _lru_grads_f64(x, a, dy):
    """Autograd of the recurrence stepped in f64: the exact gradient to
    hold an f32 one to where the f32 plain version's own rounding is past
    the tolerance."""
    ins = [t.detach().double().requires_grad_() for t in (x, a)]
    g = torch.sqrt(torch.clamp(1.0 - ins[1] * ins[1], 0.0, 1.0))
    h, hs = torch.zeros_like(ins[0][:, 0]), []
    for t in range(x.shape[1]):
        h = ins[1][:, t] * h + g[:, t] * ins[0][:, t]
        hs.append(h)
    return torch.autograd.grad(torch.stack(hs, 1), ins, dy.double())


@pytest.mark.parametrize("B,T,D", [
    (2, 64, 256),         # whole 64-channel blocks, T a multiple of 16
    (3, 77, 200),         # ragged T and D
    (1, 5, 40),           # shorter than one chunk
    (3, 33, 200),         # one step past a chunk
    (4, 513, 200),        # one step past 32 chunks of 16
    (4, 512, 2560),       # recurrentgemma-2b's training shape
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("draw", ["model", "near1", "sigmoid"])
def test_rglru_scan(gen, B, T, D, dtype, draw):
    """The forward against the plain version, and its checkpoints (the
    state at each chunk's last step) against the plain version's f32
    states there."""
    x, a = _lru_inputs(gen, B, T, D, dtype, draw)
    got = rglru_scan(x, a)
    want = ref.rglru(x, a)[0]
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    y, ck = rglru_scan(x, a, with_state=True)
    nc = -(-T // lru_chunk())
    assert torch.equal(y, got) and ck.dtype == torch.float32
    assert ck.shape == (B, nc, D)
    ends = [min((c + 1) * lru_chunk(), T) - 1 for c in range(nc)]
    torch.testing.assert_close(
        ck, ref.rglru(x.float(), a.float())[0][:, ends], rtol=2e-5,
        atol=2e-5)


@pytest.mark.parametrize("B,T,D", [(2, 64, 256), (3, 77, 200), (1, 5, 40),
                                   (3, 33, 200), (4, 513, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("draw", ["model", "near1", "sigmoid"])
def test_rglru_scan_bwd(gen, B, T, D, dtype, draw):
    """f32: held to autograd of the plain version at rtol/atol 1e-4 where
    that f32 gradient is itself within 1e-4 of the exact (f64) one.  Where
    it is not (a near 1 over 513 steps: dh sums hundreds of terms and da
    reaches thousands, so any f32 order of the sums is off the exact value
    past 1e-4), the kernel's largest error against the f64 gradient is
    held to at most 1.25x the plain f32 version's own.  bf16: a normalized
    2e-2."""
    x, a = _lru_inputs(gen, B, T, D, dtype, draw)
    assert float(a.max()) < 1.0
    dy = _randn(gen, (B, T, D), dtype)
    got = _lru_grads(x, a, dy, kernel=True)
    want = _lru_grads(x.float(), a.float(), dy.float(), kernel=False)
    exact = [w.double() for w in want]
    if dtype == torch.float32:
        exact = _lru_grads_f64(x, a, dy)
    plain_ok = all(torch.allclose(w.double(), e, rtol=1e-4, atol=1e-4)
                   for w, e in zip(want, exact))
    for g, w, e, t in zip(got, want, exact, (x, a)):
        assert g.dtype == t.dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        if dtype == torch.float32 and plain_ok:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        elif dtype == torch.float32:
            err = (g.double() - e).abs().max()
            assert err <= 1.25 * (w.double() - e).abs().max(), err
        else:
            err = (g.float() - w).abs().max() / w.abs().max()
            assert err <= 2e-2, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_a_zero_at_chunk_edges(gen, dtype):
    """a = 0 exactly at chunks' first and last steps (on every other
    channel; on every channel at one step) cuts the past: the forward and
    its checkpoints match the plain version, h from that step on does not
    depend on x before it, the gradients before it do not depend on dy
    after it, and the backward matches autograd of the plain version."""
    B, T, D, C = 2, 200, 96, lru_chunk()
    x, a = _lru_inputs(gen, B, T, D, dtype, "sigmoid")
    for t in (0, C - 1, C, 2 * C - 1, 3 * C, T - 1):
        a[:, t, ::2] = 0.0
    cut = 4 * C
    a[:, cut] = 0.0
    y, ck = rglru_scan(x, a, with_state=True)
    torch.testing.assert_close(y.float(), ref.rglru(x, a)[0].float(),
                               **TOL[dtype])
    ends = [min((c + 1) * C, T) - 1 for c in range(ck.shape[1])]
    torch.testing.assert_close(
        ck, ref.rglru(x.float(), a.float())[0][:, ends], rtol=2e-5,
        atol=2e-5)
    x2 = x.clone()
    x2[:, :cut] = 3.0
    assert torch.equal(rglru_scan(x2, a)[:, cut:], y[:, cut:])
    dy = _randn(gen, (B, T, D), dtype)
    dy2 = dy.clone()
    dy2[:, cut:] = -2.0
    got = _lru_grads(x, a, dy, kernel=True)
    got2 = _lru_grads(x, a, dy2, kernel=True)
    assert all(torch.equal(p[:, :cut], q[:, :cut]) for p, q in zip(got, got2))
    want = _lru_grads(x.float(), a.float(), dy.float(), kernel=False)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert (g.float() - w).abs().max() / w.abs().max() <= 2e-2


def test_rglru_plan_matches_the_kernels(gen):
    """The built library's chunk, and its shared memory, threads, slots,
    lanes, channels a thread and backward piece in each direction, equal
    ``plan()``'s at the training shape, the smoke shape, ragged T and
    windows past MAX_SLOTS chunks, in both dtypes."""
    for T in (5, 32, 96, 513, 512, 4096):
        for dt in (torch.float32, torch.bfloat16):
            p = lru_plan(4, T, 2560, dt)
            built = lru_tiles(T, dt)
            assert built["chunk"] == p["chunk"] == lru_chunk()
            for d in ("fwd", "bwd"):
                assert built[d] == dict(
                    smem=p[f"smem_{d}"], threads=p["threads"],
                    slots=p["slots"], lanes=p["lanes"], vec=p["vec"],
                    sub=p["sub"]), (T, dt, d)


def test_rglru_scan_bwd_at_g_zero(gen):
    """Where a = 1 (bf16 rounds every a >= 0.998046875 to 1) the clip is
    saturated and g = 0: dx = 0 and da = dh h_{t-1}, finite, where autograd
    of the plain version gives -inf or NaN; elsewhere the gradient is the
    plain version's."""
    x, a = _lru_inputs(gen, 2, 40, 64, torch.float32, "sigmoid")
    a[:, 10:30:3] = 1.0                     # a band of saturated steps
    dy = _randn(gen, (2, 40, 64), torch.float32)
    dx, da = _lru_grads(x, a, dy, kernel=True)
    assert torch.isfinite(dx).all() and torch.isfinite(da).all()
    # the closed form of the stated rule, from the plain version's states
    h = ref.rglru(x, a)[0]
    hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    g = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0))
    dh = torch.zeros_like(dy)
    c = torch.zeros_like(dy[:, 0])
    for t in range(39, -1, -1):
        dh[:, t] = dy[:, t] + c
        c = a[:, t] * dh[:, t]
    sat = a == 1.0
    assert torch.equal(dx[sat], torch.zeros_like(dx[sat]))
    torch.testing.assert_close(da[sat], (dh * hprev)[sat], rtol=1e-5,
                               atol=1e-5)
    want_da = dh * (hprev - torch.where(g > 0, a * x / g, 0.0))
    torch.testing.assert_close(da, want_da, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx, g * dh, rtol=1e-4, atol=1e-4)
    plain = _lru_grads(x, a, dy, kernel=False)[1]
    assert not torch.isfinite(plain[sat]).all()     # the hazard it avoids


def test_rglru_scan_strided_and_deterministic(gen):
    """(B, D, T)-made tensors sliced and viewed as (B, T, D) with a batch
    stride are read through their strides; the backward gives the same bits
    twice."""
    x, a = _lru_inputs(gen, 3, 50, 96, torch.float32)
    xs = torch.cat([x, x], 2)[..., 96:]              # b stride 50 * 192
    as_ = a.transpose(0, 1).contiguous().transpose(0, 1)   # t stride 3 * 96
    torch.testing.assert_close(rglru_scan(xs, as_), ref.rglru(x, a)[0],
                               rtol=2e-5, atol=2e-5)
    dy = _randn(gen, (3, 50, 96), torch.float32)
    p = _lru_grads(xs, as_, dy, kernel=True)
    q = _lru_grads(xs, as_, dy, kernel=True)
    assert all(torch.equal(u, w) for u, w in zip(p, q))
    for g, w in zip(p, _lru_grads(x, a, dy, kernel=False)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_unaligned_rows(gen, dtype):
    """Rows that do not start on 16 bytes (an odd D, and views one element
    into a wider tensor) are staged element by element: the forward, its
    checkpoints and the backward match the plain version as the aligned
    rows do."""
    B, T, D = 2, 70, 41
    x, a = _lru_inputs(gen, B, T, D, dtype, "sigmoid")
    xs = torch.cat([x[..., :1], x], 2)[..., 1:]     # row starts off 16 bytes
    y, ck = rglru_scan(xs, a, with_state=True)
    want = ref.rglru(x, a)[0]
    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype])
    ends = [min((c + 1) * lru_chunk(), T) - 1 for c in range(ck.shape[1])]
    torch.testing.assert_close(
        ck, ref.rglru(x.float(), a.float())[0][:, ends], rtol=2e-5,
        atol=2e-5)
    dy = _randn(gen, (B, T, D), dtype)
    got = _lru_grads(xs, a, dy, kernel=True)
    exp = _lru_grads(x.float(), a.float(), dy.float(), kernel=False)
    for g, w in zip(got, exp):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert (g.float() - w).abs().max() / w.abs().max() <= 2e-2


def test_rglru_scan_refuses(gen):
    x, a = _lru_inputs(gen, 1, 16, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_scan(x.cpu(), a.cpu())
    with pytest.raises(ValueError, match="dtypes"):
        rglru_scan(x, a.float())
    with pytest.raises(ValueError, match="shapes"):
        rglru_scan(x, a[:, :8])
    with pytest.raises(ValueError, match="channel dim must be contiguous"):
        rglru_scan(x.transpose(1, 2).contiguous().transpose(1, 2), a)
    y, ck = rglru_scan(x, a, with_state=True)
    with pytest.raises(ValueError, match="ck"):
        rglru_scan_bwd(x, a, ck.to(torch.bfloat16), y)
    with pytest.raises(ValueError, match="ck"):
        rglru_scan_bwd(x, a, ck[:, :0], y)
    with pytest.raises(ValueError, match="ck"):
        rglru_scan_bwd(x, a, torch.zeros_like(y, dtype=torch.float32), y)
    with pytest.raises(ValueError, match="dy"):
        rglru_scan_bwd(x, a, ck, y.float())


def test_ops_rglru_trains_through_the_kernels(gen):
    """Training through ``ops.rglru`` on the card launches the forward and
    the backward once each, and both inputs get the plain version's
    gradient."""
    x, a = _lru_inputs(gen, 2, 40, 64, torch.float32)
    ops.reset_launches()
    got = torch.autograd.grad(
        (ops.rglru(x.requires_grad_(), a.requires_grad_()) ** 2).sum(),
        (x, a))
    assert ops.launches["rglru_scan"] == 1
    assert ops.launches["rglru_scan_bwd"] == 1
    want = torch.autograd.grad((ref.rglru(x, a)[0] ** 2).sum(), (x, a))
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


# serving's shapes: a decode step of 8 rows at recurrentgemma-2b's width,
# a ragged prompt at that width, a ragged T and D, and two windows of
# chunks
LRU_STATE_CASES = [(8, 1, 2560), (1, 37, 2560), (3, 77, 200), (2, 513, 40)]


@pytest.mark.parametrize("B,T,D", LRU_STATE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_from_a_state(gen, B, T, D, dtype):
    """From a random h0: h and the final state (the last checkpoint)
    against ``ref.rglru(x, a, h0)`` (f32 at 1e-4, bf16 at 2e-2)."""
    x, a = _lru_inputs(gen, B, T, D, dtype)
    h0 = torch.randn((B, D), generator=gen, device="cuda")
    y, ck = rglru_scan(x, a, h0=h0, with_state=True)
    want, hT = ref.rglru(x, a, h0)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want.float(), **tol)
    torch.testing.assert_close(ck[:, -1], hT, **tol)


@pytest.mark.parametrize("T", [1, 77, 513])
def test_rglru_scan_null_state_bits(gen, T):
    """h0 = None and h0 = zeros give the bits of the call without a state:
    h and every checkpoint."""
    x, a = _lru_inputs(gen, 2, T, 200, torch.bfloat16)
    y, ck = rglru_scan(x, a, with_state=True)
    for h0 in (None, torch.zeros((2, 200), device="cuda")):
        y2, ck2 = rglru_scan(x, a, h0=h0, with_state=True)
        assert torch.equal(y, y2) and torch.equal(ck, ck2)


def test_ops_rglru_stateful_launches_the_kernel(gen):
    """``ops.rglru_stateful`` on the card launches the forward once a call
    at every T, 1 included, runs no plain version, and a prompt fed in two
    calls (the state carried) equals it fed in one."""
    x, a = _lru_inputs(gen, 2, 40, 64, torch.float32)
    h0 = torch.randn((2, 64), generator=gen, device="cuda")
    ops.reset_launches()
    y, h = ops.rglru_stateful(x, a, h0)
    y1, h1 = ops.rglru_stateful(x[:, :39], a[:, :39], h0)
    y2, h2 = ops.rglru_stateful(x[:, 39:], a[:, 39:], h1)
    assert ops.launches["rglru_scan"] == 3
    assert sum(ops.launches.values()) == 3
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, h, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="h0"):
        rglru_scan(x, a, h0=h0.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the sharded parameter server: shards store on the CPU, workers compute on
# the card
# ---------------------------------------------------------------------------

def test_server_lr_on_card_is_sequential_bit_for_bit(gen, monkeypatch):
    """``run_distributed_lr`` with its workers on the card (f64, under
    deterministic algorithms) gives ``run_sequential``'s theta on the card
    bit for bit, on both RPC paths, with a sequentially-correct history."""
    from repro_torch.core import history as H
    from repro_torch.core import threaded as T
    from repro_torch.pdb.server import run_distributed_lr
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    X, y = T.make_synthetic_lr(2000, 480, seed=0, device="cuda")
    task = T.LRTask(X, y, n_iters=20, mode="gd")
    torch.use_deterministic_algorithms(True)
    try:
        seq = T.run_sequential(task, 4)
        for batched in (False, True):
            res = run_distributed_lr(task, 4, n_shards=2, policy="dc",
                                     batched=batched, timeout=60.0)
            assert torch.equal(res.theta, seq.cpu())
            assert H.is_complete(res.history, 4, task.n_iters)
            assert H.is_sequentially_correct(res.history, 4)
    finally:
        torch.use_deterministic_algorithms(False)


def test_server_update_on_card_is_numpys(gen):
    """The server worker's update ``theta - lr * g`` on the card rounds as
    numpy's does on the host: the product, then the difference (two
    kernels, no fused multiply-add)."""
    import numpy as np
    theta = torch.randn(1 << 20, generator=gen, device="cuda")
    g = torch.randn(1 << 20, generator=gen, device="cuda")
    for lr in (1e-3, 0.05, 3e-4):
        got = (theta - lr * g).cpu().numpy()
        want = theta.cpu().numpy() - lr * g.cpu().numpy()
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


def test_server_shards_open_no_cuda_context(gen):
    """Eight shard processes start without opening a CUDA context: the
    card's free memory falls by less than 64 MiB across the start."""
    from repro_torch.pdb.server import ShardCluster
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    with ShardCluster([torch.zeros(64) for _ in range(16)], 2, 8):
        free1 = torch.cuda.mem_get_info()[0]
    assert free0 - free1 < 64 * 2 ** 20
