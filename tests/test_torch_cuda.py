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
the tensor's scale, not to each element.  TF32 is off, so the plain
versions' f32 products run in full f32.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention, flash_attention_bwd)
from repro_torch.kernels.moe_matmul import moe_grouped_ffn  # noqa: E402
from repro_torch.kernels.page_gather import (  # noqa: E402
    page_gather, prefill_page_attention)
from repro_torch.kernels.ring_gather import ring_gather  # noqa: E402
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
    (33, 2, 1, 128),      # short sequence, widest head
    (200, 15, 5, 64),     # smollm-360m heads
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


def test_flash_attention_rejects_cross_lengths(gen):
    q = _randn(gen, (1, 8, 2, 64), torch.float32)
    k = _randn(gen, (1, 16, 2, 64), torch.float32)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, k, k)


@pytest.mark.parametrize("B,L,H,KV,hd", [
    (3, 40, 4, 2, 64),
    (8, 544, 32, 8, 64),   # the serving shape of llama3.2-1b
    (2, 100, 15, 5, 64),   # smollm-360m heads: group 3
    (2, 77, 16, 2, 128),   # group 8, widest head
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
    ops.prefill_page_attention(*_chunk_inputs(gen, 1, 8, 16, 4, 2, 64, 5,
                                              torch.bfloat16))
    ops.moe_grouped_ffn(*_moe_inputs(gen, 1, 8, 4, 4, 64, 96,
                                     torch.bfloat16))
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
    (77, 8, 1, 128),      # group 8, widest head
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_is_deterministic(gen, dtype):
    q = _randn(gen, (2, 300, 16, 64), dtype)
    k = _randn(gen, (2, 300, 4, 64), dtype)
    do = _randn(gen, (2, 300, 16, 64), dtype)
    a = _attn_grads(q, k, k, do, True, 0, kernel=True)
    b = _attn_grads(q, k, k, do, True, 0, kernel=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


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
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_page_attention(gen, B, C, L, H, KV, hd, start, window,
                                dtype):
    ins = _chunk_inputs(gen, B, C, L, H, KV, hd, start, dtype)
    got = prefill_page_attention(*ins, window=window)
    want = ref.prefill_page_attention(*ins, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


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


def test_prefill_page_attention_is_deterministic(gen):
    ins = _chunk_inputs(gen, 1, 128, 544, 32, 8, 64, 900, torch.bfloat16)
    a = prefill_page_attention(*ins, window=128)
    b = prefill_page_attention(*ins, window=128)
    assert torch.equal(a, b)


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
    with pytest.raises(NotImplementedError, match="no backward"):
        moe_grouped_ffn(*ins[:3], ins[3].float().requires_grad_(),
                        ins[4].float(), ins[5].float())
