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
from repro_torch.kernels.page_gather import page_gather  # noqa: E402
from repro_torch.kernels.ring_gather import ring_gather  # noqa: E402

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
