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
a = 1 it is held to its stated value da = dh h_{t-1}, dx = 0).  TF32 is
off, so the plain versions' f32 products run in full f32.
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
    FlashAttention, flash_attention, flash_attention_bwd, kernel_smem, plan)
from repro_torch.kernels.moe_matmul import (  # noqa: E402
    SLOT_TILES, kernel_tiles, moe_grouped_ffn)
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
    q = _randn(gen, (1, 8, 2, 64), torch.float32)
    k = _randn(gen, (1, 16, 2, 64), torch.float32)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, k, k)


@pytest.mark.parametrize("B,L,H,KV,hd", [
    (3, 40, 4, 2, 64),
    (8, 544, 32, 8, 64),   # the serving shape of llama3.2-1b: 5 splits
    (2, 100, 15, 5, 64),   # smollm-360m heads: group 3
    (2, 77, 16, 2, 128),   # group 8
    (2, 700, 10, 1, 256),  # recurrentgemma-2b's local heads: 6 splits
    (3, 300, 4, 1, 16),    # its smoke config: head dim padded to 64
    (2, 130, 16, 1, 32),   # group 16, a one-slot last split
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
    ops.moe_grouped_ffn(*_moe_inputs(gen, 1, 8, 4, 4, 64, 96,
                                     torch.bfloat16))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_is_deterministic(gen, dtype):
    q = _randn(gen, (2, 300, 16, 64), dtype)
    k = _randn(gen, (2, 300, 4, 64), dtype)
    do = _randn(gen, (2, 300, 16, 64), dtype)
    a = _attn_grads(q, k, k, do, True, 0, kernel=True)
    b = _attn_grads(q, k, k, do, True, 0, kernel=True)
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
    p = plan(S, H, KV, hd, torch.bfloat16)
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
        p = plan(512, 8, 2, hd, dtype)
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
    with pytest.raises(NotImplementedError, match="no backward"):
        moe_grouped_ffn(*ins[:3], ins[3].float().requires_grad_(),
                        ins[4].float(), ins[5].float())


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
