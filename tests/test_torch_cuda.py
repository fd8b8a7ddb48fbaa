"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks its fixture for a GPU and skips without
one (the CPU tests hold the plain versions to the JAX package instead).
Run on a GPU machine with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 rtol/atol 2e-5 and bf16 2e-2, as tests/test_kernels.py
holds the Pallas kernels; the gather bit for bit.  TF32 is off, so the
plain versions' f32 products run in full f32.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.page_gather import page_gather  # noqa: E402

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
    q = _randn(gen, (1, 16, 4, 64), torch.bfloat16)
    k = _randn(gen, (1, 16, 2, 64), torch.bfloat16)
    pool = _randn(gen, (5, 4, 2, 64), torch.bfloat16)
    table = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    ops.reset_launches()
    ops.attention(q, k, k)
    ops.page_gather(pool, table)
    ops.attention_decode(q[:, :1], k, k,
                         torch.ones((16,), dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    assert ops.launches == {name: 1 for name in _build.SOURCES}
    ref.attention(q, k, k)                  # the plain version never counts
    assert ops.launches["flash_attention"] == 1
