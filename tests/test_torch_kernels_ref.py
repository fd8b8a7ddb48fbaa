"""The port's plain kernel versions against the JAX package's oracles and
its Pallas kernels (interpret mode), on the same numpy inputs.

Tolerances as tests/test_kernels.py: f32 rtol/atol 2e-5, bf16 2e-2; the
page and ring gathers bit for bit.  Attention gradients (torch autograd
through the plain version, the oracle of the CUDA backward) are held to
``jax.grad`` of the JAX plain version at f32, rtol/atol 1e-5: both sides
differentiate the same softmax in f32, and the sums of a few dozen terms
differ only in order.  bf16 inputs are rounded from the same f32 draws
on both sides (round-to-nearest-even in both frameworks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro.kernels.page_gather import page_gather as pallas_gather  # noqa
from repro.kernels.ring_gather import ring_gather as pallas_ring  # noqa
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy draw as a torch tensor and a jax array of dtype."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12),
                                           (False, 0)])
def test_attention(dtype, causal, window):
    S, H, KV, hd = 40, 6, 2, 16          # GQA 3:1, ragged last block
    rng = np.random.default_rng(0)
    q, jq = _pair(rng.standard_normal((2, S, H, hd), np.float32), dtype)
    k, jk = _pair(rng.standard_normal((2, S, KV, hd), np.float32), dtype)
    v, jv = _pair(rng.standard_normal((2, S, KV, hd), np.float32), dtype)
    got = ref.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jref.attention(jq, jk, jv, causal=causal, window=window),
           dtype)
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=window,
                          block_q=32, block_k=32, interpret=True)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_chunked(dtype):
    rng = np.random.default_rng(1)
    q, jq = _pair(rng.standard_normal((1, 64, 4, 16), np.float32), dtype)
    k, jk = _pair(rng.standard_normal((1, 64, 2, 16), np.float32), dtype)
    got = ref.attention_chunked(q, k, k, window=20, block_q=16)
    _close(got, jref.attention_chunked(jq, jk, jk, window=20, block_q=16),
           dtype)
    _close(got, jref.attention(jq, jk, jk, window=20), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode(dtype):
    B, L, H, KV, hd = 3, 40, 6, 2, 16
    rng = np.random.default_rng(2)
    q, jq = _pair(rng.standard_normal((B, 1, H, hd), np.float32), dtype)
    k, jk = _pair(rng.standard_normal((B, L, KV, hd), np.float32), dtype)
    v, jv = _pair(rng.standard_normal((B, L, KV, hd), np.float32), dtype)
    for shape in ((B, L), (L,)):         # per-row and shared masks
        valid = rng.random(shape) < 0.5
        valid[..., 0] = True             # at least one live slot per row
        got = ref.attention_decode(q, k, v, torch.from_numpy(valid))
        _close(got, jref.attention_decode(jq, jk, jv, jnp.asarray(valid)),
               dtype)
        if len(shape) == 2:
            _close(got, pallas_decode(jq, jk, jv, jnp.asarray(valid),
                                      block_k=32, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_gather_bit_exact(dtype):
    rng = np.random.default_rng(3)
    pool, jpool = _pair(rng.standard_normal((9, 4, 2, 8), np.float32), dtype)
    table = rng.integers(0, 9, size=(3, 5)).astype(np.int32)
    got = ref.page_gather(pool, torch.from_numpy(table))
    for want in (jref.page_gather(jpool, jnp.asarray(table)),
                 pallas_gather(jpool, jnp.asarray(table), interpret=True)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_gather_bit_exact(dtype):
    """N = 1000 is no multiple of the Pallas block (256): its last tile is
    clipped."""
    rng = np.random.default_rng(5)
    hist, jhist = _pair(rng.standard_normal((3, 1000), np.float32), dtype)
    for i in range(3):
        got = ref.ring_gather(hist, torch.tensor(i, dtype=torch.int32))
        assert got.shape == (1000,) and got.dtype == hist.dtype
        for want in (jref.ring_gather(jhist, i),
                     pallas_ring(jhist, jnp.int32(i), block=256,
                                 interpret=True)):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
    assert torch.equal(ops.ring_gather(hist, torch.tensor(2, dtype=torch.int32)),
                       hist[2])


@pytest.mark.parametrize("H,KV,causal,window", [
    (6, 2, True, 0),      # GQA 3:1
    (4, 4, True, 9),      # sliding window
    (4, 1, False, 0),     # all heads on one kv head, bidirectional
])
def test_attention_grads_match_jax(H, KV, causal, window):
    B, S, hd = 2, 24, 16
    rng = np.random.default_rng(6)
    arrs = [rng.standard_normal(shape, np.float32) for shape in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    out = ref.attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad((out * torch.from_numpy(arrs[3])).sum(),
                              (q, k, v))

    def jloss(jq, jk, jv):
        o = jref.attention(jq, jk, jv, causal=causal, window=window)
        return jnp.sum(o * arrs[3])

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs[:3]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_ops_on_cpu_take_the_plain_versions(monkeypatch):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 32, 4, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 32, 2, 8), np.float32))
    before = dict(ops.launches)
    assert torch.equal(ops.attention(q, k, k), ref.attention(q, k, k))
    valid = torch.ones((32,), dtype=torch.bool)
    assert torch.equal(ops.attention_decode(q[:, :1], k, k, valid),
                       ref.attention_decode(q[:, :1], k, k, valid))
    table = torch.zeros((1, 2), dtype=torch.int32)
    assert torch.equal(ops.page_gather(k, table), ref.page_gather(k, table))
    assert ops.launches == before            # no kernel ran
    # at and above CHUNK_THRESHOLD the blockwise plain version takes over
    monkeypatch.setattr(ops, "CHUNK_THRESHOLD", 16)
    calls = []
    monkeypatch.setattr(ref, "attention_chunked",
                        lambda *a, **kw: calls.append(a) or
                        ref.attention(*a[:3], **kw))
    ops.attention(q, k, k)
    assert len(calls) == 1


def test_ops_refuse_other_devices():
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        ops.attention(q, q, q)
