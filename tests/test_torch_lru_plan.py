"""The chunk-parallel RG-LRU algorithm of ``csrc/rglru_scan.cu``, on the CPU.

The CUDA kernels run only on a card.  This file holds the algorithm they
implement, written here in plain PyTorch with the kernels' own constants
(``CHUNK`` and ``MAX_SLOTS`` of ``repro_torch.kernels.rglru_scan``):

* forward: each chunk's pair (P = the product of its a in step order, H =
  its walk from zero), each chunk's start state folded from the pairs
  before it (from the carry of the window before, windows of
  ``MAX_SLOTS`` chunks), the checkpoint = the end state one fold step on,
  and the chunk's walk from its start state;
* backward: each chunk's states rebuilt forward from checkpoint c - 1
  (zero for c = 0), its local adjoint carry Q walked down from zero, the
  carry from the chunk after folded from the later chunks' (P, Q), and the
  walk down from it: dx = g dh, da = dh (h_{t-1} - a x / g), or dh h_{t-1}
  where g = 0.

Every step is rounded as the kernels round it (one multiply, one add, no
fused multiply-add; torch's CPU kernels round each op).  It is held in f64
to 1e-12 against the sequential recurrence and torch autograd of it, in
f32 to 2e-5 against ``ref.rglru`` (and its states at each chunk's last
step) and to 1e-4 against autograd through it, and to JAX:
``repro.kernels.ref.rglru`` and the Pallas kernel in interpret mode (f32,
2e-5, as ``tests/test_torch_rglru.py`` runs them) and ``jax.grad`` of the
plain version (da off ``jnp.clip``'s ties, ROADMAP C), on inputs drawn
from a numpy seed.  Cases: T below, at and past one chunk, T 77 and 513,
D 200, a window past ``MAX_SLOTS`` chunks; a = 0 exactly at a chunk's
first and last step (which cuts the past: nothing is divided by a); a
band of a = 1 (g = 0, where the backward's rule applies).  Then
``plan()``'s numbers at the training and smoke shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru  # noqa
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as lru  # noqa: E402

torch.set_num_threads(1)

C, SLOTS = lru.CHUNK, lru.MAX_SLOTS
SMEM_LIMIT = 232_448        # shared memory one H100 block may use


# ---------------------------------------------------------------------------
# the algorithm, vectorised over (batch, channel), in the inputs' dtype
# ---------------------------------------------------------------------------

def _gate(a):
    return torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0))


def _chunks(T):
    return [(c * C, min(C, T - c * C)) for c in range(-(-T // C))]


def _fold(P, H, h):
    return P * h + H


def chunked_forward(x, a):
    """h (B, T, D) and the checkpoints ck (B, nc, D) as the forward kernel
    computes them."""
    B, T, D = x.shape
    g = _gate(a)
    chunks = _chunks(T)
    pairs = []
    for t0, n in chunks:
        P, H = x.new_ones((B, D)), x.new_zeros((B, D))
        for t in range(t0, t0 + n):
            H = a[:, t] * H + g[:, t] * x[:, t]
            P = P * a[:, t]
        pairs.append((P, H))
    y = torch.empty_like(x)
    ck = x.new_empty((B, len(chunks), D))
    carry = x.new_zeros((B, D))
    for c0 in range(0, len(chunks), SLOTS):
        window = range(c0, min(c0 + SLOTS, len(chunks)))
        for c in window:
            h = carry
            for j in range(c0, c):
                h = _fold(*pairs[j], h)
            ck[:, c] = _fold(*pairs[c], h)
            t0, n = chunks[c]
            for t in range(t0, t0 + n):
                h = a[:, t] * h + g[:, t] * x[:, t]
                y[:, t] = h
        carry = ck[:, window[-1]]
    return y, ck


def chunked_backward(x, a, ck, dy):
    """(dx, da) as the backward kernel computes them from the forward's
    checkpoints."""
    B, T, D = x.shape
    g = _gate(a)
    dgx = torch.where(g > 0, a * x / g, torch.zeros_like(x))
    chunks = _chunks(T)
    nc = len(chunks)
    pairs = []
    for c, (t0, n) in enumerate(chunks):
        P, Q = x.new_ones((B, D)), x.new_zeros((B, D))
        for t in range(t0, t0 + n):
            P = P * a[:, t]
        for t in range(t0 + n - 1, t0 - 1, -1):
            Q = a[:, t] * (dy[:, t] + Q)
        pairs.append((P, Q))
    dx, da = torch.empty_like(x), torch.empty_like(x)
    carry = x.new_zeros((B, D))
    starts = list(range(0, nc, SLOTS))
    for c0 in reversed(starts):
        window = range(c0, min(c0 + SLOTS, nc))
        for c in window:
            cin = carry
            for j in range(window[-1], c, -1):
                cin = _fold(*pairs[j], cin)
            if c == c0:
                next_carry = _fold(*pairs[c], cin)
            t0, n = chunks[c]
            h = ck[:, c - 1] if c else x.new_zeros((B, D))
            hprev = []
            for t in range(t0, t0 + n):
                hprev.append(h)
                h = a[:, t] * h + g[:, t] * x[:, t]
            for t in range(t0 + n - 1, t0 - 1, -1):
                dh = dy[:, t] + cin
                dx[:, t] = g[:, t] * dh
                da[:, t] = dh * (hprev[t - t0] - dgx[:, t])
                cin = a[:, t] * dh
        carry = next_carry
    return dx, da


def sequential(x, a):
    """The recurrence step by step from zero, in the inputs' dtype."""
    B, T, D = x.shape
    g = _gate(a)
    h = x.new_zeros((B, D))
    hs = []
    for t in range(T):
        h = a[:, t] * h + g[:, t] * x[:, t]
        hs.append(h)
    return torch.stack(hs, 1)


def closed_form_grads(x, a, dy):
    """The stated gradient from the sequential states: dh_t = dy_t +
    a_{t+1} dh_{t+1}, dx = g dh, da = dh (h_{t-1} - a x / g), or
    dh h_{t-1} where g = 0 (the clip saturated)."""
    h = sequential(x, a)
    hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    g = _gate(a)
    dh = torch.empty_like(dy)
    c = torch.zeros_like(dy[:, 0])
    for t in range(x.shape[1] - 1, -1, -1):
        dh[:, t] = dy[:, t] + c
        c = a[:, t] * dh[:, t]
    dgx = torch.where(g > 0, a * x / g, torch.zeros_like(x))
    return g * dh, dh * (hprev - dgx)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _inputs(seed, B, T, D, draw="sigmoid", zeros=(), ones=()):
    """x, a, dy as numpy f64 arrays: a = sigmoid(N(0, 1)), or as
    recurrentgemma makes it (``model``: exp(-8 softplus(lam) sigmoid(z)),
    lam ~ N(0, 0.5^2) per channel, z ~ N(0, 1)); a set to exactly 0 at the
    steps in ``zeros`` and to exactly 1 at the steps in ``ones``, on every
    other channel."""
    rng = np.random.default_rng(seed)
    x, z, dy = (rng.standard_normal((B, T, D)) for _ in range(3))
    if draw == "model":
        lam = 0.5 * rng.standard_normal(D)
        a = np.exp(-8.0 * np.log1p(np.exp(lam)) / (1.0 + np.exp(-z)))
    else:
        a = 1.0 / (1.0 + np.exp(-z))
    for t in zeros:
        a[:, t, ::2] = 0.0
    for t in ones:
        a[:, t, ::2] = 1.0
    return x, a, dy


def _torch(arrays, dtype):
    return [torch.from_numpy(np.asarray(v)).to(dtype) for v in arrays]


# T below, at and past one chunk; T 77 and 513 at D 200; a window past
# MAX_SLOTS chunks; a = 0 exactly at a chunk's first and last step; a band
# of a = 1
CASES = [
    (2, C - 6, 16, "sigmoid", (), ()),
    (2, C, 24, "model", (0, C - 1), ()),
    (3, 77, 200, "sigmoid", (C - 1, C, 2 * C - 1), ()),
    (2, 77, 40, "model", (), tuple(range(C - 3, C + 5))),
    (2, 513, 200, "model", (C, 4 * C - 1, 512), ()),
    (1, SLOTS * C + 70, 8, "sigmoid", (SLOTS * C - 1, SLOTS * C), ()),
]
IDS = [f"T{c[1]}-D{c[2]}-{c[3]}-zeros{len(c[4])}-ones{len(c[5])}"
       for c in CASES]


def _close(got, want, tol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def _chunk_ends(T):
    return [t0 + n - 1 for t0, n in _chunks(T)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunked_matches_sequential_f64(case):
    """f64: the chunked forward, its checkpoints (the states at each
    chunk's last step) and its backward against the sequential recurrence,
    torch autograd of it where a < 1, and the stated value where a = 1,
    to 1e-12."""
    B, T, D, draw, zeros, ones = case
    x, a, dy = _torch(_inputs(0, B, T, D, draw, zeros, ones), torch.float64)
    y, ck = chunked_forward(x, a)
    hs = sequential(x, a)
    _close([y, ck], [hs, hs[:, _chunk_ends(T)]], 1e-12)
    got = chunked_backward(x, a, ck, dy)
    _close(got, closed_form_grads(x, a, dy), 1e-12)
    leaves = [t.clone().requires_grad_() for t in (x, a)]
    want = torch.autograd.grad(sequential(*leaves), leaves, dy)
    live = a < 1.0
    _close([got[0], got[1][live]], [want[0], want[1][live]], 1e-12)
    assert torch.isfinite(got[1]).all()
    if ones:
        sat = ~live
        assert torch.equal(got[0][sat], torch.zeros_like(got[0][sat]))
        assert not torch.isfinite(want[1][sat]).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunked_matches_ref_f32(case):
    """f32: against ``ref.rglru`` and its states at each chunk's last step,
    to 2e-5, and against torch autograd through it where a < 1, to 1e-4."""
    B, T, D, draw, zeros, ones = case
    x, a, dy = _torch(_inputs(1, B, T, D, draw, zeros, ones), torch.float32)
    y, ck = chunked_forward(x, a)
    want = ref.rglru(x, a)[0]
    _close([y, ck], [want, want[:, _chunk_ends(T)]], 2e-5)
    got = chunked_backward(x, a, ck, dy)
    leaves = [t.clone().requires_grad_() for t in (x, a)]
    grads = torch.autograd.grad(ref.rglru(*leaves)[0], leaves, dy)
    live = a < 1.0
    _close([got[0], got[1][live]], [grads[0], grads[1][live]], 1e-4)


JAX_CASES = [CASES[1], CASES[2], CASES[3]]


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=[IDS[CASES.index(c)] for c in JAX_CASES])
def test_chunked_matches_jax(case):
    """The chunked forward against the JAX package's plain version and its
    Pallas kernel in interpret mode, f32 at 2e-5, and the chunked backward
    against ``jax.grad`` of the plain version at 1e-4 where a < 1 (da off
    ``jnp.clip``'s ties, where 1 - a^2 rounds to 1 and JAX passes half the
    gate term), on the same numpy draw."""
    B, T, D, draw, zeros, ones = case
    arrays = [v.astype(np.float32) for v in _inputs(2, B, T, D, draw, zeros,
                                                     ones)]
    x, a, dy = _torch(arrays, torch.float32)
    y, ck = chunked_forward(x, a)
    jx, ja = jnp.asarray(arrays[0]), jnp.asarray(arrays[1])
    for want in (jref.rglru(jx, ja)[0],
                 pallas_rglru(jx, ja, block_d=128, block_t=32,
                              interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    got = chunked_backward(x, a, ck, dy)
    want = jax.grad(lambda u, v: jnp.sum(jref.rglru(u, v)[0] * arrays[2]),
                    argnums=(0, 1))(jx, ja)
    an = arrays[1]
    live = an < 1.0
    off_tie = live & ((1.0 - an * an) < 1.0)
    assert off_tie.mean() > 0.5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy()[off_tie],
                               np.asarray(want[1])[off_tie], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("t", [C, 2 * C - 1])
def test_chunked_a_zero_cuts_the_past(t):
    """a = 0 on every channel at step t (a chunk's first or last step)
    makes h from t on and the gradients before t independent of the other
    side, exactly, in the chunked form as in the definition: nothing
    divides by a."""
    B, T, D = 2, 3 * C + 5, 8
    x, a, dy = _torch(_inputs(3, B, T, D), torch.float64)
    a[:, t] = 0.0
    y, ck = chunked_forward(x, a)
    x2, dy2 = x.clone(), dy.clone()
    x2[:, :t] = 7.0            # a different past
    dy2[:, t:] = -3.0          # a different future
    y2, ck2 = chunked_forward(x2, a)
    assert torch.equal(y[:, t:], y2[:, t:])
    dx, da = chunked_backward(x, a, ck, dy)
    dx2, da2 = chunked_backward(x, a, ck, dy2)
    assert torch.equal(dx[:, :t], dx2[:, :t])
    assert torch.equal(da[:, :t], da2[:, :t])
    assert torch.isfinite(ck2).all() and torch.isfinite(da).all()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_plan_training_shape():
    """recurrentgemma-2b's training shape, B4 T512 D2560 bf16: 16-step
    chunks, 32 a sequence, all in one window of one block; two channels
    (one 4-byte word) a thread; 640 blocks of 8 words x 32 chunks, 163,840
    threads a pass against the 10,240 of one thread per channel; the
    checkpoints every 16 steps in 1,310,720 bytes against the 20,971,520
    of every state; shared memory within one block's limit."""
    p = lru.plan(4, 512, 2560, torch.bfloat16)
    assert p["chunk"] == C == lru.chunk() == 16
    assert p["nc"] == 32 == lru.n_checkpoints(512)
    assert lru.n_checkpoints(513) == 33 and lru.n_checkpoints(16) == 1
    assert p["vec"] == 2 and p["slots"] == 32 and p["lanes"] == 8
    assert p["threads"] == 256 and p["channels"] == 16 and p["windows"] == 1
    assert p["grid"] == (160, 4) and p["blocks"] == 640
    assert p["threads_total"] == 163_840 == 4 * 2560 * 32 // 2 >= 81_920
    assert p["checkpoint_bytes"] == 1_310_720 == 4 * 4 * 32 * 2560
    assert p["inputs"] == "shared" and p["sub"] == lru.SUB == 4
    assert p["smem_fwd"] == 4 * (2 * C * 256 + 2 * 2 * 256 + 2 * 2 * 8)
    assert p["smem_bwd"] == 4 * (3 * C * 256 + 2 * 2 * 256 + 2 * 2 * 8)
    assert 0 < p["smem_fwd"] < p["smem_bwd"] <= SMEM_LIMIT


@pytest.mark.parametrize("B,T,D,dtype", [
    (2, 96, 64, torch.float32),        # the smoke config's training shape
    (4, 77, 200, torch.float32),
    (4, 513, 200, torch.bfloat16),
    (2, 20, 41, torch.bfloat16),
    (1, 4096, 2560, torch.bfloat16),   # windows of MAX_SLOTS chunks
])
def test_plan_small_and_ragged_shapes(B, T, D, dtype):
    """One chunk more for a ragged tail, a block of every chunk up to
    MAX_SLOTS and windows past it, grids by (channel tiles, B), and every
    block within the shared-memory limit."""
    p = lru.plan(B, T, D, dtype)
    nc = -(-T // C)
    vec = 4 // dtype.itemsize
    assert p["nc"] == nc == lru.n_checkpoints(T)
    assert p["vec"] == vec
    assert p["slots"] == min(nc, SLOTS)
    assert p["windows"] == -(-nc // p["slots"])
    assert p["threads"] == p["lanes"] * p["slots"] <= 256
    assert p["lanes"] % 4 == 0
    assert p["grid"] == (-(-(-(-D // vec)) // p["lanes"]), B)
    assert p["blocks"] * p["channels"] >= B * D
    assert p["checkpoint_bytes"] == 4 * B * nc * D
    assert 0 < p["smem_fwd"] < p["smem_bwd"] <= SMEM_LIMIT


def test_plan_is_shape_only_and_loads_nothing():
    """``chunk()`` and ``plan()`` come from the shapes alone: on a machine
    with no CUDA toolkit they neither build nor load the library."""
    assert lru.plan(4, 512, 2560, torch.bfloat16) == \
        lru.plan(4, 512, 2560, torch.bfloat16)
    assert lru.chunk() == lru.plan(1, 1, 1, torch.float32)["chunk"]
    assert "rglru_scan" not in lru._build._libs
