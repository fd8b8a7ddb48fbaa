"""The chunk-parallel WKV algorithm of ``csrc/rwkv6_scan.cu``, on the CPU.

The CUDA kernels run only on a card.  This file holds the algorithm they
implement, written here in plain PyTorch with the kernels' own constants
(``CHUNK``, ``SEG``, ``SUB`` of ``repro_torch.kernels.rwkv6_scan``):

* forward: each chunk's summary (a = prod w, dS from a zero state), the
  fold of the earlier summaries into the chunk's start state (the
  checkpoint: the state *before* step c * CHUNK), and the chunk's walk;
* backward: the adjoint's chunk summaries walked backward from zero, dv
  from a walk of the adjoint in reverse time, dr, dk, dw from the two-level
  recompute (states at the SEG-step boundaries, then each SUB-step
  sub-chunk's states, walked backward), and du as per-(batch, chunk) f64
  partials summed in that order.

It is held in f64 to 1e-10 against the sequential recurrence and torch
autograd of it, in f32 to 1e-5 against ``ref.rwkv6`` and its autograd, and
to JAX: ``repro.kernels.ref.rwkv6`` and the Pallas kernel in interpret mode
(f32, 2e-5 as ``tests/test_torch_rwkv6.py`` holds them), on inputs drawn
from a numpy seed.  Cases cross the chunk edges: T below, at and above one
chunk, ragged tails; head dims 16 and 64; the decay near 0 (mean 2) and
exactly 0 at a chunk's first and last step and inside a chunk.  Nothing in
it divides by w.  Serving's forward from a carried state S0 (the fold
starts from it; checkpoint 0 is S0) with the state after the last step
out (the last chunk's walk ends on it): in f64 against the sequential
recurrence from S0, in f32 against ``ref.rwkv6_stateful`` and JAX's, at
T 1 (a decode step, one partial chunk and no summary) and across chunk
edges; a zero S0 gives the null state's bits.  Then ``plan()``'s numbers
at the training and smoke shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6  # noqa
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wkv  # noqa: E402

torch.set_num_threads(1)

C, SEG, SUB = wkv.CHUNK, wkv.SEG, wkv.SUB
SMEM_LIMIT = 232_448        # shared memory one H100 block may use


# ---------------------------------------------------------------------------
# the algorithm, vectorised over (batch, head), in the inputs' dtype
# ---------------------------------------------------------------------------

def _step(X, w_t, b_t, c_t):
    """X <- diag(w_t) X + b_t c_t^T over (B, H, hd, hd)."""
    return w_t[..., :, None] * X + b_t[..., :, None] * c_t[..., None, :]


def _summary(bv, cv, w, t0, n, reverse):
    """A chunk's (a, dX): its n steps from t0 walked from zero (backward in
    time when ``reverse``) and the product of its decays per row."""
    B, _, H, hd = bv.shape
    X = bv.new_zeros((B, H, hd, hd))
    a = bv.new_ones((B, H, hd))
    steps = range(t0 + n - 1, t0 - 1, -1) if reverse else range(t0, t0 + n)
    for t in steps:
        X = _step(X, w[:, t], bv[:, t], cv[:, t])
        a = a * w[:, t]
    return a, X


def _fold(summ, order, X):
    for c in order:
        a, dX = summ[c]
        X = a[..., :, None] * X + dX
    return X


def _chunks(T):
    return [(c * C, min(C, T - c * C)) for c in range(-(-T // C))]


def chunked_forward(r, k, v, w, u, S0=None, with_final=False):
    """y and the checkpoints (B, H, nc, hd, hd) as the forward kernels
    compute them, from the state S0 (zero when None); with ``with_final``
    also the state after the last step, where the last chunk's walk
    ends."""
    B, T, H, hd = r.shape
    chunks = _chunks(T)
    # one chunk has nothing to fold: the summary pass is skipped
    summ = [_summary(k, v, w, t0, n, False) for t0, n in chunks] \
        if len(chunks) > 1 else []
    start = r.new_zeros((B, H, hd, hd)) if S0 is None else S0
    y = torch.empty_like(r)
    ckpt = r.new_empty((B, H, len(chunks), hd, hd))
    for c, (t0, n) in enumerate(chunks):
        S = _fold(summ, range(c), start)
        ckpt[:, :, c] = S
        for t in range(t0, t0 + n):
            bonus = (r[:, t] * u * k[:, t]).sum(-1, keepdim=True)
            y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t], S) \
                + bonus * v[:, t]
            S = _step(S, w[:, t], k[:, t], v[:, t])
    return (y, ckpt, S) if with_final else (y, ckpt)


def chunked_backward(r, k, v, w, u, ckpt, dy):
    """(dr, dk, dv, dw, du) as the backward kernels compute them."""
    B, T, H, hd = r.shape
    chunks = _chunks(T)
    nc = len(chunks)
    adj = [_summary(r, dy, w, t0, n, True) for t0, n in chunks]
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.zeros((B, nc, H, hd), dtype=torch.float64)
    for c, (t0, n) in enumerate(chunks):
        later = range(nc - 1, c, -1)
        # dv: the adjoint walked in reverse time from the chunk's end
        G = _fold(adj, later, r.new_zeros((B, H, hd, hd)))
        for t in range(t0 + n - 1, t0 - 1, -1):
            bonus = (k[:, t] * u * r[:, t]).sum(-1, keepdim=True)
            dv[:, t] = torch.einsum("bhi,bhij->bhj", k[:, t], G) \
                + bonus * dy[:, t]
            G = _step(G, w[:, t], r[:, t], dy[:, t])
        # dr, dk, dw: the states rebuilt from the checkpoint in two levels
        G = _fold(adj, later, r.new_zeros((B, H, hd, hd)))
        nseg = -(-n // SEG)
        Sb = [ckpt[:, :, c]]
        for s in range(nseg - 1):
            S = Sb[-1]
            for t in range(t0 + SEG * s, t0 + SEG * (s + 1)):
                S = _step(S, w[:, t], k[:, t], v[:, t])
            Sb.append(S)
        for s in range(nseg - 1, -1, -1):
            ns = min(SEG, n - SEG * s)
            for p0 in range(SUB * ((ns - 1) // SUB), -1, -SUB):
                nn = min(SUB, ns - p0)
                S = Sb[s]
                ts = t0 + SEG * s
                for t in range(ts, ts + p0):
                    S = _step(S, w[:, t], k[:, t], v[:, t])
                states = [S]
                for t in range(ts + p0, ts + p0 + nn - 1):
                    states.append(_step(states[-1], w[:, t], k[:, t],
                                        v[:, t]))
                for p in range(nn - 1, -1, -1):
                    t = ts + p0 + p
                    St = states[p]
                    vdy = (v[:, t] * dy[:, t]).sum(-1, keepdim=True)
                    dr[:, t] = (St * dy[:, t, :, None, :]).sum(-1) \
                        + u * k[:, t] * vdy
                    dk[:, t] = (G * v[:, t, :, None, :]).sum(-1) \
                        + u * r[:, t] * vdy
                    dw[:, t] = (G * St).sum(-1)
                    du_part[:, c] += (r[:, t] * k[:, t] * vdy).double()
                    G = _step(G, w[:, t], r[:, t], dy[:, t])
    du = torch.zeros((H, hd), dtype=torch.float64)
    for b in range(B):
        for c in range(nc):
            du = du + du_part[b, c]
    return dr, dk, dv, dw, du.to(r.dtype)


def sequential(r, k, v, w, u, S0=None, with_final=False):
    """The recurrence step by step from S0 (zero when None), in the inputs'
    dtype; with ``with_final`` also the state after the last step."""
    B, T, H, hd = r.shape
    S = r.new_zeros((B, H, hd, hd)) if S0 is None else S0
    ys = []
    for t in range(T):
        bonus = (r[:, t] * u * k[:, t]).sum(-1, keepdim=True)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S)
                  + bonus * v[:, t])
        S = _step(S, w[:, t], k[:, t], v[:, t])
    y = torch.stack(ys, 1)
    return (y, S) if with_final else y


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _inputs(seed, B, T, H, hd, decay_mean=0.0, zeros=()):
    """r, k, v, w, u, dy as numpy f64 arrays: w = exp(-exp(x)), x ~
    N(decay_mean, 1), set to exactly 0 at the steps in ``zeros`` on every
    other row."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, T, H, hd)) * 0.5
                   for _ in range(4))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hd)) + decay_mean))
    for t in zeros:
        if t < T:
            w[:, t, :, ::2] = 0.0
    u = rng.standard_normal((H, hd)) * 0.1
    return r, k, v, w, u, dy


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# T below, at and above one chunk; ragged tails; w = 0 exactly at a chunk's
# first and last step and inside one; the decay near 0
CASES = [
    (2, 40, 2, 16, 0.0, ()),
    (2, C, 2, 16, 0.0, (0, C - 1)),
    (2, 77, 3, 16, 2.0, ()),
    (1, 77, 2, 64, 0.0, (C - 1, C)),
    (1, 200, 2, 16, 0.0, (30, C, 2 * C - 1, 3 * C)),
    (1, 200, 1, 64, 2.0, (C,)),
]
IDS = [f"T{c[1]}-hd{c[3]}-mean{c[4]:g}-zeros{len(c[5])}" for c in CASES]


def _close(got, want, tol):
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunked_matches_sequential_f64(case):
    """f64: the chunked forward, its checkpoints and its backward against
    the sequential recurrence and torch autograd of it, to 1e-10."""
    B, T, H, hd, mean, zeros = case
    arrays = _inputs(0, B, T, H, hd, mean, zeros)
    r, k, v, w, u, dy = _torch(arrays, torch.float64)
    y, ckpt = chunked_forward(r, k, v, w, u)
    _close([y], [sequential(r, k, v, w, u)], 1e-10)
    for c in range(ckpt.shape[2]):
        S = r.new_zeros((B, H, hd, hd))
        for t in range(c * C):
            S = _step(S, w[:, t], k[:, t], v[:, t])
        _close([ckpt[:, :, c]], [S], 1e-10)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    want = torch.autograd.grad(sequential(*leaves), leaves, dy)
    _close(chunked_backward(r, k, v, w, u, ckpt, dy), want, 1e-10)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunked_matches_ref_f32(case):
    """f32: against ``ref.rwkv6`` (and ``ref.rwkv6_stateful`` for the
    checkpoints) and torch autograd through it, to 1e-5; du also against
    its f64 closed form sum_{b,t} r k (v . dy)."""
    B, T, H, hd, mean, zeros = case
    arrays = _inputs(1, B, T, H, hd, mean, zeros)
    r, k, v, w, u, dy = _torch(arrays, torch.float32)
    y, ckpt = chunked_forward(r, k, v, w, u)
    _close([y], [ref.rwkv6(r, k, v, w, u)], 1e-5)
    S0 = torch.zeros((B, H, hd, hd))
    for c in range(ckpt.shape[2]):
        _, S = ref.rwkv6_stateful(*(x[:, :c * C] for x in (r, k, v, w)), u,
                                  S0)
        _close([ckpt[:, :, c]], [S], 1e-5)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    want = torch.autograd.grad(ref.rwkv6(*leaves), leaves, dy)
    got = chunked_backward(r, k, v, w, u, ckpt, dy)
    _close(got[:4], want[:4], 1e-5)
    r64, k64, v64, dy64 = (torch.from_numpy(a)
                           for a in (arrays[0], arrays[1], arrays[2],
                                     arrays[5]))
    du = torch.einsum("bthi,bthi,bth->hi", r64, k64, (v64 * dy64).sum(-1))
    torch.testing.assert_close(got[4].double(), du, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[4]],
                         ids=[IDS[1], IDS[3], IDS[4]])
def test_chunked_matches_jax(case):
    """The chunked forward against the JAX package's plain version and its
    Pallas kernel in interpret mode, f32 at 2e-5, on the same numpy draw."""
    B, T, H, hd, mean, zeros = case
    arrays = [a.astype(np.float32) for a in _inputs(2, B, T, H, hd, mean,
                                                     zeros)]
    r, k, v, w, u, _ = _torch(arrays, torch.float32)
    y, _ = chunked_forward(r, k, v, w, u)
    jx = [jnp.asarray(a) for a in arrays[:5]]
    for want in (jref.rwkv6(*jx), pallas_rwkv6(*jx, block_t=32,
                                                 interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_chunked_w_zero_cuts_the_past():
    """w = 0 on every row at step t makes y after t independent of
    everything before t, exactly, in the chunked form as in the
    definition: nothing divides by w."""
    B, T, H, hd = 1, 150, 1, 16
    arrays = _inputs(3, B, T, H, hd)
    r, k, v, w, u, _ = _torch(arrays, torch.float64)
    w[:, C] = 0.0
    y, _ = chunked_forward(r, k, v, w, u)
    k2 = k.clone()
    k2[:, :C] = 7.0  # a different past
    y2, ckpt2 = chunked_forward(r, k2, v, w, u)
    assert torch.equal(y[:, C + 1:], y2[:, C + 1:])
    assert torch.isfinite(ckpt2).all()


# serving's shapes: a decode step (T = 1) and a ragged one-chunk tail, then
# chunk edges with w = 0 and the decay near 0, all from a carried state
STATE_CASES = [(3, 1, 2, 16, 0.0, ()), (2, 37, 2, 64, 0.0, ()),
               CASES[2], CASES[4], CASES[5]]
STATE_IDS = [f"T{c[1]}-hd{c[3]}-mean{c[4]:g}" for c in STATE_CASES]


@pytest.mark.parametrize("case", STATE_CASES, ids=STATE_IDS)
def test_chunked_from_a_state(case):
    """From a random S0: in f64 y, the checkpoints (checkpoint 0 is S0) and
    the final state against the sequential recurrence from S0 to 1e-10; in
    f32 y and the final state against ``ref.rwkv6_stateful`` and JAX's to
    1e-5; an S0 of zeros gives the null state's bits."""
    B, T, H, hd, mean, zeros = case
    arrays = _inputs(4, B, T, H, hd, mean, zeros)
    S0 = np.random.default_rng(6).standard_normal((B, H, hd, hd)) * 0.5
    r, k, v, w, u, _, S064 = _torch(arrays + (S0,), torch.float64)
    y, ckpt, ST = chunked_forward(r, k, v, w, u, S064, with_final=True)
    want, wT = sequential(r, k, v, w, u, S064, with_final=True)
    _close([y, ST, ckpt[:, :, 0]], [want, wT, S064], 1e-10)
    for c in range(1, ckpt.shape[2]):
        _, Sc = sequential(*(x[:, :c * C] for x in (r, k, v, w)), u, S064,
                           with_final=True)
        _close([ckpt[:, :, c]], [Sc], 1e-10)
    r, k, v, w, u, _, S032 = _torch(arrays + (S0,), torch.float32)
    y, _, ST = chunked_forward(r, k, v, w, u, S032, with_final=True)
    _close([y, ST], ref.rwkv6_stateful(r, k, v, w, u, S032), 1e-5)
    jy, jT = jref.rwkv6_stateful(*(jnp.asarray(t.numpy())
                                   for t in (r, k, v, w, u, S032)))
    for got, jw in ((y, jy), (ST, jT)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-5)
    zero = chunked_forward(r, k, v, w, u, torch.zeros_like(S032),
                           with_final=True)
    null = chunked_forward(r, k, v, w, u, with_final=True)
    assert all(torch.equal(a, b) for a, b in zip(zero, null))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_plan_training_shape():
    """rwkv6-1.6b's training shape, B4 T512 H32 hd64: 8 chunks, every
    recurrence kernel at least 4096 blocks, checkpoints every 64 steps in
    16,777,216 bytes, shared memory within one block's limit."""
    p = wkv.plan(4, 512, 32, 64)
    assert p["chunk"] == C == 64 and p["nc"] == 8
    assert wkv.chunk() == 64 and wkv.n_checkpoints(512) == 8
    assert wkv.n_checkpoints(513) == 9 and wkv.n_checkpoints(64) == 1
    assert p["checkpoint_bytes"] == 16_777_216
    assert p["scratch_bytes"] == 4 * 4 * 32 * 8 * 64 * 65
    assert p["du_part_bytes"] == 8 * 4 * 8 * 32 * 64
    for name in ("fwd_sum", "fwd", "bwd_sum", "bwd_dv", "bwd"):
        k = p[name]
        assert k["blocks"] >= 4096, name
        assert k["grid"][1:] == (32, 4)
        assert k["grid"][0] == 8 * k["slices"]
        assert k["slices"] * k["width"] == 64
        assert 0 < k["smem"] <= SMEM_LIMIT
    assert p["fwd"]["threads"] == p["bwd_dv"]["threads"] == 32
    assert p["fwd"]["width"] == 16 and p["bwd"]["width"] == 16
    assert p["du"]["grid"] == (8, 1, 1)


@pytest.mark.parametrize("B,T,H,hd", [(2, 32, 4, 16), (4, 77, 32, 16),
                                      (4, 77, 32, 64), (1, 513, 2, 64)])
def test_plan_small_and_ragged_shapes(B, T, H, hd):
    """The smoke config's head dim 16 and ragged T: one chunk more for a
    ragged tail, grids by (chunks x slices, H, B)."""
    p = wkv.plan(B, T, H, hd)
    nc = -(-T // 64)
    assert p["nc"] == nc == wkv.n_checkpoints(T)
    assert p["checkpoint_bytes"] == 4 * B * H * nc * hd * hd
    assert p["scratch_bytes"] == 4 * B * H * nc * hd * (hd + 1)
    for name in ("fwd_sum", "fwd", "bwd_sum", "bwd_dv", "bwd"):
        k = p[name]
        # a single chunk needs no summaries: those kernels do not launch
        chunks = 0 if name.endswith("sum") and nc == 1 else nc
        assert k["grid"] == (chunks * hd // k["width"], H, B)
        assert k["blocks"] == chunks * hd // k["width"] * H * B
        assert 0 < k["smem"] <= SMEM_LIMIT
        assert k["threads"] in (8, 16, 32, 64)


def test_plan_is_shape_only_and_loads_nothing():
    """``chunk()`` and ``plan()`` come from the shapes alone: on a machine
    with no CUDA toolkit they neither build nor load the library."""
    assert wkv.plan(4, 512, 32, 64) == wkv.plan(4, 512, 32, 64)
    assert wkv.chunk() == wkv.plan(1, 1, 1, 16)["chunk"]
