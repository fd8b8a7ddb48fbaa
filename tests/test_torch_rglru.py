"""The port's recurrentgemma slice against the JAX package's, on the CPU.

Both sides get the same numpy inputs and the same numpy parameter tree
(made by ``repro``'s ``init_tree``; its constant leaves, the biases and
the norms, get seeded noise so that they matter).

* ``ref.rglru`` matches JAX's plain version and the Pallas kernel in
  interpret mode at the shapes of ``tests/test_kernels.py`` (ragged T and
  D), x and a in f32 or bf16: f32 rtol/atol 2e-5, bf16 2e-2; from a state
  h0 it matches JAX's stateful call, and a sequence split over two calls
  equals one call.
* Torch autograd through ``ops.rglru`` on the CPU (the plain version, the
  oracle of the CUDA backward) matches ``jax.grad`` of JAX's plain version
  at f32, rtol/atol 1e-5, where a < 1.
* ``_causal_conv``, ``_gates`` and ``rglru_fwd`` match at f32, atol 1e-5;
  ``lm_loss`` and every gradient on the recurrentgemma-2b smoke config at
  f32, remat ``none`` and ``full``: loss rtol 1e-5, each gradient to a
  normalized max error (max |port - jax| / max |jax|, per leaf) of 5e-5.
* ``ops.attention`` at head dim 256, 10 q heads over 1 kv head and a
  window shorter than the sequence matches JAX's ``ref.attention`` and its
  gradients at f32, 2e-5.
* The train engine tracks JAX's over 5 steps at delta 0 and 2 (SGD params
  within 1e-5, losses within 1e-4 relative; equal telemetry); a JAX
  recurrentgemma tree loads by path from a ``repro.checkpoint`` file and
  from numpy arrays, and a JAX checkpoint resumes in the engine and in
  ``repro_torch.launch.train``.
"""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.core.sync_jax import SyncConfig as JSyncConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru  # noqa
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint, load_state,  # noqa
                                    params_from_numpy)
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.data import LMBatchSpec, make_lm_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

torch.set_num_threads(1)

ARCH = "recurrentgemma-2b"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _lru_inputs(rng, B, T, D, dtype):
    """x ~ N(0, 1) and a = sigmoid(N(0, 1)) in ``dtype``, as
    tests/test_kernels.py draws them, as torch tensors and jax arrays from
    one numpy draw."""
    tdt, jdt = DTYPES[dtype]
    x = rng.standard_normal((B, T, D), np.float32)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, D))))).astype(
        np.float32)
    return ([torch.from_numpy(x).to(tdt), torch.from_numpy(a).to(tdt)],
            [jnp.asarray(x).astype(jdt), jnp.asarray(a).astype(jdt)])


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,D,bd,bt", [
    (32, 64, 64, 16), (48, 160, 64, 32), (50, 96, 32, 16),  # ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_matches_jax_and_pallas(T, D, bd, bt, dtype):
    (x, a), jx = _lru_inputs(np.random.default_rng(0), 2, T, D, dtype)
    got, hT = ref.rglru(x, a)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert hT.dtype == torch.float32 and hT.shape == (2, D)
    want, jhT = jref.rglru(*jx)
    _close(got, want, dtype)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), **TOL[dtype])
    _close(got, pallas_rglru(*jx, block_d=bd, block_t=bt, interpret=True),
           dtype)
    assert torch.equal(ops.rglru(x, a), got)    # the CPU route


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_from_a_state_matches_jax(dtype):
    rng = np.random.default_rng(1)
    (x, a), jx = _lru_inputs(rng, 2, 21, 40, dtype)
    h0 = rng.standard_normal((2, 40), np.float32)
    y, h1 = ref.rglru(x, a, torch.from_numpy(h0))
    jy, jh1 = jref.rglru(*jx, jnp.asarray(h0))
    _close(y, jy, dtype)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), **TOL[dtype])


def test_rglru_stateful_continuation():
    """Splitting a sequence across two calls == one call, as
    tests/test_kernels.py holds the JAX version."""
    (x, a), _ = _lru_inputs(np.random.default_rng(5), 1, 20, 32, "float32")
    full, hT = ref.rglru(x, a)
    y1, h1 = ref.rglru(x[:, :7], a[:, :7])
    y2, h2 = ref.rglru(x[:, 7:], a[:, 7:], h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), full, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(h2, hT, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("draw", ["sigmoid", "model"])
def test_rglru_grads_match_jax(draw):
    """Autograd through ``ops.rglru`` on the CPU, the CUDA backward's
    oracle, against jax.grad of the JAX plain version, where a < 1: a from
    a sigmoid, and from the model's own map exp(-8 softplus(lam)
    sigmoid(z)) with lam ~ N(0, 0.5^2), z ~ N(0, 4), which reaches below
    1e-4, as the model's a does at initialisation.  Where a < ~2.4e-4,
    1 - a^2 rounds to 1.0, the clip's upper bound, and ``jnp.clip`` passes
    half the gradient at a tie (torch's clamp and the kernel the whole
    derivative -a/g): da is compared off those ties (ROADMAP, faults
    against the reference)."""
    rng = np.random.default_rng(4)
    B, T, D = 2, 29, 24
    (x, a), (jx, ja) = _lru_inputs(rng, B, T, D, "float32")
    if draw == "model":
        lam = 0.5 * rng.standard_normal(D)
        z = 2.0 * rng.standard_normal((B, T, D))
        an = np.exp(-8.0 * np.log1p(np.exp(lam)) / (1.0 + np.exp(-z)))
        an = an.astype(np.float32)
        a, ja = torch.from_numpy(an), jnp.asarray(an)
    assert float(a.max()) < 1.0
    dy = rng.standard_normal((B, T, D), np.float32)
    ins = [t.clone().requires_grad_() for t in (x, a)]
    got = torch.autograd.grad((ops.rglru(*ins) * torch.from_numpy(dy)).sum(),
                              ins)
    want = jax.grad(lambda *z: jnp.sum(jref.rglru(*z)[0] * dy),
                    argnums=(0, 1))(jx, ja)
    off_tie = (1.0 - a * a).numpy() < 1.0
    assert off_tie.mean() > 0.95
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy()[off_tie],
                               np.asarray(want[1])[off_tie], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# attention at recurrentgemma's heads
# ---------------------------------------------------------------------------

def test_attention_hd256_group10_window_matches_jax():
    """``ops.attention`` (the CPU route) at head dim 256, 10 q heads over
    one kv head, a window of 16 over 40 positions, forward and gradients
    against JAX's ``ref.attention``."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 40, 10, 256), np.float32)
    k = rng.standard_normal((2, 40, 1, 256), np.float32)
    v = rng.standard_normal((2, 40, 1, 256), np.float32)
    do = rng.standard_normal((2, 40, 10, 256), np.float32)
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = ops.attention(*ins, causal=True, window=16)
    jfn = lambda *z: jref.attention(*z, causal=True, window=16)  # noqa
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jfn(q, k, v)), rtol=2e-5,
                               atol=2e-5)
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    want = jax.grad(lambda *z: jnp.sum(jfn(*z) * do),
                    argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _tpaths(tree):
    return {"/".join(path): leaf for path, leaf in leaves_with_path(tree)}


def _numpy_tree(jcfg):
    rng = np.random.default_rng(7)

    def noisy(a):          # constant leaves (zeros, ones) get noise
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            a = a + 0.5 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    return jax.tree.map(noisy, jparamlib.init_tree(jtf.model_specs(jcfg),
                                                   jax.random.PRNGKey(0)))


def _models():
    """The smoke config at f32 on both sides, one numpy parameter tree."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               dtype=torch.float32)
    npt = _numpy_tree(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npt), \
        params_from_numpy(npt, device="cpu")


def _batch(cfg, seed, B=2, S=24):
    """S = 24 exceeds the smoke config's window of 16."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "mask": mask}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_config_and_specs_match_jax():
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(tconfigs, get)(ARCH), getattr(jconfigs, get)(ARCH)
        assert t.rnn_width == j.rnn_width and t.layer_kinds == j.layer_kinds
    assert ARCH in tconfigs.all_arch_ids()
    cfg = tconfigs.get_config(ARCH)
    tspecs = _tpaths(ttf.model_specs(cfg))
    jspecs = _jpaths(jtf.model_specs(jconfigs.get_config(ARCH)))
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    # the published count, as the JAX package's param_count gives it
    assert sum(int(np.prod(v.shape)) for v in tspecs.values()) \
        == 2_894_574_080


def test_causal_conv_gates_and_block_match_jax():
    jcfg, tcfg, jp, tp = _models()
    x = np.random.default_rng(8).standard_normal((2, 13, 64), np.float32)
    j1 = jax.tree.map(lambda a: a[0], jp["groups"]["g0"]["s1"]["mix"])
    t1 = {n: a[0] for n, a in tp["groups"]["g0"]["s1"]["mix"].items()}
    u = x @ np.asarray(j1["wx"])
    got_u = trglru._causal_conv(torch.from_numpy(u), t1["conv_w"],
                                t1["conv_b"])
    want_u = jrglru._causal_conv(jnp.asarray(u), j1["conv_w"],
                                 j1["conv_b"], None)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=0,
                               atol=1e-5)
    for g, w in zip(trglru._gates(t1, got_u), jrglru._gates(j1, want_u)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    got = trglru.rglru_fwd(t1, torch.from_numpy(x), tcfg)
    want = jrglru.rglru_fwd(j1, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


_JAX_GRADS: dict = {}
# per leaf, max |port - jax| / max |jax|: the rms norms divide by small
# norms, so the two frameworks' rounding differences scale with a leaf's
# largest gradient, not with each element
GRAD_NORM_TOL = 5e-5


def _jax_value_and_grad():
    if not _JAX_GRADS:
        jcfg, tcfg, jp, tp = _models()
        jb, tb = _batch(tcfg, 1)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jtf.lm_loss(p, jb, jcfg), has_aux=True))(jp)
        _JAX_GRADS.update(tcfg=tcfg, tp=tp, tb=tb, loss=float(loss),
                          grads={k: np.asarray(v) for k, v in
                                 _jpaths(grads).items()})
    return _JAX_GRADS


@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_grads_match_jax(remat):
    r = _jax_value_and_grad()
    grad_fn = tsteps.make_lm_grad_fn(r["tcfg"], SyncConfig(remat=remat))
    loss, grads = grad_fn(r["tp"], r["tb"])
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-5)
    got = _tpaths(grads)
    assert set(got) == set(r["grads"])
    for k, g in got.items():
        want = r["grads"][k]
        assert g.shape == want.shape and g.dtype == torch.float32
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_NORM_TOL, (k, err)
    assert all(g.abs().sum() > 0 for g in got.values()), \
        "a parameter got no gradient"


def test_serving_refuses_recurrentgemma_naming_the_queue_item():
    cfg = tconfigs.get_smoke_config(ARCH)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="'rglru' comes with "
                       "ROADMAP queue A item 1 "):
        ttf.prefill({}, tokens, cfg)
    with pytest.raises(NotImplementedError, match="queue A item 1 "):
        ttf.init_chunk_carry(cfg)
    from repro_torch.serve import ServeConfig, ServeEngine
    with pytest.raises(NotImplementedError, match="queue A item 1 "):
        ServeEngine(cfg, {}, ServeConfig(batch_size=1, page_size=4,
                                         cache_len=16))


@pytest.mark.parametrize("source", ["checkpoint", "numpy"])
def test_jax_tree_loads_by_path(tmp_path, source):
    """A JAX recurrentgemma parameter tree reaches the port with JAX's paths,
    shapes and bits, from a ``repro.checkpoint`` file and from numpy
    arrays, and the port's specs name the same leaves."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    npt = _numpy_tree(jcfg)
    if source == "checkpoint":
        jsave(str(tmp_path), 3, jax.tree.map(jnp.asarray, npt))
        got = load_checkpoint(str(tmp_path), 3, device="cpu")
    else:
        got = params_from_numpy(npt, device="cpu")
    want = _jpaths(npt)
    got = _tpaths(got)
    assert set(got) == set(want) == \
        set(_tpaths(ttf.model_specs(tconfigs.get_smoke_config(ARCH))))
    assert "groups/g0/s0/mix/lam" in got and "groups/g0/s2/mix/wq" in got
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the engine and checkpoints from JAX
# ---------------------------------------------------------------------------

STEPS, CKPT_AT = 5, 2


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX engine trajectories on the recurrentgemma smoke config at f32, one
    per (delta, optimizer), each with a checkpoint after step CKPT_AT."""
    cache = {}

    def run(delta, opt_name):
        if (delta, opt_name) not in cache:
            jcfg, tcfg, jp, tp = _models()
            opt = jopt.make_optimizer(jopt.OptConfig(name=opt_name, lr=3e-3))
            eng = jsteps.make_train_engine(
                jcfg, opt, JSyncConfig(delta=delta, remat="none"), jp)
            state = eng.init_state()
            ck = str(tmp_path_factory.mktemp(f"jax_rg_d{delta}_{opt_name}"))
            losses, batches = [], []
            for i in range(STEPS):
                jb, tb = _batch(tcfg, 10 + i)
                batches.append(tb)
                state, m = eng.step(state, jb)
                losses.append(float(m["loss"]))
                if i + 1 == CKPT_AT:
                    jsave(ck, CKPT_AT, state)
            params = state["params"] if delta == 0 else state.params
            cache[(delta, opt_name)] = dict(
                tcfg=tcfg, tp=tp, batches=batches, losses=losses, ckpt=ck,
                params={k: np.asarray(v) for k, v in _jpaths(params).items()},
                telemetry=eng.telemetry.summary())
        return cache[(delta, opt_name)]
    return run


def _port_engine(cfg, params, delta, opt_name):
    opt = topt.make_optimizer(topt.OptConfig(name=opt_name, lr=3e-3))
    return tsteps.make_train_engine(cfg, opt,
                                    SyncConfig(delta=delta, remat="none"),
                                    params)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("delta", [0, 2])
def test_engine_tracks_jax(jax_runs, delta, opt_name):
    r = jax_runs(delta, opt_name)
    eng = _port_engine(r["tcfg"], r["tp"], delta, opt_name)
    state = eng.init_state()
    losses = []
    for tb in r["batches"]:
        state, m = eng.step(state, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-4)
    assert eng.telemetry.summary() == r["telemetry"]
    if opt_name == "sgd":
        got = _tpaths(state["params"] if delta == 0 else state.params)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), r["params"][k], rtol=0,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("delta", [0, 2])
def test_jax_checkpoint_resumes_in_port(jax_runs, delta):
    """The port loads JAX's step-2 recurrentgemma state (the RG-LRU and
    attention leaves by path, the ring, the optimizer state) and its next
    steps give JAX's losses and parameters."""
    r = jax_runs(delta, "sgd")
    eng = _port_engine(r["tcfg"], r["tp"], delta, "sgd")
    state = load_state(r["ckpt"], CKPT_AT, eng.init_state())
    losses = []
    for tb in r["batches"][CKPT_AT:]:
        state, m = eng.step_fn(state, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, r["losses"][CKPT_AT:], rtol=1e-5)
    got = _tpaths(state["params"] if delta == 0 else state.params)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), r["params"][k], rtol=0,
                                   atol=1e-5, err_msg=k)


CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
       "--seq", "16", "--lr", "3e-3", "--log-every", "100"]


def test_train_cli_trains_recurrentgemma_on_cpu():
    """As the llama CLI test: 25 steps of batch 4 by 64 tokens (past the
    window of 16) at delta 2 bring the loss down."""
    r = ttrain.main(CLI + ["--steps", "25", "--batch", "4", "--seq", "64",
                           "--delta", "2"])
    assert r["final_loss"] < r["first_loss"]
    assert r["telemetry"]["max_staleness"] == 2


def test_train_cli_resumes_a_jax_checkpoint(jax_runs, capsys, tmp_path):
    """``repro_torch.launch.train --resume`` picks up JAX's step-2
    recurrentgemma checkpoint (delta 2, SGD) and steps on from it: its
    final loss is the one the port's engine reaches from the same loaded
    state on the CLI's batches, bit for bit."""
    r = jax_runs(2, "sgd")
    ck = str(tmp_path / "ck")
    shutil.copytree(r["ckpt"], ck)          # the CLI saves into its dir
    out = ttrain.main(CLI + ["--steps", "4", "--delta", "2", "--optimizer",
                             "sgd", "--ckpt-dir", ck, "--resume"])
    assert f"resumed from step {CKPT_AT}" in capsys.readouterr().out
    cfg = tconfigs.get_smoke_config(ARCH)
    eng = _port_engine(cfg, r["tp"], 2, "sgd")
    state = load_state(r["ckpt"], CKPT_AT, eng.init_state())
    spec = LMBatchSpec(batch=2, seq_len=16, vocab_size=cfg.vocab_size)
    for step in range(CKPT_AT, 4):
        state, m = eng.step_fn(state, make_lm_batch(spec, step, "cpu"))
    assert out["final_loss"] == float(m["loss"])
