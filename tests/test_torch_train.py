"""The port's training path (``repro_torch.launch``, ``models``, ``optim``,
``checkpoint``, ``runtime``) against the JAX package's, on the CPU.

Both sides get the same numpy parameters (made by ``repro``'s
``init_tree``) and the same numpy batches; models run at f32.

* ``lm_loss`` and every gradient match ``jax.value_and_grad(lm_loss)`` on
  the llama3.2-1b and smollm-360m smoke configs, remat ``none``, ``full``
  and ``dots``: loss rtol 1e-5, gradients atol 2e-6 (f32 sums over 16 tokens
  and widths <= 128, taken in another order).
* sgd, momentum, adamw, global-norm clipping and int8 error feedback match
  for 5 updates from the same params and gradients: rtol/atol 1e-6.
* The train engine tracks the JAX engine over 5 steps at delta 0 and 2:
  SGD params within 1e-5, AdamW losses within 1e-4 relative (Adam's
  normalised step magnifies rounding where a gradient is near 0, so its
  params are not compared); the staleness telemetry is equal.
* A JAX checkpoint (sync dict and ``DelayedState``) resumes in the port,
  and the port's next steps match JAX's.
* The train CLI runs on the CPU, crashes with exit code 17 when told to,
  and resumes to the uninterrupted run's final loss, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.core.sync_jax import SyncConfig as JSyncConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import load_state, params_from_numpy  # noqa
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.data import LMBatchSpec, make_lm_batch  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("llama3.2-1b", "smollm-360m")


def _models(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "mask": mask}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _tpaths(tree):
    return {"/".join(path): leaf for path, leaf in leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

_JAX_GRADS: dict = {}


def _jax_value_and_grad(arch):
    """JAX's loss and gradients, once per arch (its remat policy does not
    change them)."""
    if arch not in _JAX_GRADS:
        jcfg, tcfg, jp, tp = _models(arch)
        jb, tb = _batch(tcfg, 1)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jtf.lm_loss(p, jb, jcfg), has_aux=True))(jp)
        _JAX_GRADS[arch] = (tcfg, tp, tb, float(loss),
                            {k: np.asarray(v) for k, v in
                             _jpaths(grads).items()})
    return _JAX_GRADS[arch]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, remat):
    tcfg, tp, tb, jloss, jgrads = _jax_value_and_grad(arch)
    grad_fn = tsteps.make_lm_grad_fn(tcfg, SyncConfig(remat=remat))
    loss, grads = grad_fn(tp, tb)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    got = _tpaths(grads)
    assert set(got) == set(jgrads)
    for k, g in got.items():
        assert g.shape == jgrads[k].shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=0, atol=2e-6,
                                   err_msg=k)
    assert all(g.abs().sum() > 0 for k, g in got.items()), \
        "a parameter got no gradient"


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_train_step_matches_jax(remat):
    """Three AdamW steps of ``make_train_step`` against JAX's, at the
    optimizer's default config (lr 3e-4): losses at rtol 1e-5, metrics'
    keys, params at atol 1e-5.  Adam's normalised step turns a rounding
    difference in a near-zero gradient into up to 2 lr, so the parameter
    tolerance holds only for an lr well under it (at lr 1e-3 one element
    of 16,384 moved 1.1e-5)."""
    jcfg, tcfg, jp, tp = _models("llama3.2-1b")
    jo = jopt.make_optimizer(jopt.OptConfig(name="adamw"))
    to = topt.make_optimizer(topt.OptConfig(name="adamw"))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jo,
                                           JSyncConfig(remat=remat)))
    tstep = tsteps.make_train_step(tcfg, to, SyncConfig(remat=remat))
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        jb, tb = _batch(tcfg, 20 + i)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _jpaths(jp).items()}
    got = _tpaths(tp)
    assert set(got) == set(want)
    for k, v in got.items():
        assert not v.requires_grad
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"a": rng.standard_normal((4, 6)).astype(np.float32),
            "z": {"b": rng.standard_normal(5).astype(np.float32),
                  "c": rng.standard_normal((2, 3)).astype(np.float32)}}


@pytest.mark.parametrize("name,clip,compression", [
    ("sgd", 0.0, "none"), ("momentum", 0.0, "none"), ("adamw", 0.0, "none"),
    ("adamw", 0.5, "none"), ("sgd", 0.0, "int8"), ("momentum", 1.0, "int8"),
    ("adamw", 0.5, "int8")])
def test_optimizers_match_jax(name, clip, compression):
    rng = np.random.default_rng(3)
    p0 = _opt_tree(rng)
    kw = dict(name=name, lr=0.05, grad_clip=clip, compression=compression)
    t, j = topt.make_optimizer(topt.OptConfig(**kw)), \
        jopt.make_optimizer(jopt.OptConfig(**kw))
    tp = jax.tree.map(torch.from_numpy, p0)
    jp = jax.tree.map(jnp.asarray, p0)
    ts, js = t.init(tp), j.init(jp)
    jupd = jax.jit(j.update)
    for _ in range(5):
        g = _opt_tree(rng)
        tp, ts = t.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        jp, js = jupd(jax.tree.map(jnp.asarray, g), js, jp)
    for got, want in ((tp, jp), (ts, js)):
        want = _jpaths(want)
        got = _tpaths(got)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(ts["step"]) == 5 and ts["step"].dtype == torch.int32


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(4)
    g = _opt_tree(rng)
    got = topt.clip_by_global_norm(jax.tree.map(torch.from_numpy, g), 0.3)
    want = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.3)
    np.testing.assert_allclose(float(topt.global_norm(got)),
                               float(jopt.global_norm(want)), rtol=1e-6)
    for k, v in _tpaths(got).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(_jpaths(want)[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("linear_warmup_cosine", (1e-3, 10, 100)),
    ("inverse_sqrt", (1e-3, 10))])
def test_schedules_match_jax(name, args):
    t, j = getattr(tsched, name)(*args), getattr(jsched, name)(*args)
    for step in (0, 1, 5, 10, 11, 60, 100, 250):
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got),
                                   float(j(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the engine, end to end, and checkpoints from JAX
# ---------------------------------------------------------------------------

STEPS, CKPT_AT = 5, 2


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX engine trajectories on the llama3.2-1b smoke config at f32, one
    per (delta, optimizer), each with a checkpoint after step CKPT_AT."""
    cache = {}

    def run(delta, opt_name):
        if (delta, opt_name) not in cache:
            jcfg, tcfg, jp, tp = _models("llama3.2-1b")
            opt = jopt.make_optimizer(jopt.OptConfig(name=opt_name, lr=3e-3))
            eng = jsteps.make_train_engine(
                jcfg, opt, JSyncConfig(delta=delta, remat="none"), jp)
            state = eng.init_state()
            ck = str(tmp_path_factory.mktemp(f"jax_d{delta}_{opt_name}"))
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


def _port_engine(r, delta, opt_name):
    opt = topt.make_optimizer(topt.OptConfig(name=opt_name, lr=3e-3))
    return tsteps.make_train_engine(r["tcfg"], opt,
                                    SyncConfig(delta=delta, remat="none"),
                                    r["tp"])


def _check_params(got, want, atol):
    got = _tpaths(got)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("delta", [0, 2])
def test_engine_tracks_jax(jax_runs, delta, opt_name):
    r = jax_runs(delta, opt_name)
    eng = _port_engine(r, delta, opt_name)
    state = eng.init_state()
    losses = []
    for tb in r["batches"]:
        state, m = eng.step(state, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-4)
    assert eng.telemetry.summary() == r["telemetry"]
    if opt_name == "sgd":
        _check_params(state["params"] if delta == 0 else state.params,
                      r["params"], atol=1e-5)


@pytest.mark.parametrize("delta", [0, 2])
def test_jax_checkpoint_resumes_in_port(jax_runs, delta):
    """The port loads JAX's step-2 state (params, ring, pointer, optimizer
    state, step) and its next steps give JAX's losses and parameters."""
    r = jax_runs(delta, "sgd")
    eng = _port_engine(r, delta, "sgd")
    state = load_state(r["ckpt"], CKPT_AT, eng.init_state())
    if delta:
        assert int(state.ptr) == CKPT_AT % (delta + 1)
        assert int(state.step) == CKPT_AT
    assert int((state["opt"] if delta == 0 else state.opt_state)["step"]) \
        == CKPT_AT
    losses = []
    for tb in r["batches"][CKPT_AT:]:
        state, m = eng.step_fn(state, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, r["losses"][CKPT_AT:], rtol=1e-5)
    _check_params(state["params"] if delta == 0 else state.params,
                  r["params"], atol=1e-5)


def test_batches_depend_only_on_seed_and_step():
    spec = LMBatchSpec(batch=2, seq_len=12, vocab_size=50, seed=4)
    a, b = make_lm_batch(spec, 3, "cpu"), make_lm_batch(spec, 3, "cpu")
    c = make_lm_batch(dataclasses.replace(spec, seed=5), 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], make_lm_batch(spec, 4, "cpu")["tokens"])
    t = a["tokens"]
    assert torch.equal(t[:, 2::2], t[:, 1:-1:2])        # copy structure
    assert torch.equal(a["labels"][:, :-1], t[:, 1:])
    assert a["mask"][:, -1].sum() == 0 and a["mask"][:, :-1].all()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch", "2",
       "--seq", "16", "--lr", "3e-3", "--log-every", "100"]


def test_train_cli_trains_on_cpu():
    """As tests/test_train_loop.py drives the JAX CLI: 25 steps of batch 4
    by 64 tokens bring the loss down, at delta 2 too."""
    r = ttrain.main(CLI + ["--steps", "25", "--batch", "4", "--seq", "64",
                           "--delta", "2"])
    assert r["final_loss"] < r["first_loss"]
    t = r["telemetry"]
    assert t["max_staleness"] == 2 and t["reads"] == t["writes"] == 25 * 11


@pytest.mark.parametrize("delta", [0, 2])
def test_train_cli_crash_and_resume(tmp_path, delta):
    """The restart drill: a crash at step 5 exits 17; the resumed run ends
    on the uninterrupted run's loss, bit for bit (deterministic data, the
    whole state in the checkpoint)."""
    base = CLI + ["--steps", "8", "--delta", str(delta)]
    full = ttrain.main(base)
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as e:
        ttrain.main(base + ["--ckpt-dir", ck, "--ckpt-every", "2",
                            "--fail-at-step", "5"])
    assert e.value.code == 17
    resumed = ttrain.main(base + ["--ckpt-dir", ck, "--ckpt-every", "2",
                                  "--resume"])
    assert resumed["final_loss"] == full["final_loss"]
