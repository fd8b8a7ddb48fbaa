"""The port's MoE training path against the JAX package, on the CPU.

Both sides get the same numpy parameters (made by ``repro``'s
``init_tree``) and the same numpy batches or routing; everything runs in
f32, on the mixtral-8x7b and llama4-scout-17b-a16e smoke configs.

* Autograd of the port's plain grouped FFN (``ref.moe_grouped_ffn``, the
  CPU route of ``ops.moe_grouped_ffn``) against ``jax.grad`` of JAX's:
  dx, dwg, dwu, dwd and dcombine at atol 1e-5 (times the gradient's
  largest magnitude where that is above 1: the random dispatch sums about
  five tokens a slot, and its dcombine reaches ~60, where f32's own
  spacing is 4e-6), over routed groups with capacity drops, an idle
  expert, a dropped token and two tokens in one slot.
* ``make_lm_grad_fn``'s loss and every gradient against
  ``jax.value_and_grad(lm_loss)``: the total (cross entropy plus the
  router's load-balance and z losses) at rtol 1e-5, gradients at atol
  1e-5 (f32 sums in another order); the router's gradient is non-zero.
* ``lm_loss``'s metrics (``loss``, ``total_loss``, ``lb_loss``,
  ``router_entropy``) against JAX's at capacity factors 1.25 and 4.0.
* The train engine against JAX's on mixtral smoke, 5 steps at delta 0
  and 2 with SGD and AdamW: losses at rtol 1e-4, telemetry equal.
* The train CLI trains mixtral smoke on the CPU through ``--backend
  engine`` and ``--backend server``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.sync_jax import SyncConfig as JSyncConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.moe import route  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
GRAD_TOL = 1e-5


def _models(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32, **over)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed, B=2, S=32):
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
# the grouped FFN's gradient
# ---------------------------------------------------------------------------

def _routing(rng, G, g, E, C, case):
    """dispatch (bool) and combine (f32) numpy arrays: the model's top-2
    routing of random router probabilities (capacity drops included), with
    an idle expert and a dropped token, or a random dispatch with two
    tokens in one slot and combine weights off the dispatch."""
    if case == "random":
        dispatch = rng.random((G, g, E, C)) < 0.2
        dispatch[0, 0, 1, 0] = dispatch[0, 1, 1, 0] = True
        return dispatch, rng.random((G, g, E, C)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(
        rng.normal(size=(G, g, E)).astype(np.float32)), -1)
    dispatch, combine = (t.numpy().copy() for t in route(probs, 2, C))
    if case == "idle":
        dispatch[..., 1, :] = False         # expert 1 gets no token
        combine[..., 1, :] = 0
        dispatch[:, 3] = False              # token 3 is dropped
        combine[:, 3] = 0
    return dispatch, combine


@pytest.mark.parametrize("case", ["routed", "idle", "random"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_ffn_grads_match_jax(arch, case):
    cfg = tconfigs.get_smoke_config(arch)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    G, g, C = 2, 24, 7                      # C < g k / E: drops
    rng = np.random.default_rng(3)
    dispatch, combine = _routing(rng, G, g, E, C, case)
    x = rng.normal(size=(G, g, d)).astype(np.float32)
    wg, wu = (rng.normal(size=(E, d, f)).astype(np.float32) * d ** -0.5
              for _ in range(2))
    wd = rng.normal(size=(E, f, d)).astype(np.float32) * f ** -0.5
    dout = rng.normal(size=(G, g, d)).astype(np.float32)
    args = (combine, x, wg, wu, wd)

    def jloss(comb, xx, a, b, c):
        out = jref.moe_grouped_ffn(jnp.asarray(dispatch), comb, xx, a, b, c)
        return jnp.sum(out * dout)
    want = jax.grad(jloss, argnums=range(5))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = ops.moe_grouped_ffn(torch.from_numpy(dispatch), *leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, a, b in zip(("dcombine", "dx", "dwg", "dwu", "dwd"), got,
                          want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=GRAD_TOL * max(
            1.0, np.abs(b).max()), err_msg=name)
    dcomb, dx, dwg, dwu, dwd = got
    if case == "idle":
        for w in (dwg, dwu, dwd):
            assert torch.equal(w[1], torch.zeros_like(w[1]))
        assert torch.equal(dx[:, 3], torch.zeros_like(dx[:, 3]))
    assert all(t.abs().sum() > 0 for t in got)


def test_the_cpu_route_is_the_plain_version():
    """On the CPU ``ops.moe_grouped_ffn`` is autograd of the plain version
    itself: no kernel launch, the same bits."""
    rng = np.random.default_rng(0)
    dispatch, combine = _routing(rng, 1, 16, 4, 8, "routed")
    ins = [torch.from_numpy(dispatch), torch.from_numpy(combine)] + [
        torch.from_numpy(rng.normal(size=s).astype(np.float32))
        for s in ((1, 16, 32), (4, 32, 48), (4, 32, 48), (4, 48, 32))]
    ops.reset_launches()
    assert torch.equal(ops.moe_grouped_ffn(*ins), ref.moe_grouped_ffn(*ins))
    assert ops.launches["moe_grouped_ffn"] == 0


# ---------------------------------------------------------------------------
# lm_loss: the router losses in the total, every gradient
# ---------------------------------------------------------------------------

_JAX_GRADS: dict = {}


def _jax_value_and_grad(arch, remat):
    if arch not in _JAX_GRADS:
        jcfg, tcfg, jp, tp = _models(arch)
        jb, tb = _batch(tcfg, 1)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jtf.lm_loss(p, jb, jcfg), has_aux=True))(jp)
        _JAX_GRADS[arch] = (tcfg, tp, tb, float(loss),
                            {k: float(v) for k, v in metrics.items()},
                            {k: np.asarray(v) for k, v in
                             _jpaths(grads).items()})
    return _JAX_GRADS[arch]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, remat):
    tcfg, tp, tb, jloss, jmetrics, jgrads = _jax_value_and_grad(arch, remat)
    loss, grads = tsteps.make_lm_grad_fn(tcfg, SyncConfig(remat=remat))(
        tp, tb)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert jmetrics["total_loss"] == pytest.approx(jloss, rel=1e-7)
    assert jloss > jmetrics["loss"]         # the router losses are in it
    got = _tpaths(grads)
    assert set(got) == set(jgrads)
    for k, g in got.items():
        assert g.shape == jgrads[k].shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=0,
                                   atol=GRAD_TOL, err_msg=k)
    routers = [k for k in got if k.endswith("ffn/router")]
    assert routers and all(got[k].abs().max() > 0 for k in routers)


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_metrics_match_jax(arch, cf):
    jcfg, tcfg, jp, tp = _models(arch, capacity_factor=cf)
    jb, tb = _batch(tcfg, 2)
    jtotal, jm = jtf.lm_loss(jp, jb, jcfg)
    with torch.no_grad():
        total, m = ttf.lm_loss(tp, tb, tcfg)
    assert set(m) == set(jm) == {"loss", "total_loss", "lb_loss",
                                 "router_entropy"}
    assert float(total) == float(m["total_loss"])
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(m["lb_loss"]) > 0 and float(m["router_entropy"]) > 0


def test_moe_aux_losses_are_jaxs_per_layer():
    """``moe_ffn``'s aux values, the terms ``lm_loss`` sums, against JAX's
    on one layer's parameters."""
    jcfg, tcfg, jp, tp = _models("mixtral-8x7b")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    lp = {k: v[0] for k, v in tp["groups"]["g0"]["s0"]["ffn"].items()}
    jlp = {k: v[0] for k, v in jp["groups"]["g0"]["s0"]["ffn"].items()}
    from repro_torch.models.moe import moe_ffn
    _, aux = moe_ffn(lp, torch.from_numpy(x), tcfg)
    _, jaux = jmoe.moe_ffn(jlp, jnp.asarray(x), jcfg)
    for k in ("lb_loss", "z_loss", "router_entropy"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the engine, end to end
# ---------------------------------------------------------------------------

STEPS = 5


@pytest.fixture(scope="module")
def jax_runs():
    """JAX engine trajectories on the mixtral smoke config at f32, one per
    (delta, optimizer)."""
    cache = {}

    def run(delta, opt_name):
        if (delta, opt_name) not in cache:
            jcfg, tcfg, jp, tp = _models("mixtral-8x7b")
            opt = jopt.make_optimizer(jopt.OptConfig(name=opt_name, lr=3e-3))
            eng = jsteps.make_train_engine(
                jcfg, opt, JSyncConfig(delta=delta, remat="none"), jp)
            state = eng.init_state()
            losses, batches = [], []
            for i in range(STEPS):
                jb, tb = _batch(tcfg, 10 + i)
                batches.append(tb)
                state, m = eng.step(state, jb)
                losses.append(float(m["loss"]))
            cache[(delta, opt_name)] = dict(
                tcfg=tcfg, tp=tp, batches=batches, losses=losses,
                telemetry=eng.telemetry.summary())
        return cache[(delta, opt_name)]
    return run


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("delta", [0, 2])
def test_engine_tracks_jax(jax_runs, delta, opt_name):
    r = jax_runs(delta, opt_name)
    opt = topt.make_optimizer(topt.OptConfig(name=opt_name, lr=3e-3))
    eng = tsteps.make_train_engine(r["tcfg"], opt,
                                   SyncConfig(delta=delta, remat="none"),
                                   r["tp"])
    state = eng.init_state()
    losses = []
    for tb in r["batches"]:
        state, m = eng.step(state, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-4)
    assert eng.telemetry.summary() == r["telemetry"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--batch",
       "2", "--seq", "32", "--lr", "3e-3", "--log-every", "100"]


def test_train_cli_trains_moe_through_the_engine():
    r = ttrain.main(CLI + ["--steps", "12", "--delta", "2"])
    assert np.isfinite(r["final_loss"]) and r["final_loss"] < r["first_loss"]
    assert r["telemetry"]["max_staleness"] == 2


def test_train_cli_trains_moe_through_the_server():
    r = ttrain.main(CLI + ["--steps", "3", "--backend", "server",
                           "--shards", "2", "--workers", "2", "--delta",
                           "0"])
    assert np.isfinite(r["final_loss"]) and r["sequentially_correct"]
    t = r["telemetry"]
    assert t["max_staleness"] == 0 and t["writes"] > 0
    assert r["rpc_retries"] == 0
