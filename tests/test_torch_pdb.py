"""The port's ParameterDB engine (``repro_torch.pdb``) against the JAX
package's (``repro.pdb.jax_backend``) and against its own exactness claims.

* ``init_delayed_state`` gives the JAX package's ring keys and
  bit-identical rows (leaf order, (delay, dtype) grouping, 128-element
  padding), packed and tree.
* delta=0 is bit-identical to the synchronous step; the packed ring is
  bit-identical to the tree ring for delta 0-3 and for mixed per-group
  delays; delta=2 equals hand-rolled delayed gradient descent.
* Trajectories track the JAX engine's on the same numpy problem: SGD
  params within 1e-6 (f32; the two frameworks sum the toy problem's
  gradient in another order), per-group delays included.
* A rejected step leaves the prior state intact (the ring write is
  deferred), and the copies of the Op-history oracle, the telemetry and
  ``SyncConfig`` agree with the originals.
* ``init_state`` hands the initial parameters over once: the engine keeps
  no reference to them.
* An engine on a card freezes the interpreter's heap after its warm-up
  steps, once at a time, until it is collected; one on the CPU never does.
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import history as jhist  # noqa: E402
from repro.core.sync_jax import SyncConfig as JSyncConfig  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.pdb import jax_backend as jb  # noqa: E402
from repro.pdb.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro_torch.core import history as thist  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.optim import OptConfig, make_optimizer  # noqa: E402
from repro_torch.pdb import torch_backend as tb  # noqa: E402
from repro_torch.pdb.telemetry import Telemetry  # noqa: E402

torch.set_num_threads(1)

DELAYS = {"w": 0, "m": 2, "b": 1, "h": 3}


def _numpy_problem(seed=11):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((32, 8)) / np.sqrt(8)).astype(np.float32)
    y = (A @ rng.standard_normal(8)).astype(np.float32)
    params = {"w": np.zeros(8, np.float32), "m": np.zeros((4, 8), np.float32),
              "b": np.zeros(1, np.float32),
              "h": np.zeros(8, np.float32)}         # bf16 on both sides
    return params, A, y


def _torch_problem(seed=11):
    p, A, y = _numpy_problem(seed)
    params = {k: torch.from_numpy(v) for k, v in p.items()}
    params["h"] = params["h"].to(torch.bfloat16)
    batch = {"A": torch.from_numpy(A), "y": torch.from_numpy(y)}

    def grad_fn(params, batch_):
        xs = {k: v.detach().requires_grad_() for k, v in params.items()}
        w = xs["w"] + xs["m"].mean(0) + xs["h"].float()
        r = batch_["A"] @ w + xs["b"] - batch_["y"]
        loss = 0.5 * torch.mean(r * r)
        keys = sorted(xs)
        gs = torch.autograd.grad(loss, [xs[k] for k in keys])
        return loss.detach(), dict(zip(keys, gs))

    return params, batch, grad_fn


def _jax_problem(seed=11):
    p, A, y = _numpy_problem(seed)
    params = {k: jnp.asarray(v) for k, v in p.items()}
    params["h"] = params["h"].astype(jnp.bfloat16)

    def grad_fn(params, batch_):
        def loss(pp):
            w = pp["w"] + pp["m"].mean(0) + pp["h"].astype(jnp.float32)
            r = batch_["A"] @ w + pp["b"] - batch_["y"]
            return 0.5 * jnp.mean(r * r)
        return jax.value_and_grad(loss)(params)

    return params, {"A": jnp.asarray(A), "y": jnp.asarray(y)}, grad_fn


def _delay_for_t(path):
    return DELAYS[path[0]]


def _delay_for_j(path):
    return DELAYS[path[0].key]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _opt(name, lib):
    if lib == "torch":
        return make_optimizer(OptConfig(name=name, lr=0.1, grad_clip=0,
                                        weight_decay=0.0))
    return jmake_optimizer(JOptConfig(name=name, lr=0.1, grad_clip=0,
                                      weight_decay=0.0))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("mixed", [False, True])
def test_init_state_matches_jax_bit_for_bit(packed, mixed):
    """Same ring keys, shapes and bits: catches leaf order (dict insertion
    vs sorted keys), the (delay, dtype) grouping and the row padding."""
    tparams, _, _ = _torch_problem()
    jparams, _, _ = _jax_problem()
    rng = np.random.default_rng(0)
    for k in ("w", "m", "b"):                       # distinct values
        a = rng.standard_normal(tparams[k].shape).astype(np.float32)
        tparams[k], jparams[k] = torch.from_numpy(a), jnp.asarray(a)
    got = tb.init_delayed_state(tparams, _opt("adamw", "torch").init, 3,
                                packed=packed,
                                delay_for=_delay_for_t if mixed else None)
    want = jb.init_delayed_state(jparams, _opt("adamw", "jax").init, 3,
                                 packed=packed,
                                 delay_for=_delay_for_j if mixed else None)
    jleaves = jax.tree_util.tree_leaves_with_path(want.hist)
    tleaves = tb.leaves_with_path(got.hist)
    assert ["/".join(p.key for p in jp) for jp, _ in jleaves] == \
        ["/".join(tp) for tp, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert tb.dtype_name(t.dtype) == j.dtype.name
        np.testing.assert_array_equal(_bits(t), _bits(j))
    if packed:
        assert set(got.hist) == ({"d0_float32", "d1_float32", "d2_float32",
                                  "d3_bfloat16"} if mixed
                                 else {"d3_bfloat16", "d3_float32"})
    assert int(got.ptr) == 0 and got.ptr.dtype == torch.int32


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_delta0_bit_identical_to_sync(opt_name):
    params, batch, grad_fn = _torch_problem()
    opt = _opt(opt_name, "torch")
    p_sync, s_sync = params, opt.init(params)
    for _ in range(6):
        _, g = grad_fn(p_sync, batch)
        p_sync, s_sync = opt.update(g, s_sync, p_sync)
    for packed in (True, False):
        step = tb.make_delayed_step(grad_fn, opt.update, delta=0,
                                    packed=packed)
        state = tb.init_delayed_state(params, opt.init, 0, packed=packed)
        for _ in range(6):
            state, _ = step(state, batch)
        for k in params:
            assert torch.equal(p_sync[k], state.params[k]), (packed, k)


def _trajectory(packed, delta, delay_for=None, steps=8, opt_name="adamw"):
    params, batch, grad_fn = _torch_problem()
    opt = _opt(opt_name, "torch")
    step = tb.make_delayed_step(grad_fn, opt.update, delta=delta,
                                delay_for=delay_for, packed=packed)
    state = tb.init_delayed_state(params, opt.init, delta, packed=packed,
                                  delay_for=delay_for)
    stale0 = step.read_stale(state)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
    return stale0, state, torch.stack(losses)


@pytest.mark.parametrize("delta,mixed", [(0, False), (1, False), (2, False),
                                         (3, False), (3, True)])
def test_packed_ring_bit_identical_to_tree(delta, mixed):
    delay_for = _delay_for_t if mixed else None
    s_tree, st_tree, l_tree = _trajectory(False, delta, delay_for)
    s_pack, st_pack, l_pack = _trajectory(True, delta, delay_for)
    assert torch.equal(l_tree, l_pack)
    for k in s_tree:
        assert torch.equal(s_tree[k], s_pack[k]), k
        assert torch.equal(st_tree.params[k], st_pack.params[k]), k
    # the stale reads of the final states agree too
    step = tb.make_delayed_step(None, None, delta, delay_for, packed=True)
    step_t = tb.make_delayed_step(None, None, delta, delay_for, packed=False)
    a, b = step.read_stale(st_pack), step_t.read_stale(st_tree)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_delta_matches_manual_delayed_gd():
    """delta=2 equals hand-rolled delayed gradient descent:
    w[t+1] = w[t] - lr * grad(w[t-2])."""
    params, batch, grad_fn = _torch_problem(seed=3)
    opt = make_optimizer(OptConfig(name="sgd", lr=0.05, grad_clip=0))
    hist = [params] * 3
    p = params
    for _ in range(10):
        _, g = grad_fn(hist[0], batch)
        p, _ = opt.update(g, opt.init(p), p)
        hist = hist[1:] + [p]
    for packed in (True, False):
        step = tb.make_delayed_step(grad_fn, opt.update, delta=2,
                                    packed=packed)
        state = tb.init_delayed_state(params, opt.init, 2, packed=packed)
        for _ in range(10):
            state, _ = step(state, batch)
        for k in params:
            assert torch.equal(state.params[k], p[k]), (packed, k)


@pytest.mark.parametrize("delta,mixed,opt_name", [
    (0, False, "sgd"), (2, False, "sgd"), (3, True, "sgd"),
    (2, False, "adamw")])
def test_trajectory_tracks_jax(delta, mixed, opt_name):
    """Same numpy problem, same optimizer: SGD params within 1e-6, AdamW
    within 1e-5 (Adam's normalised step magnifies f32 rounding where a
    gradient is near 0)."""
    tparams, tbatch, tgrad = _torch_problem()
    jparams, jbatch, jgrad = _jax_problem()
    topt, jopt = _opt(opt_name, "torch"), _opt(opt_name, "jax")
    step = tb.make_delayed_step(tgrad, topt.update, delta,
                                _delay_for_t if mixed else None)
    jstep = jax.jit(jb.make_delayed_step(jgrad, jopt.update, delta,
                                         _delay_for_j if mixed else None))
    state = tb.init_delayed_state(tparams, topt.init, delta,
                                  delay_for=_delay_for_t if mixed else None)
    jstate = jb.init_delayed_state(jparams, jopt.init, delta,
                                   delay_for=_delay_for_j if mixed else None)
    for _ in range(6):
        state, m = step(state, tbatch)
        jstate, jm = jstep(jstate, jbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    tol = 1e-6 if opt_name == "sgd" else 1e-5
    for k in tparams:
        np.testing.assert_allclose(state.params[k].float().numpy(),
                                   np.asarray(jstate.params[k], np.float32),
                                   rtol=0, atol=tol, err_msg=k)


def test_per_group_delays():
    """Sec-7.1 per-chunk version arrays: different param groups read
    different staleness levels, which moves the trajectory away from the
    uniform-delta one."""
    _, _, traj_mixed = _trajectory(True, 3, _delay_for_t, opt_name="sgd")
    _, _, traj_uniform = _trajectory(True, 3, None, opt_name="sgd")
    assert torch.isfinite(traj_mixed).all()
    assert not torch.allclose(traj_mixed, traj_uniform)


@pytest.mark.parametrize("packed", [True, False])
def test_rejected_step_leaves_prior_state_intact(packed):
    """The fault layer may discard a step and run the prior state again:
    the ring slot the step will fill is written only when its successor is
    used, so the rerun gives the same bits."""
    params, batch, grad_fn = _torch_problem()
    opt = _opt("adamw", "torch")
    step = tb.make_delayed_step(grad_fn, opt.update, 2, packed=packed)
    state = tb.init_delayed_state(params, opt.init, 2, packed=packed)
    for _ in range(4):
        state, _ = step(state, batch)
    first, m1 = step(state, batch)           # rejected by the driver
    rerun, m2 = step(state, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for k in params:
        assert torch.equal(first.params[k], rerun.params[k])
    committed = step.commit_ring(rerun)      # what a checkpoint sees
    again = step.read_stale(committed)
    assert int(committed.ptr) == 5 % 3
    state_check = step.commit_ring(committed)
    for k in params:
        assert torch.equal(again[k], step.read_stale(state_check)[k])


def test_engine_telemetry_matches_jax():
    """The same committed steps give the same staleness summary and the
    same Op history, which both oracles call sequentially correct."""
    sync_t = SyncConfig(delta=2, group_delays=(("m", 0), ("h", 1)))
    sync_j = JSyncConfig(delta=2, group_delays=(("m", 0), ("h", 1)))
    tparams, tbatch, tgrad = _torch_problem()
    jparams, jbatch, jgrad = _jax_problem()
    eng = tb.make_engine(tparams, tgrad, _opt("sgd", "torch"), sync_t,
                         record_history=True)
    jeng = jb.make_engine(jparams, jgrad, _opt("sgd", "jax"), sync_j,
                          record_history=True)
    assert eng.group_delays == jeng.group_delays == (2, 1, 0, 2)
    state, jstate = eng.init_state(), jeng.init_state()
    for _ in range(4):
        state, _ = eng.step(state, tbatch)
        jstate, _ = jeng.step(jstate, jbatch)
    eng.telemetry.on_retry(3)
    jeng.telemetry.on_retry(3)
    assert eng.telemetry.summary() == jeng.telemetry.summary()
    assert [repr(op) for op in eng.history] == \
        [repr(op) for op in jeng.history]
    assert thist.is_sequentially_correct(eng.history, 1)
    assert jhist.is_sequentially_correct(
        [jhist.Op(o.kind, o.worker, o.chunk, o.itr) for o in eng.history], 1)


def test_history_oracle_copy_agrees():
    rng = np.random.default_rng(2)
    base = [(k, 0, c, i) for i in range(1, 4) for c in range(3)
            for k in ("r", "w")]
    for trial in range(30):
        ops = list(base)
        if trial:
            rng.shuffle(ops)
        t = [thist.Op(*o) for o in ops]
        j = [jhist.Op(*o) for o in ops]
        assert thist.is_sequentially_correct(t, 3) == \
            jhist.is_sequentially_correct(j, 3)


def test_telemetry_copy_agrees():
    t, j = Telemetry(record_history=True), JTelemetry(record_history=True)
    for tel in (t, j):
        tel.on_read(0, 0, 1, version=0)
        tel.on_read(0, 1, 3, version=0)
        tel.on_read(1, 1, 2, version=4)
        tel.on_read(0, 2, 2)
        tel.on_write(0, 0, 1)
        tel.on_skip(2)
    assert t.summary() == j.summary()
    assert [repr(o) for o in t.history] == [repr(o) for o in j.history]


def test_sync_config_delay_for_matches_jax():
    groups = (("groups/g0", 1), ("groups/g0/s0/mix", 3), ("embedding", 0))
    t, j = SyncConfig(delta=2, group_delays=groups), \
        JSyncConfig(delta=2, group_delays=groups)
    for path in (("embedding",), ("groups", "g0", "s0", "mix", "wq"),
                 ("groups", "g0", "s0", "ffn", "wd"), ("final_norm", "scale")):
        jpath = tuple(jax.tree_util.DictKey(k) for k in path)
        assert t.delay_for(path) == j.delay_for(jpath)
    with pytest.raises(ValueError):
        SyncConfig(mode="async")


@pytest.mark.parametrize("delta", [0, 2])
def test_engine_hands_the_initial_parameters_over(delta):
    params, batch, grad_fn = _torch_problem()
    eng = tb.make_engine(params, grad_fn, _opt("adamw", "torch"),
                         SyncConfig(delta=delta))
    initial = weakref.ref(params["w"])
    state = eng.init_state()
    del params
    state, _ = eng.step(state, batch)
    gc.collect()
    assert initial() is None                # gone with the first state
    with pytest.raises(RuntimeError, match="once"):
        eng.init_state()


def _engine(on_card: bool) -> tb.TrainEngine:
    return tb.TrainEngine(init_state=dict, step_fn=lambda s, b: (s, {}),
                          telemetry=Telemetry(), delta=0, group_delays=(0,),
                          on_card=on_card)


@pytest.mark.parametrize("on_card", [False, True])
def test_engine_freezes_the_heap_after_warm_up_on_a_card(on_card):
    base = gc.get_freeze_count()           # what the interpreter froze
    first, second = _engine(on_card), _engine(on_card)
    for i in range(1, tb.WARM_STEPS + 3):
        first.record_step()
        assert (gc.get_freeze_count() > base) == (on_card
                                                  and i >= tb.WARM_STEPS)
    for _ in range(tb.WARM_STEPS + 1):     # a second engine's warm-up
        second.record_step()
    del second                             # and death leave it as it was
    gc.collect()
    assert (gc.get_freeze_count() > base) == on_card
    del first                              # the one that froze it thaws it
    gc.collect()
    assert gc.get_freeze_count() <= base
