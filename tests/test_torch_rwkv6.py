"""The port's RWKV-6 slice against the JAX package's, on the CPU.

Both sides get the same numpy inputs and the same numpy parameter tree
(made by ``repro``'s ``init_tree``; its constant leaves, the token-shift
mixes, the decay base, the norms, get seeded noise so that they matter).

* ``ref.rwkv6`` and ``ref.rwkv6_stateful`` match JAX's plain versions and
  the Pallas kernel in interpret mode at the shapes of
  ``tests/test_kernels.py`` (ragged T included), r/k/v in f32 or bf16, the
  decay and the bonus in f32 as the model gives them: f32 rtol/atol 2e-5,
  bf16 2e-2.  A sequence split over two stateful calls equals one call.
* Torch autograd through ``ref.rwkv6`` (the oracle of the CUDA backward)
  matches ``jax.grad`` of JAX's plain version at f32, rtol/atol 1e-5.
* ``time_mix_fwd`` and ``chan_mix_fwd`` match at f32, atol 1e-5; ``lm_loss``
  and every gradient on the rwkv6-1.6b smoke config at f32, remat ``none``
  and ``full``: loss rtol 1e-5, each gradient to a normalized max error
  (max |port - jax| / max |jax|, per leaf) of 5e-5.
* The train engine tracks JAX's over 5 steps at delta 0 and 2 (SGD params
  within 1e-5, losses within 1e-4 relative; equal telemetry), and a JAX
  rwkv6 checkpoint resumes in the engine and in ``repro_torch.launch.train``.
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
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6  # noqa
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import load_state, params_from_numpy  # noqa
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.data import LMBatchSpec, make_lm_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import paramlib as tparamlib  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _wkv_inputs(rng, B, T, H, hd, dtype, decay_mean=0.0):
    """r, k, v in ``dtype``, w = exp(-exp(x)) with x ~ N(decay_mean, 1) and
    u in f32, as torch tensors and jax arrays from one numpy draw."""
    tdt, jdt = DTYPES[dtype]
    rkv = [rng.standard_normal((B, T, H, hd), np.float32) * 0.5
           for _ in range(3)]
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hd), np.float32)
                       + decay_mean)).astype(np.float32)
    u = (rng.standard_normal((H, hd), np.float32) * 0.1).astype(np.float32)
    tor = [torch.from_numpy(a).to(tdt) for a in rkv] \
        + [torch.from_numpy(w), torch.from_numpy(u)]
    jx = [jnp.asarray(a).astype(jdt) for a in rkv] \
        + [jnp.asarray(w), jnp.asarray(u)]
    return tor, jx


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,H,hd,bt", [
    (32, 2, 16, 16), (48, 4, 32, 16), (40, 1, 64, 32),  # ragged tail
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_matches_jax_and_pallas(T, H, hd, bt, dtype):
    (r, k, v, w, u), jx = _wkv_inputs(np.random.default_rng(0), 2, T, H, hd,
                                      dtype)
    got = ref.rwkv6(r, k, v, w, u)
    assert got.dtype == r.dtype and got.shape == r.shape
    _close(got, jref.rwkv6(*jx), dtype)
    _close(got, pallas_rwkv6(*jx, block_t=bt, interpret=True), dtype)
    assert torch.equal(ops.rwkv6(r, k, v, w, u), got)   # the CPU route


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_stateful_matches_jax(dtype):
    rng = np.random.default_rng(1)
    (r, k, v, w, u), jx = _wkv_inputs(rng, 2, 21, 3, 16, dtype)
    S0 = rng.standard_normal((2, 3, 16, 16), np.float32)
    y, S1 = ref.rwkv6_stateful(r, k, v, w, u, torch.from_numpy(S0))
    jy, jS1 = jref.rwkv6_stateful(*jx, jnp.asarray(S0))
    assert y.dtype == r.dtype and S1.dtype == torch.float32
    _close(y, jy, dtype)
    np.testing.assert_allclose(S1.numpy(), np.asarray(jS1), rtol=2e-5,
                               atol=2e-5)
    y2, S2 = ops.rwkv6_stateful(r, k, v, w, u, torch.from_numpy(S0))
    assert torch.equal(y2, y) and torch.equal(S2, S1)


def test_rwkv6_stateful_continuation():
    """Splitting a sequence across two stateful calls == one call, as
    tests/test_kernels.py holds the JAX version."""
    (r, k, v, w, u), _ = _wkv_inputs(np.random.default_rng(3), 1, 24, 2, 16,
                                     "float32")
    full = ref.rwkv6(r, k, v, w, u)
    S0 = torch.zeros((1, 2, 16, 16))
    y1, S1 = ref.rwkv6_stateful(r[:, :10], k[:, :10], v[:, :10], w[:, :10],
                                u, S0)
    y2, _ = ref.rwkv6_stateful(r[:, 10:], k[:, 10:], v[:, 10:], w[:, 10:],
                               u, S1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), full, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("decay_mean", [0.0, 2.0])   # 2.0: w near 0
def test_rwkv6_grads_match_jax(decay_mean):
    """Autograd through the plain version, the CUDA backward's oracle,
    against jax.grad of the JAX plain version: all five gradients."""
    rng = np.random.default_rng(4)
    tor, jx = _wkv_inputs(rng, 2, 29, 2, 16, "float32", decay_mean)
    dy = rng.standard_normal((2, 29, 2, 16), np.float32)
    ins = [t.requires_grad_() for t in tor]
    got = torch.autograd.grad((ref.rwkv6(*ins) * torch.from_numpy(dy)).sum(),
                              ins)
    want = jax.grad(lambda *a: jnp.sum(jref.rwkv6(*a) * dy),
                    argnums=(0, 1, 2, 3, 4))(*jx)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _tpaths(tree):
    return {"/".join(path): leaf for path, leaf in leaves_with_path(tree)}


def _models():
    """The smoke config at f32 on both sides, one numpy parameter tree."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               dtype=torch.float32)
    rng = np.random.default_rng(7)

    def noisy(a):          # constant leaves (zeros, ones) get noise
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            a = a + 0.5 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    npt = jax.tree.map(noisy, jparamlib.init_tree(jtf.model_specs(jcfg),
                                                  jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npt), \
        params_from_numpy(npt, device="cpu")


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "mask": mask}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_config_matches_jax():
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(tconfigs, get)(ARCH), getattr(jconfigs, get)(ARCH)
        for f in dataclasses.fields(t):
            if f.name not in ("dtype", "param_dtype", "groups", "mix_lora"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.mix_lora == 0          # the JAX package's block
        assert [(g.pattern, g.n) for g in t.groups] == \
            [(g.pattern, g.n) for g in j.groups]
    assert ARCH in tconfigs.all_arch_ids()


@pytest.mark.parametrize("mix", ["time", "chan"])
def test_mixers_match_jax(mix):
    jcfg, tcfg, jp, tp = _models()
    x = np.random.default_rng(8).standard_normal((2, 13, 64), np.float32)
    jb = jp["groups"]["g0"]["s0"]
    tb = tp["groups"]["g0"]["s0"]
    j1 = jax.tree.map(lambda a: a[1], jb)           # layer 1 of the stack
    t1 = {k: {n: a[1] for n, a in v.items()} for k, v in tb.items()}
    if mix == "time":
        got = trwkv.time_mix_fwd(t1["mix"], torch.from_numpy(x), tcfg)
        want = jrwkv.time_mix_fwd(j1["mix"], jnp.asarray(x), jcfg)
    else:
        got = trwkv.chan_mix_fwd(t1["ffn"], torch.from_numpy(x), tcfg)
        want = jrwkv.chan_mix_fwd(j1["ffn"], jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


_JAX_GRADS: dict = {}
# per leaf, max |port - jax| / max |jax|: the layer norms and the per-head
# group norm divide by small norms (the embedding's scale is 0.02), so the
# two frameworks' rounding differences scale with a leaf's largest gradient,
# not with each element (observed: at most 1.7e-5)
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


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
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


def test_serving_paths_raise_naming_the_queue_item():
    """rwkv6 serves at the model level (ROADMAP queue A item 1; parity
    with JAX: tests/test_torch_recurrent_serve.py): prefill gives its
    layers' states and the chunk carry is their zero state.  The engine
    refuses it with a ValueError naming the JAX reference's fault on an
    attention-free model (ROADMAP C)."""
    cfg = tconfigs.get_smoke_config(ARCH)
    params = tparamlib.init_tree(ttf.model_specs(cfg),
                                 torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    logits, cache = ttf.prefill(params, tokens, cfg)
    assert logits.shape == (1, cfg.vocab_size)
    c = cache["g0"]["s0"]
    assert c["S"].shape == (2, 1, cfg.n_heads, cfg.hd, cfg.hd)
    assert c["x_last"].shape == c["cx_last"].shape == (2, 1, cfg.d_model)
    carry = ttf.init_chunk_carry(cfg, device="cpu")
    assert set(carry["g0"]["s0"]) == {"S", "x_last", "cx_last"}
    assert not carry["g0"]["s0"]["S"].any()
    from repro_torch.serve import ServeConfig, ServeEngine
    with pytest.raises(ValueError, match="attention-free.*min\\(\\) of "
                       "an empty page-class dict.*ROADMAP C"):
        ServeEngine(cfg, params, ServeConfig(batch_size=1, page_size=4,
                                             cache_len=16))


# ---------------------------------------------------------------------------
# the engine and checkpoints from JAX
# ---------------------------------------------------------------------------

STEPS, CKPT_AT = 5, 2


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX engine trajectories on the rwkv6 smoke config at f32, one per
    (delta, optimizer), each with a checkpoint after step CKPT_AT."""
    cache = {}

    def run(delta, opt_name):
        if (delta, opt_name) not in cache:
            jcfg, tcfg, jp, tp = _models()
            opt = jopt.make_optimizer(jopt.OptConfig(name=opt_name, lr=3e-3))
            eng = jsteps.make_train_engine(
                jcfg, opt, JSyncConfig(delta=delta, remat="none"), jp)
            state = eng.init_state()
            ck = str(tmp_path_factory.mktemp(f"jax_rwkv_d{delta}_{opt_name}"))
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
    """The port loads JAX's step-2 rwkv6 state (the untied head and the
    layernorm leaves by path, the ring, the optimizer state) and its next
    steps give JAX's losses and parameters."""
    r = jax_runs(delta, "sgd")
    eng = _port_engine(r["tcfg"], r["tp"], delta, "sgd")
    state = load_state(r["ckpt"], CKPT_AT, eng.init_state())
    params = state["params"] if delta == 0 else state.params
    assert "lm_head" in params and "bias" in params["final_norm"]
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


def test_train_cli_trains_rwkv6_on_cpu():
    """As the llama CLI test: 25 steps of batch 4 by 64 tokens at delta 2
    bring the loss down."""
    r = ttrain.main(CLI + ["--steps", "25", "--batch", "4", "--seq", "64",
                           "--delta", "2"])
    assert r["final_loss"] < r["first_loss"]
    assert r["telemetry"]["max_staleness"] == 2


def test_train_cli_resumes_a_jax_checkpoint(jax_runs, capsys, tmp_path):
    """``repro_torch.launch.train --resume`` picks up JAX's step-2 rwkv6
    checkpoint (delta 2, SGD) and steps on from it: its final loss is the
    one the port's engine reaches from the same loaded state on the CLI's
    batches, bit for bit."""
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
