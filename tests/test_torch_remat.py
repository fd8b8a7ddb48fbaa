"""Remat ``dots`` and the chunked cross entropy against the JAX package, at
f32 on the CPU.

* What ``dots`` keeps: on one llama3.2-1b and one mixtral-8x7b smoke layer,
  the outputs that the port's policy (``transformer.save_dots``) keeps
  have the shapes of the dot outputs that JAX's
  ``dots_with_no_batch_dims_saveable`` marks saveable in the layer's
  jaxpr (each shape read as (rows, columns): torch folds ``x @ W`` into
  one 2-D product).  JAX's own ``saved_residuals`` lists a subset of
  them: its partial evaluation drops the FFN's last product, which no
  backward reads.  A counting ``TorchDispatchMode`` shows that ``full``
  reruns every forward ``aten.mm`` of the layer in the backward and
  ``dots`` reruns none.
* ``REPRO_CHUNKED_CE=1``: the port's loss, metrics and gradients match
  JAX's ``_lm_loss_chunked`` (llama3.2-1b and mixtral-8x7b with its router
  losses, with and without a mask, S = 30: 6 chunks of 5) at the
  tolerances of ``test_torch_train.py`` and ``test_torch_moe_train.py``;
  and autograd keeps no tensor of logits for the backward.
"""
import collections
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

torch.set_num_threads(1)

LAYER_ARCHS = ("llama3.2-1b", "mixtral-8x7b")
GRAD_ATOL = {"llama3.2-1b": 2e-6, "mixtral-8x7b": 1e-5}
MM = torch.ops.aten.mm.default


def _models(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _rows_cols(shape) -> tuple[int, int]:
    return math.prod(shape[:-1]), shape[-1]


# ---------------------------------------------------------------------------
# remat "dots": what is kept, what is recomputed
# ---------------------------------------------------------------------------

def _layer(arch, B=2, S=16):
    """Layer 0 of the smoke model on both sides and one input x."""
    jcfg, tcfg, jp, tp = _models(arch)
    kind = jcfg.groups[0].pattern[0]
    jbp = jax.tree.map(lambda a: a[0], jp["groups"]["g0"]["s0"])
    tbp = {k: v for k, v in ttf._unstack(tp["groups"]["g0"], 1)[0][
        "s0"].items()}
    x = np.random.default_rng(0).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, kind, jbp, tbp, x


def _jax_saveable(fn, *args) -> list[tuple]:
    """Output shapes of the equations JAX's dots policy marks saveable, the
    sub-jaxprs (jit, custom_jvp) included."""
    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if policy(eqn.primitive, *[v.aval for v in eqn.invars],
                      **eqn.params):
                out.extend(v.aval.shape for v in eqn.outvars)
            for p in eqn.params.values():
                sub = getattr(p, "jaxpr", p)
                if hasattr(sub, "eqns"):
                    walk(sub)
    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _port_layer_fn(tcfg, kind, tbp, S):
    leaves = {k: _leaf(v) for k, v in tbp.items()}
    positions = torch.arange(S).expand(2, S)

    def body(x, bp):
        return ttf._apply_block(bp, kind, x, tcfg, positions)[0]
    return leaves, body


def _leaf(tree):
    if isinstance(tree, dict):
        return {k: _leaf(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_dots_keeps_what_jax_policy_keeps(arch, monkeypatch):
    jcfg, tcfg, kind, jbp, tbp, x = _layer(arch)
    S = x.shape[1]
    ctx = jtf.Ctx(positions=jnp.broadcast_to(jnp.arange(S)[None], (2, S)))

    def jblock(bp, xx):
        return jtf._apply_block(bp, kind, xx, jcfg, ctx)[0]
    want = collections.Counter(_rows_cols(s)
                               for s in _jax_saveable(jblock, jbp, x))

    kept = []
    policy = ttf.save_dots

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append((args[0].shape[0], args[1].shape[1]))
        return decision
    monkeypatch.setattr(ttf, "save_dots", recording)
    leaves, body = _port_layer_fn(tcfg, kind, tbp, S)
    y = ttf._remat_wrap(body, "dots")(torch.from_numpy(x), leaves)
    y.square().sum().backward()
    assert collections.Counter(kept) == want
    assert want, "JAX's policy keeps no product"

    # JAX's partial evaluation keeps a subset: it drops a product no
    # backward reads (the dense FFN's last one)
    jres = collections.Counter(
        _rows_cols(a.shape) for a, why in saved_residuals(
            jax.checkpoint(lambda bp, xx: jblock(bp, xx).sum(),
                           policy=jax.checkpoint_policies
                           .dots_with_no_batch_dims_saveable), jbp, x)
        if not why.startswith(("from the argument", "from a constant")))
    assert not jres - want


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is MM
        return func(*args, **(kwargs or {}))


def _mm_counts(tcfg, kind, tbp, x, remat) -> tuple[int, int]:
    """aten.mm calls in the layer's forward and in its backward."""
    leaves, body = _port_layer_fn(tcfg, kind, tbp, x.shape[1])
    with _CountMM() as fwd:
        y = ttf._remat_wrap(body, remat)(torch.from_numpy(x), leaves)
        loss = y.square().sum()
    with _CountMM() as bwd:
        loss.backward()
    return fwd.n, bwd.n


@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_full_reruns_every_forward_mm_and_dots_none(arch):
    """``full`` reruns each forward product in the backward; by default
    the checkpoint stops recomputing after the last tensor the backward
    reads, so a product whose output only feeds the residual add (the
    dense FFN's last) is not rerun: the reruns are then the products
    JAX's partial evaluation keeps under ``dots``.  ``dots`` reruns none."""
    jcfg, tcfg, kind, jbp, tbp, x = _layer(arch)
    counts = {r: _mm_counts(tcfg, kind, tbp, x, r)
              for r in ("none", "full", "dots")}
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        whole = _mm_counts(tcfg, kind, tbp, x, "full")
    n_fwd = counts["none"][0]
    assert n_fwd > 0
    assert all(c[0] == n_fwd for c in (*counts.values(), whole))
    assert whole[1] == counts["none"][1] + n_fwd
    assert counts["dots"][1] == counts["none"][1]

    S = x.shape[1]
    ctx = jtf.Ctx(positions=jnp.broadcast_to(jnp.arange(S)[None], (2, S)))
    read = [a for a, why in saved_residuals(
        jax.checkpoint(lambda bp, xx: jtf._apply_block(
            bp, kind, xx, jcfg, ctx)[0].sum(), policy=jax
            .checkpoint_policies.dots_with_no_batch_dims_saveable), jbp, x)
        if not why.startswith(("from the argument", "from a constant"))]
    assert counts["full"][1] == counts["none"][1] + len(read)


# ---------------------------------------------------------------------------
# chunked cross entropy
# ---------------------------------------------------------------------------

def _batch(cfg, masked: bool, B=2, S=30):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if masked:
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        mask[1, :7] = 0.0
        batch["mask"] = mask
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_chunked_ce_matches_jax(arch, masked, monkeypatch):
    monkeypatch.setenv("REPRO_CHUNKED_CE", "1")
    jcfg, tcfg, jp, tp = _models(arch)
    jb, tb = _batch(tcfg, masked)
    # JAX reads the switch when it traces: a fresh jit
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jb, jcfg), has_aux=True))(jp)
    metrics = {}
    loss, grads = tsteps.make_lm_grad_fn(
        tcfg, SyncConfig(remat="none"), on_metrics=metrics.update)(tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jm)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    if tcfg.is_moe:
        assert float(loss) > float(metrics["loss"])
    want = {k: np.asarray(v) for k, v in _jpaths(jgrads).items()}
    got = {"/".join(p): g for p, g in leaves_with_path(grads)}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                   atol=GRAD_ATOL[arch], err_msg=k)


def test_chunked_ce_equals_unchunked_within_rounding(monkeypatch):
    _, tcfg, _, tp = _models("llama3.2-1b")
    _, tb = _batch(tcfg, True)
    whole = ttf.lm_loss(tp, tb, tcfg)[0]
    monkeypatch.setenv("REPRO_CHUNKED_CE", "1")
    chunked = ttf.lm_loss(tp, tb, tcfg)[0]
    np.testing.assert_allclose(float(chunked), float(whole), rtol=1e-6)


def _saved_shapes(tp, tb, tcfg) -> list[tuple]:
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tsteps.make_lm_grad_fn(tcfg, SyncConfig(remat="none"))(
            tp, tb)
    assert torch.isfinite(loss)
    return shapes


def test_chunked_ce_keeps_no_logits(monkeypatch):
    """Every tensor autograd saves outside the chunks' checkpoints; none
    ends in the vocabulary, where the unchunked loss saves its (B, S, V)
    logits."""
    _, tcfg, _, tp = _models("llama3.2-1b")
    _, tb = _batch(tcfg, True)
    V = tcfg.vocab_size
    assert tcfg.d_model != V
    assert any(s[-1] == V for s in _saved_shapes(tp, tb, tcfg))
    monkeypatch.setenv("REPRO_CHUNKED_CE", "1")
    shapes = _saved_shapes(tp, tb, tcfg)
    assert shapes and not any(s and s[-1] == V for s in shapes)
