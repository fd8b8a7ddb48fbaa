"""The rest of the zoo (olmo-1b, gemma3-4b, musicgen-large and
llama-3.2-vision-11b) on the port's training and serving paths, against the
JAX package's, at f32 on the smoke configs.

* ``lm_loss`` and every gradient match ``jax.value_and_grad(lm_loss)``:
  loss rtol 1e-5, gradients atol 2e-6 (tests/test_torch_train.py's
  tolerances) times the leaf's largest gradient where that passes 1: the
  vision model's untied embedding gets gradients up to 4.0 (the rmsnorm
  of 0.02-scale embeddings divides by their size), where both packages'
  f32 sums lie ~5e-6 from the f64 gradient.  gemma3-4b runs under
  ``REPRO_CHUNKED_CE`` off and on.  The
  vision model gets the same numpy media on both sides, and its xattn
  gates (zeros at init, which would hide the layer) the same non-zero
  draws.
* Greedy outputs of the port's ``ServeEngine`` equal the JAX engine's for
  the three text models, whole prompt and chunked, and continuous equals
  static inside the port.
* The vision model trains through the port's ParameterDB engine (delta 2,
  the packed ring, sgd and adamw, non-zero gates) as through JAX's: losses
  and final parameters at the f32 kernel tolerance, rtol = atol 2e-5;
  under AdamW its moments m and v too, and its parameters at atol 2e-5 +
  lr / 20 (the normalised step magnifies the f32 rounding of a gradient
  near 0).
* The engine refuses the vision model as JAX's does; the serve CLI runs
  gemma3 chunked; the train CLI trains the vision model on the CPU; the
  synthetic batch carries the media stub; the vision model's chunked
  prefill with media gives its whole prompt's logits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.sync_jax import SyncConfig as JSyncConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.data import LMBatchSpec, make_lm_batch  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

torch.set_num_threads(1)

TEXT = ("olmo-1b", "gemma3-4b", "musicgen-large")
VISION = "llama-3.2-vision-11b"
CACHE_LEN, PAGE = 32, 8
SCFG = dict(batch_size=3, page_size=PAGE, cache_len=CACHE_LEN,
            clock="steps")


def _models(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jparamlib.init_tree(
        jtf.model_specs(jcfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for gi, g in enumerate(jcfg.groups):
        for si, kind in enumerate(g.pattern):
            if kind == "xattn":            # non-zero gates, both trees
                mix = tree["groups"][f"g{gi}"][f"s{si}"]["mix"]
                mix["gate"] = rng.uniform(
                    0.5, 1.5, mix["gate"].shape).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "mask": mask}
    if cfg.frontend == "vision":
        batch["media"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,chunked", [
    ("olmo-1b", False), ("gemma3-4b", False), ("gemma3-4b", True),
    ("musicgen-large", False), (VISION, False)])
def test_lm_loss_and_grads_match_jax(arch, chunked, monkeypatch):
    monkeypatch.setenv("REPRO_CHUNKED_CE", "1" if chunked else "0")
    jcfg, tcfg, jp, tp = _models(arch)
    jb, tb = _batch(tcfg, 1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jb, jcfg), has_aux=True))(jp)
    jgrads = {k: np.asarray(v) for k, v in _jpaths(jgrads).items()}
    loss, grads = tsteps.make_lm_grad_fn(tcfg, SyncConfig())(tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = {"/".join(p): g for p, g in leaves_with_path(grads)}
    assert set(got) == set(jgrads)
    for k, g in got.items():
        assert g.shape == jgrads[k].shape and g.dtype == torch.float32
        scale = max(1.0, float(np.abs(jgrads[k]).max()))
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=0,
                                   atol=2e-6 * scale, err_msg=k)
    assert all(g.abs().sum() > 0 for g in got.values()), \
        "a parameter got no gradient"


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_engine_trains_vision_as_jax_does(opt_name):
    """The smoke vision config (4 self-attention layers and one xattn
    layer, gates drawn non-zero) trained 3 steps at delta 2 on the packed
    ring by the port's engine and by JAX's, on the same numpy params,
    batches and media: every loss and every final parameter within
    rtol = atol 2e-5, and under AdamW its moments m and v (the gradients
    through the engine).  AdamW's first steps move an element by about lr
    whatever its gradient's size, lr m / (sqrt(v) + eps): where the
    gradient is ~1e-7 (the two frameworks' f32 sums ~2e-9 apart there)
    the step moves by a few % of lr, so its parameters get lr / 20 more
    (measured: 2.99e-5 in one element of 6144 of an FFN's wd, 6.14e-5 in
    one of 4096 of a wq, 1% and 2% of lr; every parameter moves ~3 lr)."""
    jcfg, tcfg, jp, tp = _models(VISION)
    sync = dict(delta=2, remat="none", packed_ring=True)
    lr = 3e-3
    jeng = jsteps.make_train_engine(
        jcfg, jopt.make_optimizer(jopt.OptConfig(name=opt_name, lr=lr)),
        JSyncConfig(**sync), jp)
    teng = tsteps.make_train_engine(
        tcfg, topt.make_optimizer(topt.OptConfig(name=opt_name, lr=lr)),
        SyncConfig(**sync), tp)
    jstate, tstate = jeng.init_state(), teng.init_state()
    for i in range(3):
        jb, tb = _batch(tcfg, 20 + i)
        jstate, jm = jeng.step(jstate, jb)
        tstate, tm = teng.step(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-5, atol=2e-5)
    want = {k: np.asarray(v) for k, v in _jpaths(jstate.params).items()}
    got = {"/".join(p): v for p, v in leaves_with_path(tstate.params)}
    assert set(got) == set(want)
    atol = 2e-5 + (lr / 20 if opt_name == "adamw" else 0.0)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=2e-5, atol=atol,
                                   err_msg=k)
    if opt_name == "adamw":
        for mom in ("m", "v"):
            want_m = _jpaths(jstate.opt_state[mom])
            for p, v in leaves_with_path(tstate.opt_state[mom]):
                k = "/".join(p)
                np.testing.assert_allclose(v.numpy(), np.asarray(want_m[k]),
                                           rtol=2e-5, atol=2e-5,
                                           err_msg=f"{mom} {k}")
    assert teng.telemetry.summary() == jeng.telemetry.summary()


def _empty_subtrees(tree, path=()):
    if not isinstance(tree, dict):
        return []
    if not tree:
        return [path]
    return [p for k in sorted(tree)
            for p in _empty_subtrees(tree[k], path + (k,))]


def test_unflatten_keeps_no_value_alive():
    """A rebuilt tree's values die with the tree, without the cycle
    collector: the gradients a step rebuilds are freed when it drops
    them."""
    import gc
    import weakref

    from repro_torch.tree import structure, unflatten
    like = structure({"a": {"b": torch.zeros(2), "n": {}},
                      "c": torch.zeros(3)})
    vals = [torch.ones(2), torch.ones(3)]
    dead = [weakref.ref(v) for v in vals]
    gc.disable()
    try:
        out = unflatten(like, vals)
        assert out["a"]["n"] == {} and out["c"] is vals[1]
        del out, vals
        assert all(r() is None for r in dead)
    finally:
        gc.enable()


@pytest.mark.parametrize("rebuild", ["grad_fn", "stale_tree", "stale_packed",
                                     "unravel", "load_state"])
def test_olmo_empty_norms_survive_every_rebuild(rebuild, tmp_path):
    """olmo's ``layernorm_np`` norms are empty subtrees.  Every tree the
    port rebuilds from leaves (the gradient function's, the ring's stale
    read in both layouts, ``unravel``, a checkpoint's ``load_state``)
    keeps them, as JAX's treedef does, so the model's lookup of a norm
    that is missing still raises."""
    from repro_torch.checkpoint import load_state, save_checkpoint
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.pdb.torch_backend import (init_delayed_state,
                                               make_delayed_step)
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import ravel
    _, tcfg, _, tp = _models("olmo-1b")
    empties = _empty_subtrees(tp)
    # final_norm, and ln1 and ln2 of every slot of every group
    assert ("final_norm",) in empties and len(empties) == 1 + 2 * sum(
        len(g.pattern) for g in tcfg.groups)
    _, tb = _batch(tcfg, 1)
    grad_fn = tsteps.make_lm_grad_fn(tcfg, SyncConfig())
    opt = make_optimizer(OptConfig(name="sgd", lr=1e-2))
    if rebuild == "grad_fn":
        out = grad_fn(tp, tb)[1]
    elif rebuild.startswith("stale"):
        packed = rebuild == "stale_packed"
        step = make_delayed_step(grad_fn, opt.update, 2, packed=packed)
        state = init_delayed_state(tp, opt.init, 2, packed=packed)
        state, _ = step(state, tb)
        out = step.read_stale(state)
    elif rebuild == "unravel":
        flat, unravel = ravel(tp)
        out = unravel(flat)
    else:
        save_checkpoint(str(tmp_path), 1, tp)
        out = load_state(str(tmp_path), 1, tp)
    assert _empty_subtrees(out) == empties
    loss, _ = ttf.lm_loss(out, tb, tcfg)
    assert torch.isfinite(loss)
    del out["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        ttf.lm_loss(out, tb, tcfg)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(vocab, seed, n=6):
    kw = dict(prompt_lens=(8, 16), gen_lens=(2, 4, 8), seed=seed)
    t = tserve.open_loop_requests(n, 100.0, vocab, **kw)
    j = jserve.open_loop_requests(n, 100.0, vocab, **kw)
    return t, j


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("arch", TEXT)
def test_greedy_outputs_match_jax_engine(arch, chunk):
    jcfg, tcfg, jp, tp = _models(arch)
    treqs, jreqs = _requests(jcfg.vocab_size, 3)
    want = jserve.ServeEngine(jcfg, jp, jserve.ServeConfig(
        prefill_chunk=chunk, **SCFG)).run(jreqs)
    got = tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
        prefill_chunk=chunk, **SCFG)).run(treqs)
    assert got.outputs == want.outputs
    assert got.decode_steps == want.decode_steps
    assert got.prefill_chunks == want.prefill_chunks
    if chunk == 0:
        static = tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
            continuous=False, **SCFG)).run(treqs)
        assert static.outputs == got.outputs


def test_engine_refuses_vision_as_jax_does():
    jcfg, tcfg, jp, tp = _models(VISION)
    with pytest.raises(NotImplementedError) as jerr:
        jserve.ServeEngine(jcfg, jp, jserve.ServeConfig(**SCFG))
    with pytest.raises(NotImplementedError) as terr:
        tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(**SCFG))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="text-only"):
        serve_cli.main(["--arch", VISION, "--smoke", "--device", "cpu",
                        "--requests", "2"])


def test_serving_cli_gemma3_chunked_on_cpu(capsys):
    out = serve_cli.main(["--arch", "gemma3-4b", "--smoke", "--device",
                          "cpu", "--requests", "4", "--rate", "50",
                          "--batch", "2", "--gen", "4", "--seed", "1",
                          "--prefill-chunk", "8"])
    rep = out["report"]
    assert rep.n_requests == 4 and rep.total_tokens == 4 * 4
    assert rep.prefill_chunks > 0
    assert "continuous on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the media stub through the batch and the train CLI
# ---------------------------------------------------------------------------

def test_batches_carry_media():
    """The media draw follows the tokens' on the (seed, step) generator:
    the tokens are those of a batch without media, and the media are a
    deterministic (B, N, d_frontend) f32 draw at JAX's 0.02 scale."""
    spec = LMBatchSpec(batch=2, seq_len=12, vocab_size=50, media_tokens=8,
                       media_dim=24, seed=4)
    a, b = make_lm_batch(spec, 3, "cpu"), make_lm_batch(spec, 3, "cpu")
    plain = make_lm_batch(dataclasses.replace(spec, media_tokens=0), 3,
                          "cpu")
    assert "media" not in plain
    assert torch.equal(a["tokens"], plain["tokens"])
    assert a["media"].shape == (2, 8, 24) and a["media"].dtype == \
        torch.float32
    assert torch.equal(a["media"], b["media"])
    assert not torch.equal(a["media"],
                           make_lm_batch(spec, 4, "cpu")["media"])
    assert 0.01 < float(a["media"].std()) < 0.03


def test_train_cli_trains_vision_on_cpu():
    r = ttrain.main(["--arch", VISION, "--smoke", "--device", "cpu",
                     "--batch", "2", "--seq", "16", "--steps", "6",
                     "--lr", "3e-3", "--delta", "2", "--log-every", "100"])
    assert np.isfinite(r["final_loss"]) and np.isfinite(r["first_loss"])
    assert r["telemetry"]["max_staleness"] == 2


def test_vision_chunked_prefill_matches_whole_prompt():
    """``prefill_chunk`` with media (a feature the JAX engine does not
    reach: its engine is text-only) gives the whole-prompt ``prefill``'s
    last logits, chunk by chunk against the paged cache, at f32."""
    from repro_torch.models import transformer as ttf
    _, tcfg, _, tp = _models(VISION)
    _, tb = _batch(tcfg, 2, B=1, S=12)
    toks, media = tb["tokens"].long(), tb["media"]
    want, _ = ttf.prefill(tp, toks, tcfg, cache_len=CACHE_LEN, media=media)
    alloc = tserve.PageAllocator(tcfg, 1, CACHE_LEN, PAGE)
    cache = tserve.init_paged_cache(tcfg, 1, CACHE_LEN, PAGE, device="cpu")
    rows = {L: torch.from_numpy(ids) for L, ids in alloc.alloc(0).items()}
    carry = ttf.init_chunk_carry(tcfg, device="cpu")
    for s0 in range(0, 12, 4):
        got, cache, carry = ttf.prefill_chunk(
            tp, cache, toks[:, s0:s0 + 4], s0, rows, carry, tcfg, CACHE_LEN,
            media=media)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
