"""The port's serving forward against the JAX package's, at f32, on the
ten smoke configs of the zoo (JAX's own matrix is
tests/test_decode_consistency.py).

Both sides get the same parameter tree (made by ``repro``'s
``paramlib.init_tree``, handed to the port through ``params_from_numpy``)
and the same numpy tokens; the vision model also the same numpy media,
and its xattn gates (zeros at init, which would hide the layer: tanh(0)
= 0) are set to the same non-zero draws in both trees.  MoE configs run
at capacity 4.0, as JAX's matrix does, so that no token is dropped.  The
port's prefill and paged and dense ``decode_step`` are held to JAX's
``prefill``/``forward`` (no ring wrap) and to JAX's own ``decode_step``
(ring wrap, prompts longer than the ring), logits at atol 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models.config import BlockGroup as JBlockGroup  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.models.config import BlockGroup  # noqa: E402
from repro_torch.models import paramlib as tparamlib  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import paged_cache as tpc  # noqa: E402

torch.set_num_threads(1)

ARCHS = tuple(jconfigs.all_arch_ids())
# the zoo's rest, ported last: the dense-ring case runs these (the others'
# dense decode is tests/test_torch_dense_decode.py's)
NEW_ARCHS = ("olmo-1b", "gemma3-4b", "musicgen-large", "llama-3.2-vision-11b")
ATOL = 1e-4


def _set_gates(tree: dict, cfg, seed: int = 0) -> dict:
    """The xattn slots' gates (n, 1) set to draws in [0.5, 1.5) from
    ``seed`` (in place on a numpy tree)."""
    rng = np.random.default_rng(seed)
    for gi, g in enumerate(cfg.groups):
        for si, kind in enumerate(g.pattern):
            if kind == "xattn":
                mix = tree["groups"][f"g{gi}"][f"s{si}"]["mix"]
                mix["gate"] = rng.uniform(
                    0.5, 1.5, mix["gate"].shape).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX config, port config, JAX params, port params), once per arch:
    no test writes into the parameters."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32, capacity_factor=4.0)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32, capacity_factor=4.0)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    npt = _set_gates(jax.tree.map(np.asarray, jp), jcfg)
    jp = jax.tree.map(jnp.asarray, npt)
    tp = params_from_numpy(npt, device="cpu")
    return jcfg, tcfg, jp, tp


def _media(cfg, B, seed=3):
    """(numpy media for JAX, the same as a torch tensor), or Nones."""
    if cfg.frontend != "vision":
        return None, None
    m = np.random.default_rng(seed).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return jnp.asarray(m), torch.from_numpy(m)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _paged(cfg, params, prompts, cache_len, page, B, media=None):
    """Port: B=1 prefill per row joined into a paged cache."""
    alloc = tpc.PageAllocator(cfg, B, cache_len, page)
    cache = tpc.init_paged_cache(cfg, B, cache_len, page, device="cpu")
    join = tpc.make_join_fn(cfg, cache_len, page)
    for b, p in enumerate(prompts):
        _, dense = ttf.prefill(params, torch.tensor([p]), cfg,
                               cache_len=cache_len,
                               media=None if media is None else media[b:b + 1])
        rows = {L: torch.from_numpy(ids) for L, ids in alloc.alloc(b).items()}
        cache = join(cache, dense, b, rows)
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    jspecs = dict(jax.tree_util.tree_flatten_with_path(
        jtf.model_specs(jcfg), is_leaf=lambda x: isinstance(
            x, jparamlib.P))[0])
    jshapes = {"/".join(k.key for k in path): s.shape
               for path, s in jspecs.items()}
    tshapes = {path: s.shape
               for path, s in tparamlib.leaves(ttf.model_specs(tcfg))}
    assert tshapes == jshapes
    assert tparamlib.param_count(ttf.model_specs(tcfg)) == \
        jparamlib.param_count(jtf.model_specs(jcfg))


def _slot_caches(cache):
    """((group key, slot key), slot cache) of every non-empty slot."""
    return [((gk, sk), c) for gk, g in cache.items() for sk, c in g.items()
            if c]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_jax_forward(arch):
    """No ring wrap: prefill + teacher-forced paged decode == forward."""
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(0)
    lens, extra, cache_len, page = (12, 9), 4, 16, 4
    toks = rng.integers(0, jcfg.vocab_size, (2, 12 + extra)).astype(np.int32)
    jm, tm = _media(jcfg, 2)
    full, _ = jtf.forward(jp, jnp.asarray(toks), jcfg, media=jm)
    tfull = ttf.forward(tp, torch.from_numpy(toks).long(), tcfg, media=tm)
    _close(tfull, full)

    S = lens[0]
    jlast, jcache = jtf.prefill(jp, jnp.asarray(toks[:, :S]), jcfg,
                                cache_len=cache_len, media=jm)
    tlast, tcache = ttf.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                                tcfg, cache_len=cache_len, media=tm)
    _close(tlast, jlast)
    _close(tlast, full[:, S - 1])
    for (gs, ss), c in _slot_caches(tcache):
        for name, t in c.items():
            _close(t, jcache[gs][ss][name])

    prompts = [tuple(toks[b, :n]) for b, n in enumerate(lens)]
    cache = _paged(tcfg, tp, prompts, cache_len, page, B=2, media=tm)
    pos = torch.tensor(lens)
    for _ in range(extra):
        tok = torch.from_numpy(toks[np.arange(2), pos.numpy()])[:, None]
        logits, cache = ttf.decode_step(tp, cache, tok.long(), pos, tcfg,
                                        media=tm)
        assert logits.shape == (2, 1, tcfg.vocab_size)
        _close(logits[:, 0], full[np.arange(2), pos.numpy()])
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax_through_ring_wrap(arch):
    """Prompts longer than the ring and decode past its end: the port's
    floor-mod slots and last-L fill match JAX's paged decode."""
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(1)
    cache_len, page, steps = 8, 4, 6
    prompts = [tuple(int(t) for t in rng.integers(0, jcfg.vocab_size, n))
               for n in (11, 6)]
    jm, tm = _media(jcfg, 2)
    cache = _paged(tcfg, tp, prompts, cache_len, page, B=2, media=tm)

    jalloc = jpc.PageAllocator(jcfg, 2, cache_len, page)
    jcache = jpc.init_paged_cache(jcfg, 2, cache_len, page)
    jjoin = jpc.make_join_fn(jcfg, cache_len, page)
    for b, p in enumerate(prompts):
        _, dense = jtf.prefill(jp, jnp.asarray([p], jnp.int32), jcfg,
                               cache_len=cache_len,
                               media=None if jm is None else jm[b:b + 1])
        rows = {L: jnp.asarray(ids) for L, ids in jalloc.alloc(b).items()}
        jcache = jjoin(jcache, dense, jnp.asarray(b, jnp.int32), rows)

    jdecode = jax.jit(lambda p, c, t, q, m: jtf.decode_step(p, c, t, q, jcfg,
                                                            media=m))
    pos = np.array([len(p) for p in prompts])
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1))
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos, jnp.int32), jm)
        tlog, cache = ttf.decode_step(tp, cache, torch.from_numpy(tok),
                                      torch.from_numpy(pos), tcfg, media=tm)
        _close(tlog, jlog)
        pos = pos + 1


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_dense_decode_matches_jax_through_ring_wrap(arch):
    """The dense cache (``prefill``'s, JAX's own form): prompts, then
    decode steps at a scalar position past the ring's end, against JAX's
    dense ``decode_step``; the caches leaf for leaf."""
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(2)
    cache_len, S, steps = 8, 10, 4
    toks = rng.integers(0, jcfg.vocab_size, (2, S + steps)).astype(np.int32)
    jm, tm = _media(jcfg, 2, seed=4)
    jlast, jcache = jtf.prefill(jp, jnp.asarray(toks[:, :S]), jcfg,
                                cache_len=cache_len, media=jm)
    tlast, cache = ttf.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                               tcfg, cache_len=cache_len, media=tm)
    _close(tlast, jlast)
    jdecode = jax.jit(lambda p, c, t, q, m: jtf.decode_step(p, c, t, q, jcfg,
                                                            media=m))
    for t in range(steps):
        pos = S + t
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                               jnp.asarray(pos, jnp.int32), jm)
        tlog, cache = ttf.decode_step(
            tp, cache, torch.from_numpy(toks[:, pos:pos + 1]).long(),
            torch.tensor(pos), tcfg, media=tm)
        _close(tlog, jlog)
    for (gs, ss), c in _slot_caches(cache):
        for name, t in c.items():
            _close(t, jcache[gs][ss][name])


def test_unported_layer_kinds_raise():
    """Every layer kind of the zoo now builds and runs in the port: xattn
    (a vision config made of it alone) gives the JAX forward's logits, and
    without media it raises; the recurrent kinds serve (below)."""
    jcfg, tcfg, _, _ = _models("llama-3.2-vision-11b")
    jcfg = dataclasses.replace(jcfg, groups=(JBlockGroup(("xattn",), 1),))
    tcfg = dataclasses.replace(tcfg, groups=(BlockGroup(("xattn",), 1),))
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(1))
    npt = _set_gates(jax.tree.map(np.asarray, jp), jcfg, seed=1)
    tp = params_from_numpy(npt, device="cpu")
    jm, tm = _media(jcfg, 2)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 7))
    want, _ = jtf.forward(jax.tree.map(jnp.asarray, npt), jnp.asarray(toks),
                          jcfg, media=jm)
    got = ttf.forward(tp, torch.from_numpy(toks), tcfg, media=tm)
    _close(got, want)
    assert set(ttf.init_cache(tcfg, 2, 8, device="cpu")["g0"]["s0"]) == set()
    with pytest.raises(ValueError, match="needs media"):
        ttf.forward(tp, torch.from_numpy(toks), tcfg)
    # the recurrent kinds train and serve: prefill gives finite logits and
    # each layer's serving state under its own names
    names = {"rwkv6": {"S", "x_last", "cx_last"}, "rglru": {"h", "conv"},
             "local": {"k", "v"}}
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        rec = tconfigs.get_smoke_config(arch)
        params = tparamlib.init_tree(ttf.model_specs(rec),
                                     torch.Generator().manual_seed(0))
        logits, cache = ttf.prefill(params,
                                    torch.zeros((1, 4), dtype=torch.long), rec)
        assert logits.shape == (1, rec.vocab_size)
        assert torch.isfinite(logits).all()
        for gi, g in enumerate(rec.groups):
            for si, kind in enumerate(g.pattern):
                c = cache[f"g{gi}"][f"s{si}"]
                assert set(c) == names[kind]
                assert all(t.shape[:2] == (g.n, 1) for t in c.values())
