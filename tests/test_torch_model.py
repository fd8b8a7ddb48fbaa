"""The port's serving forward against the JAX package's, at f32.

Both sides get the same parameter tree (made by ``repro``'s
``paramlib.init_tree``, handed to the port through ``params_from_numpy``)
and the same numpy tokens.  The port's prefill and paged ``decode_step``
are held to JAX's ``prefill``/``forward`` (no ring wrap) and to JAX's own
paged ``decode_step`` (ring wrap, prompts longer than the ring), logits at
atol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.models.config import BlockGroup  # noqa: E402
from repro_torch.models import paramlib as tparamlib  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import paged_cache as tpc  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("llama3.2-1b", "smollm-360m")
ATOL = 1e-4


def _models(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _paged(cfg, params, prompts, cache_len, page, B):
    """Port: B=1 prefill per row joined into a paged cache."""
    alloc = tpc.PageAllocator(cfg, B, cache_len, page)
    cache = tpc.init_paged_cache(cfg, B, cache_len, page, device="cpu")
    join = tpc.make_join_fn(cfg, cache_len, page)
    for b, p in enumerate(prompts):
        _, dense = ttf.prefill(params, torch.tensor([p]), cfg,
                               cache_len=cache_len)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_jax_forward(arch):
    """No ring wrap: prefill + teacher-forced paged decode == forward."""
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(0)
    lens, extra, cache_len, page = (12, 9), 4, 16, 4
    toks = rng.integers(0, jcfg.vocab_size, (2, 12 + extra)).astype(np.int32)
    full, _ = jtf.forward(jp, jnp.asarray(toks), jcfg)

    S = lens[0]
    jlast, jcache = jtf.prefill(jp, jnp.asarray(toks[:, :S]), jcfg,
                                cache_len=cache_len)
    tlast, tcache = ttf.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                                tcfg, cache_len=cache_len)
    _close(tlast, jlast)
    _close(tlast, full[:, S - 1])
    for name in ("k", "v"):
        _close(tcache["g0"]["s0"][name], jcache["g0"]["s0"][name])

    prompts = [tuple(toks[b, :n]) for b, n in enumerate(lens)]
    cache = _paged(tcfg, tp, prompts, cache_len, page, B=2)
    pos = torch.tensor(lens)
    for _ in range(extra):
        tok = torch.from_numpy(toks[np.arange(2), pos.numpy()])[:, None]
        logits, cache = ttf.decode_step(tp, cache, tok.long(), pos, tcfg)
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
    cache = _paged(tcfg, tp, prompts, cache_len, page, B=2)

    jalloc = jpc.PageAllocator(jcfg, 2, cache_len, page)
    jcache = jpc.init_paged_cache(jcfg, 2, cache_len, page)
    jjoin = jpc.make_join_fn(jcfg, cache_len, page)
    for b, p in enumerate(prompts):
        _, dense = jtf.prefill(jp, jnp.asarray([p], jnp.int32), jcfg,
                               cache_len=cache_len)
        rows = {L: jnp.asarray(ids) for L, ids in jalloc.alloc(b).items()}
        jcache = jjoin(jcache, dense, jnp.asarray(b, jnp.int32), rows)

    jdecode = jax.jit(lambda p, c, t, q: jtf.decode_step(p, c, t, q, jcfg))
    pos = np.array([len(p) for p in prompts])
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1))
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos, jnp.int32))
        tlog, cache = ttf.decode_step(tp, cache, torch.from_numpy(tok),
                                      torch.from_numpy(pos), tcfg)
        _close(tlog, jlog)
        pos = pos + 1


def test_unported_layer_kinds_raise():
    cfg = tconfigs.get_smoke_config("llama3.2-1b")
    bad = dataclasses.replace(cfg, groups=(BlockGroup(("xattn",), 1),))
    with pytest.raises(NotImplementedError, match="slice 7"):
        ttf.model_specs(bad)
    # the recurrent kinds train (model_specs builds them) but do not serve
    # yet
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        rec = tconfigs.get_smoke_config(arch)
        ttf.model_specs(rec)
        with pytest.raises(NotImplementedError, match="queue A item 1 "):
            ttf.prefill({}, torch.zeros((1, 4), dtype=torch.long), rec)
