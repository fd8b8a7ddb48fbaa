"""The port's dense ring decode cache against the JAX package's, at f32 on
the CPU.

Both sides get the same parameter tree (made by ``repro``'s
``paramlib.init_tree``) and the same numpy prompts.  ``prefill`` plus 8
greedy ``decode_step``s on the dense cache match JAX's at a scalar and at
a (B,) ``pos`` (rows prefilled apart, at two lengths), and from
``init_cache``: logits at atol 1e-4, greedy tokens equal.  The cases are
llama3.2-1b (its 16-slot ring wraps after 4 steps), mixtral-8x7b
(capacity factor 4.0, a 16-slot window ring) and recurrentgemma-2b (the
local layer's 16-slot window ring decoded past its end, the RG-LRU rows).
The port's dense path equals its own paged path bit for bit (pools filled
from the same ring, pages of 4 under an identity table); ``init_cache``
matches JAX's tree, shapes, dtypes and zeros; ``make_prefill_step`` and
``make_decode_step`` match JAX's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-4
CACHE_LEN = 16
STEPS = 8
CASES = {"llama3.2-1b": {}, "mixtral-8x7b": {"capacity_factor": 4.0},
         "recurrentgemma-2b": {}}


_jdecode = jax.jit(jtf.decode_step, static_argnums=(4,))
_jprefill = jax.jit(jtf.prefill, static_argnums=(2, 3))


def _models(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32, **over)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _prefill_rows(jcfg, tcfg, jp, tp, prompts):
    """Each row prefilled alone, the rows' caches joined along the batch
    axis (axis 1 of every stacked leaf): (JAX cache, port cache, JAX last
    logits, port last logits)."""
    jouts = [_jprefill(jp, jnp.asarray([p], jnp.int32), jcfg, CACHE_LEN)
             for p in prompts]
    touts = [ttf.prefill(tp, torch.tensor([p]), tcfg, cache_len=CACHE_LEN)
             for p in prompts]
    jcache = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1),
                          *[c for _, c in jouts])
    tcache = _tree_map(lambda *xs: torch.cat(xs, dim=1),
                       *[c for _, c in touts])
    jlast = jnp.concatenate([lg for lg, _ in jouts])
    tlast = torch.cat([lg for lg, _ in touts])
    return jcache, tcache, jlast, tlast


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def _greedy(jcfg, tcfg, jp, tp, jcache, tcache, jlast, tlast, pos):
    """STEPS greedy decode steps on each side from its own tokens; pos is
    an int (scalar form) or a (B,) array.  Returns the port's logits."""
    _close(tlast, jlast)
    jtok = jnp.argmax(jlast, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tlast, -1)[:, None]
    assert np.array_equal(np.asarray(jtok), ttok.numpy())
    out = []
    for i in range(STEPS):
        p = pos + i
        jlog, jcache = _jdecode(jp, jcache, jtok, jnp.asarray(p, jnp.int32),
                                jcfg)
        tlog, tcache = ttf.decode_step(tp, tcache, ttok,
                                       torch.as_tensor(p), tcfg)
        assert tlog.shape == (ttok.shape[0], 1, tcfg.vocab_size)
        _close(tlog, jlog)
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog[:, -1], -1)[:, None]
        assert np.array_equal(np.asarray(jtok), ttok.numpy())
        out.append(tlog)
    return out


@pytest.mark.parametrize("per_row", [False, True],
                         ids=["scalar_pos", "row_pos"])
@pytest.mark.parametrize("arch", CASES)
def test_dense_decode_matches_jax(arch, per_row):
    jcfg, tcfg, jp, tp = _models(arch, **CASES[arch])
    rng = np.random.default_rng(0)
    lens = (12, 7) if per_row else (12, 12)
    prompts = [tuple(int(t) for t in rng.integers(0, jcfg.vocab_size, n))
               for n in lens]
    if per_row:
        caches = _prefill_rows(jcfg, tcfg, jp, tp, prompts)
        pos = np.array(lens)
    else:
        toks = np.array(prompts, np.int32)
        jlast, jcache = _jprefill(jp, jnp.asarray(toks), jcfg, CACHE_LEN)
        tlast, tcache = ttf.prefill(tp, torch.from_numpy(toks).long(), tcfg,
                                    cache_len=CACHE_LEN)
        caches = (jcache, tcache, jlast, tlast)
        pos = lens[0]
    with torch.no_grad():
        _greedy(jcfg, tcfg, jp, tp, *caches, pos)


@pytest.mark.parametrize("arch", CASES)
def test_decode_from_init_cache_matches_jax(arch):
    """Teacher-forced steps from the zero cache, rows at positions 0 and
    3 (the zero slots behind row 1 count as live on both sides)."""
    jcfg, tcfg, jp, tp = _models(arch, **CASES[arch])
    jcache = jtf.init_cache(jcfg, 2, CACHE_LEN)
    tcache = ttf.init_cache(tcfg, 2, CACHE_LEN, device="cpu")
    rng = np.random.default_rng(1)
    pos = np.array([0, 3])
    with torch.no_grad():
        for _ in range(6):
            tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
            jlog, jcache = _jdecode(jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos, jnp.int32), jcfg)
            tlog, tcache = ttf.decode_step(tp, tcache,
                                           torch.from_numpy(tok).long(),
                                           torch.from_numpy(pos), tcfg)
            _close(tlog, jlog)
            pos = pos + 1


def _paged_from_dense(cache: dict, page: int) -> dict:
    """A paged cache holding the dense cache's rings: each row's L slots
    as L / page pages of one pool, row b on pages b * L / page onward (an
    identity table); recurrent rows copied."""
    out = {}
    for gkey, slots in cache.items():
        out[gkey] = {}
        for skey, c in slots.items():
            if "k" not in c:
                out[gkey][skey] = {k: t.clone() for k, t in c.items()}
                continue
            n, B, L, KV, hd = c["k"].shape
            npp = L // page
            pt = torch.arange(B * npp, dtype=torch.int32).view(1, B, npp)
            out[gkey][skey] = {
                "pk": c["k"].reshape(n, B * npp, page, KV, hd).clone(),
                "pv": c["v"].reshape(n, B * npp, page, KV, hd).clone(),
                "pt": pt.expand(n, B, npp).contiguous()}
    return out


@pytest.mark.parametrize("per_row", [False, True],
                         ids=["scalar_pos", "row_pos"])
@pytest.mark.parametrize("arch", CASES)
def test_dense_decode_equals_paged_bit_for_bit(arch, per_row):
    _, tcfg, _, tp = _models(arch, **CASES[arch])
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 12)))
    with torch.no_grad():
        last, dense = ttf.prefill(tp, toks, tcfg, cache_len=CACHE_LEN)
        paged = _paged_from_dense(dense, page=4)
        tok_d = tok_p = torch.argmax(last, -1)[:, None]
        for i in range(STEPS):
            pos = torch.tensor([12 + i, 12 + i]) if per_row \
                else torch.tensor(12 + i)
            ld, dense = ttf.decode_step(tp, dense, tok_d, pos, tcfg)
            lp, paged = ttf.decode_step(tp, paged, tok_p, pos, tcfg)
            assert torch.equal(ld, lp), i
            tok_d = torch.argmax(ld[:, -1], -1)[:, None]
            tok_p = torch.argmax(lp[:, -1], -1)[:, None]
        for (path, a), (_, b) in zip(leaves_with_path(paged),
                                     leaves_with_path(
                                         _paged_from_dense(dense, 4))):
            assert torch.equal(a, b), path


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("arch", ("llama3.2-1b", "mixtral-8x7b",
                                  "recurrentgemma-2b", "rwkv6-1.6b"))
def test_init_cache_matches_jax(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jtf.init_cache(jcfg, 3, 40))}
    got = {"/".join(path): t for path, t in
           leaves_with_path(ttf.init_cache(tcfg, 3, 40, device="cpu"))}
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert _dtype_name(t.dtype) == str(want[k].dtype), k
        assert not t.any(), k
    assert not np.any([np.asarray(v).any() for v in want.values()])


def test_prefill_and_decode_step_builders_match_jax():
    jcfg, tcfg, jp, tp = _models("llama3.2-1b")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jlast, jcache = jsteps.make_prefill_step(jcfg, CACHE_LEN)(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlast, tcache = tsteps.make_prefill_step(tcfg, CACHE_LEN, "full")(
            tp, {"tokens": torch.from_numpy(toks).long()})
    _close(tlast, jlast)
    jdec, tdec = jsteps.make_decode_step(jcfg), tsteps.make_decode_step(tcfg)
    tok = np.argmax(np.asarray(jlast), -1)[:, None].astype(np.int32)
    for i in range(3):
        jlog, jcache = jdec(jp, jcache, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.asarray(10 + i,
                                                            jnp.int32)})
        with torch.no_grad():
            tlog, tcache = tdec(tp, tcache, {
                "tokens": torch.from_numpy(tok).long(),
                "pos": torch.tensor(10 + i)})
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)
