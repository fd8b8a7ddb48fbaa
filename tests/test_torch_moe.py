"""The port's MoE serving path against the JAX package, on the CPU.

* ``ref.moe_grouped_ffn`` against JAX's plain version and its Pallas
  kernel (interpret mode) on the shapes of tests/test_kernels.py (one of
  them drops tokens), f32 at rtol/atol 2e-5 and bf16 at 2e-2.
* ``moe_ffn`` against JAX's on the mixtral and llama4-scout smoke configs
  at capacity factors 1.25 and 4.0: output at atol 1e-4, the aux values,
  and the routing (``dispatch``) exactly; the uniform-router tie and the
  forced-expert drop of tests/test_moe.py; the group size rule.
* Parameter trees: spec shapes, and a JAX MoE tree through
  ``params_from_numpy``.
* Prefill + paged decode == the JAX forward (tests/test_decode_consistency
  .py), through the mixtral SWA ring wrap.
* The engine's greedy tokens equal the JAX engine's, continuous and
  static, at capacity factor 1.25 (where the two modes differ from each
  other, as in JAX: a decode batch is one routing group, idle rows
  included) and 4.0; chunked and prefix-cached runs give JAX's tokens,
  ``prefill_chunks`` and ``prefix_hit_rate``.

MoE training is held to JAX in tests/test_torch_moe_train.py.

Inputs come from numpy with a seed; models run in f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_matmul import \
    moe_grouped_ffn as pallas_moe  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import paramlib as tparamlib  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import paged_cache as tpc  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
ATOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


# ---------------------------------------------------------------------------
# the plain kernel version
# ---------------------------------------------------------------------------

def _routing(rng, G, g, E, C, k=2):
    """Top-k dispatch/combine (numpy) the way models/moe.py builds them."""
    logits = rng.standard_normal((G, g, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    remaining = probs.copy()
    combine = np.zeros((G, g, E, C), np.float32)
    dispatch = np.zeros((G, g, E, C), bool)
    fill = np.zeros((G, E), np.int64)
    for _ in range(k):
        idx = remaining.argmax(-1)
        gate = np.take_along_axis(remaining, idx[..., None], -1)[..., 0]
        onehot = np.eye(E, dtype=np.float32)[idx]
        pos = fill[:, None, :] + (np.cumsum(onehot, 1) - onehot).astype(int)
        keep = onehot.astype(bool) & (pos < C)
        slot = np.eye(C + 1, dtype=np.float32)[np.where(keep, pos, C)][..., :C]
        dispatch |= slot.astype(bool)
        combine += slot * gate[..., None, None]
        fill += onehot.sum(1).astype(int)
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine


def _kernel_inputs(G, g, E, C, d, f, seed=14):
    rng = np.random.default_rng(seed)
    dispatch, combine = _routing(rng, G, g, E, C)
    xg = rng.standard_normal((G, g, d)).astype(np.float32)
    w = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    return dispatch, combine, xg, w


@pytest.mark.parametrize("G,g,E,C,d,f", [
    (1, 16, 4, 8, 32, 48),
    (2, 24, 4, 16, 16, 64),
    (1, 32, 8, 10, 64, 96),    # capacity drops (over-capacity tokens)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref_and_pallas(G, g, E, C, d, f, dtype):
    dispatch, combine, xg, w = _kernel_inputs(G, g, E, C, d, f)
    tdt, jdt = DTYPES[dtype]
    got = tref.moe_grouped_ffn(torch.from_numpy(dispatch),
                               torch.from_numpy(combine),
                               torch.from_numpy(xg).to(tdt),
                               *(torch.from_numpy(a).to(tdt) for a in w))
    jin = (jnp.asarray(dispatch), jnp.asarray(combine),
           jnp.asarray(xg).astype(jdt), *(jnp.asarray(a).astype(jdt)
                                          for a in w))
    assert got.dtype == tdt and got.shape == (G, g, d)
    for want in (jref.moe_grouped_ffn(*jin),
                 pallas_moe(*jin, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype])
    if C == 10:          # some (token, expert) choices over capacity
        assert dispatch.sum() < G * g * 2


def test_ops_on_cpu_take_the_plain_version():
    dispatch, combine, xg, w = _kernel_inputs(1, 16, 4, 8, 32, 48)
    args = [torch.from_numpy(a) for a in (dispatch, combine, xg, *w)]
    before = dict(tops.launches)
    assert torch.equal(tops.moe_grouped_ffn(*args),
                       tref.moe_grouped_ffn(*args))
    assert tops.launches == before           # no kernel ran


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer(arch, seed=0, **kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32, **kw)
    jp = jparamlib.init_tree(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed))
    jp = {k: np.array(v) for k, v in jp.items()}
    return jcfg, tcfg, jp


def _capture(monkeypatch, module, name="moe_grouped_ffn"):
    """Record the (dispatch, combine) each package hands its kernel op."""
    seen = []
    inner = getattr(module, name)

    def spy(dispatch, combine, *rest, **kw):
        seen.append((np.asarray(dispatch), np.asarray(combine)))
        return inner(dispatch, combine, *rest, **kw)
    monkeypatch.setattr(module, name, spy)
    return seen


def _both(monkeypatch, jcfg, tcfg, jp, x):
    jseen, tseen = _capture(monkeypatch, jops), _capture(monkeypatch, tops)
    want, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in jp.items()},
                              jnp.asarray(x), jcfg)
    got, taux = tmoe.moe_ffn({k: torch.from_numpy(v) for k, v in jp.items()},
                             torch.from_numpy(x), tcfg)
    (jd, jc), = jseen
    (td, tc), = tseen
    np.testing.assert_array_equal(td, jd)        # routing is exact
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for k in ("lb_loss", "z_loss", "router_entropy"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6)
    return got, jd


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_ffn_matches_jax(monkeypatch, arch, cf):
    jcfg, tcfg, jp = _layer(arch, capacity_factor=cf)
    x = np.random.default_rng(1).standard_normal(
        (2, 48, jcfg.d_model)).astype(np.float32)
    _, dispatch = _both(monkeypatch, jcfg, tcfg, jp, x)
    routed = dispatch.any(axis=(2, 3)).mean()
    if cf == 4.0:
        assert routed == 1.0
    assert dispatch.shape[:2] == (2, 48)     # 96 tokens, groups of 48


def test_uniform_router_ties_take_the_lowest_index(monkeypatch):
    """tests/test_moe.py: a zero router gives equal probabilities; both
    packages pick experts 0 then 1 for every token (lax.top_k's rule),
    and lb_loss is at its minimum region (>= 1)."""
    jcfg, tcfg, jp = _layer("mixtral-8x7b", capacity_factor=4.0)
    jp["router"] = np.zeros_like(jp["router"])
    x = np.random.default_rng(2).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    _, dispatch = _both(monkeypatch, jcfg, tcfg, jp, x)
    experts = dispatch.any(axis=3)           # (G, g, E)
    assert experts[..., :2].all() and not experts[..., 2:].any()


def test_forced_expert_drops_tokens(monkeypatch):
    """tests/test_moe.py: every token to expert 0 at capacity factor 0.25
    and top-1: overflow tokens contribute exactly zero, on both sides."""
    jcfg, tcfg, jp = _layer("mixtral-8x7b", capacity_factor=0.25, top_k=1)
    jp["router"] = np.zeros_like(jp["router"])
    jp["router"][:, 0] = 10.0
    x = np.random.default_rng(3).standard_normal(
        (1, 32, jcfg.d_model)).astype(np.float32)
    got, dispatch = _both(monkeypatch, jcfg, tcfg, jp, x)
    dropped = ~dispatch.any(axis=(2, 3))[0]
    assert 0 < dropped.sum() < 32
    assert (got[0].numpy()[dropped] == 0).all()
    assert (np.abs(got[0].numpy()[~dropped]).sum(-1) > 0).all()


@pytest.mark.parametrize("T", [8, 127, 300, 512, 2048])
def test_group_size_matches_jax(T):
    x = np.zeros((1, T, 4), np.float32)
    jxg, jg = jmoe._group_tokens(jnp.asarray(x), 1024)
    txg, tg = tmoe._group_tokens(torch.from_numpy(x), 1024)
    assert tg == jg and tuple(txg.shape) == jxg.shape


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _models(arch, cf=4.0):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32, capacity_factor=cf)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32, capacity_factor=cf)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_params_from_numpy(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    tshapes = {p: s.shape for p, s in tparamlib.leaves(ttf.model_specs(tcfg))}
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(tshapes)
    for path, leaf in flat:
        key = "/".join(k.key for k in path)
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tshapes[key] == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    ffn = tp["groups"]["g0"]["s0"]["ffn"]
    E, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert ffn["router"].shape == (2, d, E)
    assert ffn["wg"].shape == ffn["wu"].shape == (2, E, d, f)
    assert ffn["wd"].shape == (2, E, f, d)


def test_leaf_by_leaf_serving_tree_equals_serving_params():
    """``init_tree(..., leaf_fn=serving_leaf)`` (each master leaf cast as
    soon as it is drawn, as the full-width run builds mixtral) gives the
    bits of ``serving_params(init_tree(...))``: bf16 expert and attention
    matrices, f32 router and norms."""
    cfg = tconfigs.get_smoke_config("mixtral-8x7b")
    specs = ttf.model_specs(cfg)
    want = tserve.serving_params(tparamlib.init_tree(
        specs, torch.Generator().manual_seed(3)), cfg)
    got = tparamlib.init_tree(
        specs, torch.Generator().manual_seed(3),
        leaf_fn=lambda k, t, spec: tserve.serving_leaf(k, t, cfg,
                                                       spec))
    flat = dict(tparamlib.leaves(specs))
    for path in flat:
        a, b = got, want
        for k in path.split("/"):
            a, b = a[k], b[k]
        assert a.dtype == b.dtype and torch.equal(a, b), path
    ffn = got["groups"]["g0"]["s0"]["ffn"]
    assert ffn["wg"].dtype == torch.bfloat16
    assert ffn["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# prefill + paged decode == forward (tests/test_decode_consistency.py)
# ---------------------------------------------------------------------------

def _paged(cfg, params, prompts, cache_len, page):
    B = len(prompts)
    alloc = tpc.PageAllocator(cfg, B, cache_len, page)
    cache = tpc.init_paged_cache(cfg, B, cache_len, page, device="cpu")
    join = tpc.make_join_fn(cfg, cache_len, page)
    for b, p in enumerate(prompts):
        _, dense = ttf.prefill(params, torch.tensor([p]), cfg,
                               cache_len=cache_len)
        rows = {L: torch.from_numpy(ids) for L, ids in alloc.alloc(b).items()}
        cache = join(cache, dense, b, rows)
    return cache


@pytest.mark.parametrize("arch,B,S,extra", [
    ("mixtral-8x7b", 2, 24, 3), ("llama4-scout-17b-a16e", 2, 24, 3),
    ("mixtral-8x7b", 1, 16, 6)])     # decode positions 16..21 wrap the ring
def test_prefill_and_paged_decode_match_jax_forward(arch, B, S, extra):
    jcfg, tcfg, jp, tp = _models(arch)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, S + extra)).astype(np.int32)
    full, _ = jtf.forward(jp, jnp.asarray(toks), jcfg)
    full = np.asarray(full)
    last, _ = ttf.prefill(tp, torch.from_numpy(toks[:, :S]).long(), tcfg,
                          cache_len=S + extra)
    np.testing.assert_allclose(last.numpy(), full[:, S - 1], rtol=0,
                               atol=ATOL)
    cache_len = -(-(S + extra) // 4) * 4           # a whole number of pages
    cache = _paged(tcfg, tp, [tuple(r[:S]) for r in toks], cache_len, 4)
    for t in range(extra):
        logits, cache = ttf.decode_step(
            tp, cache, torch.from_numpy(toks[:, S + t:S + t + 1]).long(),
            torch.full((B,), S + t), tcfg)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, S + t],
                                   rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

SCFG = dict(batch_size=4, page_size=8, cache_len=64, clock="steps")


@pytest.fixture(scope="module", params=[1.25, 4.0], ids=["cf1.25", "cf4"])
def mixtral(request):
    return _models("mixtral-8x7b", cf=request.param)


def _requests(vocab, n=8, seed=0):
    kw = dict(prompt_lens=(8, 16), gen_lens=(4, 8, 12), seed=seed)
    return (tserve.open_loop_requests(n, 100.0, vocab, **kw),
            jserve.open_loop_requests(n, 100.0, vocab, **kw))


def test_greedy_tokens_match_jax_engine(mixtral):
    jcfg, tcfg, jp, tp = mixtral
    treqs, jreqs = _requests(jcfg.vocab_size)
    got, want = {}, {}
    for cont in (True, False):
        want[cont] = jserve.ServeEngine(jcfg, jp, jserve.ServeConfig(
            continuous=cont, **SCFG)).run(jreqs)
        got[cont] = tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
            continuous=cont, **SCFG)).run(treqs)
        assert got[cont].outputs == want[cont].outputs
        assert got[cont].decode_steps == want[cont].decode_steps
    same = sum(got[True].outputs[r.rid] == got[False].outputs[r.rid]
               for r in treqs)
    if jcfg.capacity_factor >= 4.0:      # nothing dropped: schedule-free
        assert same == len(treqs)
    else:                                # drops depend on the batch
        assert same < len(treqs)


def test_chunked_and_prefix_cached_match_jax_engine(mixtral):
    """Prompts of at most 16 tokens fit the smoke SWA ring (window 16),
    so the prefix cache adopts pages and the chunks end-align."""
    jcfg, tcfg, jp, tp = mixtral
    reqs = tserve.shared_prefix_requests(
        8, 100.0, jcfg.vocab_size, n_prefixes=2, prefix_len=8,
        suffix_lens=(4, 8), gen_lens=(2, 4, 8), seed=3)
    jreqs = [jserve.Request(**dataclasses.asdict(r)) for r in reqs]
    scfg = dict(SCFG, page_size=4)
    for knobs in (dict(prefill_chunk=8), dict(prefix_cache=True)):
        want = jserve.ServeEngine(jcfg, jp, jserve.ServeConfig(
            **knobs, **scfg)).run(jreqs)
        got = tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
            **knobs, **scfg)).run(reqs)
        assert got.outputs == want.outputs
        assert got.prefill_chunks == want.prefill_chunks > 0
        assert got.prefix_hit_rate == want.prefix_hit_rate
        if knobs.get("prefix_cache"):
            assert got.prefix_hit_rate > 0
