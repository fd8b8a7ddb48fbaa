"""Recurrent serving of the port against the JAX package, on the CPU.

Both sides get the same numpy parameter tree (made by ``repro``'s
``init_tree``; its constant leaves get seeded noise so that they matter),
the f32 smoke configs, and the same requests or numpy inputs.

* ``recurrentgemma-2b`` through both serving engines: greedy outputs,
  decode steps and prefill chunks equal in the whole-prompt, chunked
  (chunk 8: two chunks and a teacher-forced tail), static and
  prefix-cached modes, with the prefix hit rate 0 on both sides (a model
  with a recurrent layer adopts no prefix); and the serving CLI on
  ``--device cpu``.
* ``rwkv6-1.6b`` through the model-level serving functions, ``prefill``,
  the paged cache's ``join``, ``decode_step``, ``init_chunk_carry`` and
  ``prefill_chunk``, against a JAX paged cache of recurrent rows only:
  logits rtol/atol 1e-4, states 1e-5.  Its engine refuses it, naming the
  reference's fault.
* ``rglru_decode`` and ``time_mix_decode`` from a random state at T = 1
  and T = 5; the conv and token-shift carries; ``ops.rglru_stateful`` and
  ``ops.rwkv6_stateful`` on CPU tensors are the plain versions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(1)

RG, RWKV = "recurrentgemma-2b", "rwkv6-1.6b"
# the smoke recurrentgemma's local ring is its window, 16 slots: 2 pages
SCFG = dict(batch_size=2, page_size=8, cache_len=32, clock="steps")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy_tree(jcfg, seed=7):
    rng = np.random.default_rng(seed)

    def noisy(a):          # constant leaves (zeros, ones) get noise
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            a = a + 0.5 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    return jax.tree.map(noisy, jparamlib.init_tree(jtf.model_specs(jcfg),
                                                   jax.random.PRNGKey(0)))


def _models(arch):
    """The smoke config at f32 on both sides, one numpy parameter tree."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype=torch.float32)
    npt = _numpy_tree(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npt), \
        params_from_numpy(npt, device="cpu")


@pytest.fixture(scope="module")
def rg():
    return _models(RG)


@pytest.fixture(scope="module")
def rwkv():
    return _models(RWKV)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _tree_close(got: dict, want: dict, tol):
    """Every leaf of a (port, JAX) cache or carry tree."""
    assert set(got) == set(want)
    for k, g in got.items():
        if isinstance(g, dict):
            _tree_close(g, want[k], tol)
        else:
            _close(g, want[k], tol)


# ---------------------------------------------------------------------------
# recurrentgemma through the engines
# ---------------------------------------------------------------------------

def _requests(vocab, shared: bool):
    """Prompts of 6 to 20 tokens (below, at and past the chunk of 8 and the
    ring of 16), or shared-prefix traffic, as both packages draw them."""
    if shared:
        reqs = tserve.shared_prefix_requests(
            8, 100.0, vocab, n_prefixes=2, prefix_len=8, suffix_lens=(4, 8),
            gen_lens=(2, 4, 8), seed=3)
    else:
        reqs = tserve.open_loop_requests(
            8, 2.0, vocab, prompt_lens=(6, 13, 20), gen_lens=(3, 6, 9),
            seed=4)
    return reqs, [jserve.Request(**dataclasses.asdict(r)) for r in reqs]


@pytest.mark.parametrize("mode", ["whole", "chunked", "static", "prefix"])
def test_recurrentgemma_engine_matches_jax(rg, mode):
    jcfg, tcfg, jp, tp = rg
    knobs, shared = {
        "whole": ({}, False),
        "chunked": (dict(prefill_chunk=8), False),
        "static": (dict(continuous=False), False),
        "prefix": (dict(prefix_cache=True), True),
    }[mode]
    treqs, jreqs = _requests(jcfg.vocab_size, shared)
    want = jserve.ServeEngine(jcfg, jp, jserve.ServeConfig(
        **knobs, **SCFG)).run(jreqs)
    got = tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
        **knobs, **SCFG)).run(treqs)
    assert got.outputs == want.outputs
    assert all(len(got.outputs[r.rid]) == r.gen_len for r in treqs)
    assert got.decode_steps == want.decode_steps
    assert got.prefill_chunks == want.prefill_chunks
    assert got.prefix_hit_rate == want.prefix_hit_rate == 0.0
    if mode in ("chunked", "prefix"):
        assert got.prefill_chunks > 0


def test_recurrentgemma_chunked_and_prefix_equal_whole_prompt(rg):
    """On one model the chunk plan (non-overlapping chunks, then the tail
    teacher-forced through decode) and the prefix cache (which adopts
    nothing) give the whole-prompt run's greedy tokens."""
    _, tcfg, _, tp = rg
    reqs, _ = _requests(tcfg.vocab_size, shared=True)
    outs = {name: tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
        **knobs, **SCFG)).run(reqs).outputs
        for name, knobs in (("whole", {}), ("chunked", dict(prefill_chunk=8)),
                            ("prefix", dict(prefix_cache=True)))}
    assert outs["whole"] == outs["chunked"] == outs["prefix"]


def test_recurrentgemma_serving_cli_on_cpu(capsys):
    out = serve_cli.main(["--arch", RG, "--smoke", "--device", "cpu",
                          "--requests", "5", "--rate", "50", "--batch", "2",
                          "--gen", "4", "--seed", "1", "--prefill-chunk",
                          "8"])
    rep = out["report"]
    assert rep.n_requests == 5 and rep.total_tokens == 5 * 4
    assert rep.prefill_chunks > 0 and rep.prefix_hit_rate == 0.0
    assert "continuous on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# rwkv6: the model-level serving functions
# ---------------------------------------------------------------------------

CACHE_LEN, PAGE = 32, 8


def test_rwkv6_engine_refuses_naming_the_reference_fault(rwkv):
    _, tcfg, _, tp = rwkv
    with pytest.raises(ValueError, match="min\\(\\) of an empty page-class "
                       "dict, repro/serve/engine.py:202"):
        tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(**SCFG))


def test_rwkv6_prefill_join_decode_match_jax(rwkv):
    """Two prompts prefilled and joined into rows 0 and 1 of a paged cache
    of recurrent rows only, then decode steps at batch 2 (a row at
    another's position, as the engine runs them): logits and every state
    leaf against JAX's."""
    jcfg, tcfg, jp, tp = rwkv
    rng = np.random.default_rng(11)
    prompts = [tuple(int(t) for t in rng.integers(0, 256, S))
               for S in (9, 14)]
    jcache = jpc.init_paged_cache(jcfg, 2, CACHE_LEN, PAGE)
    tcache = tserve.init_paged_cache(tcfg, 2, CACHE_LEN, PAGE, device="cpu")
    jjoin = jpc.make_join_fn(jcfg, CACHE_LEN, PAGE)
    tjoin = tserve.make_join_fn(tcfg, CACHE_LEN, PAGE)
    assert tserve.PageAllocator(tcfg, 2, CACHE_LEN, PAGE).alloc(0) == {}
    for b, p in enumerate(prompts):
        jlog, jdense = jtf.prefill(jp, jnp.asarray([p], jnp.int32), jcfg,
                                   cache_len=CACHE_LEN)
        tlog, tdense = ttf.prefill(tp, torch.tensor([p]), tcfg,
                                   cache_len=CACHE_LEN)
        _close(tlog, jlog, LOGIT_TOL)
        _tree_close(tdense, jdense, STATE_TOL)
        jcache = jjoin(jcache, jdense, jnp.asarray(b, jnp.int32), {})
        tcache = tjoin(tcache, tdense, b, {})
    _tree_close(tcache, jcache, STATE_TOL)
    pos = np.array([len(p) for p in prompts])
    for _ in range(4):
        tok = rng.integers(0, 256, (2, 1))
        jlog, jcache = jtf.decode_step(jp, jcache, jnp.asarray(tok, jnp.int32),
                                       jnp.asarray(pos, jnp.int32), jcfg)
        tlog, tcache = ttf.decode_step(tp, tcache, torch.from_numpy(tok),
                                       torch.from_numpy(pos), tcfg)
        _close(tlog, jlog, LOGIT_TOL)
        _tree_close(tcache, jcache, STATE_TOL)
        pos = pos + 1


def test_rwkv6_chunks_match_jax_and_the_whole_prompt(rwkv):
    """``prefill_chunk`` over 3 chunks of 5 with the carry, against JAX's
    chunks (logits and carry) and against the whole-prompt prefill's
    logits and final states; then activation writes the carry into row 1
    and a decode step there matches JAX's."""
    jcfg, tcfg, jp, tp = rwkv
    rng = np.random.default_rng(12)
    prompt = tuple(int(t) for t in rng.integers(0, 256, 15))
    jcache = jpc.init_paged_cache(jcfg, 2, CACHE_LEN, PAGE)
    tcache = tserve.init_paged_cache(tcfg, 2, CACHE_LEN, PAGE, device="cpu")
    jcar, tcar = jtf.init_chunk_carry(jcfg), ttf.init_chunk_carry(
        tcfg, device="cpu")
    _tree_close(tcar, jcar, STATE_TOL)
    t0 = tcar
    for s0 in range(0, 15, 5):
        toks = prompt[s0:s0 + 5]
        jlog, jcache, jcar = jtf.prefill_chunk(
            jp, jcache, jnp.asarray([toks], jnp.int32),
            jnp.asarray(s0, jnp.int32), {}, jcar, jcfg, CACHE_LEN)
        tlog, tcache, tcar = ttf.prefill_chunk(
            tp, tcache, torch.tensor([toks]), s0, {}, tcar, tcfg, CACHE_LEN)
        _close(tlog, jlog, LOGIT_TOL)
        _tree_close(tcar, jcar, STATE_TOL)
    # the carry given is left as it was
    assert all(torch.equal(v, torch.zeros_like(v))
               for s in t0.values() for c in s.values() for v in c.values())
    wlog, wdense = ttf.prefill(tp, torch.tensor([prompt]), tcfg,
                               cache_len=CACHE_LEN)
    torch.testing.assert_close(tlog, wlog, **LOGIT_TOL)
    for skey, c in tcar["g0"].items():
        for name, t in c.items():
            torch.testing.assert_close(t, wdense["g0"][skey][name],
                                       **STATE_TOL)
    jcache = jpc.make_activate_fn(jcfg, CACHE_LEN, PAGE)(
        jcache, jnp.asarray(1, jnp.int32), {}, jcar)
    tcache = tserve.make_activate_fn(tcfg, CACHE_LEN, PAGE)(
        tcache, 1, {}, tcar)
    _tree_close(tcache, jcache, STATE_TOL)
    tok = np.array([[3], [int(torch.argmax(tlog[0]))]])
    pos = np.array([0, 15])
    jlog, jcache = jtf.decode_step(jp, jcache, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(pos, jnp.int32), jcfg)
    tlog, tcache = ttf.decode_step(tp, tcache, torch.from_numpy(tok),
                                   torch.from_numpy(pos), tcfg)
    _close(tlog, jlog, LOGIT_TOL)
    _tree_close(tcache, jcache, STATE_TOL)


# ---------------------------------------------------------------------------
# the blocks' serving pieces from a random state
# ---------------------------------------------------------------------------

def _layer0(tp, jp, slot):
    t = {k: v[0] if not isinstance(v, dict) else
         {kk: vv[0] for kk, vv in v.items()}
         for k, v in tp["groups"]["g0"][slot].items()}
    j = jax.tree.map(lambda a: a[0], jp["groups"]["g0"][slot])
    return t, j


@pytest.mark.parametrize("T", [1, 5])
def test_rglru_decode_matches_jax(rg, T):
    jcfg, tcfg, jp, tp = rg
    tl, jl = _layer0(tp, jp, "s0")
    rng = np.random.default_rng(20 + T)
    d, dr, cw = tcfg.d_model, tcfg.rnn_width, tcfg.conv_width
    x = rng.standard_normal((2, T, d)).astype(np.float32)
    h = rng.standard_normal((2, dr)).astype(np.float32)
    conv = rng.standard_normal((2, cw - 1, dr)).astype(np.float32)
    got, gs = trglru.rglru_decode(
        tl["mix"], torch.from_numpy(x),
        {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}, tcfg)
    want, ws = jrglru.rglru_decode(
        jl["mix"], jnp.asarray(x),
        {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}, jcfg)
    _close(got, want, LOGIT_TOL)
    _tree_close(gs, ws, STATE_TOL)
    assert gs["h"].dtype == torch.float32 and gs["conv"].shape == conv.shape


@pytest.mark.parametrize("T", [1, 5])
def test_time_mix_decode_and_chan_mix_carry_match_jax(rwkv, T):
    jcfg, tcfg, jp, tp = rwkv
    tl, jl = _layer0(tp, jp, "s0")
    rng = np.random.default_rng(30 + T)
    H, hd, d = tcfg.n_heads, tcfg.hd, tcfg.d_model
    x = rng.standard_normal((2, T, d)).astype(np.float32)
    S = rng.standard_normal((2, H, hd, hd)).astype(np.float32)
    xl = rng.standard_normal((2, d)).astype(np.float32)
    got, gs = trwkv.time_mix_decode(
        tl["mix"], torch.from_numpy(x),
        {"S": torch.from_numpy(S), "x_last": torch.from_numpy(xl)}, tcfg)
    want, ws = jrwkv.time_mix_decode(
        jl["mix"], jnp.asarray(x),
        {"S": jnp.asarray(S), "x_last": jnp.asarray(xl)}, jcfg)
    _close(got, want, LOGIT_TOL)
    _tree_close(gs, ws, STATE_TOL)
    got = trwkv.chan_mix_fwd(tl["ffn"], torch.from_numpy(x), tcfg,
                             x_last=torch.from_numpy(xl))
    want = jrwkv.chan_mix_fwd(jl["ffn"], jnp.asarray(x), jcfg,
                              x_last=jnp.asarray(xl))
    _close(got, want, LOGIT_TOL)


def test_conv_and_token_shift_carries_match_jax(rg):
    """The conv with the previous inputs and the token shift with the
    previous token, against JAX's; and a sequence split in two with the
    carries equals the sequence whole."""
    jcfg, tcfg, jp, tp = rg
    tl, jl = _layer0(tp, jp, "s0")
    rng = np.random.default_rng(40)
    u = rng.standard_normal((2, 7, 64)).astype(np.float32)
    carry = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w, b = tl["mix"]["conv_w"], tl["mix"]["conv_b"]
    got = trglru._causal_conv(torch.from_numpy(u), w, b,
                              torch.from_numpy(carry))
    want = jrglru._causal_conv(jnp.asarray(u), jl["mix"]["conv_w"],
                               jl["mix"]["conv_b"], jnp.asarray(carry))
    _close(got, want, STATE_TOL)
    whole = trglru._causal_conv(torch.from_numpy(u), w, b)
    split = torch.cat([trglru._causal_conv(torch.from_numpy(u[:, :4]), w, b),
                       trglru._causal_conv(torch.from_numpy(u[:, 4:]), w, b,
                                           torch.from_numpy(u[:, 1:4]))], 1)
    torch.testing.assert_close(split, whole, rtol=0, atol=0)
    mu = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    xl = rng.standard_normal((2, 64)).astype(np.float32)
    got = trwkv._token_shift(torch.from_numpy(u), torch.from_numpy(xl), mu)
    want = jrwkv._token_shift(jnp.asarray(u), jnp.asarray(xl),
                              jnp.asarray(mu.numpy()))
    _close(got, want, STATE_TOL)
    whole = trwkv._token_shift(torch.from_numpy(u), None, mu)
    split = torch.cat([trwkv._token_shift(torch.from_numpy(u[:, :4]), None,
                                          mu),
                       trwkv._token_shift(torch.from_numpy(u[:, 4:]),
                                          torch.from_numpy(u[:, 3]), mu)], 1)
    torch.testing.assert_close(split, whole, rtol=0, atol=0)


def test_stateful_ops_on_cpu_are_the_plain_versions():
    """On CPU tensors the stateful routes are ``ref.rglru(x, a, h0)`` and
    ``ref.rwkv6_stateful`` (JAX's ``rglru_stateful`` and
    ``rwkv6_stateful``), bit for bit, and launch nothing."""
    rng = np.random.default_rng(50)
    x, z = (torch.from_numpy(rng.standard_normal((2, 5, 12))
                             .astype(np.float32)) for _ in range(2))
    a, h0 = torch.sigmoid(z), torch.from_numpy(
        rng.standard_normal((2, 12)).astype(np.float32))
    r, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 3, 4))
                                .astype(np.float32)) for _ in range(3))
    w = torch.sigmoid(torch.from_numpy(rng.standard_normal((2, 5, 3, 4))
                                       .astype(np.float32)))
    u = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    S0 = torch.from_numpy(rng.standard_normal((2, 3, 4, 4))
                          .astype(np.float32))
    ops.reset_launches()
    for got, want, jwant in (
            (ops.rglru_stateful(x, a, h0), ref.rglru(x, a, h0),
             jref.rglru(jnp.asarray(x.numpy()), jnp.asarray(a.numpy()),
                        jnp.asarray(h0.numpy()))),
            (ops.rwkv6_stateful(r, k, v, w, u, S0),
             ref.rwkv6_stateful(r, k, v, w, u, S0),
             jref.rwkv6_stateful(*(jnp.asarray(t.numpy())
                                   for t in (r, k, v, w, u, S0))))):
        for g, wt, j in zip(got, want, jwant):
            assert torch.equal(g, wt)
            _close(g, j, STATE_TOL)
    assert not any(ops.launches.values())


def test_serving_copy_keeps_the_rglru_gates_f32():
    """The serving copy casts the weight matrices to the compute dtype but
    keeps the RG-LRU's gate matrices ``wa`` and ``wi`` f32, as the model
    reads them (JAX computes the gates in f32 from the f32 master): their
    specs say so, and only theirs."""
    cfg = tconfigs.get_smoke_config(RG)
    from repro_torch.models import paramlib as tparamlib
    specs = ttf.model_specs(cfg)
    kept = {path for path, spec in tparamlib.leaves(specs) if spec.keep_f32}
    assert {path.rsplit("/", 1)[1] for path in kept} == {"wa", "wi"}
    master = tparamlib.init_tree(specs, torch.Generator().manual_seed(0))
    mix = tserve.serving_params(master, cfg)["groups"]["g0"]["s0"]["mix"]
    assert mix["wx"].dtype == mix["wo"].dtype == torch.bfloat16
    for name in ("wa", "wi"):
        assert mix[name].dtype == torch.float32
        assert torch.equal(mix[name],
                           master["groups"]["g0"]["s0"]["mix"][name])
