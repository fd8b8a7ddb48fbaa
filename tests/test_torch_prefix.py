"""The port's prefix cache, chunked-prefill engine and sampler against the
JAX package, on the CPU.

* The refcount and trie oracles of tests/test_paged_cache.py on the
  port's allocator and trie.
* ``shared_prefix_requests`` draws the JAX package's requests from one
  seed.
* The port's engine gives the JAX engine's greedy tokens, decode steps,
  ``prefill_chunks`` and ``prefix_hit_rate`` exactly under the same
  ``ServeConfig`` (chunked, prefix-cached, eviction under pressure,
  staggered arrivals, a near-complete hit through the tail phase): the
  scheduling logic is the same.
* The nucleus filter equals a numpy transcription of the JAX rule, ties
  included; sampled tokens depend only on (seed, request, token index).

The smoke config runs in f32 on the ``steps`` clock.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.workload import Request  # noqa: E402

torch.set_num_threads(1)

ARCH = "llama3.2-1b"
CACHE_LEN, PAGE = 32, 8
SCFG = dict(batch_size=3, page_size=PAGE, cache_len=CACHE_LEN, clock="steps")


# ---------------------------------------------------------------------------
# allocator refcounts and the trie (as tests/test_paged_cache.py)
# ---------------------------------------------------------------------------

def _cfg():
    return tconfigs.get_smoke_config(ARCH)


class TestRefcounts:
    def test_shared_page_survives_free_slot(self):
        alloc = tserve.PageAllocator(_cfg(), batch=2, cache_len=CACHE_LEN,
                                     page_size=PAGE, extra_seqs=1)
        (L, npp), = alloc.classes.items()
        rows = alloc.alloc(0)
        shared = int(rows[L][0])
        alloc.incref(L, shared)              # a second owner (the trie)
        free_before = alloc.n_free(L)
        alloc.free_slot(0)
        assert alloc.n_free(L) == free_before + npp - 1
        assert shared not in alloc.free[L]
        alloc.decref(L, shared)              # last owner drops it
        assert shared in alloc.free[L]
        assert alloc.refcount[L][shared] == 0

    def test_install_adopted_rows(self):
        alloc = tserve.PageAllocator(_cfg(), batch=2, cache_len=CACHE_LEN,
                                     page_size=PAGE, extra_seqs=1)
        (L, npp), = alloc.classes.items()
        donor = alloc.alloc(0)
        adopted = int(donor[L][0])
        alloc.incref(L, adopted)             # slot 1's lease on the page
        fresh = alloc.alloc_pages(L, npp - 1)
        row = np.concatenate([[adopted], fresh]).astype(np.int32)
        alloc.install(1, {L: row})
        with pytest.raises(ValueError, match="already holds"):
            alloc.install(1, {L: row})
        assert alloc.refcount[L][adopted] == 2
        alloc.free_slot(1)
        assert alloc.refcount[L][adopted] == 1   # donor still owns it
        assert all(alloc.refcount[L][p] == 0 for p in fresh)

    def test_headroom_capacity(self):
        alloc = tserve.PageAllocator(_cfg(), batch=2, cache_len=CACHE_LEN,
                                     page_size=PAGE, extra_seqs=2)
        (L, npp), = alloc.classes.items()
        alloc.alloc(0)
        alloc.alloc(1)
        assert alloc.n_free(L) == 2 * npp    # extra_seqs' worth left over
        assert alloc.junk[L] == 4 * npp


class TestPrefixCacheTrie:
    def _alloc(self, extra=2):
        alloc = tserve.PageAllocator(_cfg(), batch=2, cache_len=CACHE_LEN,
                                     page_size=PAGE, extra_seqs=extra)
        return alloc, tserve.PrefixCache(alloc, PAGE)

    def _publish(self, alloc, trie, prompt, b=0):
        rows = alloc.alloc(b)
        path, new_idx = trie.insert(prompt, rows)
        return rows, path, new_idx

    def test_lookup_full_partial_and_cap(self):
        alloc, trie = self._alloc()
        prompt = tuple(range(100, 100 + 24))          # 3 full pages
        rows, path, new_idx = self._publish(alloc, trie, prompt)
        assert len(path) == 3 and new_idx == [0, 1, 2]
        full, partial = trie.lookup(prompt)           # capped at len - 1
        assert len(full) == 2 and partial is not None
        assert partial[1] == PAGE - 1
        div = prompt[:12] + (7, 7) + prompt[14:]      # diverges in page 1
        full, partial = trie.lookup(div)
        assert len(full) == 1 and partial[1] == 4
        full, partial = trie.lookup((prompt[0], 9, 9, 9, 9, 9, 9, 9, 1, 2))
        assert full == [] and partial[1] == 1
        full, partial = trie.lookup(tuple(range(500, 524)))
        assert full == [] and partial is None
        assert 0.0 < trie.hit_rate < 1.0

    def test_lease_blocks_eviction(self):
        alloc, trie = self._alloc()
        (L,) = alloc.classes
        prompt = tuple(range(16))
        rows, path, _ = self._publish(alloc, trie, prompt)
        alloc.free_slot(0)                   # trie is now the only owner
        full, _ = trie.lookup(prompt + (1, 2, 3))
        trie.lease(full)
        trie.evict_for(L, 10 ** 9)           # "evict everything you can"
        assert trie.n_nodes == 2             # leased path survives
        trie.release(full)
        for p in full:                       # drop the lease's page refs
            alloc.decref(L, p.pages[L])
        trie.release(path)                   # inserting slot retires
        trie.evict_for(L, 10 ** 9)
        assert trie.n_nodes == 0             # now LRU-evictable
        with pytest.raises(RuntimeError, match="over-released"):
            trie.release(path)

    def test_eviction_roundtrip_under_pressure(self):
        alloc, trie = self._alloc(extra=1)
        (L, npp), = alloc.classes.items()
        for i in range(6):
            trie.evict_for(L, npp)
            prompt = tuple(range(i * 50, i * 50 + 16))
            rows, path, _ = self._publish(alloc, trie, prompt, b=0)
            trie.release(path)               # slot retires immediately
            alloc.free_slot(0)
        assert trie.n_nodes > 0
        total = (alloc.batch + 1) * npp
        held = sum(int(alloc.refcount[L][p]) for p in range(total))
        assert held + alloc.n_free(L) == total
        assert all(alloc.refcount[L][p] in (0, 1) for p in range(total))


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n=10, rate=100.0, n_prefixes=3, prefix_len=16, suffix_lens=(4, 8),
         gen_lens=(2, 4, 8), seed=3),
    dict(n=16, rate=0.5, n_prefixes=4, prefix_len=256,
         suffix_lens=(64, 192), gen_lens=(16, 32), seed=0),
])
def test_shared_prefix_requests_match_jax(kw):
    kw = dict(kw)
    n, rate = kw.pop("n"), kw.pop("rate")
    t = tserve.shared_prefix_requests(n, rate, 1000, **kw)
    j = jserve.shared_prefix_requests(n, rate, 1000, **kw)
    assert [dataclasses.astuple(r) for r in t] == \
        [dataclasses.astuple(r) for r in j]


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               dtype=torch.float32)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _shared_reqs(vocab, n=10, rate=100.0, seed=3, n_prefixes=3):
    return tserve.shared_prefix_requests(
        n, rate, vocab, n_prefixes=n_prefixes, prefix_len=16,
        suffix_lens=(4, 8), gen_lens=(2, 4, 8), seed=seed)


def _to_jax(reqs):
    return [jserve.Request(**dataclasses.asdict(r)) for r in reqs]


def _pair(model, reqs, **knobs):
    jcfg, tcfg, jp, tp = model
    want = jserve.ServeEngine(jcfg, jp, jserve.ServeConfig(
        **knobs, **SCFG)).run(_to_jax(reqs))
    got = tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
        **knobs, **SCFG)).run(reqs)
    return got, want


@pytest.mark.parametrize("case", ["chunked", "prefix", "prefix_pressure",
                                  "prefix_staggered"])
def test_engine_matches_jax(model, case):
    vocab = model[0].vocab_size
    reqs, knobs = {
        "chunked": (_shared_reqs(vocab), dict(prefill_chunk=8)),
        "prefix": (_shared_reqs(vocab), dict(prefix_cache=True)),
        "prefix_pressure": (_shared_reqs(vocab, n=12, n_prefixes=6, seed=9),
                            dict(prefix_cache=True, prefix_seqs=1)),
        "prefix_staggered": (_shared_reqs(vocab, rate=0.5, seed=5),
                             dict(prefix_cache=True)),
    }[case]
    got, want = _pair(model, reqs, **knobs)
    assert got.outputs == want.outputs
    assert got.prefill_chunks == want.prefill_chunks > 0
    assert got.prefix_hit_rate == want.prefix_hit_rate
    assert got.decode_steps == want.decode_steps
    assert got.ttft_p50 == want.ttft_p50
    assert got.latency_p99 == want.latency_p99
    if knobs.get("prefix_cache"):
        assert got.prefix_hit_rate > 0.3


def test_prefix_cache_saves_chunks_and_matches_static(model):
    _, tcfg, _, tp = model
    reqs = _shared_reqs(tcfg.vocab_size)
    run = lambda **kw: tserve.ServeEngine(  # noqa: E731
        tcfg, tp, tserve.ServeConfig(**kw, **SCFG)).run(reqs)
    static = run(continuous=False)
    chunked = run(prefill_chunk=8)
    cached = run(prefix_cache=True)
    assert chunked.outputs == static.outputs == cached.outputs
    assert cached.prefill_chunks < chunked.prefill_chunks
    assert static.prefill_chunks == 0 and static.prefix_hit_rate == 0.0


def test_near_complete_hit_goes_through_the_tail(model):
    """A prompt whose first 16 tokens are cached and whose last two are
    new adopts two full pages, plans no chunk and teacher-forces the two
    tokens through the decode path; tokens as the JAX engine and as the
    whole-prompt static run."""
    _, tcfg, _, tp = model
    rng = np.random.default_rng(11)
    base = tuple(int(t) for t in rng.integers(0, tcfg.vocab_size, 17))
    reqs = [Request(0, 0.0, base, 4),
            Request(1, 12.0, base[:16] + (5, 6), 5)]
    got, want = _pair(model, reqs, prefix_cache=True)
    assert got.outputs == want.outputs
    assert got.prefill_chunks == want.prefill_chunks == 3   # all request 0
    assert got.prefix_hit_rate == want.prefix_hit_rate == 16 / 35
    static = tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
        continuous=False, **SCFG)).run(reqs)
    assert got.outputs == static.outputs


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _nucleus_numpy(lf, top_p):
    """repro/serve/engine.py's nucleus rule, transcribed to numpy."""
    srt = np.sort(lf, axis=-1)[:, ::-1]
    e = np.exp(srt - srt.max(-1, keepdims=True))
    pr = e / e.sum(-1, keepdims=True)
    cum = np.cumsum(pr, axis=-1)
    keep = cum - pr < top_p
    cutoff = np.min(np.where(keep, srt, np.inf), axis=-1)
    return np.where(lf >= cutoff[:, None], lf, -np.inf)


@pytest.mark.parametrize("top_p", [0.3, 0.6, 0.9])
def test_nucleus_filter_matches_the_jax_rule(top_p):
    """Over the values the engine filters at (it skips the filter at
    top_p 1, as the JAX engine does)."""
    rng = np.random.default_rng(4)
    lf = rng.standard_normal((6, 50)).astype(np.float32) * 3
    lf[0, :10] = 2.5                 # a tie at the cutoff: all kept
    lf[1] = 0.0                      # a flat row
    lf[2, 7] = 40.0                  # one token holds all the mass
    got = tengine.nucleus_filter(torch.from_numpy(lf), top_p).numpy()
    want = _nucleus_numpy(lf, top_p)
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[2]).sum() == 49
    # the kept set is whole at the tie: every 2.5 kept or none
    assert len({bool(np.isfinite(x)) for x in got[0, :10]}) == 1


def test_sample_tokens_inverts_the_cdf():
    logits = torch.tensor([[0.0, 0.0, -torch.inf, 0.0],
                           [5.0, -torch.inf, -torch.inf, -torch.inf]])
    cuts = [(0.0, 0), (0.3, 0), (0.34, 1), (0.5, 1), (0.67, 3), (0.999, 3)]
    for u, want in cuts:
        got = tengine.sample_tokens(logits, torch.tensor([u, u]), 1.0, 1.0)
        assert got.tolist() == [want, 0]
    # a draw depends on (seed, rid, ctr) only, and is an exact f32
    u = tengine.draw_uniform(7, 3, 2)
    assert u == tengine.draw_uniform(7, 3, 2) and 0.0 <= u < 1.0
    assert float(np.float32(u)) == u
    assert len({tengine.draw_uniform(7, r, c) for r in range(4)
                for c in range(4)}) == 16


def test_sampling_is_schedule_invariant(model):
    """Continuous + prefix-cached and static schedules draw identical
    tokens; they differ from greedy and change with the seed."""
    _, tcfg, _, tp = model
    reqs = _shared_reqs(tcfg.vocab_size)
    kw = dict(temperature=0.8, top_p=0.9, sample_seed=7)
    run = lambda **k: tserve.ServeEngine(  # noqa: E731
        tcfg, tp, tserve.ServeConfig(**k, **SCFG)).run(reqs).outputs
    a = run(continuous=True, prefix_cache=True, **kw)
    b = run(continuous=False, **kw)
    assert a == b
    assert a != run(continuous=False)                 # it actually sampled
    assert b != run(continuous=False, temperature=0.8, top_p=0.9,
                    sample_seed=8)                    # the seed matters
