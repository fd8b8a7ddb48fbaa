"""The port's serving engine and paged cache.

* Greedy outputs of the port's ``ServeEngine`` equal the JAX engine's at
  f32 on the ``steps`` clock, from the same numpy parameters and requests
  (both packages draw the same workload from one seed).
* Continuous == static inside the port (scheduling never changes tokens).
* The engine's configuration checks and the CLI's chunked, prefix-cached,
  sampled path on the CPU (their parity with JAX: test_torch_prefix.py).
* Allocator churn, exhaustion and evict/rejoin oracles mirroring
  tests/test_paged_cache.py, with JAX's per-sequence dense decode as the
  token oracle.
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
from repro_torch import resolve_device  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(1)

ARCH = "llama3.2-1b"
CACHE_LEN, PAGE = 32, 8
SCFG = dict(batch_size=3, page_size=PAGE, cache_len=CACHE_LEN, clock="steps")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               dtype=torch.float32)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _requests(vocab, rate, seed, n=8):
    kw = dict(prompt_lens=(8, 16), gen_lens=(2, 4, 8), seed=seed)
    t = tserve.open_loop_requests(n, rate, vocab, **kw)
    j = jserve.open_loop_requests(n, rate, vocab, **kw)
    assert [dataclasses.astuple(r) for r in t] == \
        [dataclasses.astuple(r) for r in j]
    return t, j


@pytest.mark.parametrize("rate,seed", [(100.0, 3), (0.5, 5)])
def test_greedy_outputs_match_jax_engine(model, rate, seed):
    jcfg, tcfg, jp, tp = model
    treqs, jreqs = _requests(jcfg.vocab_size, rate, seed)
    want = jserve.ServeEngine(jcfg, jp, jserve.ServeConfig(**SCFG)) \
        .run(jreqs)
    got = tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(**SCFG)) \
        .run(treqs)
    assert got.outputs == want.outputs
    assert got.decode_steps == want.decode_steps
    assert got.latency_p50 == want.latency_p50
    assert got.utilization == want.utilization


def test_continuous_equals_static_and_wins_under_load(model):
    _, tcfg, _, tp = model
    treqs, _ = _requests(tcfg.vocab_size, 100.0, 3, n=10)
    reps = {cont: tserve.ServeEngine(
        tcfg, tp, tserve.ServeConfig(continuous=cont, **SCFG)).run(treqs)
        for cont in (True, False)}
    assert reps[True].outputs == reps[False].outputs
    for r in treqs:
        assert len(reps[True].outputs[r.rid]) == r.gen_len
    assert reps[True].decode_steps < reps[False].decode_steps
    assert reps[True].utilization > reps[False].utilization


def test_raw_tree_wrapped_as_serving_copy(model):
    _, _, _, tp = model
    cfg = tconfigs.get_smoke_config(ARCH)              # bf16 compute
    eng = tserve.ServeEngine(cfg, tp, tserve.ServeConfig(**SCFG))
    assert isinstance(eng.db, tserve.StaticParams)
    served = eng.db.get()
    mix = served["groups"]["g0"]["s0"]["mix"]
    assert mix["wq"].dtype == torch.bfloat16
    assert served["embedding"].dtype == torch.bfloat16
    # norm scales stay f32: they are read as f32, never cast to cfg.dtype
    assert served["final_norm"]["scale"].dtype == torch.float32
    assert served["groups"]["g0"]["s0"]["ln1"]["scale"] is \
        tp["groups"]["g0"]["s0"]["ln1"]["scale"]


def test_config_validation(model):
    """As tests/test_serve_engine.py: the chunked path needs continuous
    batching, top_p lies in (0, 1], temperature is >= 0, the prefix cache
    implies a page-sized chunk, and a chunk longer than the smallest ring
    is refused (its scatter slots would not be unique)."""
    with pytest.raises(ValueError, match="continuous"):
        tserve.ServeConfig(continuous=False, prefill_chunk=8, **SCFG)
    with pytest.raises(ValueError, match="top_p"):
        tserve.ServeConfig(top_p=0.0, **SCFG)
    with pytest.raises(ValueError, match="temperature"):
        tserve.ServeConfig(temperature=-0.5, **SCFG)
    scfg = tserve.ServeConfig(prefix_cache=True, **SCFG)
    assert scfg.prefill_chunk == SCFG["page_size"]
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="smallest"):
        tserve.ServeEngine(tcfg, tp, tserve.ServeConfig(
            prefill_chunk=CACHE_LEN + PAGE, **SCFG))


def test_unported_arch_names_its_slice():
    with pytest.raises(KeyError, match="slice 7 \\(rest of the zoo"):
        tconfigs.get_config("gemma3-4b")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-model")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.init_paged_cache(tconfigs.get_smoke_config(ARCH), 2,
                                    CACHE_LEN, PAGE)
    assert resolve_device("cpu").type == "cpu"


def test_serving_cli_on_cpu(capsys):
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "5", "--rate", "50", "--batch", "2",
                          "--gen", "4", "--seed", "1"])
    rep = out["report"]
    assert rep.n_requests == 5 and rep.total_tokens == 5 * 4
    assert all(len(t) == 4 for t in rep.outputs.values())
    assert "continuous on cpu" in capsys.readouterr().out


def test_serving_cli_prefix_cache_and_sampling_on_cpu(capsys):
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "6", "--rate", "50", "--batch", "2",
                          "--gen", "4", "--seed", "1", "--shared-prefix",
                          "--prefix-cache", "--temperature", "0.8",
                          "--top-p", "0.9"])
    rep = out["report"]
    assert rep.n_requests == 6 and rep.total_tokens == 6 * 4
    assert rep.prefill_chunks > 0 and rep.prefix_hit_rate > 0.0
    assert "prefix hit rate" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# allocator and evict/rejoin oracles (as tests/test_paged_cache.py)
# ---------------------------------------------------------------------------

class TestPageAllocator:
    def test_indivisible_page_size_rejected(self):
        cfg = tconfigs.get_smoke_config(ARCH)
        with pytest.raises(ValueError, match="must divide"):
            tserve.page_classes(cfg, cache_len=32, page_size=5)

    def test_churn_and_reuse(self):
        cfg = tconfigs.get_smoke_config(ARCH)
        alloc = tserve.PageAllocator(cfg, batch=3, cache_len=CACHE_LEN,
                                     page_size=PAGE)
        (L, npp), = alloc.classes.items()
        total = 3 * npp
        rows0 = alloc.alloc(0)
        rows1 = alloc.alloc(1)
        assert alloc.n_free(L) == total - 2 * npp
        assert not set(rows0[L]) & set(rows1[L])     # disjoint pages
        assert alloc.junk[L] not in set(rows0[L]) | set(rows1[L])
        alloc.free_slot(0)
        assert alloc.n_free(L) == total - npp
        rows2 = alloc.alloc(2)                       # reuses freed pages
        assert set(rows2[L]) == set(rows0[L])
        assert (alloc.tables[L][0] == alloc.junk[L]).all()

    def test_double_alloc_and_exhaustion(self):
        cfg = tconfigs.get_smoke_config(ARCH)
        alloc = tserve.PageAllocator(cfg, batch=2, cache_len=CACHE_LEN,
                                     page_size=PAGE)
        alloc.alloc(0)
        with pytest.raises(ValueError, match="already holds"):
            alloc.alloc(0)
        (L,) = alloc.classes
        alloc.free[L].clear()                        # pool drained
        with pytest.raises(RuntimeError, match="exhausted"):
            alloc.alloc(1)

    def test_over_free_raises(self):
        cfg = tconfigs.get_smoke_config(ARCH)
        alloc = tserve.PageAllocator(cfg, batch=1, cache_len=CACHE_LEN,
                                     page_size=PAGE)
        (L,) = alloc.classes
        page = alloc.alloc_pages(L, 1)
        alloc.decref(L, page)
        with pytest.raises(RuntimeError, match="over-freed"):
            alloc.decref(L, page)


def _dense_tokens(jcfg, jp, prompt, n_steps):
    """JAX per-sequence (B=1) dense-ring greedy decode: the oracle."""
    logits, cache = jtf.prefill(jp, jnp.asarray([prompt], jnp.int32), jcfg,
                                cache_len=CACHE_LEN)
    decode = jax.jit(lambda p, c, t, q: jtf.decode_step(p, c, t, q, jcfg))
    tok, pos = int(jnp.argmax(logits[0])), len(prompt)
    toks = [tok]
    for _ in range(n_steps):
        lg, cache = decode(jp, cache, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray(pos, jnp.int32))
        tok = int(jnp.argmax(lg[0, -1]))
        toks.append(tok)
        pos += 1
    return toks


def test_evict_rejoin_roundtrip(model):
    """Evicting a slot and rejoining a new sequence onto recycled pages
    leaves the survivor untouched, and the rejoined sequence decodes
    exactly as it would alone."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(1)
    p0, p1, p2 = (tuple(int(t) for t in rng.integers(0, jcfg.vocab_size, n))
                  for n in (6, 4, 6))
    want0 = _dense_tokens(jcfg, jp, p0, 6)
    want2 = _dense_tokens(jcfg, jp, p2, 2)

    B = 2
    alloc = tserve.PageAllocator(tcfg, B, CACHE_LEN, PAGE)
    cache = tserve.init_paged_cache(tcfg, B, CACHE_LEN, PAGE, device="cpu")
    join = tserve.make_join_fn(tcfg, CACHE_LEN, PAGE)
    evict = tserve.make_evict_fn(tcfg, CACHE_LEN, PAGE)
    tok = np.zeros((B, 1), np.int64)
    pos = np.zeros((B,), np.int64)

    def join_seq(b, prompt):
        nonlocal cache
        logits, dense = ttf.prefill(tp, torch.tensor([prompt]), tcfg,
                                    cache_len=CACHE_LEN)
        rows = {L: torch.from_numpy(ids) for L, ids in alloc.alloc(b).items()}
        cache = join(cache, dense, b, rows)
        tok[b, 0] = int(torch.argmax(logits[0]))
        pos[b] = len(prompt)

    def step():
        nonlocal cache
        lg, cache = ttf.decode_step(tp, cache, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tcfg)
        nxt = torch.argmax(lg[:, -1], -1).numpy()
        tok[:, 0] = nxt
        pos[:] += 1
        return nxt

    join_seq(0, p0)
    join_seq(1, p1)
    got0 = [int(tok[0, 0])]
    for _ in range(3):
        got0.append(int(step()[0]))
    cache = evict(cache, 1)                      # sequence 1 leaves
    alloc.free_slot(1)
    assert (cache["g0"]["s0"]["pt"][:, 1] ==
            cache["g0"]["s0"]["pk"].shape[1] - 1).all()
    tok[1, 0] = 0
    pos[1] = 0
    got0.append(int(step()[0]))                  # survivor with an idle row
    join_seq(1, p2)                              # rejoin on recycled pages
    got2 = [int(tok[1, 0])]
    for _ in range(2):
        nxt = step()
        got0.append(int(nxt[0]))
        got2.append(int(nxt[1]))
    assert got0 == want0[:7]
    assert got2 == want2
