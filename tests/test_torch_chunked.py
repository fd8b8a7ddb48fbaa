"""Chunked prefill of the port against the JAX package, on the CPU.

* ``ref.prefill_page_attention`` (the plain version the CUDA kernel is held
  to on the card) equals JAX's oracle at the shapes of
  tests/test_kernels.py, f32 and bf16, at that file's tolerances; equals
  the Pallas kernel in interpret mode; and reproduces rows of one dense
  causal attention.
* ``transformer.prefill_chunk`` gives JAX's logits and writes the pools as
  JAX does, from the same numpy parameters and cache state, before and
  after the ring wraps.
* Chunks plus activation decode token-identically to JAX's per-sequence
  dense prefill and decode (mirrors tests/test_paged_cache.py).

Inputs are numpy arrays drawn from a seed; the smoke config runs in f32.
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
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

ARCH = "llama3.2-1b"
CACHE_LEN, PAGE = 32, 8


def _ring_positions(start, L, B):
    idx = np.arange(L)
    last = start - 1
    abs_pos = last - np.mod(last - idx, L)          # floor modulo
    ctx = np.where(abs_pos >= 0, abs_pos, -1).astype(np.int32)
    return np.broadcast_to(ctx[None], (B, L)).copy()


def _inputs(seed, B, C, L, H, KV, hd, start):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, C, H, hd), (B, L, KV, hd), (B, L, KV, hd), (B, C, KV, hd),
             (B, C, KV, hd))]
    ctx_pos = _ring_positions(start, L, B)
    q_pos = np.broadcast_to((start + np.arange(C, dtype=np.int32))[None],
                            (B, C)).copy()
    return arrs, ctx_pos, q_pos


def _both(arrs, ctx_pos, q_pos, dtype):
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs] + \
        [torch.from_numpy(ctx_pos), torch.from_numpy(q_pos)]
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs] + \
        [jnp.asarray(ctx_pos), jnp.asarray(q_pos)]
    return t, j


@pytest.mark.parametrize("L,C,H,KV,hd,window", [
    (32, 8, 4, 2, 16, 0),      # GQA, full attention
    (16, 8, 2, 2, 8, 16),      # MHA, windowed ring
    (24, 6, 4, 1, 16, 0),      # ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(L, C, H, KV, hd, window, dtype):
    arrs, ctx_pos, q_pos = _inputs(21, 2, C, L, H, KV, hd, start=10)
    t, j = _both(arrs, ctx_pos, q_pos, dtype)
    got = ref.prefill_page_attention(*t, window=window)
    want = jref.prefill_page_attention(*j, window=window)
    assert got.dtype == TDT[dtype] and got.shape == (2, C, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("start", [0, 10, 45])
def test_ref_matches_pallas_interpret(start):
    """Against the Pallas kernel as the JAX tests run it on the CPU; start 0
    is an all-dead ring, 45 a ring that has wrapped."""
    from repro.kernels.page_gather import prefill_page_attention
    L, C, H, KV, hd = 16, 8, 4, 2, 16
    arrs, ctx_pos, q_pos = _inputs(23, 2, C, L, H, KV, hd, start)
    t, j = _both(arrs, ctx_pos, q_pos, "float32")
    want = prefill_page_attention(*j, window=12, block_k=8, interpret=True)
    got = ops.prefill_page_attention(*t, window=12)     # CPU: the ref path
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_ref_matches_dense_attention():
    """Context slots 0..start-1 + chunk == rows start..start+C-1 of one
    dense causal attention over the whole sequence."""
    rng = np.random.default_rng(22)
    B, S, start, H, KV, hd = 1, 24, 16, 4, 2, 16
    C, L = S - start, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, hd))
                                .astype(np.float32)) for n in (H, KV, KV))
    full = ref.attention(q, k, v, causal=True)
    k_ctx = torch.zeros((B, L, KV, hd))
    v_ctx = torch.zeros((B, L, KV, hd))
    k_ctx[:, :start] = k[:, :start]
    v_ctx[:, :start] = v[:, :start]
    ar = torch.arange(L, dtype=torch.int32)
    ctx_pos = torch.where(ar < start, ar, -1)[None]
    q_pos = (start + torch.arange(C, dtype=torch.int32))[None]
    got = ref.prefill_page_attention(q[:, start:], k_ctx, v_ctx,
                                     k[:, start:], v[:, start:], ctx_pos,
                                     q_pos)
    torch.testing.assert_close(got, full[:, start:], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model: prefill_chunk against JAX
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


def _random_pools(jcfg, tcfg, B, seed):
    """The same random pool contents in a JAX and a port paged cache."""
    rng = np.random.default_rng(seed)
    jc = jserve.init_paged_cache(jcfg, B, CACHE_LEN, PAGE)
    tc = tserve.init_paged_cache(tcfg, B, CACHE_LEN, PAGE, device="cpu")
    for gkey, slots in tc.items():
        for skey, pc in slots.items():
            for name in ("pk", "pv"):
                a = rng.standard_normal(pc[name].shape).astype(np.float32)
                pc[name].copy_(torch.from_numpy(a))
                jc[gkey][skey] = {**jc[gkey][skey], name: jnp.asarray(a)}
    return jc, tc


@pytest.mark.parametrize("start", [0, 8, 36])
def test_prefill_chunk_matches_jax(model, start):
    """Logits and every pool written: start 0 (empty ring), 8 (context of
    one chunk), 36 (the ring of 32 has wrapped: context positions 4..35)."""
    jcfg, tcfg, jp, tp = model
    B, C = 2, 8
    jc, tc = _random_pools(jcfg, tcfg, B, seed=start)
    rng = np.random.default_rng(100 + start)
    toks = rng.integers(0, jcfg.vocab_size, (1, C)).astype(np.int32)
    rows = np.array([5, 2, 7, 0], np.int32)           # the slot's pages
    L = CACHE_LEN
    jlog, jc2, _ = jtf.prefill_chunk(
        jp, jc, jnp.asarray(toks), jnp.asarray(start, jnp.int32),
        {L: jnp.asarray(rows)}, jtf.init_chunk_carry(jcfg), jcfg, CACHE_LEN)
    tlog, tc2, carry = ttf.prefill_chunk(
        tp, tc, torch.from_numpy(toks).long(), start,
        {L: torch.from_numpy(rows)}, ttf.init_chunk_carry(tcfg), tcfg,
        CACHE_LEN)
    assert tlog.shape == (1, tcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    for gkey, slots in tc2.items():
        for skey, pc in slots.items():
            for name in ("pk", "pv"):
                np.testing.assert_allclose(
                    pc[name].numpy(), np.asarray(jc2[gkey][skey][name]),
                    rtol=1e-5, atol=1e-5)
            # the batch page table is untouched until activation
            assert (pc["pt"] == pc["pk"].shape[1] - 1).all()
    assert carry == ttf.init_chunk_carry(tcfg)


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


@pytest.mark.parametrize("S", [16, 20])
def test_chunks_plus_activate_match_dense(model, S):
    """Chunked prefill into junk-tabled pages + activation decodes
    token-identically to dense whole-prompt prefill (S 20: an end-aligned
    final chunk that overlaps its predecessor, as the engine plans it)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    C, n_steps = 8, 4
    prompt = tuple(int(t) for t in rng.integers(0, jcfg.vocab_size, S))
    want = _dense_tokens(jcfg, jp, prompt, n_steps)

    B = 2
    alloc = tserve.PageAllocator(tcfg, B, CACHE_LEN, PAGE)
    cache = tserve.init_paged_cache(tcfg, B, CACHE_LEN, PAGE, device="cpu")
    activate = tserve.make_activate_fn(tcfg, CACHE_LEN, PAGE)
    rows = {L: torch.from_numpy(ids) for L, ids in alloc.alloc(1).items()}
    carry = ttf.init_chunk_carry(tcfg)
    starts = list(range(0, S - C, C)) + [S - C]
    for s0 in starts:
        toks = torch.tensor([prompt[s0:s0 + C]])
        logits, cache, carry = ttf.prefill_chunk(tp, cache, toks, s0, rows,
                                                 carry, tcfg, CACHE_LEN)
    assert (cache["g0"]["s0"]["pt"][:, 1] == alloc.junk[CACHE_LEN]).all()
    cache = activate(cache, 1, rows, carry)
    assert (cache["g0"]["s0"]["pt"][:, 1] == rows[CACHE_LEN]).all()
    tok = np.zeros((B, 1), np.int64)
    pos = np.zeros((B,), np.int64)
    tok[1, 0] = int(torch.argmax(logits[0]))
    pos[1] = S
    got = [int(tok[1, 0])]
    for _ in range(n_steps):
        lg, cache = ttf.decode_step(tp, cache, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tcfg)
        tok[1, 0] = int(torch.argmax(lg[1, -1]))
        pos[1] += 1
        got.append(int(tok[1, 0]))
    assert got == want


def test_copy_page_and_activate_in_place(model):
    _, tcfg, _, _ = model
    cache = tserve.init_paged_cache(tcfg, 2, CACHE_LEN, PAGE, extra_seqs=1,
                                    device="cpu")
    pc = cache["g0"]["s0"]
    pk0 = pc["pk"]
    pc["pk"][:, 3].fill_(1.5)
    pc["pv"][:, 3].fill_(-2.0)
    copy = tserve.make_copy_page_fn(tcfg, CACHE_LEN, PAGE)
    out = copy(cache, 3, 9, L=CACHE_LEN, set_pt=False, b=0, idx=0)
    assert out is cache and pc["pk"] is pk0
    assert (pc["pk"][:, 9] == 1.5).all() and (pc["pv"][:, 9] == -2.0).all()
    junk = pc["pk"].shape[1] - 1
    assert (pc["pt"] == junk).all()
    copy(cache, 3, 10, L=CACHE_LEN, set_pt=True, b=1, idx=2)
    assert (pc["pt"][:, 1, 2] == 10).all()
    assert int((pc["pt"] != junk).sum()) == pc["pt"].shape[0]
    assert pc["pk"].shape[1] == (2 + 1) * (CACHE_LEN // PAGE) + 1
