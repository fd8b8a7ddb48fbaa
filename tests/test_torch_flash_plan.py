"""The bf16 flash-attention kernels' plan and rounding, on the CPU.

``flash_attention.plan`` states the tiles, grids and shared memory of the
CUDA kernels (the card's tests hold the built kernels to the same bytes);
here it is held to the H100's limits and to the rule that a row's result
does not depend on the batch.  The bf16 kernels feed their tensor-core
products bf16 operands and sum in f32: the forward splits P into two bf16
parts (P_hi = bf16(P), P_lo = bf16(P - P_hi)), the backward rounds P and
dS to bf16 once.  An emulation of that rounding in plain torch, written
here and not in the package, is held to f64 attention and its autograd at
half of the card's gates (forward rtol/atol 2e-2, backward a normalized
2e-2), so the gates keep a margin over what the rounding alone costs,
at Sq == Sk and at the vision model's cross-attention lengths (Sq != Sk,
non-causal), where the backward's two grids walk the two lengths apart.
The wrappers' checks of lengths and strides come before their device
check, so their refusals are held here too.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    SMEM_LIMIT, SMS, FlashAttention, flash_attention, flash_attention_bwd,
    plan)

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
# the training shapes: llama3.2-1b (B4 S512 H32 KV8 hd64) and
# recurrentgemma-2b (B4 S512 H10 KV1 hd256)
TRAINING = [(4, 512, 32, 8, 64), (4, 512, 10, 1, 256)]


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_shared_memory(hd, dtype):
    p = plan(512, 512, 8, 2, hd, dtype)
    assert p["hd_tile"] >= hd
    for kind in ("fwd", "dkdv", "dq"):
        assert 0 < p[kind]["smem"] <= SMEM_LIMIT, (kind, p[kind])
        assert p[kind]["threads"] in (128, 256)


@pytest.mark.parametrize("B,S,H,KV,hd", TRAINING)
def test_plan_fills_the_card_at_the_training_shapes(B, S, H, KV, hd):
    """Each bf16 backward pass (dK/dV, dQ) launches at least one block per
    SM at the training shapes; so does the forward."""
    p = plan(S, S, H, KV, hd, torch.bfloat16)
    for kind in ("dkdv", "dq", "fwd"):
        blocks = int(np.prod(p[kind]["grid"])) * B
        assert blocks >= SMS, (kind, blocks)


@pytest.mark.parametrize("S,H,KV,hd", [(512, 32, 8, 64), (512, 10, 1, 256),
                                       (4096, 10, 1, 256), (300, 15, 5, 64),
                                       (100, 4, 4, 32)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_is_independent_of_the_batch(S, H, KV, hd, dtype):
    """The plan takes no batch size: grids are per batch row, the launch
    adds B as its last dimension, and B = 1 and B = 4 get the same
    tiles."""
    assert list(inspect.signature(plan).parameters) == \
        ["Sq", "Sk", "H", "KV", "hd", "dtype"]
    p = plan(S, S, H, KV, hd, dtype)
    assert p == plan(S, S, H, KV, hd, dtype)
    group = H // KV
    assert group % p["heads_per_block"] == 0
    assert p["split"] * p["heads_per_block"] == group \
        if dtype == torch.bfloat16 else p["split"] == 1
    for kind in ("fwd", "dkdv", "dq"):
        rows = p[kind]["rows"]
        assert p[kind]["grid"][0] == -(-S // rows)
    for B in (1, 4):
        assert [(*p[k]["grid"], B) for k in ("fwd", "dq")] == \
            [(-(-S // p[k]["rows"]), H, B) for k in ("fwd", "dq")]


def test_plan_splits_long_sequences_into_head_chunks():
    """Where the key tiles alone fill the card twice (S 4096, one kv head
    of ten q heads), a dK/dV block walks a chunk of q heads and fewer
    partials are summed; at S 512 every q head is its own partial."""
    long = plan(4096, 4096, 10, 1, 256, torch.bfloat16)
    assert long["heads_per_block"] == 2 and long["split"] == 5
    short = plan(512, 512, 10, 1, 256, torch.bfloat16)
    assert short["heads_per_block"] == 1 and short["split"] == 10


# ---------------------------------------------------------------------------
# the kernels' bf16 rounding, emulated
# ---------------------------------------------------------------------------

def _mask(S, causal, window, Sk=None):
    Sk = S if Sk is None else Sk
    qp = torch.arange(S)[:, None]
    kp = torch.arange(Sk)[None, :]
    live = kp <= qp if causal else torch.ones(S, Sk, dtype=torch.bool)
    if window > 0:
        live = live & (kp > qp - window)
    return live


def _attention_f64(q, k, v, causal, window):
    """Plain attention in f64: q (B,Sq,H,hd), k/v (B,Sk,KV,hd)."""
    H, KV = q.shape[2], k.shape[2]
    k = k.repeat_interleave(H // KV, 2)
    v = v.repeat_interleave(H // KV, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~_mask(q.shape[1], causal, window, k.shape[1]),
                      float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_fwd(q, k, v, causal, window, keys):
    """The forward kernel's arithmetic: f32 scores of bf16 inputs, online
    softmax over key tiles of ``keys`` (the last one partial where Sk is
    not a multiple), P as the sum of two bf16 parts in P V, f32 sums, the
    output rounded to bf16.  Returns (out, lse)."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    group = H // k.shape[2]
    kf = k.repeat_interleave(group, 2)
    vf = v.repeat_interleave(group, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * hd ** -0.5
    live = _mask(S, causal, window, Sk)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, Sk, keys):
        st = s[..., k0:k0 + keys]
        lt = live[:, k0:k0 + keys]
        st = st.masked_fill(~lt, -1e30)
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new) * lt
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = _bf16(p)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd",
                                         p_hi + _bf16(p - p_hi),
                                         vf[:, k0:k0 + keys])
        m = m_new
    out = _bf16((acc / l).transpose(1, 2))
    return out, (m + torch.log(l))[..., 0]


def _emulate_bwd(q, k, v, o, do, lse, causal, window):
    """The backward kernels' arithmetic: P = exp(scale q.k - lse) in f32,
    dS = P (dP - D) in f32, both rounded to bf16 as operands of dV = P^T
    dO, dK = scale dS^T Q and dQ = scale dS K with f32 sums; the group's
    partial dK/dV summed in f32; outputs rounded to bf16.  q, o, do (B,
    Sq, H, hd), k, v (B, Sk, KV, hd)."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = hd ** -0.5
    kf = k.repeat_interleave(group, 2)
    vf = v.repeat_interleave(group, 2)
    live = _mask(S, causal, window, Sk)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * scale
    p = torch.exp(s - lse[..., None]) * live
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    D = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - D)
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), do)
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), q)
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kf) * scale
    dk = dk.reshape(B, Sk, KV, group, hd).sum(3) * scale
    dv = dv.reshape(B, Sk, KV, group, hd).sum(3)
    return _bf16(dq), _bf16(dk), _bf16(dv)


EMU_CASES = [(hd, H, KV, causal, window)
             for hd in (64, 256)
             for H, KV in ((8, 2), (10, 1))
             for causal, window in ((True, 0), (True, 24))]


@pytest.mark.parametrize("hd,H,KV,causal,window", EMU_CASES)
def test_bf16_rounding_keeps_the_gates_margin(hd, H, KV, causal, window):
    rng = np.random.default_rng(hd * 100 + H + window)
    B, S = 2, 96
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.standard_normal((B, S, n, hd)).astype(np.float32)))
        for n in (H, KV, KV, H))
    keys = plan(S, S, H, KV, hd, torch.bfloat16)["fwd"]["cols"]
    out, lse = _emulate_fwd(q, k, v, causal, window, keys)

    ins = [t.double().requires_grad_() for t in (q, k, v)]
    want = _attention_f64(*ins, causal, window)
    torch.testing.assert_close(out.double(), want.detach(), rtol=1e-2,
                               atol=1e-2)

    grads = _emulate_bwd(q, k, v, out, do, lse, causal, window)
    wants = torch.autograd.grad(want, ins, do.double())
    for g, w in zip(grads, wants):
        err = ((g.double() - w).abs().max() / w.abs().max()).item()
        assert err <= 1e-2, err


# the vision model's cross-attention (non-causal, Sq != Sk): one decode row
# or a prompt against 1600 media keys, a ragged key tail (1601, 8), and
# gemma3-like head dim 256 tiles of 32 keys
XATTN = [(1, 1600, 32, 8, 128), (300, 1600, 32, 8, 128),
         (1, 1601, 32, 8, 128), (77, 8, 4, 2, 16), (5, 100, 8, 4, 256)]


@pytest.mark.parametrize("Sq,Sk,H,KV,hd", XATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_cross_attention_shapes(Sq, Sk, H, KV, hd, dtype):
    """The forward's grid walks Sq's q tiles (one at a decode row), its
    tiles and shared memory do not depend on the key length, and the key
    tiles cover Sk with a partial last tile where Sk is not a multiple."""
    p = plan(Sq, Sk, H, KV, hd, dtype)
    f = p["fwd"]
    assert f["grid"] == (-(-Sq // f["rows"]), H)
    assert f == plan(Sq, Sq, H, KV, hd, dtype)["fwd"]
    assert f["cols"] == (64 if dtype == torch.float32 or hd <= 128 else 32)
    tiles = -(-Sk // f["cols"])
    assert (tiles - 1) * f["cols"] < Sk <= tiles * f["cols"]


@pytest.mark.parametrize("Sq,Sk,H,KV,hd", XATTN)
def test_bf16_rounding_keeps_the_gates_margin_at_cross_lengths(Sq, Sk, H,
                                                               KV, hd):
    """The forward's bf16 arithmetic at Sq != Sk, non-causal, the ragged
    key tail's dead keys at probability 0, against f64 attention at half
    the card's 2e-2 gate."""
    rng = np.random.default_rng(Sq * 7 + Sk)
    q = _bf16(torch.from_numpy(
        rng.standard_normal((1, Sq, H, hd)).astype(np.float32)))
    k, v = (_bf16(torch.from_numpy(
        rng.standard_normal((1, Sk, KV, hd)).astype(np.float32)))
        for _ in range(2))
    keys = plan(Sq, Sk, H, KV, hd, torch.bfloat16)["fwd"]["cols"]
    out, lse = _emulate_fwd(q, k, v, False, 0, keys)
    want = _attention_f64(q.double(), k.double(), v.double(), False, 0)
    assert out.shape == (1, Sq, H, hd)
    torch.testing.assert_close(out.double(), want, rtol=1e-2, atol=1e-2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                     k.double().repeat_interleave(H // KV, 2)) * hd ** -0.5
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Sq,Sk,H,KV,hd", XATTN)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_backward_at_cross_lengths(Sq, Sk, H, KV, hd, dtype):
    """The backward at Sq != Sk: dK/dV's grid walks Sk's key tiles, dQ's
    Sq's q tiles; the q heads a dK/dV block walks follow Sk alone; shared
    memory depends on neither length."""
    p = plan(Sq, Sk, H, KV, hd, dtype)
    kv, dq = p["dkdv"], p["dq"]
    assert kv["grid"] == (-(-Sk // kv["rows"]),
                          KV * (H // KV // p["heads_per_block"]))
    assert dq["grid"] == (-(-Sq // dq["rows"]), H)
    for other_sq in (1, Sq, 4096):
        q_side = plan(other_sq, Sk, H, KV, hd, dtype)
        assert q_side["heads_per_block"] == p["heads_per_block"]
        assert q_side["dkdv"] == kv
    assert p["heads_per_block"] == plan(Sk, Sk, H, KV, hd,
                                        dtype)["heads_per_block"]
    square = plan(512, 512, H, KV, hd, dtype)
    for kind in ("dkdv", "dq"):
        assert p[kind]["smem"] == square[kind]["smem"] <= SMEM_LIMIT
        assert p[kind]["rows"] == square[kind]["rows"]


@pytest.mark.parametrize("Sq,Sk,H,KV,hd", XATTN)
def test_bf16_backward_rounding_keeps_the_gates_margin_at_cross_lengths(
        Sq, Sk, H, KV, hd):
    """The backward's bf16 arithmetic at Sq != Sk, non-causal (the dead
    keys of a ragged tail and the dead rows past Sq at probability 0),
    from the emulated forward's bf16 output and lse, against f64 autograd
    of plain attention at half the card's normalized 2e-2 gate."""
    rng = np.random.default_rng(Sq * 11 + Sk)
    q, do = (_bf16(torch.from_numpy(
        rng.standard_normal((1, Sq, H, hd)).astype(np.float32)))
        for _ in range(2))
    k, v = (_bf16(torch.from_numpy(
        rng.standard_normal((1, Sk, KV, hd)).astype(np.float32)))
        for _ in range(2))
    keys = plan(Sq, Sk, H, KV, hd, torch.bfloat16)["fwd"]["cols"]
    out, lse = _emulate_fwd(q, k, v, False, 0, keys)
    grads = _emulate_bwd(q, k, v, out, do, lse, False, 0)
    ins = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(_attention_f64(*ins, False, 0), ins,
                               do.double())
    for g, w, t in zip(grads, want, (q, k, v)):
        assert g.shape == t.shape
        err = ((g.double() - w).abs().max() / w.abs().max()).item()
        assert err <= 1e-2, err


def test_flash_wrappers_check_lengths_and_strides_before_the_device():
    """Both wrappers refuse causal or windowed Sq != Sk and a strided head
    dim, whatever the device; non-causal Sq != Sk passes those checks (it
    reaches the device check), and a gradient wanted there is no longer
    refused by ``FlashAttention`` (on the CPU it reaches the same check:
    no fallback to the plain version)."""
    q = torch.zeros((1, 4, 4, 64))
    k = torch.zeros((1, 1600, 2, 64))
    lse = torch.zeros((1, 4, 4))
    fwd = lambda *a, **kw: flash_attention(*a, **kw)          # noqa: E731
    bwd = lambda q_, k_, v_, **kw: flash_attention_bwd(       # noqa: E731
        q_, k_, v_, q_, q_, lse, **kw)
    for fn in (fwd, bwd):
        for kw in (dict(causal=True), dict(causal=False, window=8),
                   dict(causal=True, window=8)):
            with pytest.raises(ValueError, match="Sq != Sk"):
                fn(q, k, k, **kw)
        strided = k.transpose(2, 3).contiguous().transpose(2, 3)
        for args in ((q, strided, k), (q, k, strided)):
            with pytest.raises(ValueError, match="head dim must be "
                                                 "contiguous"):
                fn(*args, causal=False)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(q, k, k, causal=False)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        FlashAttention.apply(q.clone().requires_grad_(), k, k, False, 0)
