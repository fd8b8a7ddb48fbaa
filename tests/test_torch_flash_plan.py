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
2e-2), so the gates keep a margin over what the rounding alone costs.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    SMEM_LIMIT, SMS, plan)

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
# the training shapes: llama3.2-1b (B4 S512 H32 KV8 hd64) and
# recurrentgemma-2b (B4 S512 H10 KV1 hd256)
TRAINING = [(4, 512, 32, 8, 64), (4, 512, 10, 1, 256)]


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_shared_memory(hd, dtype):
    p = plan(512, 8, 2, hd, dtype)
    assert p["hd_tile"] >= hd
    for kind in ("fwd", "dkdv", "dq"):
        assert 0 < p[kind]["smem"] <= SMEM_LIMIT, (kind, p[kind])
        assert p[kind]["threads"] in (128, 256)


@pytest.mark.parametrize("B,S,H,KV,hd", TRAINING)
def test_plan_fills_the_card_at_the_training_shapes(B, S, H, KV, hd):
    """Each bf16 backward pass (dK/dV, dQ) launches at least one block per
    SM at the training shapes; so does the forward."""
    p = plan(S, H, KV, hd, torch.bfloat16)
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
        ["S", "H", "KV", "hd", "dtype"]
    p = plan(S, H, KV, hd, dtype)
    assert p == plan(S, H, KV, hd, dtype)
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
    long = plan(4096, 10, 1, 256, torch.bfloat16)
    assert long["heads_per_block"] == 2 and long["split"] == 5
    short = plan(512, 10, 1, 256, torch.bfloat16)
    assert short["heads_per_block"] == 1 and short["split"] == 10


# ---------------------------------------------------------------------------
# the kernels' bf16 rounding, emulated
# ---------------------------------------------------------------------------

def _mask(S, causal, window):
    qp = torch.arange(S)[:, None]
    kp = torch.arange(S)[None, :]
    live = kp <= qp if causal else torch.ones(S, S, dtype=torch.bool)
    if window > 0:
        live = live & (kp > qp - window)
    return live


def _attention_f64(q, k, v, causal, window):
    """Plain attention in f64: q (B,S,H,hd), k/v (B,S,KV,hd)."""
    H, KV = q.shape[2], k.shape[2]
    k = k.repeat_interleave(H // KV, 2)
    v = v.repeat_interleave(H // KV, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~_mask(q.shape[1], causal, window), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_fwd(q, k, v, causal, window, keys):
    """The forward kernel's arithmetic: f32 scores of bf16 inputs, online
    softmax over key tiles of ``keys``, P as the sum of two bf16 parts in
    P V, f32 sums, the output rounded to bf16.  Returns (out, lse)."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    kf = k.repeat_interleave(group, 2)
    vf = v.repeat_interleave(group, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * hd ** -0.5
    live = _mask(S, causal, window)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, keys):
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
    partial dK/dV summed in f32; outputs rounded to bf16."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    scale = hd ** -0.5
    kf = k.repeat_interleave(group, 2)
    vf = v.repeat_interleave(group, 2)
    live = _mask(S, causal, window)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * scale
    p = torch.exp(s - lse[..., None]) * live
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    D = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - D)
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), do)
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), q)
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kf) * scale
    dk = dk.reshape(B, S, KV, group, hd).sum(3) * scale
    dv = dv.reshape(B, S, KV, group, hd).sum(3)
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
    keys = plan(S, H, KV, hd, torch.bfloat16)["fwd"]["cols"]
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
