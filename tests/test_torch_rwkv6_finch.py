"""RWKV-6 in its two forms, on the CPU.

``ModelConfig.mix_lora`` picks the block: 0 the JAX package's (static
sigmoid token shifts, a linear decay LoRA, a per-head RMS norm), above 0
Finch as published (arXiv:2404.05892 §4, RWKV-LM's ``RWKV_Tmix_x060`` and
``RWKV_CMix_x060``).

* At ``mix_lora = 0`` the block's outputs, serving state and gradients are
  bit for bit those recorded from the block before the Finch form was
  added (``rwkv6_jax_form_bits.json``, one thread), so the JAX-parity
  tests hold as they were.
* The Finch form against the benchmark's plain reference
  (``perfbench/reference/``, written from the paper, not from the port):
  the loss and every leaf's gradient under remat ``none`` and ``full``, in
  float32.
* The reference's chunked WKV against the step-by-step recurrence, with
  decays that reach exactly 0.
* Prefill, then decode through the carried state, against the full
  forward's logits, in the Finch form.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import rwkv6_1_6b
from repro_torch.core.sync import SyncConfig
from repro_torch.kernels import ref as kref
from repro_torch.launch.steps import make_lm_grad_fn
from repro_torch.models import paramlib
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as ttf
from repro_torch.tree import leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from perfbench import feed, harness  # noqa: E402
from perfbench.reference import mix_rwkv6 as ref_mix  # noqa: E402
from perfbench.reference import model as ref_model  # noqa: E402

RECORDED = Path(__file__).with_name("rwkv6_jax_form_bits.json")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEED = 2 ** 31 + 38
CPU = torch.device("cpu")
# Finch at smoke widths, as the benchmark's configuration file states it
FINCH = {
    "name": "tiny-finch", "family": "ssm",
    "groups": [{"pattern": ["rwkv6"], "n": 2}],
    "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
    "d_ff": 128, "vocab_size": 256, "decay_lora": 8, "mix_lora": 8,
    "norm": "layernorm", "norm_eps": 1e-6, "qk_norm": False,
    "tie_embeddings": False, "embed_scale": False, "logit_softcap": 0.0,
    "n_experts": 0, "top_k": 0, "dtype": "float32",
    "param_dtype": "float32", "max_seq": 128}
# each leaf's ||port - reference|| / ||reference||: both in f32, so
# rounding alone (observed at most 4e-5; the f32 reference itself lies 3e-5
# from its f64 run); the program in bf16 misses it by two orders
GRAD_TOL = 2e-4


def _digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:32]


def _noisy_params(cfg, seed: int) -> dict:
    """The smoke model's parameters with seeded noise on every leaf, so
    the constant ones (token-shift mixes, decay base, norms) matter."""
    gen = torch.Generator().manual_seed(seed)
    tree = paramlib.init_tree(ttf.model_specs(cfg), gen)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else v + 0.1 * torch.randn(v.shape, generator=gen)
                for k, v in sorted(node.items())}
    return walk(tree)


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def jax_form_bits() -> dict:
    """Digests of what the block computes at ``mix_lora = 0`` on the smoke
    configuration: the two mixers, the time mix from a carried state, the
    loss and every gradient under remat ``none`` and ``full``, prefill and
    a decode step, in float32 and bfloat16."""
    out = {}
    for dname, dt in DTYPES.items():
        cfg = dataclasses.replace(rwkv6_1_6b.smoke_config(), dtype=dt)
        params = _noisy_params(cfg, 3)
        gen = torch.Generator().manual_seed(4)
        x = torch.randn((2, 13, cfg.d_model), generator=gen).to(dt)
        blk = _layer(params["groups"]["g0"]["s0"], 1)
        out[f"{dname}.time_mix"] = _digest(
            trwkv.time_mix_fwd(blk["mix"], x, cfg))
        out[f"{dname}.chan_mix"] = _digest(
            trwkv.chan_mix_fwd(blk["ffn"], x, cfg))
        state = {"S": torch.randn((2, cfg.n_heads, cfg.hd, cfg.hd),
                                  generator=gen),
                 "x_last": torch.randn((2, cfg.d_model),
                                       generator=gen).to(dt)}
        y, new = trwkv.time_mix_decode(blk["mix"], x[:, :3], state, cfg)
        out[f"{dname}.time_mix_decode"] = [_digest(y), _digest(new["S"]),
                                           _digest(new["x_last"])]
        out[f"{dname}.chan_mix_carry"] = _digest(trwkv.chan_mix_fwd(
            blk["ffn"], x[:, :3], cfg, x_last=state["x_last"]))
        tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        for remat in ("none", "full"):
            loss, grads = make_lm_grad_fn(cfg, SyncConfig(remat=remat))(
                params, batch)
            out[f"{dname}.lm_loss.{remat}"] = _digest(loss)
            out[f"{dname}.grads.{remat}"] = {
                "/".join(path): _digest(g)
                for path, g in leaves_with_path(grads)}
        logits, cache = ttf.prefill(params, batch["tokens"][:, :12], cfg)
        step, _ = ttf.decode_step(params, cache, batch["tokens"][:, 12:13],
                                  torch.tensor(12), cfg)
        out[f"{dname}.prefill_decode"] = [_digest(logits), _digest(step)]
    return out


@pytest.fixture
def one_thread():
    """The recorded digests were taken with one thread: the sums' order,
    and so their last bits, are the same at every core count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_jax_form_is_bit_for_bit_as_recorded(one_thread):
    assert jax_form_bits() == json.loads(RECORDED.read_text())


def _finch_grads(dtype: str, remat: str = "none"):
    conf = dict(FINCH, dtype=dtype)
    cfg = harness.program_config(conf)
    params = feed.make_params(ttf.model_specs(cfg), SEED, CPU)
    b = feed.make_batch(SEED, 0, 2, 40, conf["vocab_size"], CPU)
    loss, grads = make_lm_grad_fn(cfg, SyncConfig(remat=remat))(params, b)
    want_loss, want = ref_model.loss_and_grads(
        params, b["tokens"], b["labels"], FINCH, ref_model.Numerics())
    got = dict(feed.leaf_items(grads))
    assert sorted(got) == sorted(want)
    gaps = {k: float(torch.linalg.vector_norm(got[k].float() - want[k])
                     / torch.linalg.vector_norm(want[k])) for k in want}
    return float(loss), float(want_loss), got, gaps


@pytest.mark.parametrize("remat", ["none", "full"])
def test_finch_matches_the_reference(remat):
    """The port's loss and every leaf's gradient against the plain
    reference, from the benchmark's own initial weights, every leaf with a
    gradient at step 1."""
    loss, want_loss, got, gaps = _finch_grads("float32", remat)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert max(gaps.values()) <= GRAD_TOL, gaps
    assert all(float(g.abs().sum()) > 0 for g in got.values()), \
        [k for k, g in got.items() if float(g.abs().sum()) == 0]


def test_the_gradient_tolerance_fails_bfloat16():
    _, _, _, gaps = _finch_grads("bfloat16")
    assert max(gaps.values()) > 10 * GRAD_TOL


def test_finch_leaves_and_the_benchmark_count():
    """Finch adds ``maa_x``, the LoRA's A and five B and the group norm's
    bias to the JAX form's leaves; at rwkv6-1.6b's widths the model holds
    the parameters the benchmark's configuration states."""
    jax_cfg = rwkv6_1_6b.config()
    finch = dataclasses.replace(jax_cfg, mix_lora=32)
    one = {c: {p for p, _ in paramlib.leaves(trwkv.rwkv6_specs(c))}
           for c in (jax_cfg, finch)}
    assert one[finch] - one[jax_cfg] == {
        "time/maa_x", "time/maa_w1", "time/maa_w2", "time/gn_bias"}
    assert one[jax_cfg] <= one[finch]
    specs = dict(paramlib.leaves(trwkv.rwkv6_specs(finch)))
    assert specs["time/maa_w2"].shape == (5, 32, 2048)
    conf = json.loads((ROOT / "perfbench" / "configs" / "rwkv6-1.6b.json")
                      .read_text())
    got = harness.program_config(conf)
    for f in ("groups", "d_model", "n_heads", "hd", "d_ff", "vocab_size",
              "decay_lora", "mix_lora", "norm", "tie_embeddings"):
        assert getattr(got, f) == getattr(finch, f), f
    assert sum(int(np.prod(s.shape)) for _, s in
               paramlib.leaves(ttf.model_specs(finch))) \
        == conf["parameters"]


def _wkv_inputs(B, T, H, hd, decay_mean, seed=11):
    gen = torch.Generator().manual_seed(seed)
    r, k, v = (0.5 * torch.randn((B, T, H, hd), generator=gen)
               for _ in range(3))
    log_w = -torch.exp(torch.randn((B, T, H, hd), generator=gen)
                       + decay_mean)
    u = 0.3 * torch.randn((H, hd), generator=gen)
    return r, k, v, log_w, u


@pytest.mark.parametrize("decay_mean", [0.0, 6.0])
@pytest.mark.parametrize("T,chunk", [(1, 32), (37, 32), (64, 16), (50, 8)])
def test_chunked_wkv_matches_the_recurrence(T, chunk, decay_mean):
    """The reference's chunked WKV against the step-by-step recurrence
    (the port's plain version), outputs and gradients, in f32; at decay
    mean 6 most decays are exactly 0 in f32 (log w ~ -400), which the
    chunked form takes in log space."""
    ins = [x.requires_grad_() for x in _wkv_inputs(2, T, 3, 8, decay_mean)]
    r, k, v, log_w, u = ins
    if decay_mean:
        assert bool((torch.exp(log_w) == 0).any())
    got = ref_mix.wkv(r, k, v, log_w, u, chunk)
    want = kref.rwkv6(r, k, v, torch.exp(log_w), u)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(2))
    g_got = torch.autograd.grad(got, ins, dy, allow_unused=True)
    g_want = torch.autograd.grad(want, ins, dy, allow_unused=True)
    for x, a, b in zip(ins, g_got, g_want):
        # T = 1: the last step's decay reaches no output
        a, b = (torch.zeros_like(x) if g is None else g for g in (a, b))
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_finch_prefill_then_decode_matches_the_forward(one_thread):
    """Finch's shifts through the carried state: a prompt's prefill, then
    decode steps, give the full forward's logits (f32, the stateful plain
    recurrence against the whole-sequence one)."""
    cfg = dataclasses.replace(rwkv6_1_6b.smoke_config(), mix_lora=8,
                              dtype=torch.float32)
    params = _noisy_params(cfg, 7)
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(8))
    full = ttf.forward(params, tokens, cfg)
    logits, cache = ttf.prefill(params, tokens[:, :12], cfg)
    torch.testing.assert_close(logits, full[:, 11], rtol=1e-5, atol=1e-5)
    for t in range(12, 20):
        step, cache = ttf.decode_step(params, cache, tokens[:, t:t + 1],
                                      torch.tensor(t), cfg)
        torch.testing.assert_close(step[:, 0], full[:, t], rtol=1e-5,
                                   atol=1e-5)
