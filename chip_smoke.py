#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, the CUDA toolkit's ``nvcc`` and this checkout's
sources; it imports nothing of JAX and nothing of the JAX package.
Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together), with ptxas' register report;
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at its path's shapes, timed with CUDA events (device time, inputs
   rotated past the L2 cache) beside its roofline bound, the plain version
   and one PyTorch library call computing the same function.  Serving's
   kernels in bf16 at rtol/atol 2e-2, the page gather bit for bit;
   training's ring gather bit for bit on the full-width packed row (and
   once under ``torch.cuda.set_sync_debug_mode("error")``: no host sync);
   the flash-attention backward against torch autograd of the plain
   attention, f32 at rtol/atol 1e-4, bf16 at a normalized max error of
   2e-2;
3. end to end, small: the serving engine on a narrow f32 model on the card
   (CUDA kernels) against the same model on the CPU (plain versions): same
   greedy tokens, prefill logits within 1e-3;
4. serving at full width: ``llama3.2-1b`` in bf16 with random weights from
   seed 0, batch 8, page 16, 16 open-loop requests (prompts 128/300/512,
   generations 16/32, cache 544).  Continuous and static modes on the
   ``steps`` clock must give identical greedy tokens, and the continuous
   run (the serving path: launch counts reset just before, read just
   after) must launch each of its kernels.  Then one continuous
   ``wall``-clock run, and ``torch.profiler`` over a continuous run of 8
   requests arriving together: device time by kernel group and the
   device's idle share;
5. training, small: a narrow f32 model trained 4 steps through the train
   engine at delta 2 on the packed ring, on the card (CUDA kernels)
   against the CPU (plain versions): losses and parameters within 1e-4.
   Then, under ``torch.use_deterministic_algorithms(True)`` on the card,
   delta=0 of the delayed step is bit-identical to the synchronous step
   and the packed ring bit-identical to the tree ring at delta 2;
6. training at full width: ``llama3.2-1b``, f32 master and bf16 compute,
   batch 4 x 512 tokens, AdamW, delta 2 on the packed ring, 8 steps from
   seed 0 (the training path: launch counts reset just before, read just
   after; every kernel of the path launches, as often as the model says,
   and no plain version runs).  Finite losses, the staleness ramp 0, 1,
   2, 2, ... in the telemetry, non-zero q/k/v projection gradients; step
   time, tokens/s, peak memory, and ``torch.profiler`` over 2 more steps.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  float32 matmuls and convolutions run in
full f32 (TF32 off) throughout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SPIN_HZ = 2.0e9                 # at or above any H100 SM clock
L2_BYTES = 50 * 2 ** 20
BF16_TOL = 2e-2                 # rtol = atol, as tests/test_kernels.py
BWD_F32_TOL = 1e-4              # f32 backward vs autograd, rtol = atol
BWD_BF16_NORM_TOL = 2e-2        # bf16 backward: max |err| / max |ref|
TRAIN_TOL = 1e-4                # small training run, CUDA vs CPU


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) of one call ``fn(i)``.  Device time comes from
    CUDA events around ``iters`` back-to-back calls; a spin kernel queued
    first keeps the card busy while the host enqueues them, so the host's
    per-call cost (Python, argument checks, ctypes) leaves no gaps between
    the launches.  Host time is that enqueue time per call.  ``i`` counts
    the calls, so ``fn`` can rotate through input copies (``rotation``)."""
    import torch
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / warmup
    spin_s = 2 * per_call * iters + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * SPIN_HZ))
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host > spin_s:
        raise RuntimeError(f"enqueue {host:.4f} s outlasted the spin "
                           f"{spin_s:.4f} s: device time would include gaps")
    return start.elapsed_time(end) / iters, host * 1e3 / iters


def rotation(tensors: tuple, cap: int = 64) -> list[tuple]:
    """Copies of ``tensors`` whose total exceeds twice the L2 cache, so a
    timed call cycling through them reads its inputs from device memory,
    as the serving path does (a layer's K/V pages and weights were last
    touched a whole decode step earlier)."""
    n = min(cap, max(2, -(-2 * L2_BYTES // nbytes(*tensors))))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(torch, F, ref, gen):
    from repro_torch.kernels.flash_attention import flash_attention
    cases = [(1, S, 32, 8, 64) for S in (128, 300, 512, 1024)] \
        + [(1, 300, 15, 5, 64)]          # smollm-360m heads: group 3
    worst, rows = 0.0, []
    for B, S, H, KV, hd in cases:
        mk = lambda n: torch.randn((B, S, n, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
        q, k, v = mk(H), mk(KV), mk(KV)
        got = flash_attention(q, k, v, causal=True)
        want = ref.attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        worst = max(worst, err)
        flops = 4.0 * hd * H * B * S * (S + 1) / 2
        b_ms, b_by = bound(nbytes(q, k, v, got), flops, "bfloat16")
        sets = rotation((q, k, v))
        n = len(sets)
        lib_sets = [tuple(t.transpose(1, 2) for t in st) for st in sets]
        ms, host_ms = time_ms(lambda i: flash_attention(*sets[i % n]), 20)
        row = dict(shape=[B, S, H, KV, hd], max_abs_err=err,
                   tolerance=BF16_TOL, ms=ms,
                   host_ms=host_ms,
                   plain_ms=time_ms(lambda i: ref.attention(*sets[i % n]),
                                    10)[0],
                   library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                       *lib_sets[i % n], is_causal=True, enable_gqa=True),
                       20)[0],
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print("flash_attention", json.dumps(row), flush=True)
    main = next(r for r in rows if r["shape"][1] == 512)   # longest prompt
    return {**main, "max_abs_err": worst}


# decode shapes: the serving run's ring (cache_len 544 = 34 pages of 16)
# and a 1024-slot ring; the first is the one the main path gives the kernels
MAIN_L, RING_LENS = 544, (544, 1024)


def check_decode(torch, F, ref, gen):
    from repro_torch.kernels.decode_attention import decode_attention
    rows = {}
    for L in RING_LENS:
        B, H, KV, hd = 8, 32, 8, 64
        mk = lambda s, n: torch.randn((B, s, n, hd), generator=gen,
                                      device="cuda").to(torch.bfloat16)
        q, k, v = mk(1, H), mk(L, KV), mk(L, KV)
        # ring masks as the engine makes them: row b holds positions < n_b
        n_live = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
        n_live[0] = 1
        n_live[1] = L
        valid = torch.arange(L, device="cuda")[None, :] < n_live[:, None]
        got = decode_attention(q, k, v, valid)
        want = ref.attention_decode(q, k, v, valid)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        live = int(valid.sum().item())
        need = nbytes(q, got) + B * L + live * KV * hd * 2 * k.element_size()
        b_ms, b_by = bound(need, 4.0 * hd * H * live, "bfloat16")
        sets = rotation((q, k, v, valid))
        n = len(sets)
        lib_sets = [(q_.transpose(1, 2), k_.transpose(1, 2),
                     v_.transpose(1, 2), m_[:, None, None, :])
                    for q_, k_, v_, m_ in sets]
        ms, host_ms = time_ms(lambda i: decode_attention(*sets[i % n]), 200)
        rows[L] = dict(
            shape=[B, L, H, KV, hd], max_abs_err=err, tolerance=BF16_TOL,
            ms=ms, host_ms=host_ms,
            plain_ms=time_ms(lambda i: ref.attention_decode(*sets[i % n]),
                             50)[0],
            library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                *lib_sets[i % n][:3], attn_mask=lib_sets[i % n][3],
                enable_gqa=True), 200)[0],
            bound_ms=b_ms, bound_by=b_by)
        print("decode_attention", json.dumps(rows[L]), flush=True)
    worst = max(r["max_abs_err"] for r in rows.values())
    return {**rows[MAIN_L], "max_abs_err": worst}


def check_page_gather(torch, ref, gen):
    from repro_torch.kernels.page_gather import page_gather
    rows = {}
    for L in RING_LENS:
        B, page, KV, hd = 8, 16, 8, 64
        n_pp = L // page
        P = B * n_pp + 1
        pool = torch.randn((P, page, KV, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)
        table = torch.randperm(P - 1, generator=gen, device="cuda")
        table = table[:B * n_pp].reshape(B, n_pp).to(torch.int32)
        table[0, -1] = P - 1                   # an idle row's junk page
        got = page_gather(pool, table)
        want = ref.page_gather(pool, table)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("page_gather is not bit-exact")
        b_ms, b_by = bound(2 * nbytes(got) + nbytes(table), 0.0, "bfloat16")
        sets = rotation((pool, table))
        n = len(sets)
        idx = [t.long() for _, t in sets]
        ms, host_ms = time_ms(lambda i: page_gather(*sets[i % n]), 200)
        rows[L] = dict(
            shape=[P, page, KV, hd, B, n_pp], max_abs_err=0.0,
            tolerance=0.0, ms=ms, host_ms=host_ms,
            plain_ms=time_ms(lambda i: ref.page_gather(*sets[i % n]),
                             200)[0],
            library_ms=time_ms(lambda i: sets[i % n][0][idx[i % n]],
                               200)[0],
            bound_ms=b_ms, bound_by=b_by)
        print("page_gather", json.dumps(rows[L]), flush=True)
    return rows[MAIN_L]


# the full-width packed ring row of llama3.2-1b: 1,235,814,400 f32 parameters,
# a multiple of the engine's 128-element padding
RING_N = 1_235_814_400


def check_ring_gather(torch, ref, gen):
    """Bit for bit at the full-width f32 row (size 3, every index, so the
    64-bit offsets past 2^31 elements are exercised) and in bf16 at a
    smaller, odd length; timed at the full row; once more with the host
    sync detector set to raise."""
    from repro_torch.kernels.ring_gather import ring_gather
    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(3)]
    small = torch.randn((3, 50_000_001), generator=gen,
                        device="cuda").to(torch.bfloat16)
    for idx in idxs:
        if not torch.equal(ring_gather(small, idx),
                           ref.ring_gather(small, idx)):
            raise AssertionError("ring_gather (bf16) is not bit-exact")
    del small
    hist = torch.empty((3, RING_N), dtype=torch.float32, device="cuda")
    for i in range(3):          # distinct rows, so a wrong row shows
        hist[i].normal_(generator=gen)
    for idx in idxs:
        got = ring_gather(hist, idx)
        want = ref.ring_gather(hist, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ring_gather (f32, idx {int(idx)}) is "
                                 "not bit-exact")
        del got, want
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ring_gather(hist, idxs[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.equal(out, hist[2]):
        raise AssertionError("ring_gather under the sync detector")
    del out
    b_ms, b_by = bound(2 * RING_N * 4, 0.0, "float32")
    ms, host_ms = time_ms(lambda i: ring_gather(hist, idxs[i % 3]), 12)
    row = dict(shape=[3, RING_N], dtype="float32", max_abs_err=0.0,
               tolerance=0.0, ms=ms, host_ms=host_ms,
               plain_ms=time_ms(lambda i: ref.ring_gather(hist, idxs[i % 3]),
                                12)[0],
               library_ms=time_ms(lambda i: torch.index_select(
                   hist, 0, idxs[i % 3].view(1)), 12)[0],
               bound_ms=b_ms, bound_by=b_by, host_sync_free=True)
    print("ring_gather", json.dumps(row), flush=True)
    del hist
    torch.cuda.empty_cache()
    return row


def _live_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work of one head."""
    if not causal:
        return S * S if window <= 0 else sum(
            S - max(0, q - window + 1) for q in range(S))
    if window <= 0:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) for q in range(S))


def check_flash_bwd(torch, F, ref, gen):
    """The backward kernel against torch autograd of the plain attention in
    f32 on the same inputs (f32 at rtol/atol 1e-4; bf16 to a normalized max
    error of 2e-2, since dS = P (dP - D) is a difference of nearly equal
    terms, rounded to bf16 relative to the tensor's scale); the forward's
    log-sum-exp against the plain one; timed in bf16 beside its bound,
    autograd of the plain version and SDPA's backward."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)
    cases = [(4, 512, 32, 8, 64, True, 0), (4, 128, 32, 8, 64, True, 0),
             (4, 1024, 32, 8, 64, True, 0), (4, 300, 15, 5, 64, True, 0),
             (4, 512, 32, 8, 64, True, 128)]
    rows = []
    for B, S, H, KV, hd, causal, window in cases:
        mk = lambda n: torch.randn((B, S, n, hd), generator=gen,   # noqa
                                   device="cuda")
        q32, k32, v32, do32 = mk(H), mk(KV), mk(KV), mk(H)
        ins32 = [t.requires_grad_() for t in (q32, k32, v32)]
        want_o = ref.attention(*ins32, causal=causal, window=window)
        want = torch.autograd.grad(want_o, ins32, do32)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.detach().to(dt) for t in (q32, k32, v32, do32))
            if dt == torch.bfloat16:    # the plain version on the same
                ins = [t.float().requires_grad_() for t in (q, k, v)]
                ref_o = ref.attention(*ins, causal=causal, window=window)
                ref_g = torch.autograd.grad(ref_o, ins, do.float())
            else:
                ref_g = want
            o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                     with_lse=True)
            got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                      window=window)
            torch.cuda.synchronize()
            if dt == torch.float32:
                for g, w in zip(got, ref_g):
                    torch.testing.assert_close(g, w, rtol=BWD_F32_TOL,
                                               atol=BWD_F32_TOL)
                errs["float32"] = max((g - w).abs().max().item()
                                      for g, w in zip(got, ref_g))
                scores = torch.einsum(
                    "bqhd,bkhd->bhqk", q,
                    k.repeat_interleave(H // KV, dim=2)) * hd ** -0.5
                qp = torch.arange(S, device="cuda")[:, None]
                kp = torch.arange(S, device="cuda")[None, :]
                live = kp <= qp if causal else torch.ones_like(qp == kp)
                if window > 0:
                    live = live & (kp > qp - window)
                want_lse = torch.logsumexp(
                    scores.masked_fill(~live, float("-inf")), -1)
                torch.testing.assert_close(lse, want_lse, rtol=1e-5,
                                           atol=1e-5)
            else:
                norm = max(((g.float() - w).abs().max()
                            / w.abs().max()).item()
                           for g, w in zip(got, ref_g))
                if not norm <= BWD_BF16_NORM_TOL:
                    raise AssertionError(f"flash_attention_bwd bf16 "
                                         f"normalized error {norm}")
                errs["bfloat16_normalized"] = norm
                errs["bfloat16"] = max((g.float() - w).abs().max().item()
                                       for g, w in zip(got, ref_g))
        # timing in bf16, the training path's dtype
        q, k, v, do = (t.detach().to(torch.bfloat16)
                       for t in (q32, k32, v32, do32))
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 with_lse=True)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window)
        flops = 2.5 * 4.0 * hd * H * B * _live_pairs(S, causal, window)
        b_ms, b_by = bound(nbytes(q, k, v, o, do, lse, dq, dk, dv), flops,
                           "bfloat16")
        sets = rotation((q, k, v, o, do, lse))
        n = len(sets)
        ms, host_ms = time_ms(lambda i: flash_attention_bwd(
            *sets[i % n], causal=causal, window=window), 10)
        pin = [t.requires_grad_() for t in (q.clone(), k.clone(), v.clone())]
        pout = ref.attention(*pin, causal=causal, window=window)
        plain_ms = time_ms(lambda i: torch.autograd.grad(
            pout, pin, do, retain_graph=True), 5)[0]
        lin = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        mask = None
        if window > 0:
            qp = torch.arange(S, device="cuda")[:, None]
            kp = torch.arange(S, device="cuda")[None, :]
            mask = (kp <= qp) & (kp > qp - window)
        lout = F.scaled_dot_product_attention(
            *lin, is_causal=causal and mask is None, attn_mask=mask,
            enable_gqa=True)
        ldo = do.transpose(1, 2)
        library_ms = time_ms(lambda i: torch.autograd.grad(
            lout, lin, ldo, retain_graph=True), 10)[0]
        row = dict(shape=[B, S, H, KV, hd], causal=causal, window=window,
                   max_abs_err=errs["float32"], tolerance=BWD_F32_TOL,
                   bf16_max_abs_err=errs["bfloat16"],
                   bf16_normalized_err=errs["bfloat16_normalized"],
                   bf16_tolerance=BWD_BF16_NORM_TOL, ms=ms, host_ms=host_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        print("flash_attention_bwd", json.dumps(row), flush=True)
        del pin, pout, lin, lout, sets
    torch.cuda.empty_cache()
    main = rows[0]                  # the training shape, causal
    return {**main, "max_abs_err": max(r["max_abs_err"] for r in rows)}


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------

def small_end_to_end(torch):
    """The serving path on a narrow f32 model: CUDA kernels on the card
    vs plain versions on the CPU, same params and requests."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import ServeConfig, ServeEngine, open_loop_requests
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), d_model=256,
                              n_heads=8, n_kv_heads=2, head_dim=64,
                              d_ff=512, dtype=torch.float32)
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(1))
    reqs = open_loop_requests(6, 1.0, cfg.vocab_size, prompt_lens=(8, 40),
                              gen_lens=(4, 12), seed=1)
    scfg = ServeConfig(batch_size=3, page_size=8, cache_len=56,
                       clock="steps")
    outs, logits = {}, {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        outs[dev] = ServeEngine(cfg, p, scfg).run(reqs).outputs
        toks = torch.tensor([reqs[1].prompt], device=dev)
        logits[dev] = prefill(p, toks, cfg, cache_len=56)[0].cpu()
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    print(f"small f32 end to end: prefill logits max |cuda-cpu| {err:.3g}; "
          f"greedy tokens equal: {outs['cpu'] == outs['cuda']}", flush=True)
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"greedy tokens differ: {outs}")
    if not err <= 1e-3:
        raise AssertionError(f"prefill logits differ by {err}")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


SERVING_KERNELS = ("flash_attention", "page_gather", "decode_attention")
TRAINING_KERNELS = ("flash_attention", "flash_attention_bwd", "ring_gather")


def full_width(torch, ops, ref):
    from repro_torch.configs import get_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests, serving_params)
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    master = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    params = serving_params(master, cfg)
    del master
    torch.cuda.synchronize()
    print(f"llama3.2-1b: {paramlib.param_count(model_specs(cfg))} params "
          f"initialised in {time.perf_counter() - t0:.2f} s", flush=True)

    common = dict(batch_size=8, page_size=16, cache_len=MAIN_L)
    reqs = open_loop_requests(16, 0.5, cfg.vocab_size,
                              prompt_lens=(128, 300, 512), gen_lens=(16, 32),
                              seed=0)
    # a check that what comes out is right: finite logits of the right shape
    logits, _ = prefill(params, torch.tensor([reqs[0].prompt], device="cuda"),
                        cfg, cache_len=MAIN_L)
    if logits.shape != (1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError("full-width prefill logits are not finite")

    reports, launches = {}, {}
    for cont in (True, False):
        eng = ServeEngine(cfg, params, ServeConfig(continuous=cont,
                                                   clock="steps", **common))
        ops.reset_launches()                 # the serving path starts here
        t0 = time.perf_counter()
        with plain_versions_counted(ref) as plain_calls:
            rep = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[cont] = dict(ops.launches)  # ... and ends here
        reports[cont] = rep
        print(f"{rep.mode} (steps clock): {rep.total_tokens} tokens, "
              f"{rep.decode_steps} decode steps, utilization "
              f"{rep.utilization:.3f}, {dt:.2f} s host time; launches "
              f"{launches[cont]}; plain version calls {plain_calls}",
              flush=True)
        if any(plain_calls.values()):
            raise AssertionError(f"plain versions ran: {plain_calls}")
    for rep in reports.values():
        for r in reqs:
            toks = rep.outputs[r.rid]
            if len(toks) != r.gen_len or not all(
                    0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"request {r.rid}: bad output {toks}")
    if reports[True].outputs != reports[False].outputs:
        raise AssertionError("continuous and static greedy tokens differ")
    print("continuous == static greedy tokens: True", flush=True)
    for cont, counts in launches.items():
        if min(counts[k] for k in SERVING_KERNELS) <= 0:
            raise AssertionError(f"a kernel never launched: {counts}")

    eng = ServeEngine(cfg, params, ServeConfig(continuous=True, clock="wall",
                                               **common))
    wreqs = open_loop_requests(16, 50.0, cfg.vocab_size,
                               prompt_lens=(128, 300, 512),
                               gen_lens=(16, 32), seed=0)
    rep = eng.run(wreqs)
    print("wall clock continuous:", json.dumps(dict(
        tokens=rep.total_tokens, duration_s=rep.duration,
        tok_per_s=rep.tokens_per_sec, latency_p50_s=rep.latency_p50,
        latency_p99_s=rep.latency_p99, ttft_p50_s=rep.ttft_p50,
        ttft_p99_s=rep.ttft_p99, decode_steps=rep.decode_steps,
        utilization=rep.utilization,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)),
        flush=True)
    where_time_goes(torch, cfg, params, common)
    return launches[True]


KERNEL_GROUPS = (("flash_attention", "flash_fwd_kernel"),
                 ("flash_attention_bwd", "flash_bwd_"),
                 ("decode_attention", "decode_kernel"),
                 ("page_gather", "page_gather_kernel"),
                 ("ring_gather", "ring_gather_kernel"),
                 ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "splitK")))


def device_profile(torch, prof, wall_ms: float, label: str, **extra):
    """Print device time by kernel group and the device's idle share of
    the host's wall time, then the top kernels and host operators."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for e in kernels:
        for name, keys in KERNEL_GROUPS:
            if any(k in e.key for k in (keys if isinstance(keys, tuple)
                                        else (keys,))):
                groups[name] += dev_us(e) / 1e3
                break
        else:
            groups["other"] += dev_us(e) / 1e3
    print(f"{label}:", json.dumps(dict(
        **extra, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / wall_ms if wall_ms else None,
        device_ms_by_group=groups)), flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"{label} kernel: {dev_us(e) / 1e3:9.3f} ms x{e.count:6d} "
              f"{e.key[:90]}", flush=True)
    # the host side, where a device idle most of the time waits: operators
    # and runtime calls by their own CPU time (profiler overhead included)
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:12]:
        print(f"{label} host: {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"x{e.count:6d} {e.key[:90]}", flush=True)


def where_time_goes(torch, cfg, params, common):
    """torch.profiler over one continuous run of 8 requests arriving
    together (8 whole-prompt prefills, then decode to the end): device
    time by kernel group and the device's idle share of the host's wall
    time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests)
    reqs = [dataclasses.replace(r, arrival=0.0) for r in open_loop_requests(
        8, 1.0, cfg.vocab_size, prompt_lens=(128, 300, 512),
        gen_lens=(16, 32), seed=2)]
    scfg = ServeConfig(continuous=True, clock="steps", warmup=False,
                       **common)
    # host clock per decode step: every step ends in a device sync (the
    # greedy tokens' host copy), and all 8 requests are admitted before
    # the first step, so the gaps between step hooks are pure decode steps
    stamps = []
    t0 = time.perf_counter()
    ServeEngine(cfg, params, scfg).run(
        reqs, step_hook=lambda _: stamps.append(time.perf_counter()))
    gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    step_ms = gaps[len(gaps) // 2] * 1e3
    print("host clock:", json.dumps(dict(
        decode_step_p50_ms=step_ms,
        prefill_mean_ms=((stamps[0] - t0) * 1e3 - step_ms) / len(reqs),
        prompt_lens=[len(r.prompt) for r in reqs])), flush=True)

    eng = ServeEngine(cfg, params, scfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_profile(torch, prof, wall_ms, "profile", requests=len(reqs),
                   decode_steps=rep.decode_steps, tokens=rep.total_tokens)


# ---------------------------------------------------------------------------
# phases 5 and 6: training
# ---------------------------------------------------------------------------

PLAIN_VERSIONS = ("attention", "attention_chunked", "attention_decode",
                  "page_gather", "ring_gather")


@contextlib.contextmanager
def plain_versions_counted(ref):
    """Count calls of the plain versions in ``kernels/ref.py`` while the
    block runs (the dispatch looks them up at each call)."""
    calls = dict.fromkeys(PLAIN_VERSIONS, 0)
    saved = {name: getattr(ref, name) for name in PLAIN_VERSIONS}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return fn
    for name in PLAIN_VERSIONS:
        setattr(ref, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def _train_run(torch, cfg, params, opt_name, sync, batches, lr):
    from repro_torch.launch.steps import make_train_engine
    from repro_torch.optim import OptConfig, make_optimizer
    opt = make_optimizer(OptConfig(name=opt_name, lr=lr))
    eng = make_train_engine(cfg, opt, sync, params)
    state = eng.init_state()
    losses = []
    for b in batches:
        state, m = eng.step(state, b)
        losses.append(m["loss"])
    p = state["params"] if sync.delta == 0 else state.params
    return torch.stack(losses), p


def small_training(torch):
    """The training path on a narrow f32 model: CUDA kernels on the card vs
    plain versions on the CPU, then the engine's bit-identities on the
    card under deterministic algorithms."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.pdb import make_delayed_step, init_delayed_state
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import leaves_with_path
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), d_model=256,
                              n_heads=8, n_kv_heads=2, head_dim=64,
                              d_ff=512, dtype=torch.float32)
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(1))
    spec = LMBatchSpec(batch=2, seq_len=96, vocab_size=cfg.vocab_size,
                       seed=1)
    sync = SyncConfig(delta=2, remat="none", packed_ring=True)
    res = {}
    for opt_name in ("sgd", "adamw"):
        for dev in ("cpu", "cuda"):
            batches = [make_lm_batch(spec, t, dev) for t in range(4)]
            res[opt_name, dev] = _train_run(torch, cfg, _to(params, dev),
                                            opt_name, sync, batches, 0.05)
    loss_err = max((res[o, "cpu"][0] - res[o, "cuda"][0].cpu()).abs().max()
                   .item() / res[o, "cpu"][0].abs().max().item()
                   for o in ("sgd", "adamw"))
    param_err = max((a - b.cpu()).abs().max().item() for (_, a), (_, b) in zip(
        leaves_with_path(res["sgd", "cpu"][1]),
        leaves_with_path(res["sgd", "cuda"][1])))
    print("small f32 training, delta 2 packed, 4 steps:", json.dumps(dict(
        loss_rel_err_cuda_vs_cpu=loss_err,
        sgd_param_max_abs_err_cuda_vs_cpu=param_err,
        losses_cuda={o: res[o, "cuda"][0].tolist() for o in ("sgd", "adamw")},
        tolerance=TRAIN_TOL)), flush=True)
    if not (loss_err <= TRAIN_TOL and param_err <= TRAIN_TOL):
        raise AssertionError("small training run: CUDA and CPU differ")

    # bit-identities on the card, deterministic algorithms
    torch.use_deterministic_algorithms(True)
    try:
        p = _to(params, "cuda")
        batches = [make_lm_batch(spec, t, "cuda") for t in range(3)]
        grad_fn = make_lm_grad_fn(cfg, sync)
        opt = make_optimizer(OptConfig(name="adamw", lr=0.05))
        sync_p, sync_s = p, opt.init(p)
        for b in batches:
            _, g = grad_fn(sync_p, b)
            sync_p, sync_s = opt.update(g, sync_s, sync_p)
        step = make_delayed_step(grad_fn, opt.update, 0, packed=True)
        st = init_delayed_state(p, opt.init, 0, packed=True)
        for b in batches:
            st, _ = step(st, b)
        same0 = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_path(sync_p), leaves_with_path(st.params)))
        finals = {}
        for packed in (True, False):
            step = make_delayed_step(grad_fn, opt.update, 2, packed=packed)
            st = init_delayed_state(p, opt.init, 2, packed=packed)
            losses = []
            for b in batches:
                st, m = step(st, b)
                losses.append(m["loss"])
            finals[packed] = (torch.stack(losses), st.params)
        same_layout = torch.equal(finals[True][0], finals[False][0]) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_path(finals[True][1]),
                leaves_with_path(finals[False][1])))
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"deterministic, on the card: delta=0 == sync bit for bit: "
          f"{same0}; packed == tree at delta 2 bit for bit: {same_layout}",
          flush=True)
    if not (same0 and same_layout):
        raise AssertionError("a bit-identity of the engine failed")


TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_DELTA = 4, 512, 8, 2


def full_width_training(torch, ops, ref):
    """llama3.2-1b at full width through the train engine: f32 master,
    bf16 compute, AdamW, delta 2 on the packed ring."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.pdb import make_engine
    cfg = get_config("llama3.2-1b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    sync = SyncConfig(delta=TRAIN_DELTA, remat="none", packed_ring=True)
    spec = LMBatchSpec(batch=TRAIN_B, seq_len=TRAIN_S,
                       vocab_size=cfg.vocab_size, seed=0)
    inner = make_lm_grad_fn(cfg, sync)
    qkv_grad_max = []

    def grad_fn(p, batch):              # the engine's grad_fn, watched
        loss, grads = inner(p, batch)
        mix = grads["groups"]["g0"]["s0"]["mix"]
        qkv_grad_max.append(torch.stack(
            [mix[w].abs().max() for w in ("wq", "wk", "wv")]))
        return loss, grads

    opt = make_optimizer(OptConfig(name="adamw", lr=3e-4))
    eng = make_engine(params, grad_fn, opt, sync)
    state = eng.init_state()
    del params
    torch.cuda.synchronize()
    print(f"llama3.2-1b training state ready in "
          f"{time.perf_counter() - t0:.2f} s: ring "
          f"{ {k: list(v.shape) for k, v in state.hist.items()} }, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    batches = [make_lm_batch(spec, t, "cuda") for t in range(TRAIN_STEPS + 2)]

    stats = eng.telemetry.stats
    losses, step_s, ramp = [], [], []
    ops.reset_launches()                 # the training path starts here
    with plain_versions_counted(ref) as plain_calls:
        for b in batches[:TRAIN_STEPS]:
            before = stats.sum_staleness
            t1 = time.perf_counter()
            state, m = eng.step(state, b)
            losses.append(float(m["loss"]))       # syncs with the device
            step_s.append(time.perf_counter() - t1)
            ramp.append((stats.sum_staleness - before)
                        / len(eng.group_delays))
    launches = dict(ops.launches)        # ... and ends here
    n_groups = len(state.hist)
    n_layers = sum(g.n * len(g.pattern) for g in cfg.groups)
    want = {"ring_gather": n_groups * TRAIN_STEPS,
            "flash_attention": n_layers * TRAIN_STEPS,
            "flash_attention_bwd": n_layers * TRAIN_STEPS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    qkv = torch.stack(qkv_grad_max).min().item()
    tele = eng.telemetry.summary()
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print("full-width training:", json.dumps(dict(
        arch=cfg.name, batch=TRAIN_B, seq=TRAIN_S, delta=TRAIN_DELTA,
        optimizer="adamw", steps=TRAIN_STEPS, losses=losses,
        step_s=step_s, step_s_p50_after_first=steady,
        tokens_per_s=TRAIN_B * TRAIN_S / steady, peak_mem_gib=peak,
        staleness_per_step=ramp, telemetry=tele, launches=launches,
        expected_launches=want, plain_version_calls=plain_calls,
        min_qkv_grad_max_abs=qkv)), flush=True)
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    if ramp != [min(i, TRAIN_DELTA) for i in range(TRAIN_STEPS)] or \
            tele["max_staleness"] != TRAIN_DELTA:
        raise AssertionError(f"staleness ramp {ramp}, telemetry {tele}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"launches {launches}, expected {want}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran: {plain_calls}")
    if not qkv > 0:
        raise AssertionError("a q/k/v projection got no gradient")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for b in batches[TRAIN_STEPS:]:
            state, m = eng.step(state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    device_profile(torch, prof, wall_ms, "train profile", steps=2,
                   tokens=2 * TRAIN_B * TRAIN_S)
    del state, eng, batches
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    # deterministic cuBLAS for the engine's bit-identity checks: read when
    # the first cuBLAS handle is made, so it is set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build, ops, ref
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"kernel build {time.perf_counter() - t0:.2f} s wall; per source "
          f"{json.dumps(secs)}", flush=True)
    for name in _build.SOURCES:
        log = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"flash_attention": check_flash(torch, F, ref, gen),
               "page_gather": check_page_gather(torch, ref, gen),
               "decode_attention": check_decode(torch, F, ref, gen),
               "ring_gather": check_ring_gather(torch, ref, gen),
               "flash_attention_bwd": check_flash_bwd(torch, F, ref, gen)}
    small_end_to_end(torch)
    paths = {"serving": full_width(torch, ops, ref)}
    torch.cuda.empty_cache()
    small_training(torch)
    paths["training"] = full_width_training(torch, ops, ref)

    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:86",
                "page_gather": "src/repro/kernels/page_gather.py:35",
                "decode_attention": "src/repro/kernels/decode_attention.py:70",
                "ring_gather": "src/repro/kernels/ring_gather.py:36",
                # the gradient of the kernel above: the TPU package has
                # none and trains through autodiff of its plain attention
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention.py:86"}
    own_path = {"flash_attention": "serving", "page_gather": "serving",
                "decode_attention": "serving", "ring_gather": "training",
                "flash_attention_bwd": "training"}
    kernels = []
    for name, row in results.items():
        source = "flash_attention" if name == "flash_attention_bwd" else name
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}.cu",
            replaces=replaces[name], path=own_path[name],
            launches=paths[own_path[name]][name],
            launches_by_path={p: c[name] for p, c in paths.items()},
            max_abs_err=row["max_abs_err"], tolerance=row["tolerance"],
            ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            host_ms=row["host_ms"], shape=row["shape"]))
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
