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
   no flash-attention, decode, chunked-prefill, MoE, WKV or RG-LRU
   instantiation may spill (ptxas' spill bytes all 0), and the flash, MoE,
   WKV and RG-LRU wrappers' plans must state what the CUDA sources launch
   with (the WKV chunk of 64 steps and the RG-LRU chunk of 16 among it);
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at its path's shapes, timed with CUDA events (device time, inputs
   rotated past the L2 cache) beside its roofline bound, the plain version
   and one PyTorch library call computing the same function.  Serving's
   kernels in bf16 at rtol/atol 2e-2, the page gather bit for bit;
   training's ring gather bit for bit on the full-width packed row (and
   once under ``torch.cuda.set_sync_debug_mode("error")``: no host sync);
   the flash-attention backward against torch autograd of the plain
   attention, f32 at rtol/atol 1e-4, bf16 at a normalized max error of
   2e-2; the split decode kernel also at recurrentgemma-2b's local heads
   (10 over 1 kv head of 256, a 2048-slot ring) in bf16 and f32 (1e-4),
   each row of a batch of 8 bit-identical to the row alone and two calls
   bit-identical; chunked-prefill attention reading its ring in place from
   page pools under a shuffled table (against the plain version over
   ``ref.page_gather``; its gathered form against the plain version and
   bit-identical to the paged one) over rings with dead slots, wrapped
   rings and windows, bf16 at 2e-2 and f32 at 1e-4, recurrentgemma-2b's
   local heads with its 2048 window included, timed beside the two
   ``page_gather`` calls it replaces; the three attention kernels also at
   mixtral-8x7b's head dim 128; the grouped MoE FFN at
   mixtral-8x7b's width (a decode batch, a 128-token chunk, prompts of 300
   and 512 tokens) in bf16 at a normalized 2e-2, its edge cases (an expert
   with no token, a token no expert takes: exactly 0, two tokens in one
   slot) and one f32 case at 1e-4; the RWKV-6 WKV forward at rwkv6-1.6b's
   training shape (batch 4 x 512, 32 heads of 64) in bf16 at 2e-2, with
   the decay from N(0, 1) and near 0 (N(2, 1)), at a ragged T = 77 in f32
   at 1e-4 (head dims 16 and 64) and at T = 513 (nine 64-step chunks),
   its checkpointed states against the plain stateful version at 1e-4,
   and its backward against torch autograd of the plain version (f32 at
   1e-4, du against its f64 closed form, bf16 at a normalized 2e-2), both
   decays, and in f32 at T = 513; no PyTorch call computes the
   recurrence, so these two rows have no library time (they carry the
   chunk, the blocks a pass launches and the launch plan); flash attention forward and backward
   at recurrentgemma-2b's heads (10 over 1 kv head of 256) at batch 4 x
   512 and at 4096 tokens with its 2048 window (``hd256`` entries, SDPA
   with a boolean mask as the library time); the RG-LRU forward at
   recurrentgemma-2b's training shape (batch 4 x 512, 2560 channels) in
   bf16 at 2e-2, the decay from the model's map and near 1, at ragged
   T 77 and 513, D 200 and on strided inputs in f32 at 1e-4, its
   checkpoints (the state at each 16-step chunk's last step) against the
   plain version's states at 1e-4, and its backward against torch
   autograd of the plain version where a < 1 (f32 at 1e-4, also at
   T 513; bf16 at a normalized 2e-2), its value at a = 1 (dx = 0, da = dh
   h_{t-1}) pinned and two runs bit for bit; no library time either (these
   rows carry the chunk and the threads a pass); then
   flash attention's batch invariance in bf16 at llama3.2-1b's and
   recurrentgemma-2b's training shapes: each batch row alone gives the
   bits of the forward, lse and the three gradients it gives inside the
   batch of 4;
3. end to end, small: the serving engine on a narrow f32 model on the card
   (CUDA kernels) against the same model on the CPU (plain versions): same
   greedy tokens, prefill logits within 1e-3; on shared-prefix requests,
   chunked, prefix-cached, prefix-cached under eviction pressure and
   sampled runs: greedy tokens CUDA == CPU, chunked == prefix-cached ==
   static whole-prompt on the card, sampled tokens the same under both
   schedules and not the greedy ones;
4. serving at full width: ``llama3.2-1b`` in bf16 with random weights from
   seed 0, batch 8, page 16, 16 open-loop requests (prompts 128/300/512,
   generations 16/32, cache 544).  Continuous and static modes on the
   ``steps`` clock must give identical greedy tokens, and the continuous
   run (the serving path: launch counts reset just before, read just
   after) must launch each of its kernels.  Then one continuous
   ``wall``-clock run, and ``torch.profiler`` over a continuous run of 8
   requests arriving together: device time by kernel group and the
   device's idle share.  Then the chunked path on the same weights: 16
   shared-prefix requests (4 hot 256-token prefixes, suffixes 64/192,
   generations 16/32), chunk 128, run chunked, prefix-cached and
   prefix-cached with nucleus sampling (launch counts reset before the
   three, read after): each run launches ``prefill_page_attention`` 16
   times per chunk (its own and the warmup's) and the paged decode
   kernels, ``page_gather`` exactly twice per ``decode_attention`` (the
   chunks read the pools in place), no plain version runs, every output
   is whole, the cache hits more than 30 % of prompt tokens and saves
   chunks, sampling changes the tokens; the first-token logits of the chunk plan agree with the whole
   prompt's within a normalized 2e-2; then a ``wall``-clock prefix-cached
   run and its profile;
4b. MoE serving: a narrow f32 mixtral (4 experts, top-2, window 16) on the
   card against the CPU at capacity factor 1.25 (whole prompt, chunked,
   prefix-cached: same greedy tokens, prefill logits within 1e-3), and
   continuous == static on the card at 4.0, where nothing is dropped; then
   ``mixtral-8x7b`` at full width, depth 8 of 32, bf16, random weights from
   seed 0 built leaf by leaf, batch 8, page 16, cache 544, the traffic of
   phase 4: continuous and static runs on the steps clock (the MoE serving
   path: exact launch counts of the grouped FFN and the attention kernels,
   no plain version; continuous-vs-static agreement reported, not gated,
   since capacity drops depend on the batch), the first-token logits of
   the kernels against the plain versions on the card, a ``wall``-clock
   run, a chunked (128) prefix-cached run on shared-prefix traffic, and a
   profile;
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
   time, tokens/s, peak memory, and ``torch.profiler`` over 2 more steps;
7. RWKV-6 training: phase 5 on the rwkv6-1.6b smoke config (f32, 2 layers,
   d 64, 4 heads of 16), then phase 6 on ``rwkv6-1.6b`` at full width and
   full depth (24 layers, d 2048, 32 heads of 64, d_ff 7168, vocab 65536,
   untied head): the WKV forward and backward kernels launch once per
   layer and step, the ring gather once per group and step, and no plain
   version runs; ``wr``, ``wk``, ``wv``, ``decay_w1`` and ``bonus_u`` of
   layer 0 get non-zero gradients;
8. recurrentgemma training: phase 5 on the recurrentgemma-2b smoke config
   (f32, one (rglru, rglru, local) group, d 64, window 16 at 96 tokens),
   then phase 6 on ``recurrentgemma-2b`` at full width (d 2560, 10 heads
   over 1 kv head of 256, window 2048, d_ff 7680, vocab 256000, tied and
   scaled embeddings), depth cut to 11 of 26 layers (``reduced``): each
   rglru layer launches the RG-LRU forward and backward once a step, each
   local layer the flash forward and backward, the ring gather once per
   group and step, no plain version runs, and layer 0's ``wx``, ``wa``,
   ``wi``, ``lam``, ``conv_w`` (slot 0) and ``wq``, ``wk``, ``wv`` (slot 2)
   get non-zero gradients.

The last two lines are the ``kernels`` JSON object (eleven rows) and
``{"ok": true, "device": {...}}``.  float32 matmuls and convolutions run in
full f32 (TF32 off) throughout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
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
F32_TOL = 1e-4                  # f32 decode and chunked prefill, rtol = atol
BWD_BF16_NORM_TOL = 2e-2        # bf16 backward: max |err| / max |ref|
TRAIN_TOL = 1e-4                # small training run, CUDA vs CPU


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3,
            spin: bool = True) -> tuple[float, float]:
    """(device ms, host ms) of one call ``fn(i)``.  Device time comes from
    CUDA events around ``iters`` back-to-back calls; a spin kernel queued
    first keeps the card busy while the host enqueues them, so the host's
    per-call cost (Python, argument checks, ctypes) leaves no gaps between
    the launches.  Host time is that enqueue time per call.  ``i`` counts
    the calls, so ``fn`` can rotate through input copies (``rotation``).
    The spin is sized from calls made after the warmup: a first call's
    one-off set-up (a library loading its kernels) would stretch it to
    minutes.  ``spin=False`` times without the spin, for a call of more
    launches than the card's launch queue holds (the WKV plain versions,
    thousands of small kernels a call): the host cannot queue them ahead,
    so the device time includes the host's gaps and is the time a caller
    waits."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / warmup
    spin_s = 4 * per_call * iters + 5e-3 if spin else 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    if spin and host > spin_s:
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

# recurrentgemma-2b's local attention (10 q heads over 1 kv head of 256):
# the training shape, and one sequence past its 2048 window (B, S, window)
FLASH_HD256 = ((4, 512, 0), (1, 4096, 2048))
# the forward's shapes (B, S, H, KV, hd, window), all causal: llama3.2-1b's
# prompts, smollm-360m's heads (group 3), mixtral-8x7b's head dim 128,
# then recurrentgemma-2b's
FLASH_CASES = [(1, S, 32, 8, 64, 0) for S in (128, 300, 512, 1024)] \
    + [(1, 300, 15, 5, 64, 0), (1, 512, 32, 8, 128, 0)] \
    + [(B, S, 10, 1, 256, w) for B, S, w in FLASH_HD256]
# the backward's (B, S, H, KV, hd, causal, window): llama3.2-1b's training
# shape first (the main row), other lengths, smollm-360m's heads, a window,
# then recurrentgemma-2b's
FLASH_BWD_CASES = [(4, 512, 32, 8, 64, True, 0), (4, 128, 32, 8, 64, True, 0),
                   (4, 1024, 32, 8, 64, True, 0), (4, 300, 15, 5, 64, True, 0),
                   (4, 512, 32, 8, 64, True, 128)] \
    + [(B, S, 10, 1, 256, True, w) for B, S, w in FLASH_HD256]


def window_mask(torch, S: int, window: int):
    """The boolean (S, S) mask of a causal window, SDPA's ``attn_mask``."""
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    return (kp <= qp) & (kp > qp - window)


def check_flash(torch, F, ref, gen):
    from repro_torch.kernels.flash_attention import flash_attention
    worst, rows = 0.0, []
    for B, S, H, KV, hd, window in FLASH_CASES:
        mk = lambda n: torch.randn((B, S, n, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
        q, k, v = mk(H), mk(KV), mk(KV)
        got = flash_attention(q, k, v, causal=True, window=window)
        want = ref.attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        worst = max(worst, err)
        flops = 4.0 * hd * H * B * _live_pairs(S, True, window)
        b_ms, b_by = bound(nbytes(q, k, v, got), flops, "bfloat16")
        sets = rotation((q, k, v))
        n = len(sets)
        lib_sets = [tuple(t.transpose(1, 2) for t in st) for st in sets]
        mask = window_mask(torch, S, window) if window > 0 else None
        ms, host_ms = time_ms(lambda i: flash_attention(
            *sets[i % n], causal=True, window=window), 20)
        row = dict(shape=[B, S, H, KV, hd], window=window, max_abs_err=err,
                   tolerance=BF16_TOL, ms=ms,
                   host_ms=host_ms,
                   plain_ms=time_ms(lambda i: ref.attention(
                       *sets[i % n], causal=True, window=window), 10)[0],
                   library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                       *lib_sets[i % n], is_causal=mask is None,
                       attn_mask=mask, enable_gqa=True), 20)[0],
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print("flash_attention", json.dumps(row), flush=True)
    main = next(r for r in rows if r["shape"] == [1, 512, 32, 8, 64])
    hd128 = next(r for r in rows if r["shape"][4] == 128)
    hd256 = [r for r in rows if r["shape"][4] == 256]
    return {**main, "max_abs_err": worst, "hd128": hd128, "hd256": hd256}


# decode shapes (B, L, H, KV, hd, dtype): the serving run's ring (cache_len
# 544 = 34 pages of 16) and a 1024-slot ring at llama3.2-1b's heads,
# mixtral-8x7b's head dim 128 on the serving ring, then recurrentgemma-2b's
# local layers (10 q heads over 1 kv head of 256, its 2048-slot window
# ring) in bf16 and f32; the first is the one the main path gives the kernel
MAIN_L, RING_LENS = 544, (544, 1024)
DECODE_CASES = tuple((8, L, 32, 8, 64, "bfloat16") for L in RING_LENS) \
    + ((8, MAIN_L, 32, 8, 128, "bfloat16"),
       (8, 2048, 10, 1, 256, "bfloat16"), (8, 2048, 10, 1, 256, "float32"))


def check_decode(torch, F, ref, gen):
    """The split decode kernel against its plain version on ring masks as
    the engine makes them (bf16 2e-2, f32 1e-4); every row of the batch
    of 8 bit-identical to the same row run alone, and two calls
    bit-identical; timed beside its bound, the plain version and SDPA with
    a boolean mask."""
    from repro_torch.kernels.decode_attention import decode_attention, plan
    rows = {}
    for B, L, H, KV, hd, dt in DECODE_CASES:
        dtype = getattr(torch, dt)
        mk = lambda s, n: torch.randn((B, s, n, hd), generator=gen,  # noqa
                                      device="cuda").to(dtype)
        q, k, v = mk(1, H), mk(L, KV), mk(L, KV)
        # ring masks as the engine makes them: row b holds positions < n_b
        n_live = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
        n_live[0] = 1
        n_live[1] = L
        valid = torch.arange(L, device="cuda")[None, :] < n_live[:, None]
        got = decode_attention(q, k, v, valid)
        want = ref.attention_decode(q, k, v, valid)
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if not torch.equal(got, decode_attention(q, k, v, valid)):
            raise AssertionError(f"decode_attention not deterministic at "
                                 f"{(B, L, H, KV, hd, dt)}")
        for b in range(B):
            one = decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   valid[b:b + 1])
            if not torch.equal(one, got[b:b + 1]):
                raise AssertionError(f"decode_attention row {b} at B1 "
                                     f"differs from B{B} at "
                                     f"{(B, L, H, KV, hd, dt)}")
        live = int(valid.sum().item())
        need = nbytes(q, got) + B * L + live * KV * hd * 2 * k.element_size()
        b_ms, b_by = bound(need, 4.0 * hd * H * live, dt)
        sets = rotation((q, k, v, valid))
        n = len(sets)
        lib_sets = [(q_.transpose(1, 2), k_.transpose(1, 2),
                     v_.transpose(1, 2), m_[:, None, None, :])
                    for q_, k_, v_, m_ in sets]
        ms, host_ms = time_ms(lambda i: decode_attention(*sets[i % n]), 200)
        reps = 200 if dt == "bfloat16" else 10   # f32 SDPA: ~2.5 ms a call
        rows[L, hd, dt] = dict(
            shape=[B, L, H, KV, hd], dtype=dt, splits=plan(L, hd,
                                                           dtype)["splits"],
            max_abs_err=err, tolerance=tol, batch_invariant=True,
            deterministic=True, ms=ms, host_ms=host_ms,
            plain_ms=time_ms(lambda i: ref.attention_decode(*sets[i % n]),
                             reps // 4)[0],
            library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                *lib_sets[i % n][:3], attn_mask=lib_sets[i % n][3],
                enable_gqa=True), reps)[0],
            bound_ms=b_ms, bound_by=b_by)
        print("decode_attention", json.dumps(rows[L, hd, dt]), flush=True)
        del sets, lib_sets
    worst = max(r["max_abs_err"] for r in rows.values())
    return {**rows[MAIN_L, 64, "bfloat16"], "max_abs_err": worst,
            "hd128": rows[MAIN_L, 128, "bfloat16"],
            "hd256": [r for (_, hd, _), r in rows.items() if hd == 256]}


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
    rows = []
    for B, S, H, KV, hd, causal, window in FLASH_BWD_CASES:
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
        mask = window_mask(torch, S, window) if window > 0 else None
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
    return {**main, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "hd256": [r for r in rows if r["shape"][4] == 256]}


# chunked prefill (C, L, start, window, dtype, head dim, H, KV): at
# llama3.2-1b's 32 heads over 8 kv heads an empty ring, dead slots (start <
# L), wrapped rings (start > L), windows and one f32 case; the main shape
# at mixtral-8x7b's head dim 128; recurrentgemma-2b's local layers (10
# heads over 1 kv head of 256, its 2048 window over a full 2048-slot ring)
# in bf16 and f32.  PREFILL_MAIN, the third chunk of a 448-token prompt in
# the 544-slot ring, is the main path's shape.  The ring lives in pools of
# 16-slot pages under a shuffled table, as the serving cache holds it.
PREFILL_CASES = [(128, 544, 0, 0, "bfloat16", 64, 32, 8),
                 (128, 544, 256, 0, "bfloat16", 64, 32, 8),
                 (16, 544, 320, 0, "bfloat16", 64, 32, 8),
                 (128, 1024, 700, 0, "bfloat16", 64, 32, 8),
                 (128, 544, 900, 0, "bfloat16", 64, 32, 8),
                 (16, 1024, 1500, 128, "bfloat16", 64, 32, 8),
                 (128, 544, 300, 128, "bfloat16", 64, 32, 8),
                 (128, 544, 900, 0, "float32", 64, 32, 8),
                 (128, 544, 256, 0, "bfloat16", 128, 32, 8),
                 (128, 2048, 2176, 2048, "bfloat16", 256, 10, 1),
                 (128, 2048, 2176, 2048, "float32", 256, 10, 1)]
PREFILL_MAIN = (128, 544, 256, 0, "bfloat16", 64, 32, 8)
PREFILL_HD128 = (128, 544, 256, 0, "bfloat16", 128, 32, 8)
PAGE = 16


def chunk_inputs(torch, gen, C, L, start, dtype, B=1, H=32, KV=8, hd=64):
    """A chunk at positions start..start+C-1 over a ring of L slots holding
    the positions before it, as ``attention_prefill_paged`` makes them."""
    from repro_torch.models.attention import ring_positions
    mk = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                device="cuda").to(dtype)
    ctx_pos = ring_positions(start, L, "cuda")[None].expand(B, L)
    q_pos = (start + torch.arange(C, dtype=torch.int32,
                                  device="cuda"))[None].expand(B, C)
    return (mk(B, C, H, hd), mk(B, L, KV, hd), mk(B, L, KV, hd),
            mk(B, C, KV, hd), mk(B, C, KV, hd), ctx_pos, q_pos)


def paged(torch, gen, ins, page=PAGE):
    """The context of ``chunk_inputs`` moved into pools of ``page``-slot
    pages (B * n_pp + 5 of them, the rest random) under a shuffled table:
    (q, k_pool, v_pool, table, k_new, v_new, ctx_pos, q_pos)."""
    q, k_ctx, v_ctx, k_new, v_new, ctx_pos, q_pos = ins
    B, L, KV, hd = k_ctx.shape
    n_pp = L // page
    P = B * n_pp + 5
    table = torch.randperm(P, generator=gen, device="cuda")[:B * n_pp]
    table = table.reshape(B, n_pp).to(torch.int32)
    if torch.equal(table.flatten().long(), torch.arange(B * n_pp,
                                                        device="cuda")):
        table = table.flip(1)
    pools = []
    for ctx in (k_ctx, v_ctx):
        pool = torch.randn((P, page, KV, hd), generator=gen,
                           device="cuda").to(ctx.dtype)
        pool[table.long()] = ctx.reshape(B, n_pp, page, KV, hd)
        pools.append(pool)
    return (q, pools[0], pools[1], table, k_new, v_new, ctx_pos, q_pos)


def check_prefill_page_attention(torch, F, ref, gen):
    """The chunked-prefill kernel reading the ring in place from pools under
    a shuffled page table, against ``ref.prefill_page_attention`` over
    ``ref.page_gather``; its gathered form (one page of L slots a row) on
    the same inputs against the plain version and bit-identical to the
    paged one; each case timed (the paged form, the main path's) beside
    its bound, the plain version (gather included), two ``page_gather``
    calls (the copies this kernel no longer needs) and SDPA with a boolean
    mask over the gathered keys (timed only)."""
    from repro_torch.kernels.page_gather import (
        page_gather, prefill_page_attention, prefill_page_attention_paged)
    rows = {}
    for case in PREFILL_CASES:
        C, L, start, window, dt, hd, H, KV = case
        dtype = getattr(torch, dt)
        ins = chunk_inputs(torch, gen, C, L, start, dtype, H=H, KV=KV, hd=hd)
        pins = paged(torch, gen, ins)
        q, pk, pv, table = pins[:4]
        got = prefill_page_attention_paged(*pins, window=window)
        view = prefill_page_attention(*ins, window=window)
        want = ref.prefill_page_attention(*ins, window=window)
        want_p = ref.prefill_page_attention(
            q, ref.page_gather(pk, table), ref.page_gather(pv, table),
            *ins[3:], window=window)
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        err = max((got.float() - want_p.float()).abs().max().item(),
                  (view.float() - want.float()).abs().max().item())
        torch.testing.assert_close(got.float(), want_p.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(view.float(), want.float(), rtol=tol,
                                   atol=tol)
        if not torch.equal(got, view):
            raise AssertionError(f"prefill paged != gathered form at {case}")
        k_ctx, ctx_pos, q_pos = ins[1], ins[5], ins[6]
        mask = ref.prefill_mask(ctx_pos, q_pos, window)
        live = int(mask.sum().item())           # this run's (row, key) pairs
        # bytes: q, out, the positions and the table whole, K/V only for
        # the key slots some row of the chunk sees (the kernel loads no
        # other)
        keys = int(mask.any(1).sum().item())
        kv_bytes = 2 * keys * KV * hd * k_ctx.element_size()
        b_ms, b_by = bound(nbytes(q, got, ctx_pos, q_pos, table) + kv_bytes,
                           4.0 * hd * H * live, dt)
        sets = rotation(pins)
        n = len(sets)
        lib_sets = [(st[0].transpose(1, 2),
                     torch.cat([ref.page_gather(st[1], st[3]), st[4]],
                               1).transpose(1, 2),
                     torch.cat([ref.page_gather(st[2], st[3]), st[5]],
                               1).transpose(1, 2)) for st in sets]
        reps = 50 if dt == "bfloat16" else 5
        ms, host_ms = time_ms(lambda i: prefill_page_attention_paged(
            *sets[i % n], window=window), reps)
        gather_ms = time_ms(lambda i: (page_gather(sets[i % n][1],
                                                   sets[i % n][3]),
                                       page_gather(sets[i % n][2],
                                                   sets[i % n][3])), reps)[0]
        plain = lambda st: ref.prefill_page_attention(  # noqa: E731
            st[0], ref.page_gather(st[1], st[3]),
            ref.page_gather(st[2], st[3]), *st[4:], window=window)
        row = dict(
            shape=[1, C, L, H, KV, hd], start=start, window=window, dtype=dt,
            page=PAGE, live_pairs_per_head=live, live_keys=keys,
            max_abs_err=err, tolerance=tol, ms=ms, host_ms=host_ms,
            gather_ms=gather_ms,
            plain_ms=time_ms(lambda i: plain(sets[i % n]), 10)[0],
            library_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                *lib_sets[i % n], attn_mask=mask[:, None],
                enable_gqa=True), reps)[0],
            bound_ms=b_ms, bound_by=b_by)
        rows[case] = row
        print("prefill_page_attention", json.dumps(row), flush=True)
        del sets, lib_sets
    worst = max(r["max_abs_err"] for r in rows.values())
    return {**rows[PREFILL_MAIN], "max_abs_err": worst,
            "hd128": rows[PREFILL_HD128],
            "hd256": [r for c, r in rows.items() if c[5] == 256]}


# moe_grouped_ffn at mixtral-8x7b's width (d 4096, f 14336, 8 experts,
# top-2, capacity factor 1.25), one routing group of g tokens each: a decode
# batch (the shape the serving path launches most, so the main row), a
# 128-token chunk and whole prompts of 300 and 512 tokens
MOE_SHAPES = (("decode", 8), ("chunk", 128), ("prompt300", 300),
              ("prompt512", 512))
MOE_F32_TOL = 1e-4


def moe_route(torch, gen, cfg, g):
    """dispatch and combine for one group of g tokens from random router
    logits, through the model's own routing (``models.moe.route``)."""
    import math
    from repro_torch.models.moe import route
    E = cfg.n_experts
    C = max(math.ceil(g * cfg.top_k * cfg.capacity_factor / E), 1)
    probs = torch.softmax(torch.randn((1, g, E), generator=gen,
                                      device="cuda"), -1)
    return route(probs, cfg.top_k, C)


def _moe_norm_err(torch, got, want) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check_moe_grouped_ffn(torch, F, ref, gen):
    """The grouped MoE FFN kernel against its plain version at the mixtral
    shapes in bf16 (normalized max error <= 2e-2), the edge cases at the
    decode shape (an expert with no token, a token no expert takes, a
    random dispatch with two tokens in one slot), and one small f32 case
    at rtol/atol 1e-4.  Timed beside its bound over the live experts and
    slots, the plain version, and as a library yardstick the three expert
    products as ``torch.bmm`` (cuBLAS) on the gathered (E, C, d) input,
    with the SwiGLU between them and no dispatch or combine: no single
    PyTorch call computes the grouped FFN.  Only the small tensors are
    rotated past the L2 cache: the 2.8 GB of expert weights exceed it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_matmul import moe_grouped_ffn, plan
    cfg = get_config("mixtral-8x7b")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    E, d, f, bf = cfg.n_experts, cfg.d_model, cfg.d_ff, torch.bfloat16

    def weight(shape, fan_in):
        w = torch.randn(shape, generator=gen, device="cuda")
        return w.mul_(fan_in ** -0.5).to(bf)

    ws = (weight((E, d, f), d), weight((E, d, f), d), weight((E, f, d), f))
    torch.cuda.empty_cache()

    def gathered(dispatch, x):          # (E, C, d): the bmm yardstick's input
        return torch.einsum("GgEC,Ggd->ECd", dispatch.to(bf), x).contiguous()

    def library(xin):
        h = F.silu(torch.bmm(xin, ws[0])) * torch.bmm(xin, ws[1])
        return torch.bmm(h, ws[2])

    rows = {}
    for name, g in MOE_SHAPES:
        dispatch, combine = moe_route(torch, gen, cfg, g)
        x = torch.randn((1, g, d), generator=gen, device="cuda").to(bf)
        got = moe_grouped_ffn(dispatch, combine, x, *ws)
        want = ref.moe_grouped_ffn(dispatch, combine, x, *ws)
        torch.cuda.synchronize()
        err, norm = _moe_norm_err(torch, got, want)
        if not norm <= BF16_TOL:
            raise AssertionError(f"moe_grouped_ffn {name}: normalized error "
                                 f"{norm}")
        slots = int(dispatch.any(1).sum().item())          # live (e, c)
        experts = int(dispatch.any(3).any(1).sum().item())
        need = experts * 3 * d * f * 2 + nbytes(dispatch, combine, x, got)
        b_ms, b_by = bound(need, 6.0 * d * f * slots, "bfloat16")
        sets = rotation((dispatch, combine, x))
        n = len(sets)
        lib_sets = [gathered(st[0], st[2]) for st in sets]
        iters = 40 if g <= 128 else 10
        ms, host_ms = time_ms(lambda i: moe_grouped_ffn(*sets[i % n], *ws),
                              iters)
        p = plan(1, g, E, dispatch.shape[-1], d, f, bf, n_sm)
        rows[name] = dict(
            case=name, shape=[1, g, E, dispatch.shape[-1], d, f],
            slot_tile=p["tile"], down_splits=p["ks"], live_experts=experts,
            live_slots=slots, max_abs_err=err, normalized_err=norm,
            tolerance=BF16_TOL, ms=ms, host_ms=host_ms,
            plain_ms=time_ms(lambda i: ref.moe_grouped_ffn(
                *sets[i % n], *ws), max(iters // 4, 3))[0],
            library_ms=time_ms(lambda i: library(lib_sets[i % n]), iters)[0],
            library="3 x torch.bmm + SwiGLU on the gathered (E, C, d) input",
            bound_ms=b_ms, bound_by=b_by)
        print("moe_grouped_ffn", json.dumps(rows[name]), flush=True)
        del sets, lib_sets
    print("moe_grouped_ffn ms by shape (kernel / bound / plain / bmm):",
          json.dumps({n: [r[k] for k in ("ms", "bound_ms", "plain_ms",
                                         "library_ms")]
                      for n, r in rows.items()}), flush=True)

    # edge cases at the decode shape
    dispatch, combine = moe_route(torch, gen, cfg, 8)
    dispatch[..., 0, :] = False                 # expert 0 gets no token
    combine[..., 0, :] = 0
    dispatch[:, 3] = False                      # token 3 is dropped
    combine[:, 3] = 0
    x = torch.randn((1, 8, d), generator=gen, device="cuda").to(bf)
    got = moe_grouped_ffn(dispatch, combine, x, *ws)
    edge = {"no_token_expert_and_dropped_token":
            _moe_norm_err(torch, got, ref.moe_grouped_ffn(
                dispatch, combine, x, *ws))[1]}
    if not torch.equal(got[:, 3], torch.zeros_like(got[:, 3])):
        raise AssertionError("moe_grouped_ffn: a dropped token is not 0")
    dispatch = torch.rand(dispatch.shape, generator=gen, device="cuda") < 0.2
    dispatch[0, 0, 1, 0] = dispatch[0, 1, 1, 0] = True   # two in one slot
    combine = torch.rand(dispatch.shape, generator=gen, device="cuda")
    edge["random_dispatch_two_in_one_slot"] = _moe_norm_err(
        torch, moe_grouped_ffn(dispatch, combine, x, *ws),
        ref.moe_grouped_ffn(dispatch, combine, x, *ws))[1]
    del ws
    torch.cuda.empty_cache()
    # one small f32 case
    small = dataclasses.replace(cfg, n_experts=4)
    dispatch, combine = moe_route(torch, gen, small, 16)
    x = torch.randn((1, 16, 256), generator=gen, device="cuda")
    w32 = [torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5
           for s in ((4, 256, 512), (4, 256, 512), (4, 512, 256))]
    got = moe_grouped_ffn(dispatch, combine, x, *w32)
    want = ref.moe_grouped_ffn(dispatch, combine, x, *w32)
    torch.testing.assert_close(got, want, rtol=MOE_F32_TOL, atol=MOE_F32_TOL)
    edge["float32_max_abs_err"] = (got - want).abs().max().item()
    print("moe_grouped_ffn edge cases:", json.dumps(dict(
        **edge, tolerance=BF16_TOL, float32_tolerance=MOE_F32_TOL)),
        flush=True)
    if not max(edge["no_token_expert_and_dropped_token"],
               edge["random_dispatch_two_in_one_slot"]) <= BF16_TOL:
        raise AssertionError(f"moe_grouped_ffn edge cases: {edge}")
    worst = max(r["max_abs_err"] for r in rows.values())
    return {**rows["decode"], "max_abs_err": worst, "shapes": rows,
            "edge_cases": edge}


# the WKV recurrence at rwkv6-1.6b's width on the training path (batch 4 x
# 512 tokens, 32 heads of 64), ragged T at the smoke and full head dims, and
# a ragged T past eight 64-step chunks
WKV_MAIN = (4, 512, 32, 64)
WKV_RAGGED = ((4, 77, 32, 16), (4, 77, 32, 64), (4, 513, 32, 64))
WKV_RAGGED_BWD = (4, 513, 32, 64)


def wkv_plan_fields(B, T, H, hd, fwd: bool) -> dict:
    """The chunk, the blocks a pass launches and the launch plan of the WKV
    kernels of one direction, for the timing rows."""
    from repro_torch.kernels.rwkv6_scan import plan
    p = plan(B, T, H, hd)
    names = ("fwd_sum", "fwd") if fwd else ("bwd_sum", "bwd_dv", "bwd",
                                            "du")
    return dict(chunk=p["chunk"], blocks={n: p[n]["blocks"] for n in names},
                plan={n: {k: p[n][k] for k in ("grid", "threads", "smem")}
                      for n in names})
WKV_LIBRARY = "none: no single PyTorch call computes the WKV recurrence"
WKV_PLAIN_TIMING = "events without the spin: host-bound, host gaps included"


def wkv_inputs(torch, gen, B, T, H, hd, dtype, decay_mean=0.0):
    """r, k, v in ``dtype``; w = exp(-exp(x)), x ~ N(decay_mean, 1), and u
    in f32, the range and types the model gives the kernel (decay_mean 2
    puts w near 0)."""
    r, k, v = (torch.randn((B, T, H, hd), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    x = torch.randn((B, T, H, hd), generator=gen, device="cuda")
    u = torch.randn((H, hd), generator=gen, device="cuda") * 0.1
    return r, k, v, torch.exp(-torch.exp(x + decay_mean)), u


def check_rwkv6_scan(torch, ref, gen):
    """The WKV forward against its plain version: at the training shape in
    bf16 (w from N(0, 1) and near 0 from N(2, 1)) at rtol/atol 2e-2, at a
    ragged T = 77 in f32 at 1e-4 (head dims 16 and 64) and at T = 513 (nine
    chunks, the last one step), and its checkpointed states against
    ``ref.rwkv6_stateful`` over the first chunks and the last, f32 at 1e-4.  Timed as the training path calls it (with its
    checkpoints) beside its bound, the serial floor of T dependent steps
    and the plain version; there is no library call to time."""
    from repro_torch.kernels.rwkv6_scan import chunk, rwkv6_scan
    B, T, H, hd = WKV_MAIN
    errs = {}
    for mean in (0.0, 2.0):
        ins = wkv_inputs(torch, gen, B, T, H, hd, torch.bfloat16, mean)
        got, want = rwkv6_scan(*ins), ref.rwkv6(*ins)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)
        errs[f"bfloat16_decay_mean_{mean:g}"] = \
            (got.float() - want.float()).abs().max().item()
    for shape in WKV_RAGGED:
        ins = wkv_inputs(torch, gen, *shape, torch.float32)
        got, want = rwkv6_scan(*ins), ref.rwkv6(*ins)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        errs[f"float32_T{shape[1]}_hd{shape[3]}"] = \
            (got - want).abs().max().item()
    ins = wkv_inputs(torch, gen, B, T, H, hd, torch.float32)
    _, ckpt = rwkv6_scan(*ins, with_state=True)
    S0 = torch.zeros((B, H, hd, hd), device="cuda")
    ck_err = 0.0
    for c in (0, 1, 2, 3, ckpt.shape[2] - 1):
        t = c * chunk()
        _, want = ref.rwkv6_stateful(*(x[:, :t] for x in ins[:4]), ins[4], S0)
        torch.testing.assert_close(ckpt[:, :, c], want, rtol=F32_TOL,
                                   atol=F32_TOL)
        ck_err = max(ck_err, (ckpt[:, :, c] - want).abs().max().item())
    errs["float32_checkpoints"] = ck_err
    del ckpt
    # timing in bf16, the training path's dtype, with its checkpoints
    ins = wkv_inputs(torch, gen, B, T, H, hd, torch.bfloat16)
    y, ckpt = rwkv6_scan(*ins, with_state=True)
    # the bound counts the function's own traffic (r, k, v, w, u in, y out);
    # the checkpoints are this kernel's design, reported apart
    b_ms, b_by = bound(nbytes(*ins, y), 5.0 * hd * hd * B * T * H,
                       "float32")
    sets = rotation(ins)
    n = len(sets)
    ms, host_ms = time_ms(lambda i: rwkv6_scan(*sets[i % n], with_state=True),
                          20)
    row = dict(shape=[B, T, H, hd], dtype="bfloat16 r/k/v, float32 w/u",
               max_abs_err=max(errs.values()), errors=errs,
               tolerance=BF16_TOL, f32_tolerance=F32_TOL, ms=ms,
               host_ms=host_ms, serial_steps=T, ms_per_step=ms / T,
               plain_ms=time_ms(lambda i: ref.rwkv6(*sets[i % n]), 3,
                                spin=False)[0],
               plain_timing=WKV_PLAIN_TIMING, library_ms=None,
               library=WKV_LIBRARY, bound_ms=b_ms, bound_by=b_by,
               checkpoint_bytes=nbytes(ckpt),
               **wkv_plan_fields(B, T, H, hd, fwd=True))
    print("rwkv6_scan", json.dumps(row), flush=True)
    del sets, y, ckpt
    torch.cuda.empty_cache()
    return row


def check_rwkv6_scan_bwd(torch, ref, gen):
    """The WKV backward against torch autograd of the plain version in f32
    on the same inputs (f32 at rtol/atol 1e-4, du against its closed form
    sum_{b,t} r k (v . dy) in f64; bf16 to a normalized max error of 2e-2,
    the plain version run on the bf16 inputs upcast), at the training
    shape with w from N(0, 1) and near 0 from N(2, 1), and in f32 at
    T = 513 (nine chunks, the last one step).
    Timed in bf16 beside its bound, the serial floor and autograd of the
    plain version; there is no library call to time."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
    B, T, H, hd = WKV_MAIN
    errs = {}
    # the training shape at both decays in f32 and bf16 on one draw each,
    # then the ragged T = 513 in f32
    cases = [(WKV_MAIN, 0.0, (torch.float32, torch.bfloat16)),
             (WKV_MAIN, 2.0, (torch.float32, torch.bfloat16)),
             (WKV_RAGGED_BWD, 0.0, (torch.float32,))]
    for shape, mean, dts in cases:
        ins32 = wkv_inputs(torch, gen, *shape, torch.float32, mean)
        dy32 = torch.randn(shape, generator=gen, device="cuda")
        for dt in dts:
            ins = [x.to(dt) for x in ins32[:3]] + list(ins32[3:])
            dy = dy32.to(dt)
            leaves = [x.float().requires_grad_() for x in ins]
            want = torch.autograd.grad(ref.rwkv6(*leaves), leaves,
                                       dy.float())
            del leaves
            _, ckpt = rwkv6_scan(*ins, with_state=True)
            got = rwkv6_scan_bwd(*ins, ckpt, dy)
            torch.cuda.synchronize()
            key = f"{str(dt)[6:]}_decay_mean_{mean:g}" + (
                "" if shape == WKV_MAIN else f"_T{shape[1]}")
            if dt == torch.float32:
                for g, w in zip(got[:4], want[:4]):
                    torch.testing.assert_close(g, w, rtol=BWD_F32_TOL,
                                               atol=BWD_F32_TOL)
                # du sums B*T = 2048 terms of ~|v.dy|: autograd's f32
                # running sum drifts ~1e-3 from the exact value, so du is
                # held to its closed form in f64 instead
                du = torch.einsum("bthi,bthi,bth->hi", ins[0].double(),
                                  ins[1].double(),
                                  (ins[2].double() * dy.double()).sum(-1))
                torch.testing.assert_close(got[4].double(), du,
                                           rtol=BWD_F32_TOL,
                                           atol=BWD_F32_TOL)
                errs[key] = max([(g - w).abs().max().item()
                                 for g, w in zip(got[:4], want[:4])]
                                + [(got[4].double() - du).abs().max().item()])
                errs[key + "_du_autograd_vs_exact"] = \
                    (want[4].double() - du).abs().max().item()
            else:
                norm = max(((g.float() - w).abs().max()
                            / w.abs().max()).item()
                           for g, w in zip(got, want))
                if not norm <= BWD_BF16_NORM_TOL:
                    raise AssertionError(f"rwkv6_scan_bwd bf16 normalized "
                                         f"error {norm}")
                errs[key + "_normalized"] = norm
            del got, want, ckpt
    torch.cuda.empty_cache()
    # timing in bf16, the training path's dtype
    ins = wkv_inputs(torch, gen, B, T, H, hd, torch.bfloat16)
    dy = torch.randn((B, T, H, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    _, ckpt = rwkv6_scan(*ins, with_state=True)
    grads = rwkv6_scan_bwd(*ins, ckpt, dy)
    # the function's own traffic: r, k, v, w, u, dy in, the five gradients
    # out; the checkpoints it reads are the forward's design, reported apart
    b_ms, b_by = bound(nbytes(*ins, dy, *grads),
                       14.0 * hd * hd * B * T * H, "float32")
    sets = rotation((*ins, ckpt, dy))
    n = len(sets)
    ms, host_ms = time_ms(lambda i: rwkv6_scan_bwd(*sets[i % n]), 10)
    leaves = [x.float().requires_grad_() for x in ins]
    out = ref.rwkv6(*leaves)
    plain_ms = time_ms(lambda i: torch.autograd.grad(
        out, leaves, dy.float(), retain_graph=True), 3, spin=False)[0]
    row = dict(shape=[B, T, H, hd], dtype="bfloat16 r/k/v/dy, float32 w/u",
               max_abs_err=max(v for k, v in errs.items()
                               if k.startswith("float32")
                               and not k.endswith("exact")),
               errors=errs, tolerance=BWD_F32_TOL,
               bf16_tolerance=BWD_BF16_NORM_TOL, ms=ms, host_ms=host_ms,
               serial_steps=T, ms_per_step=ms / T, plain_ms=plain_ms,
               plain_timing=WKV_PLAIN_TIMING, library_ms=None,
               library=WKV_LIBRARY, bound_ms=b_ms, bound_by=b_by,
               checkpoint_bytes=nbytes(ckpt),
               **wkv_plan_fields(B, T, H, hd, fwd=False))
    print("rwkv6_scan_bwd", json.dumps(row), flush=True)
    del sets, leaves, out, grads, ckpt
    torch.cuda.empty_cache()
    return row


# the RG-LRU recurrence at recurrentgemma-2b's width on the training path
# (batch 4 x 512 tokens, 2560 channels), a ragged shape, and a ragged T one
# step past the training shape's chunks
LRU_MAIN = (4, 512, 2560)
LRU_RAGGED = ((4, 77, 200), (4, 513, 200))
LRU_LIBRARY = "none: no single PyTorch call computes the RG-LRU recurrence"
LRU_FWD_FLOPS = 6.0             # a step: a^2, 1 - a^2, sqrt, 2 products, sum
LRU_BWD_FLOPS = 10.0            # the gate again, dh, dx, da, the carry


def lru_inputs(torch, gen, B, T, D, dtype, draw="model"):
    """x ~ N(0, 1) and the decay a in ``dtype``: ``model`` as recurrentgemma
    makes it, exp(-8 softplus(lam) sigmoid(z)) with lam ~ N(0, 0.5^2) per
    channel (the init scale of ``lam``) and z ~ N(0, 1); ``near1`` puts
    1 - a in [5e-4, 4e-3], which bf16 rounds to 1 (g = 0) or 1 - 2^-8."""
    x = torch.randn((B, T, D), generator=gen, device="cuda")
    z = torch.randn((B, T, D), generator=gen, device="cuda")
    if draw == "model":
        lam = 0.5 * torch.randn((D,), generator=gen, device="cuda")
        a = torch.exp(-8.0 * torch.nn.functional.softplus(lam)
                      * torch.sigmoid(z))
    else:
        a = 1.0 - (5e-4 + 3.5e-3 * torch.sigmoid(z))
    return x.to(dtype), a.to(dtype)


def lru_plan_fields(torch, B, T, D) -> dict:
    """The chunk (the dependent steps a thread walks), the threads a pass
    and the launch plan of the RG-LRU kernels at bf16, for the timing
    rows."""
    from repro_torch.kernels.rglru_scan import plan
    p = plan(B, T, D, torch.bfloat16)
    return dict(chunk=p["chunk"], serial_steps=p["chunk"],
                threads=p["threads_total"],
                plan={k: p[k] for k in ("grid", "threads", "slots", "lanes",
                                        "windows", "smem_fwd", "smem_bwd")})


def lru_chunk_ends(T: int) -> list[int]:
    """The step each RG-LRU checkpoint follows: each chunk's last."""
    from repro_torch.kernels.rglru_scan import chunk
    return [min(t + chunk(), T) - 1 for t in range(0, T, chunk())]


def check_rglru_scan(torch, ref, gen):
    """The RG-LRU forward against its plain version: at the training shape
    in bf16 (a from the model's map, and a near 1, where bf16 makes it 1 and
    g = 0) at rtol/atol 2e-2, at ragged T 77 and 513 (one step past the
    training shape's chunks), D 200 in f32 at 1e-4, and on strided inputs
    (x a slice of a wider tensor, a with a transposed batch layout) in f32
    at 1e-4; its checkpoints (the f32 state at each chunk's last step)
    against the plain version's states there in f32 at 1e-4.  Timed as the
    training path calls it (with its checkpoints) beside its bound and the
    plain version; there is no library call to time."""
    from repro_torch.kernels.rglru_scan import rglru_scan
    B, T, D = LRU_MAIN
    errs = {}
    for draw in ("model", "near1"):
        x, a = lru_inputs(torch, gen, B, T, D, torch.bfloat16, draw)
        got, want = rglru_scan(x, a), ref.rglru(x, a)[0]
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)
        errs[f"bfloat16_{draw}"] = \
            (got.float() - want.float()).abs().max().item()
        if draw == "near1":
            errs["bfloat16_near1_saturated_share"] = \
                (a == 1.0).float().mean().item()
    for shape in LRU_RAGGED:
        x, a = lru_inputs(torch, gen, *shape, torch.float32)
        got, ck = rglru_scan(x, a, with_state=True)
        want = ref.rglru(x, a)[0]
        torch.cuda.synchronize()
        for name, t, w in (("", got, want), ("_checkpoints", ck,
                                             want[:, lru_chunk_ends(shape[1])])):
            torch.testing.assert_close(t, w, rtol=F32_TOL, atol=F32_TOL)
            errs[f"float32_T{shape[1]}_D{shape[2]}{name}"] = \
                (t - w).abs().max().item()
    x, a = lru_inputs(torch, gen, *LRU_RAGGED[0], torch.float32)
    want = ref.rglru(x, a)[0]
    xs = torch.cat([x, x], 2)[..., LRU_RAGGED[0][2]:]
    as_ = a.transpose(0, 1).contiguous().transpose(0, 1)
    got = rglru_scan(xs, as_)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    errs["float32_strided"] = (got - want).abs().max().item()
    # timing in bf16, the training path's dtype, with its checkpoints
    x, a = lru_inputs(torch, gen, B, T, D, torch.bfloat16)
    y, ck = rglru_scan(x, a, with_state=True)
    # the bound counts the function's own traffic (x, a in, h out); the f32
    # checkpoints are this kernel's design, reported apart
    b_ms, b_by = bound(nbytes(x, a, y), LRU_FWD_FLOPS * B * T * D,
                       "float32")
    sets = rotation((x, a))
    n = len(sets)
    ms, host_ms = time_ms(lambda i: rglru_scan(*sets[i % n],
                                               with_state=True), 20)
    row = dict(shape=[B, T, D], dtype="bfloat16", max_abs_err=max(
                   v for k, v in errs.items() if not k.endswith("share")),
               errors=errs, tolerance=BF16_TOL, f32_tolerance=F32_TOL,
               ms=ms, host_ms=host_ms,
               plain_ms=time_ms(lambda i: ref.rglru(*sets[i % n]), 3,
                                spin=False)[0],
               plain_timing=WKV_PLAIN_TIMING, library_ms=None,
               library=LRU_LIBRARY, bound_ms=b_ms, bound_by=b_by,
               state_bytes=nbytes(ck), **lru_plan_fields(torch, B, T, D))
    print("rglru_scan", json.dumps(row), flush=True)
    del sets, y, ck
    torch.cuda.empty_cache()
    return row


def check_rglru_scan_bwd(torch, ref, gen):
    """The RG-LRU backward against torch autograd of the plain version in
    f32 on the same inputs, where a < 1 (f32 at rtol/atol 1e-4; bf16 to a
    normalized max error of 2e-2, the plain version run on the bf16 inputs
    upcast) at the training shape, a from the model's map, and in f32 at
    T 513, D 200 (one step past the training shape's chunks); the value at
    g = 0 pinned (a band of steps with a = 1: dx = 0 and da = dh h_{t-1}
    exactly as its closed form from the plain version's states, and finite
    where autograd of the plain version is not); two runs bit for bit.
    Timed in bf16 beside its bound and autograd of the plain version; there
    is no library call to time."""
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    B, T, D = LRU_MAIN
    errs = {}
    x32, a32 = lru_inputs(torch, gen, B, T, D, torch.float32)
    dy32 = torch.randn((B, T, D), generator=gen, device="cuda")
    xr, ar = lru_inputs(torch, gen, *LRU_RAGGED[1], torch.float32)
    dyr = torch.randn(LRU_RAGGED[1], generator=gen, device="cuda")
    for key, (x, a, dy) in (
            ("float32", (x32, a32, dy32)),
            ("bfloat16", (t.to(torch.bfloat16) for t in (x32, a32, dy32))),
            ("float32_T513", (xr, ar, dyr))):
        if not a.max().item() < 1.0:
            raise AssertionError("rglru_scan_bwd: the draw reached a = 1")
        leaves = [t.float().requires_grad_() for t in (x, a)]
        want = torch.autograd.grad(ref.rglru(*leaves)[0], leaves,
                                   dy.float())
        _, ck = rglru_scan(x, a, with_state=True)
        got = rglru_scan_bwd(x, a, ck, dy)
        torch.cuda.synchronize()
        if key.startswith("float32"):
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=BWD_F32_TOL,
                                           atol=BWD_F32_TOL)
            errs[key] = max((g - w).abs().max().item()
                            for g, w in zip(got, want))
        else:
            norm = max(((g.float() - w).abs().max() / w.abs().max()).item()
                       for g, w in zip(got, want))
            if not norm <= BWD_BF16_NORM_TOL:
                raise AssertionError(f"rglru_scan_bwd bf16 normalized "
                                     f"error {norm}")
            errs["bfloat16_normalized"] = norm
        del leaves, want, got, ck
    # the value at g = 0, in f32 (bf16 rounds a >= 0.998046875 to 1)
    n = min(64, T)
    x, a = x32[:, :n].contiguous(), a32[:, :n].clone()
    a[:, 8:n - 8:4] = 1.0
    dy = dy32[:, :n].contiguous()
    _, ck = rglru_scan(x, a, with_state=True)
    dx, da = rglru_scan_bwd(x, a, ck, dy)
    h = ref.rglru(x, a)[0]
    hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    dh, c = torch.empty_like(dy), torch.zeros_like(dy[:, 0])
    for t in range(n - 1, -1, -1):
        dh[:, t] = dy[:, t] + c
        c = a[:, t] * dh[:, t]
    sat = a == 1.0
    leaves = [t.clone().requires_grad_() for t in (x, a)]
    plain_da = torch.autograd.grad(ref.rglru(*leaves)[0], leaves, dy)[1]
    torch.cuda.synchronize()
    torch.testing.assert_close(da[sat], (dh * hprev)[sat], rtol=BWD_F32_TOL,
                               atol=BWD_F32_TOL)
    pinned = (torch.equal(dx[sat], torch.zeros_like(dx[sat]))
              and bool(torch.isfinite(da).all())
              and not bool(torch.isfinite(plain_da[sat]).all()))
    errs["g0_da_err"] = (da[sat] - (dh * hprev)[sat]).abs().max().item()
    if not pinned:
        raise AssertionError("rglru_scan_bwd: the g = 0 rule does not hold")
    del leaves, plain_da
    # two runs, bit for bit
    x, a, dy = x32.to(torch.bfloat16), a32.to(torch.bfloat16), \
        dy32.to(torch.bfloat16)
    _, ck = rglru_scan(x, a, with_state=True)
    first = rglru_scan_bwd(x, a, ck, dy)
    again = rglru_scan_bwd(x, a, ck, dy)
    if not all(torch.equal(p, q) for p, q in zip(first, again)):
        raise AssertionError("rglru_scan_bwd is not deterministic")
    # timing in bf16, the training path's dtype: the function's own traffic
    # (x, a, dy in, dx, da out); the f32 checkpoints it reads are the
    # forward's design, reported apart
    b_ms, b_by = bound(nbytes(x, a, dy, *first),
                       LRU_BWD_FLOPS * B * T * D, "float32")
    sets = rotation((x, a, ck, dy))
    n = len(sets)
    ms, host_ms = time_ms(lambda i: rglru_scan_bwd(*sets[i % n]), 20)
    leaves = [t.float().requires_grad_() for t in (x, a)]
    out = ref.rglru(*leaves)[0]
    plain_ms = time_ms(lambda i: torch.autograd.grad(
        out, leaves, dy.float(), retain_graph=True), 3, spin=False)[0]
    row = dict(shape=[B, T, D], dtype="bfloat16",
               max_abs_err=max(errs["float32"], errs["float32_T513"]),
               errors=errs,
               tolerance=BWD_F32_TOL, bf16_tolerance=BWD_BF16_NORM_TOL,
               g0_rule_pinned=pinned, deterministic=True, ms=ms,
               host_ms=host_ms, plain_ms=plain_ms,
               plain_timing=WKV_PLAIN_TIMING, library_ms=None,
               library=LRU_LIBRARY, bound_ms=b_ms, bound_by=b_by,
               state_bytes=nbytes(ck), **lru_plan_fields(torch, B, T, D))
    print("rglru_scan_bwd", json.dumps(row), flush=True)
    del sets, leaves, out, first, again, ck
    torch.cuda.empty_cache()
    return row


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
    small_chunked(torch, cfg, params)


# the four chunked configurations of the small f32 run; "pressure" evicts
# trie pages under a pool of one spare sequence
SMALL_CHUNKED = {"chunked": dict(prefill_chunk=8),
                 "prefix": dict(prefix_cache=True),
                 "pressure": dict(prefix_cache=True, prefix_seqs=1),
                 "sampled": dict(prefix_cache=True, temperature=0.8,
                                 top_p=0.9, sample_seed=7)}


def small_chunked(torch, cfg, params):
    """Chunked prefill, the prefix cache and sampling on the narrow f32
    model: greedy tokens CUDA == CPU and chunked == prefix-cached ==
    static whole-prompt on the card; sampled tokens the same under
    continuous + prefix cache and static on the card, and not greedy's."""
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   shared_prefix_requests)
    base = dict(batch_size=3, page_size=8, cache_len=56, clock="steps")
    reqs = shared_prefix_requests(10, 100.0, cfg.vocab_size, n_prefixes=3,
                                  prefix_len=16, suffix_lens=(4, 8),
                                  gen_lens=(2, 4, 8), seed=3)
    pressure = shared_prefix_requests(12, 100.0, cfg.vocab_size,
                                      n_prefixes=6, prefix_len=16,
                                      suffix_lens=(4, 8), gen_lens=(2, 4, 8),
                                      seed=9)
    sampling = {k: v for k, v in SMALL_CHUNKED["sampled"].items()
                if k != "prefix_cache"}
    reps = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        for name, kw in SMALL_CHUNKED.items():
            rq = pressure if name == "pressure" else reqs
            reps[name, dev] = ServeEngine(cfg, p, ServeConfig(
                **kw, **base)).run(rq)
        for name, kw, rq in (("static", {}, reqs),
                             ("static_pressure", {}, pressure),
                             ("static_sampled", sampling, reqs)):
            reps[name, dev] = ServeEngine(cfg, p, ServeConfig(
                continuous=False, **kw, **base)).run(rq)
    out = {k: r.outputs for k, r in reps.items()}
    checks = {
        "cuda_eq_cpu": all(out[n, "cuda"] == out[n, "cpu"]
                           for n, _ in reps if n not in ("sampled",
                                                         "static_sampled")),
        "chunked_eq_prefix_eq_static": out["chunked", "cuda"]
        == out["prefix", "cuda"] == out["static", "cuda"],
        "pressure_eq_static": out["pressure", "cuda"]
        == out["static_pressure", "cuda"],
        "sampled_schedule_invariant": out["sampled", "cuda"]
        == out["static_sampled", "cuda"],
        "sampled_ne_greedy": out["sampled", "cuda"] != out["static", "cuda"]}
    print("small f32 chunked / prefix / sampled:", json.dumps(dict(
        **checks, prefill_chunks={n: reps[n, "cuda"].prefill_chunks
                                  for n in SMALL_CHUNKED},
        prefix_hit_rate={n: reps[n, "cuda"].prefix_hit_rate
                         for n in SMALL_CHUNKED})), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"small chunked run: {checks}")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


SERVING_KERNELS = ("flash_attention", "page_gather", "decode_attention")


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
    return {"serving": launches[True],
            "chunked_serving": chunked_serving(torch, ops, ref, cfg, params,
                                               common)}


def small_moe(torch):
    """The MoE serving path on a narrow f32 mixtral (4 experts, top-2,
    window 16, so the ring wraps): CUDA kernels on the card vs plain
    versions on the CPU, same params and requests, at capacity factor
    1.25 (whole prompt, chunked and prefix-cached: same greedy tokens,
    prefill logits within 1e-3); then at 4.0, where no token is dropped,
    continuous == static greedy tokens on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests, shared_prefix_requests)
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), d_model=256,
                              n_heads=8, n_kv_heads=2, head_dim=64,
                              d_ff=512, dtype=torch.float32)
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(1))
    V = cfg.vocab_size
    reqs = open_loop_requests(6, 1.0, V, prompt_lens=(8, 40),
                              gen_lens=(4, 12), seed=1)
    shared = shared_prefix_requests(8, 100.0, V, n_prefixes=2, prefix_len=8,
                                    suffix_lens=(4, 8), gen_lens=(4, 8),
                                    seed=3)
    base = dict(batch_size=3, page_size=8, cache_len=56, clock="steps")
    runs = {"whole": ({}, reqs), "chunked": (dict(prefill_chunk=8), reqs),
            "prefix": (dict(prefix_cache=True), shared)}
    reps, logits = {}, {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        for name, (kw, rq) in runs.items():
            reps[name, dev] = ServeEngine(cfg, p, ServeConfig(
                **kw, **base)).run(rq)
        toks = torch.tensor([reqs[1].prompt], device=dev)
        logits[dev] = prefill(p, toks, cfg, cache_len=56)[0].cpu()
    err = (logits["cpu"] - logits["cuda"]).abs().max().item()
    same = {name: reps[name, "cpu"].outputs == reps[name, "cuda"].outputs
            for name in runs}
    wide = dataclasses.replace(cfg, capacity_factor=4.0)
    p = _to(params, "cuda")
    cont, static = (ServeEngine(wide, p, ServeConfig(
        continuous=c, **base)).run(reqs).outputs for c in (True, False))
    print("small f32 MoE:", json.dumps(dict(
        prefill_logits_max_abs_err_cuda_vs_cpu=err,
        greedy_tokens_cuda_eq_cpu=same,
        prefill_chunks={n: reps[n, "cuda"].prefill_chunks for n in runs},
        prefix_hit_rate=reps["prefix", "cuda"].prefix_hit_rate,
        continuous_eq_static_at_cf4=cont == static)), flush=True)
    if not all(same.values()):
        raise AssertionError(f"MoE greedy tokens differ CUDA vs CPU: {same}")
    if not err <= 1e-3:
        raise AssertionError(f"MoE prefill logits differ by {err}")
    if not reps["prefix", "cuda"].prefix_hit_rate > 0:
        raise AssertionError("the MoE prefix-cached run hit nothing")
    if cont != static:
        raise AssertionError("MoE continuous != static at capacity 4.0")


# mixtral-8x7b at full width, cut from 32 layers to MOE_DEPTH so its bf16
# weights (23.7 GB) fit one 80 GB card beside their f32 draw
MOE_DEPTH = 8
MOE_KERNELS = ("moe_grouped_ffn", "flash_attention", "page_gather",
               "decode_attention")


@contextlib.contextmanager
def plain_route(ops):
    """Send CUDA tensors through the plain versions while the block runs
    (the dispatch asks ``_on_cuda`` at each call)."""
    saved = ops._on_cuda
    ops._on_cuda = lambda t: False
    try:
        yield
    finally:
        ops._on_cuda = saved


@contextlib.contextmanager
def routing_traced(ops):
    """Record the ``dispatch`` of every MoE layer while the block runs."""
    seen, saved = [], ops.moe_grouped_ffn

    def spy(dispatch, *rest):
        seen.append(dispatch.clone())
        return saved(dispatch, *rest)
    ops.moe_grouped_ffn = spy
    try:
        yield seen
    finally:
        ops.moe_grouped_ffn = saved


def moe_serving(torch, ops, ref):
    """mixtral-8x7b at full width and depth 8 in bf16, random weights from
    seed 0, built leaf by leaf (each f32 leaf drawn, cast and freed): the
    MoE serving path.  Continuous and static runs on the steps clock
    (launch counts reset just before the continuous run, read just after;
    exact counts for the grouped FFN and the attention kernels, no plain
    version); the first-token logits of the kernels against the plain
    versions on the card; a wall-clock run; a chunked, prefix-cached run;
    and a device profile."""
    from repro_torch.configs import get_config
    from repro_torch.models import paramlib
    from repro_torch.models.config import BlockGroup
    from repro_torch.models.transformer import model_specs, prefill
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   open_loop_requests, serving_leaf,
                                   shared_prefix_requests)
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, groups=(BlockGroup(("swa",),
                                                       MOE_DEPTH),))
    n_layers = MOE_DEPTH
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype, leaf_fn=lambda k, t: serving_leaf(k, t, cfg))
    torch.cuda.synchronize()
    print(f"mixtral-8x7b depth {MOE_DEPTH} of {len(full.layer_kinds)}: "
          f"{paramlib.param_count(model_specs(cfg))} params (bf16 serving "
          f"copy, router f32) in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)

    V = cfg.vocab_size
    common = dict(batch_size=8, page_size=16, cache_len=MAIN_L)
    reqs = open_loop_requests(16, 0.5, V, prompt_lens=(128, 300, 512),
                              gen_lens=(16, 32), seed=0)
    toks = torch.tensor([reqs[0].prompt], device="cuda")
    with routing_traced(ops) as kernel_routes:
        got, _ = prefill(params, toks, cfg, cache_len=MAIN_L)
    with plain_route(ops), routing_traced(ops) as plain_routes:
        want, _ = prefill(params, toks, cfg, cache_len=MAIN_L)
    if got.shape != (1, V) or not torch.isfinite(got).all():
        raise AssertionError("mixtral prefill logits are not finite")
    norm = ((got - want).abs().max() / want.abs().max()).item()
    # bf16 rounds differently on the two paths (the kernel keeps f32 until
    # its output), and a token whose top-2 choice flips, or which another
    # flip pushes over an expert's capacity, takes other experts: the
    # share of tokens routed differently, layer by layer, says how far
    # the two paths' inputs have drifted apart
    moved = [(a.any(-1) != b.any(-1)).any(-1).float().mean().item()
             for a, b in zip(kernel_routes, plain_routes)]
    print("mixtral first-token logits, kernels vs plain versions on the "
          "card (bf16; not gated):", json.dumps(dict(
              prompt_len=len(reqs[0].prompt), normalized_err=norm,
              tokens_routed_differently_by_layer=moved)), flush=True)

    reports, launches = {}, {}
    n_prefills = len(reqs) + len({len(r.prompt) for r in reqs})  # + warmup
    for cont in (True, False):
        eng = ServeEngine(cfg, params, ServeConfig(continuous=cont,
                                                   clock="steps", **common))
        ops.reset_launches()                 # the MoE serving path starts
        t0 = time.perf_counter()
        with plain_versions_counted(ref) as plain_calls:
            rep = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[cont] = dict(ops.launches)  # ... and ends here
        reports[cont] = rep
        steps = rep.decode_steps + 1         # + the warmup's decode step
        want_l = {"moe_grouped_ffn": n_layers * (n_prefills + steps),
                  "flash_attention": n_layers * n_prefills,
                  "decode_attention": n_layers * steps,
                  "page_gather": 2 * n_layers * steps}
        print(f"mixtral {rep.mode} (steps clock): {rep.total_tokens} tokens, "
              f"{rep.decode_steps} decode steps, utilization "
              f"{rep.utilization:.3f}, {dt:.2f} s host time; launches "
              f"{launches[cont]}; expected {want_l}; plain version calls "
              f"{plain_calls}", flush=True)
        if any(launches[cont][k] != v for k, v in want_l.items()):
            raise AssertionError(f"launches {launches[cont]}, want {want_l}")
        if any(plain_calls.values()):
            raise AssertionError(f"plain versions ran: {plain_calls}")
        for r in reqs:
            out = rep.outputs[r.rid]
            if len(out) != r.gen_len or not all(0 <= t < V for t in out):
                raise AssertionError(f"request {r.rid}: bad output {out}")
    share = sum(reports[True].outputs[r.rid] == reports[False].outputs[r.rid]
                for r in reqs) / len(reqs)
    print("mixtral continuous vs static greedy requests equal (capacity "
          "1.25 drops depend on the batch; not gated):", share, flush=True)

    torch.cuda.reset_peak_memory_stats()
    wreqs = open_loop_requests(16, 50.0, V, prompt_lens=(128, 300, 512),
                               gen_lens=(16, 32), seed=0)
    rep = ServeEngine(cfg, params, ServeConfig(
        continuous=True, clock="wall", **common)).run(wreqs)
    print("mixtral wall clock continuous:", json.dumps(dict(
        tokens=rep.total_tokens, duration_s=rep.duration,
        tok_per_s=rep.tokens_per_sec, latency_p50_s=rep.latency_p50,
        latency_p99_s=rep.latency_p99, ttft_p50_s=rep.ttft_p50,
        ttft_p99_s=rep.ttft_p99, decode_steps=rep.decode_steps,
        utilization=rep.utilization,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)),
        flush=True)

    sreqs = shared_prefix_requests(16, 0.5, V, n_prefixes=4, prefix_len=256,
                                   suffix_lens=(64, 192), gen_lens=(16, 32),
                                   seed=0)
    eng = ServeEngine(cfg, params, ServeConfig(
        clock="steps", prefill_chunk=CHUNK, prefix_cache=True, **common))
    ops.reset_launches()
    with plain_versions_counted(ref) as plain_calls:
        rep = eng.run(sreqs)
    torch.cuda.synchronize()
    chunked = dict(ops.launches)
    want_c = {"prefill_page_attention": n_layers * (rep.prefill_chunks + 1),
              "moe_grouped_ffn": n_layers * (rep.prefill_chunks + 1
                                             + rep.decode_steps + 1),
              "page_gather": 2 * chunked["decode_attention"]}
    print("mixtral chunked, prefix-cached (steps clock):", json.dumps(dict(
        tokens=rep.total_tokens, decode_steps=rep.decode_steps,
        prefill_chunks=rep.prefill_chunks,
        prefix_hit_rate=rep.prefix_hit_rate, launches=chunked,
        expected=want_c, plain_version_calls=plain_calls)), flush=True)
    if any(chunked[k] != v for k, v in want_c.items()):
        raise AssertionError(f"chunked launches {chunked}, want {want_c}")
    if any(plain_calls.values()) or not rep.prefix_hit_rate > 0.3:
        raise AssertionError(f"chunked run: plain {plain_calls}, hit rate "
                             f"{rep.prefix_hit_rate}")
    for r in sreqs:
        out = rep.outputs[r.rid]
        if len(out) != r.gen_len or not all(0 <= t < V for t in out):
            raise AssertionError(f"chunked request {r.rid}: bad {out}")
    where_time_goes(torch, cfg, params, common, label="mixtral profile")
    del params
    torch.cuda.empty_cache()
    return launches[True]


CHUNK = 128
CHUNKED_KERNELS = ("prefill_page_attention", "page_gather",
                   "decode_attention")
LOGITS_NORM_TOL = 2e-2          # bf16 first-token logits: max |d| / max |l|


def chunked_serving(torch, ops, ref, cfg, params, common):
    """llama3.2-1b at full width through chunked prefill (chunk 128), the
    prefix cache and nucleus sampling, on 16 shared-prefix requests (4 hot
    256-token prefixes, suffixes 64/192, generations 16/32): the chunked
    serving path.  Launch counts are set to 0 before its three
    ``steps``-clock runs and read after them."""
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   shared_prefix_requests)
    V = cfg.vocab_size
    n_layers = sum(g.n * len(g.pattern) for g in cfg.groups)
    reqs = shared_prefix_requests(16, 0.5, V, n_prefixes=4, prefix_len=256,
                                  suffix_lens=(64, 192), gen_lens=(16, 32),
                                  seed=0)
    runs = {"chunked": dict(prefill_chunk=CHUNK),
            "prefix": dict(prefill_chunk=CHUNK, prefix_cache=True),
            "sampled": dict(prefill_chunk=CHUNK, prefix_cache=True,
                            temperature=0.8, top_p=0.9, sample_seed=7)}
    reps, per_run = {}, {}
    ops.reset_launches()                 # the chunked path starts here
    with plain_versions_counted(ref) as plain_calls:
        for name, kw in runs.items():
            eng = ServeEngine(cfg, params, ServeConfig(clock="steps", **kw,
                                                       **common))
            before = dict(ops.launches)
            t0 = time.perf_counter()
            reps[name] = rep = eng.run(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_run[name] = {k: ops.launches[k] - before[k]
                             for k in ops.launches}
            # the warmup runs one chunk before the clock starts
            want = n_layers * (rep.prefill_chunks + 1)
            print(f"{name} (steps clock): {rep.total_tokens} tokens, "
                  f"{rep.decode_steps} decode steps, {rep.prefill_chunks} "
                  f"prefill chunks (+1 in the warmup), prefix hit rate "
                  f"{rep.prefix_hit_rate:.4f}, {dt:.2f} s host time; "
                  f"launches {per_run[name]}; prefill_page_attention "
                  f"expected {want}", flush=True)
            if per_run[name]["prefill_page_attention"] != want:
                raise AssertionError(f"{name}: prefill_page_attention "
                                     f"launched {per_run[name]}, want {want}")
            # the chunks read the pools in place: every gather is decode's
            if per_run[name]["page_gather"] != \
                    2 * per_run[name]["decode_attention"]:
                raise AssertionError(f"{name}: page_gather launched "
                                     f"{per_run[name]}, want 2 x "
                                     "decode_attention")
            if min(per_run[name][k] for k in CHUNKED_KERNELS) <= 0:
                raise AssertionError(f"{name}: a kernel never launched")
    launches = dict(ops.launches)        # ... and ends here
    print(f"chunked path: launches {launches}; plain version calls "
          f"{plain_calls}", flush=True)
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran: {plain_calls}")
    for name, rep in reps.items():
        for r in reqs:
            toks = rep.outputs[r.rid]
            if len(toks) != r.gen_len or not all(0 <= t < V for t in toks):
                raise AssertionError(f"{name} request {r.rid}: bad output "
                                     f"{toks}")
    for name in ("prefix", "sampled"):
        if not reps[name].prefix_hit_rate > 0.3:
            raise AssertionError(f"{name}: prefix hit rate "
                                 f"{reps[name].prefix_hit_rate}")
    if not reps["prefix"].prefill_chunks < reps["chunked"].prefill_chunks:
        raise AssertionError("the prefix cache saved no chunk")
    if reps["sampled"].outputs == reps["prefix"].outputs:
        raise AssertionError("sampled tokens equal the greedy ones")
    static = ServeEngine(cfg, params, ServeConfig(
        continuous=False, clock="steps", **common)).run(reqs)
    share = {name: sum(reps[name].outputs[r.rid] == static.outputs[r.rid]
                       for r in reqs) / len(reqs)
             for name in ("chunked", "prefix")}
    print("greedy requests equal to the static whole-prompt run (bf16, "
          "not gated):", json.dumps(share), flush=True)
    first_token_logits(torch, cfg, params, reqs, common)

    wreqs = shared_prefix_requests(16, 50.0, V, n_prefixes=4,
                                   prefix_len=256, suffix_lens=(64, 192),
                                   gen_lens=(16, 32), seed=0)
    torch.cuda.reset_peak_memory_stats()
    rep = ServeEngine(cfg, params, ServeConfig(
        clock="wall", **runs["prefix"], **common)).run(wreqs)
    print("wall clock prefix-cached:", json.dumps(dict(
        tokens=rep.total_tokens, duration_s=rep.duration,
        tok_per_s=rep.tokens_per_sec, latency_p50_s=rep.latency_p50,
        latency_p99_s=rep.latency_p99, ttft_p50_s=rep.ttft_p50,
        ttft_p99_s=rep.ttft_p99, decode_steps=rep.decode_steps,
        prefill_chunks=rep.prefill_chunks,
        prefix_hit_rate=rep.prefix_hit_rate, utilization=rep.utilization,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)),
        flush=True)

    from torch.profiler import ProfilerActivity, profile
    preqs = [dataclasses.replace(r, arrival=0.0) for r in wreqs[:8]]
    eng = ServeEngine(cfg, params, ServeConfig(clock="steps", warmup=False,
                                               **runs["prefix"], **common))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(preqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_profile(torch, prof, wall_ms, "chunked profile",
                   requests=len(preqs), decode_steps=rep.decode_steps,
                   prefill_chunks=rep.prefill_chunks,
                   prefix_hit_rate=rep.prefix_hit_rate,
                   tokens=rep.total_tokens)
    return launches


def first_token_logits(torch, cfg, params, reqs, common):
    """For the first request of each hot prefix (prefix + its suffix), the
    last logits of ``prefill_chunk`` over the engine's end-aligned chunk
    plan against the whole-prompt ``prefill``: max |d| / max |logit|."""
    from repro_torch.models.transformer import (init_chunk_carry, prefill,
                                                prefill_chunk)
    from repro_torch.serve import PageAllocator, init_paged_cache
    L, page = common["cache_len"], common["page_size"]
    seen, errs = set(), []
    for r in reqs:
        if r.prompt[:256] in seen:
            continue
        seen.add(r.prompt[:256])
        S = len(r.prompt)
        alloc = PageAllocator(cfg, 1, L, page)
        cache = init_paged_cache(cfg, 1, L, page, device="cuda")
        rows = {k: torch.from_numpy(v).cuda()
                for k, v in alloc.alloc(0).items()}
        carry = init_chunk_carry(cfg)
        for s0 in list(range(0, S - CHUNK, CHUNK)) + [S - CHUNK]:
            toks = torch.tensor([r.prompt[s0:s0 + CHUNK]], device="cuda")
            got, cache, carry = prefill_chunk(params, cache, toks, s0, rows,
                                              carry, cfg, L)
        want, _ = prefill(params, torch.tensor([r.prompt], device="cuda"),
                          cfg, cache_len=L)
        errs.append(((got.float() - want.float()).abs().max()
                     / want.float().abs().max()).item())
        del cache
    print("first-token logits, chunked vs whole prompt:", json.dumps(dict(
        prompts=len(errs), normalized_err=errs, tolerance=LOGITS_NORM_TOL)),
        flush=True)
    if len(errs) != 4 or not max(errs) <= LOGITS_NORM_TOL:
        raise AssertionError(f"first-token logits differ: {errs}")


KERNEL_GROUPS = (("flash_attention", "flash_fwd_kernel"),
                 ("flash_attention_bwd", "flash_bwd_"),
                 ("decode_attention", "decode_split_kernel"),
                 ("page_gather", "page_gather_kernel"),
                 ("ring_gather", "ring_gather_kernel"),
                 ("prefill_page_attention", "prefill_page_attention_kernel"),
                 ("moe_grouped_ffn", ("moe_dispatch_kernel",
                                      "moe_mma_kernel", "moe_gemm_kernel",
                                      "moe_combine_kernel")),
                 ("rwkv6_scan", ("rwkv6_fwd_sum_kernel", "rwkv6_fwd_kernel")),
                 ("rwkv6_scan_bwd", ("rwkv6_bwd_sum_kernel",
                                     "rwkv6_bwd_dv_kernel", "rwkv6_bwd_kernel",
                                     "rwkv6_du_kernel")),
                 ("rglru_scan", "rglru_fwd_kernel"),
                 ("rglru_scan_bwd", "rglru_bwd_kernel"),
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
            if "rwkv6_" in e.key or "rglru_" in e.key:
                # every recurrence kernel belongs to its group
                raise AssertionError(f"{label}: {e.key} in no kernel group")
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


def where_time_goes(torch, cfg, params, common, label="profile"):
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
    print(f"{label} host clock:", json.dumps(dict(
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
    device_profile(torch, prof, wall_ms, label, requests=len(reqs),
                   decode_steps=rep.decode_steps, tokens=rep.total_tokens)


# ---------------------------------------------------------------------------
# phases 5 and 6: training
# ---------------------------------------------------------------------------

PLAIN_VERSIONS = ("attention", "attention_chunked", "attention_decode",
                  "page_gather", "ring_gather", "prefill_page_attention",
                  "moe_grouped_ffn", "rwkv6", "rwkv6_stateful", "rglru")


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


def small_train_config(torch, arch: str):
    """The narrow f32 model of the small training run: llama3.2-1b's smoke
    config widened to d 256 and head dim 64; rwkv6-1.6b's and
    recurrentgemma-2b's smoke configs as they are (d 64, 4 heads of 16;
    recurrentgemma's window of 16 wraps at the run's 96 tokens)."""
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    if arch == "llama3.2-1b":
        cfg = dataclasses.replace(cfg, d_model=256, n_heads=8, n_kv_heads=2,
                                  head_dim=64, d_ff=512)
    return cfg


def small_training(torch, arch):
    """The training path on a narrow f32 model: CUDA kernels on the card vs
    plain versions on the CPU, then the engine's bit-identities on the
    card under deterministic algorithms."""
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.pdb import make_delayed_step, init_delayed_state
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import leaves_with_path
    cfg = small_train_config(torch, arch)
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
        arch=arch, loss_rel_err_cuda_vs_cpu=loss_err,
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
    print(f"deterministic, on the card ({arch}): delta=0 == sync bit for "
          f"bit: {same0}; packed == tree at delta 2 bit for bit: "
          f"{same_layout}", flush=True)
    if not (same0 and same_layout):
        raise AssertionError("a bit-identity of the engine failed")


TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_DELTA = 4, 512, 8, 2
# per trained arch: the kernels a layer of each kind launches once per step
# (forward and backward), and per slot of the first group the projections
# of its layer 0 that must get a gradient
FLASH = ("flash_attention", "flash_attention_bwd")
TRAIN_RUNS = {
    "llama3.2-1b": ({"attn": FLASH}, {"s0": ("wq", "wk", "wv")}),
    "rwkv6-1.6b": ({"rwkv6": ("rwkv6_scan", "rwkv6_scan_bwd")},
                   {"s0": ("wr", "wk", "wv", "decay_w1", "bonus_u")}),
    "recurrentgemma-2b": ({"rglru": ("rglru_scan", "rglru_scan_bwd"),
                           "local": FLASH},
                          {"s0": ("wx", "wa", "wi", "lam", "conv_w"),
                           "s2": ("wq", "wk", "wv")}),
}
# depth cuts, every width kept: recurrentgemma-2b's 26 layers (2,894,574,080
# parameters) need 69.5 GB of engine state at delta 2 (12 + 4 (delta + 1)
# bytes a parameter) plus 11.6 GB of f32 gradients, over the card's 80 GB.
# AdamW's update is out of place, so the step also holds a second copy of
# the parameters and moments (12 bytes a parameter) and the stale read:
# 4 of the 8 (rglru, rglru, local) groups and the (rglru, rglru) tail (14
# layers, 1,866,744,320 parameters) run out of memory in that update; 3
# groups and the tail are 11 layers, 1,609,786,880 parameters, 38.6 GB of
# state
TRAIN_GROUPS = {"recurrentgemma-2b": 3}


def train_config(arch: str):
    """``arch``'s published config, its first group cut to
    ``TRAIN_GROUPS`` repeats where the card's memory forces a cut; and the
    ``reduced`` note for the printed result (None when nothing is cut)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch not in TRAIN_GROUPS:
        return cfg, None
    n = TRAIN_GROUPS[arch]
    full = len(cfg.layer_kinds)
    first, *rest = cfg.groups
    cut = dataclasses.replace(
        cfg, groups=(dataclasses.replace(first, n=n), *rest))
    return cut, (f"layers {full} -> {len(cut.layer_kinds)}: {n} of the "
                 f"{first.n} {first.pattern} groups and the groups after "
                 f"them; every width kept (the engine's delta-{TRAIN_DELTA} "
                 f"state and AdamW's update for all {full} layers exceed "
                 "the card's memory)")


def full_width_training(torch, ops, ref, arch):
    """``arch`` at full width through the train engine, at full depth or
    at its ``TRAIN_GROUPS`` cut: f32 master, bf16 compute, AdamW, delta 2
    on the packed ring."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.pdb import make_engine
    from repro_torch.tree import leaves
    cfg, reduced = train_config(arch)
    kind_kernels, watched = TRAIN_RUNS[arch]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    sync = SyncConfig(delta=TRAIN_DELTA, remat="none", packed_ring=True)
    spec = LMBatchSpec(batch=TRAIN_B, seq_len=TRAIN_S,
                       vocab_size=cfg.vocab_size, seed=0)
    inner = make_lm_grad_fn(cfg, sync)
    watched_max = []

    def grad_fn(p, batch):              # the engine's grad_fn, watched
        loss, grads = inner(p, batch)
        g0 = grads["groups"]["g0"]
        watched_max.append(torch.stack([
            g0[slot]["mix"][w][0].abs().max()
            for slot, names in watched.items() for w in names]))
        return loss, grads

    opt = make_optimizer(OptConfig(name="adamw", lr=3e-4))
    eng = make_engine(params, grad_fn, opt, sync)
    state = eng.init_state()
    del params
    torch.cuda.synchronize()
    print(f"{cfg.name} training state ready in "
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
    n_layers = len(cfg.layer_kinds)
    want = {"ring_gather": n_groups * TRAIN_STEPS}
    for kind, names in kind_kernels.items():
        for k in names:
            want[k] = want.get(k, 0) \
                + cfg.layer_kinds.count(kind) * TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grad_min = dict(zip(
        [f"g0.{slot}.mix.{w}" for slot, names in watched.items()
         for w in names],
        torch.stack(watched_max).amin(0).tolist()))
    tele = eng.telemetry.summary()
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print("full-width training:", json.dumps(dict(
        arch=cfg.name, layers=n_layers, reduced=reduced,
        parameters=sum(t.numel() for t in leaves(state.params)),
        batch=TRAIN_B, seq=TRAIN_S,
        delta=TRAIN_DELTA, optimizer="adamw", steps=TRAIN_STEPS,
        losses=losses, step_s=step_s, step_s_p50_after_first=steady,
        tokens_per_s=TRAIN_B * TRAIN_S / steady, peak_mem_gib=peak,
        staleness_per_step=ramp, telemetry=tele, launches=launches,
        expected_launches=want, plain_version_calls=plain_calls,
        min_layer0_grad_max_abs=grad_min)), flush=True)
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    if ramp != [min(i, TRAIN_DELTA) for i in range(TRAIN_STEPS)] or \
            tele["max_staleness"] != TRAIN_DELTA:
        raise AssertionError(f"staleness ramp {ramp}, telemetry {tele}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"launches {launches}, expected {want}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran: {plain_calls}")
    if not min(grad_min.values()) > 0:
        raise AssertionError(f"a watched parameter got no gradient: "
                             f"{grad_min}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for b in batches[TRAIN_STEPS:]:
            state, m = eng.step(state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    device_profile(torch, prof, wall_ms, f"train profile {cfg.name}",
                   steps=2, tokens=2 * TRAIN_B * TRAIN_S)
    del state, eng, batches
    torch.cuda.empty_cache()
    return launches


def print_ptxas(source: str, log: str) -> dict[str, tuple[int, int]]:
    """One line per compiled kernel: its entry (the mangled name without
    the anonymous-namespace prefix, so the template arguments show, e.g.
    ``Li128E`` for head dim 128), registers, shared memory and spills.
    Returns {entry: (spill store bytes, spill load bytes)}."""
    entry, spills, out = "?", "", {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = re.sub(r"^_ZN\w*?_cu_[0-9a-f]{8}\d*", "", m.group(1))
        elif "spill" in line:
            spills = line.strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[entry] = (int(m.group(1)), int(m.group(2)))
        elif "registers" in line:
            print(f"ptxas {source} {entry[:60]}: "
                  f"{line.split(':', 1)[-1].strip()}; {spills}")
    return out


def check_flash_build(torch, spills: dict) -> None:
    """Gates on the built flash-attention library: no instantiation spills
    (``spills``, ptxas' report as ``print_ptxas`` returns it), and the
    wrapper's plan states the shared memory the CUDA source launches with,
    at every head dim and both element types."""
    from repro_torch.kernels.flash_attention import kernel_smem, plan
    if not spills or any(st or ld for st, ld in spills.values()):
        raise AssertionError(f"flash_attention spills (or no ptxas "
                             f"report): {spills}")
    for dt in (torch.float32, torch.bfloat16):
        for hd in (16, 32, 64, 128, 256):
            p = plan(512, 8, 2, hd, dt)
            want = {k: p[k]["smem"] for k in ("fwd", "dkdv", "dq")}
            if kernel_smem(dt, hd) != want:
                raise AssertionError(f"flash plan vs kernel smem at {dt} hd "
                                     f"{hd}: {want} {kernel_smem(dt, hd)}")
    print(f"flash ptxas: {len(spills)} kernels, no spill stores or loads; "
          "plan == kernel shared memory", flush=True)


def check_moe_build(torch) -> None:
    """Gate: the grouped FFN wrapper's plan states the shared memory,
    stages and weight columns a block that the bf16 kernels are built
    with, at every slot tile."""
    from repro_torch.kernels.moe_matmul import SLOT_TILES, kernel_tiles, plan
    built = kernel_tiles()
    for nt in SLOT_TILES:
        p = plan(1, nt, 8, nt, 4096, 14336, torch.bfloat16, 132)
        want = {k: (p[k]["smem"], p[k]["stages"], p[k]["cols"])
                for k in ("up", "down")}
        got = {k: built[(nt, k)] for k in ("up", "down")}
        if p["tile"] != nt or got != want:
            raise AssertionError(f"moe plan vs kernels at slot tile {nt}: "
                                 f"{want} {got}")
    print(f"moe_grouped_ffn plan == kernel shared memory, stages and "
          f"columns at slot tiles {list(SLOT_TILES)}", flush=True)


def check_wkv_build() -> None:
    """Gate: the WKV wrapper's plan states the chunk and, for every kernel,
    the shared memory, threads and slice width the built library has, at
    both head dims."""
    from repro_torch.kernels.rwkv6_scan import KERNELS, kernel_tiles, plan
    for hd in (16, 64):
        built, p = kernel_tiles(hd), plan(*WKV_MAIN[:3], hd)
        want = {k: (p[k]["smem"], p[k]["threads"], p[k]["width"])
                for k in KERNELS}
        if built != dict(chunk=p["chunk"], **want):
            raise AssertionError(f"rwkv6 plan vs kernels at hd {hd}: "
                                 f"{want} chunk {p['chunk']}; {built}")
    print(f"rwkv6_scan plan == kernels: chunk {p['chunk']}, "
          f"{json.dumps(want)}", flush=True)


def check_lru_build(torch) -> None:
    """Gate: the RG-LRU wrapper's plan states the chunk and, for each
    direction, the shared memory, threads, chunk slots, lanes, channels a
    thread and the backward's piece the built library launches with, at
    the training shape (bf16), the smoke config's (f32, 96 tokens), ragged
    T 513 and 4096 tokens (windows of the block's chunks), and prints the
    blocks resident on an SM."""
    from repro_torch.kernels.rglru_scan import (kernel_tiles, plan,
                                                resident_blocks)
    for T, dt in ((LRU_MAIN[1], torch.bfloat16), (96, torch.float32),
                  (513, torch.float32), (4096, torch.bfloat16)):
        p, built = plan(4, T, LRU_MAIN[2], dt), kernel_tiles(T, dt)
        want = dict(chunk=p["chunk"], **{
            d: dict(smem=p[f"smem_{d}"], threads=p["threads"],
                    slots=p["slots"], lanes=p["lanes"], vec=p["vec"],
                    sub=p["sub"]) for d in ("fwd", "bwd")})
        if built != want:
            raise AssertionError(f"rglru plan vs kernels at T {T} {dt}: "
                                 f"{want}; {built}")
    resident = resident_blocks(LRU_MAIN[1], torch.bfloat16)
    print(f"rglru_scan plan == kernels: chunk {want['chunk']}, "
          f"{json.dumps(want['bwd'])}; bf16 blocks resident an SM at the "
          f"training shape (fwd, bwd) {resident}", flush=True)


def check_no_spill(spills: dict, sources: tuple) -> None:
    """Gate: ptxas reported every kernel of ``sources`` and none spills."""
    for name in sources:
        sp = spills.get(name, {})
        if not sp or any(st or ld for st, ld in sp.values()):
            raise AssertionError(f"{name} spills (or no ptxas report): {sp}")
        print(f"{name} ptxas: {len(sp)} kernels, no spill stores or loads",
              flush=True)


# (B, S, H, KV, hd) of the batch-invariance gate: llama3.2-1b's and
# recurrentgemma-2b's training shapes
FLASH_INVARIANCE = ((4, 512, 32, 8, 64), (4, 512, 10, 1, 256))


def check_flash_batch_invariance(torch, gen) -> None:
    """Each batch row alone gives the bits it gives inside the batch,
    forward and backward, bf16: the kernels' tiles and split come from a
    plan that never reads B, and the serving engine's continuous ==
    static gate relies on it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)
    for B, S, H, KV, hd in FLASH_INVARIANCE:
        mk = lambda n: torch.randn((B, S, n, hd), generator=gen,  # noqa
                                   device="cuda").to(torch.bfloat16)
        q, k, v, do = mk(H), mk(KV), mk(KV), mk(H)
        o, lse = flash_attention(q, k, v, with_lse=True)
        grads = flash_attention_bwd(q, k, v, o, do, lse)
        for b in range(B):
            one = [t[b:b + 1] for t in (q, k, v, do)]
            o1, lse1 = flash_attention(*one[:3], with_lse=True)
            g1 = flash_attention_bwd(*one[:3], o1, one[3], lse1)
            same = [torch.equal(o[b:b + 1], o1),
                    torch.equal(lse[b:b + 1], lse1)]
            same += [torch.equal(g[b:b + 1], x) for g, x in zip(grads, g1)]
            if not all(same):
                raise AssertionError(f"flash attention not batch-invariant "
                                     f"at {(B, S, H, KV, hd)} row {b}: "
                                     f"(o, lse, dq, dk, dv) {same}")
        print("flash batch invariance:", json.dumps(dict(
            shape=[B, S, H, KV, hd], rows=B, bit_identical=True)),
            flush=True)


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
    spills = {}
    for name in _build.SOURCES:
        log = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log")
        if log.exists():
            spills[name] = print_ptxas(name, log.read_text())
    check_flash_build(torch, spills.get("flash_attention", {}))
    check_no_spill(spills, ("decode_attention", "prefill_page_attention",
                            "moe_grouped_ffn", "rwkv6_scan", "rglru_scan"))
    check_moe_build(torch)
    check_wkv_build()
    check_lru_build(torch)

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_s = {}

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t1
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    results = {name: timed(name, fn, *args) for name, fn, args in (
        ("flash_attention", check_flash, (torch, F, ref, gen)),
        ("page_gather", check_page_gather, (torch, ref, gen)),
        ("decode_attention", check_decode, (torch, F, ref, gen)),
        ("ring_gather", check_ring_gather, (torch, ref, gen)),
        ("flash_attention_bwd", check_flash_bwd, (torch, F, ref, gen)),
        ("prefill_page_attention", check_prefill_page_attention,
         (torch, F, ref, gen)),
        ("moe_grouped_ffn", check_moe_grouped_ffn, (torch, F, ref, gen)),
        ("rwkv6_scan", check_rwkv6_scan, (torch, ref, gen)),
        ("rwkv6_scan_bwd", check_rwkv6_scan_bwd, (torch, ref, gen)),
        ("rglru_scan", check_rglru_scan, (torch, ref, gen)),
        ("rglru_scan_bwd", check_rglru_scan_bwd, (torch, ref, gen)))}
    timed("flash_batch_invariance", check_flash_batch_invariance, torch, gen)
    timed("small_end_to_end", small_end_to_end, torch)
    paths = timed("full_width_serving", full_width, torch, ops, ref)
    torch.cuda.empty_cache()
    timed("small_moe", small_moe, torch)
    paths["moe_serving"] = timed("moe_serving", moe_serving, torch, ops, ref)
    timed("small_training", small_training, torch, "llama3.2-1b")
    paths["training"] = timed("full_width_training", full_width_training,
                              torch, ops, ref, "llama3.2-1b")
    timed("small_rwkv6_training", small_training, torch, "rwkv6-1.6b")
    paths["rwkv6_training"] = timed("rwkv6_training", full_width_training,
                                    torch, ops, ref, "rwkv6-1.6b")
    timed("small_recurrentgemma_training", small_training, torch,
          "recurrentgemma-2b")
    paths["recurrentgemma_training"] = timed(
        "recurrentgemma_training", full_width_training, torch, ops, ref,
        "recurrentgemma-2b")
    print("phase seconds:", json.dumps(dict(
        phase_s, total=time.perf_counter() - t0)), flush=True)

    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:86",
                "page_gather": "src/repro/kernels/page_gather.py:35",
                "decode_attention": "src/repro/kernels/decode_attention.py:70",
                "ring_gather": "src/repro/kernels/ring_gather.py:36",
                # the gradient of the kernel above: the TPU package has
                # none and trains through autodiff of its plain attention
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention.py:86",
                "prefill_page_attention":
                    "src/repro/kernels/page_gather.py:107",
                "moe_grouped_ffn": "src/repro/kernels/moe_matmul.py:64",
                "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:54",
                # the gradient of the kernel above: the TPU package has
                # none and trains through autodiff of its plain recurrence
                "rwkv6_scan_bwd": "src/repro/kernels/rwkv6_scan.py:54",
                "rglru_scan": "src/repro/kernels/rglru_scan.py:44",
                # the gradient of the kernel above: the TPU package has
                # none and trains through autodiff of its plain recurrence
                "rglru_scan_bwd": "src/repro/kernels/rglru_scan.py:44"}
    own_path = {"flash_attention": "serving", "page_gather": "serving",
                "decode_attention": "serving", "ring_gather": "training",
                "flash_attention_bwd": "training",
                "prefill_page_attention": "chunked_serving",
                "moe_grouped_ffn": "moe_serving",
                "rwkv6_scan": "rwkv6_training",
                "rwkv6_scan_bwd": "rwkv6_training",
                "rglru_scan": "recurrentgemma_training",
                "rglru_scan_bwd": "recurrentgemma_training"}
    kernels = []
    for name, row in results.items():
        source = name.removesuffix("_bwd")
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
            host_ms=row["host_ms"], shape=row["shape"],
            **{k: row[k] for k in ("hd128", "hd256", "shapes", "edge_cases",
                                   "library", "serial_steps", "state_bytes",
                                   "checkpoint_bytes", "chunk", "threads")
               if k in row}))
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
