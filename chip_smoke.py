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
   at the serving path's shapes (bf16 at rtol/atol 2e-2, the gather bit for
   bit), timed with CUDA events (device time, inputs rotated past the L2
   cache) beside its roofline bound, the plain version and one PyTorch
   library call computing the same function;
3. end to end, small: the serving engine on a narrow f32 model on the card
   (CUDA kernels) against the same model on the CPU (plain versions): same
   greedy tokens, prefill logits within 1e-3;
4. serving at full width: ``llama3.2-1b`` in bf16 with random weights from
   seed 0, batch 8, page 16, 16 open-loop requests (prompts 128/300/512,
   generations 16/32, cache 544).  Continuous and static modes on the
   ``steps`` clock must give identical greedy tokens, and the continuous
   run (the main path: launch counts reset just before, read just after)
   must launch every kernel.  Then one continuous ``wall``-clock run;
5. where the time goes: ``torch.profiler`` over a continuous run of 8
   requests arriving together, device time by kernel group and the
   device's idle share.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  float32 matmuls and convolutions run in
full f32 (TF32 off) throughout.
"""
from __future__ import annotations

import dataclasses
import json
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


def full_width(torch, ops):
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
        ops.reset_launches()                 # the main path starts here
        t0 = time.perf_counter()
        rep = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[cont] = dict(ops.launches)  # ... and ends here
        reports[cont] = rep
        print(f"{rep.mode} (steps clock): {rep.total_tokens} tokens, "
              f"{rep.decode_steps} decode steps, utilization "
              f"{rep.utilization:.3f}, {dt:.2f} s host time; launches "
              f"{launches[cont]}", flush=True)
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
        if min(counts.values()) <= 0:
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
                 ("decode_attention", "decode_kernel"),
                 ("page_gather", "page_gather_kernel"),
                 ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "splitK")))


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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
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
    print("profile:", json.dumps(dict(
        requests=len(reqs), decode_steps=rep.decode_steps,
        tokens=rep.total_tokens, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / wall_ms if wall_ms else None,
        device_ms_by_group=groups)), flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"profile kernel: {dev_us(e) / 1e3:9.3f} ms x{e.count:6d} "
              f"{e.key[:90]}", flush=True)
    # the host side, where a device idle most of the time waits: operators
    # and runtime calls by their own CPU time (profiler overhead included)
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:12]:
        print(f"profile host: {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"x{e.count:6d} {e.key[:90]}", flush=True)


def main() -> int:
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
               "decode_attention": check_decode(torch, F, ref, gen)}
    small_end_to_end(torch)
    launches = full_width(torch, ops)

    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:86",
                "page_gather": "src/repro/kernels/page_gather.py:35",
                "decode_attention": "src/repro/kernels/decode_attention.py:70"}
    kernels = []
    for name, row in results.items():
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces[name], launches=launches[name],
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
