#!/usr/bin/env python3
"""A layer's paged decode read and chunked serving, this checkout against
another (an earlier commit unpacked under the ignored ``build/``) on one
card, in turns: other, this, this, other, each turn a fresh process.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 tools/decode_compare.py build/parent

Each turn builds its own checkout's attention kernels and prints:

* at ``chip_smoke.py``'s three bf16 decode shapes (B8 L544 H32 KV8 hd64,
  the same at hd 128, B8 L2048 H10 KV1 hd256; 16-slot pages under a
  shuffled table) the device and host ms of the gathered pair (two
  ``ops.page_gather`` calls and ``ops.attention_decode``) and, where the
  checkout has it, of ``ops.attention_decode_paged`` (the in-place
  kernel); CUDA events over 200 calls, inputs rotated past the L2 cache,
  as ``chip_smoke.time_ms`` times them;
* llama3.2-1b at full width (random weights, seed 0), chunked (128) and
  prefix-cached, on ``chip_smoke.py``'s shared-prefix traffic, batch 8,
  page 16, ring 544: ``RUNS`` runs on the ``steps`` clock, and the p50
  over all their decode steps of the host's time in ``decode_step`` (the
  model's enqueue: the step's device sync comes after it, in the sampler)
  and of the wall time between steps; then a ``wall``-clock run's
  tokens/s.

The summary line gives every turn's numbers.  With no other checkout, two
turns of this one.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, L, H, KV, hd), bf16
SHAPES = ((8, 544, 32, 8, 64), (8, 544, 32, 8, 128), (8, 2048, 10, 1, 256))
PAGE = 16
RUNS = 3                    # steps-clock serving runs a turn


def decode_reads(torch, cs, ops) -> list[dict]:
    """The two forms of a layer's decode read at ``SHAPES``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    paged = getattr(ops, "attention_decode_paged", None)
    out = []
    for B, L, H, KV, hd in SHAPES:
        n_pp = L // PAGE
        P = B * n_pp + 1
        mk = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
        q, pk, pv = mk(B, 1, H, hd), mk(P, PAGE, KV, hd), mk(P, PAGE, KV, hd)
        table = torch.randperm(P - 1, generator=gen, device="cuda")
        table = table[:B * n_pp].reshape(B, n_pp).to(torch.int32)
        n_live = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
        valid = torch.arange(L, device="cuda")[None, :] < n_live[:, None]
        sets = cs.rotation((q, pk, pv, table, valid))
        n = len(sets)
        pair = lambda st: ops.attention_decode(  # noqa: E731
            st[0], ops.page_gather(st[1], st[3]),
            ops.page_gather(st[2], st[3]), st[4])
        rec = dict(shape=[B, L, H, KV, hd])
        rec["pair_ms"], rec["pair_host_ms"] = cs.time_ms(
            lambda i: pair(sets[i % n]), 200)
        if paged is not None:
            if not torch.equal(paged(*sets[0]), pair(sets[0])):
                raise AssertionError(f"paged != gathered pair at {rec}")
            rec["paged_ms"], rec["paged_host_ms"] = cs.time_ms(
                lambda i: paged(*sets[i % n]), 200)
        print("decode read", json.dumps(rec), flush=True)
        out.append(rec)
        del sets
    return out


def chunked_serving(torch) -> dict:
    """Decode-step host and wall p50 over ``RUNS`` chunked prefix-cached
    runs on the steps clock, and a wall-clock run's tokens/s."""
    import repro_torch.serve.engine as engine
    from repro_torch.configs import get_config
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.serve import (ServeConfig, ServeEngine, serving_params,
                                   shared_prefix_requests)
    cfg = get_config("llama3.2-1b")
    master = paramlib.init_tree(
        model_specs(cfg), torch.Generator(device="cuda").manual_seed(0),
        dtype=cfg.param_dtype)
    params = serving_params(master, cfg)
    del master
    V = cfg.vocab_size
    common = dict(batch_size=8, page_size=PAGE, cache_len=544,
                  prefill_chunk=128, prefix_cache=True)
    reqs = shared_prefix_requests(16, 0.5, V, n_prefixes=4, prefix_len=256,
                                  suffix_lens=(64, 192), gen_lens=(16, 32),
                                  seed=0)
    host, gaps = [], []
    decode_step = engine.decode_step

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = decode_step(*a, **kw)
        steps.append(time.perf_counter() - t0)
        return out
    engine.decode_step = timed
    try:
        for _ in range(RUNS):
            steps, stamps = [], []
            eng = ServeEngine(cfg, params, ServeConfig(clock="steps",
                                                       **common))
            rep = eng.run(reqs, step_hook=lambda _: stamps.append(
                time.perf_counter()))
            host += steps[-rep.decode_steps:]   # not the warmup's step
            gaps += [b - a for a, b in zip(stamps, stamps[1:])]
    finally:
        engine.decode_step = decode_step
    torch.cuda.synchronize()
    gaps, host = sorted(gaps), sorted(host)
    wreqs = shared_prefix_requests(16, 50.0, V, n_prefixes=4,
                                   prefix_len=256, suffix_lens=(64, 192),
                                   gen_lens=(16, 32), seed=0)
    wrep = ServeEngine(cfg, params, ServeConfig(clock="wall",
                                                **common)).run(wreqs)
    rec = dict(runs=RUNS, decode_steps=rep.decode_steps,
               prefill_chunks=rep.prefill_chunks,
               decode_host_ms_p50=host[len(host) // 2] * 1e3,
               step_wall_ms_p50=gaps[len(gaps) // 2] * 1e3,
               wall_tok_per_s=wrep.tokens_per_sec,
               wall_decode_steps=wrep.decode_steps)
    print("chunked serving", json.dumps(rec), flush=True)
    return rec


def one(root: Path) -> None:
    """One turn, from the checkout at ``root``."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    if not torch.cuda.is_available():
        raise SystemExit("decode_compare: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"turn {root}: {cs.smi()}", flush=True)
    _build.build_all(("flash_attention", "page_gather", "decode_attention",
                      "prefill_page_attention"))
    print("turn", json.dumps(dict(decode=decode_reads(torch, cs, ops),
                                  serving=chunked_serving(torch))),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", help="another checkout's root")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(Path(args.one).resolve())
        return 0
    roots = [ROOT, ROOT]
    if args.other:
        other = Path(args.other).resolve()
        roots = [other, ROOT, ROOT, other]
    summary = []
    for root in roots:
        out = subprocess.run([sys.executable, __file__, "--one", str(root)],
                             capture_output=True, text=True)
        print(out.stdout, out.stderr[-2000:], flush=True)
        if out.returncode:
            return out.returncode
        turn = next(json.loads(line.partition(" ")[2])
                    for line in out.stdout.splitlines()
                    if line.startswith("turn {"))
        summary.append(dict(checkout=str(root), **turn))
    print("turns", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
