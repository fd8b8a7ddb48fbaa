"""Serving CLI: the continuous-batching engine on an open-loop workload
(port of ``repro.launch.serve``).

Prompts are prefilled whole into paged per-sequence KV caches, then
decoded greedily with sequences joining and leaving the batch mid-decode
(``--static`` restores the drain-the-batch baseline).  Arrivals follow a
Poisson process at ``--rate`` requests per second.  Weights are random,
drawn from ``--seed`` (which also seeds the workload).  The kernels are
picked by device: ``--device cuda`` (the default) runs the hand-written
CUDA kernels, ``--device cpu`` their plain PyTorch versions.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --requests 8 --rate 4 --batch 4
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import paramlib
from ..models.transformer import model_specs
from ..serve import ServeConfig, ServeEngine, open_loop_requests


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="sequence slots (B_max)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate, requests/second")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="fix the prompt length (default: sample 8/16/32)")
    ap.add_argument("--gen", type=int, default=None,
                    help="fix the generation length (default: sample "
                         "4/8/16/48)")
    ap.add_argument("--static", action="store_true",
                    help="drain-the-batch baseline (continuous off)")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=None,
                    help="logical KV ring length (default: fits the "
                         "longest prompt+gen, page-aligned)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill (not ported yet: must stay 0)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prompt-prefix caching (not ported yet)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (not ported yet: 0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the workload")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = paramlib.init_tree(model_specs(cfg), gen,
                                dtype=cfg.param_dtype)

    gen_lens = (args.gen,) if args.gen else (4, 8, 16, 48)
    prompt_lens = (args.prompt_len,) if args.prompt_len else (8, 16, 32)
    requests = open_loop_requests(
        args.requests, args.rate, cfg.vocab_size,
        prompt_lens=prompt_lens, gen_lens=gen_lens, seed=args.seed)
    page = args.page_size
    need = max(prompt_lens) + max(gen_lens)
    cache_len = args.cache_len or -(-need // page) * page

    scfg = ServeConfig(batch_size=args.batch, page_size=page,
                       cache_len=cache_len, continuous=not args.static,
                       prefill_chunk=args.prefill_chunk,
                       prefix_cache=args.prefix_cache,
                       temperature=args.temperature, top_p=args.top_p)
    report = ServeEngine(cfg, params, scfg).run(requests)

    print(f"{report.mode} on {device}: {report.total_tokens} tokens / "
          f"{report.n_requests} requests in {report.duration:.2f}s "
          f"({report.tokens_per_sec:.1f} tok/s, "
          f"slot utilization {report.utilization:.0%})")
    print(f"latency p50 {report.latency_p50*1e3:.0f}ms "
          f"p99 {report.latency_p99*1e3:.0f}ms over {report.decode_steps} "
          f"decode steps")
    print(f"ttft p50 {report.ttft_p50*1e3:.0f}ms "
          f"p99 {report.ttft_p99*1e3:.0f}ms")
    first = report.outputs[min(report.outputs)]
    print("first request:", list(first[:12]))
    return {"report": report, "tok_per_s": report.tokens_per_sec}


if __name__ == "__main__":
    main()
