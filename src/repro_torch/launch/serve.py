"""Serving CLI: the continuous-batching engine on an open-loop workload
(port of ``repro.launch.serve``).

Prompts are prefilled into paged per-sequence KV caches — whole at
admission, or in ``--prefill-chunk`` token chunks interleaved with decode,
adopting cached pages of shared prefixes with ``--prefix-cache`` — then
decoded (greedy, or sampled with ``--temperature``/``--top-p``) with
sequences joining and leaving the batch mid-decode (``--static`` restores
the drain-the-batch baseline).  Arrivals follow a Poisson process at
``--rate`` requests per second; ``--shared-prefix`` draws prompts as hot
system prompts plus unique suffixes.  Weights are random, drawn from
``--seed`` (which also seeds the workload).  The kernels are picked by
device: ``--device cuda`` (the default) runs the hand-written CUDA
kernels, ``--device cpu`` their plain PyTorch versions.  Every text
arch runs: the dense configs (olmo-1b and gemma3-4b's local/global layers
among them), the MoE configs, musicgen-large (its inputs are codebook ids)
and recurrentgemma-2b (RG-LRU layers with local attention).  The engine
refuses two, as the JAX reference's does: an attention-free model
(rwkv6-1.6b: the JAX engine fails on it) and the vision model
(llama-3.2-vision-11b: the JAX engine is text-only); both serve through
the model-level functions of ``models.transformer``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --requests 8 --rate 4 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --shared-prefix --prefix-cache \\
      --temperature 0.8 --top-p 0.9
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --smoke --device cpu --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --smoke --device cpu --prefill-chunk 8
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import paramlib
from ..models.transformer import model_specs
from ..serve import (ServeConfig, ServeEngine, open_loop_requests,
                     shared_prefix_requests)
from .tuning import apply_tuning


def main(argv=None) -> dict:
    apply_tuning()
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
                    help="chunked prefill: tokens per chunk, one chunk "
                         "per tick interleaved with decode (0 = whole-"
                         "prompt prefill at admission)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prompt-prefix caching: adopt cached KV pages "
                         "for shared prompt prefixes (implies chunked "
                         "prefill at --page-size granularity)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="shared-prefix traffic (hot system prompts + "
                         "unique suffixes) instead of fully random "
                         "prompts")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (with --temperature)")
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the workload")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = paramlib.init_tree(model_specs(cfg), gen,
                                dtype=cfg.param_dtype)

    gen_lens = (args.gen,) if args.gen else (4, 8, 16, 48)
    if args.shared_prefix:
        plen = args.prompt_len or 32
        requests = shared_prefix_requests(
            args.requests, args.rate, cfg.vocab_size,
            prefix_len=plen - plen // 4, suffix_lens=(plen // 4,),
            gen_lens=gen_lens, seed=args.seed)
        max_prompt = plen
    else:
        prompt_lens = (args.prompt_len,) if args.prompt_len else (8, 16, 32)
        requests = open_loop_requests(
            args.requests, args.rate, cfg.vocab_size,
            prompt_lens=prompt_lens, gen_lens=gen_lens, seed=args.seed)
        max_prompt = max(prompt_lens)
    page = args.page_size
    need = max_prompt + max(gen_lens)
    cache_len = args.cache_len or -(-need // page) * page

    scfg = ServeConfig(batch_size=args.batch, page_size=page,
                       cache_len=cache_len, continuous=not args.static,
                       prefill_chunk=args.prefill_chunk,
                       prefix_cache=args.prefix_cache,
                       temperature=args.temperature, top_p=args.top_p,
                       sample_seed=args.sample_seed)
    report = ServeEngine(cfg, params, scfg).run(requests)

    print(f"{report.mode} on {device}: {report.total_tokens} tokens / "
          f"{report.n_requests} requests in {report.duration:.2f}s "
          f"({report.tokens_per_sec:.1f} tok/s, "
          f"slot utilization {report.utilization:.0%})")
    print(f"latency p50 {report.latency_p50*1e3:.0f}ms "
          f"p99 {report.latency_p99*1e3:.0f}ms over {report.decode_steps} "
          f"decode steps")
    print(f"ttft p50 {report.ttft_p50*1e3:.0f}ms "
          f"p99 {report.ttft_p99*1e3:.0f}ms; "
          f"{report.prefill_chunks} prefill chunks, "
          f"prefix hit rate {report.prefix_hit_rate:.0%}")
    first = report.outputs[min(report.outputs)]
    print("first request:", list(first[:12]))
    return {"report": report, "tok_per_s": report.tokens_per_sec}


if __name__ == "__main__":
    main()
