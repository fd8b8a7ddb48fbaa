"""Training driver (port of ``repro.launch.train``'s ``engine`` backend).

Runs the training loop of the ported archs, at full width or reduced
(``--smoke``), through the ParameterDB train engine
(:mod:`repro_torch.pdb.torch_backend`): the synchronous step at
``--delta 0``, the delta-stale ring buffer above it, with Op/staleness
telemetry, atomic checkpointing + resume (``--resume``), failure-injection
drills (``--fail-at-step``, exit code 17) and deterministic data (batch t
depends only on (seed, t)).  The kernels are picked by device: ``--device
cuda`` (the default) runs the hand-written CUDA kernels (flash attention,
the WKV and RG-LRU recurrences, forward and backward; the ring gather) and
ends with the peak device memory, ``--device cpu`` their plain versions.
Weights are random, drawn from ``--seed``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 8 --batch 2 --seq 32 --lr 3e-3 \\
      --delta 2 --log-every 4
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import latest_step, load_state, save_checkpoint
from ..configs import get_config, get_smoke_config
from ..core.sync import SyncConfig
from ..data import LMBatchSpec, make_lm_batch
from ..device import resolve_device
from ..models import paramlib
from ..models.transformer import model_specs
from ..optim import OptConfig, make_optimizer
from ..runtime.fault import (FailureInjector, InjectedFailure, RetryPolicy,
                             run_with_recovery)
from .steps import make_train_engine


def build(args, device: torch.device):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    specs = model_specs(cfg)
    params = paramlib.init_tree(
        specs, torch.Generator(device=device).manual_seed(args.seed),
        dtype=cfg.param_dtype)
    opt = make_optimizer(OptConfig(name=args.optimizer, lr=args.lr,
                                   compression=args.compression))
    sync = SyncConfig(mode=args.mode, delta=args.delta,
                      compression=args.compression, remat=args.remat)
    spec = LMBatchSpec(batch=args.batch, seq_len=args.seq,
                       vocab_size=cfg.vocab_size, seed=args.seed)
    return cfg, params, opt, sync, spec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--mode", choices=["datacentric", "bsp", "ssp"],
                    default="datacentric")
    ap.add_argument("--delta", type=int, default=0)
    ap.add_argument("--compression", choices=["none", "int8"], default="none")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a crash (restart drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--backend", choices=["engine", "server"],
                    default="engine",
                    help="engine: in-process ParameterDB train engine; "
                         "server: multi-process sharded parameter server")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "versions)")
    args = ap.parse_args(argv)

    if args.backend == "server":
        raise NotImplementedError(
            "--backend server (the multi-process sharded parameter server) "
            "comes with a later slice of the port")

    device = resolve_device(args.device)
    cfg, params, opt, sync, spec = build(args, device)
    start = 0

    # one ParameterDB engine for both paths (sync dict state at delta=0,
    # device ring buffer otherwise) — see repro_torch.pdb.torch_backend
    engine = make_train_engine(cfg, opt, sync, params)
    state = engine.init_state()

    if args.resume and args.ckpt_dir:
        ls = latest_step(args.ckpt_dir)
        if ls is not None:
            state = load_state(args.ckpt_dir, ls, state)
            start = ls
            print(f"resumed from step {ls}")

    injector = FailureInjector(
        fail_steps=(args.fail_at_step,) if args.fail_at_step >= 0 else ())
    policy = RetryPolicy()
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = make_lm_batch(spec, step, device)
        try:
            state, metrics, outcome = run_with_recovery(
                engine.step_fn, state, batch, step, policy, injector,
                is_finite=lambda m: bool(torch.isfinite(m["loss"]).all()),
                telemetry=engine.telemetry)
        except InjectedFailure:
            print(f"CRASH at step {step} (injected); restart with --resume")
            raise SystemExit(17)
        if outcome != "skipped":    # skipped steps never updated parameters
            engine.record_step()
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} [{outcome}] "
                  f"{(time.time()-t0):.1f}s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, engine.commit(state))
    tele = engine.telemetry.summary()
    if not losses:   # resumed from a checkpoint at/after the last step:
        # don't re-save — it would label step-`start` weights as args.steps
        print(f"nothing to do: resumed at step {start} >= {args.steps}")
        return {"first_loss": None, "final_loss": None, "telemetry": tele}
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, engine.commit(state))
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) "
          f"[pdb: {tele['reads']}r/{tele['writes']}w "
          f"max_staleness={tele['max_staleness']:.0f} "
          f"retried={tele['retried_steps']} skipped={tele['skipped_steps']}]")
    if device.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "telemetry": tele}


if __name__ == "__main__":
    main()
