"""Training driver (port of ``repro.launch.train``).

Runs the training loop of the ported archs, at full width or reduced
(``--smoke``), with:
  * the ParameterDB train engine (:mod:`repro_torch.pdb.torch_backend`,
    ``--backend engine``, the default): the synchronous step at
    ``--delta 0``, the delta-stale ring buffer above it, with Op/staleness
    telemetry, atomic checkpointing + resume (``--resume``) and
    failure-injection drills (``--fail-at-step``, exit code 17);
  * the multi-process sharded parameter server (``--backend server``,
    :mod:`repro_torch.pdb.server`): the raveled parameter vector is split
    into ``--param-chunks`` chunks, hash-sharded over ``--shards`` shard
    processes (CPU storage), and trained by ``--workers`` client threads
    that compute on the device under the same consistency policies (Def-3
    partitioned SGD: each worker reads all chunks, updates its own chunk
    group); ``--kill-shard-at-step`` is a shard death + snapshot-restart
    drill;
  * deterministic data (batch t depends only on (seed, t)).
The kernels are picked by device: ``--device cuda`` (the default) runs the
hand-written CUDA kernels (flash attention, the WKV and RG-LRU
recurrences, forward and backward; the ring gather) and ends with the peak
device memory, ``--device cpu`` their plain versions.  Weights are random,
drawn from ``--seed``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 8 --batch 2 --seq 32 --lr 3e-3 \\
      --delta 2 --log-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --backend server --shards 2 --workers 2 \\
      --steps 4
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
from .steps import make_lm_grad_fn, make_train_engine
from .tuning import apply_tuning


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
                       vocab_size=cfg.vocab_size,
                       media_tokens=cfg.n_frontend_tokens,
                       media_dim=cfg.d_frontend, seed=args.seed)
    return cfg, params, opt, sync, spec


def _server_layout(args, n: int):
    """JAX's layout of the raveled vector: ``m`` chunks with ``np.linspace``
    bounds, chunk c owned by worker ``c % p``."""
    import numpy as np
    p = args.workers
    m = args.param_chunks if args.param_chunks > 0 else 2 * p
    bounds = [int(b) for b in np.linspace(0, n, m + 1).astype(int)]
    owned = {k: [c for c in range(m) if c % p == k] for k in range(p)}
    return p, m, bounds, owned


def run_server_backend(args) -> dict:
    """Train against the multi-process sharded ParameterDB
    (:mod:`repro_torch.pdb.server`): parameter-server-style SGD on the
    raveled parameter vector.  Worker ``k`` reads every chunk
    (policy-admitted, cache-served when admissible), moves them to the
    device, computes LM grads on its own deterministic batch stream, and
    writes ``theta - lr * g`` for its owned chunk group — the Def-3 program
    with one logical worker owning many chunks.  Returns JAX's keys plus
    ``steps``: per worker and step, its loss and the host-clock seconds of
    the step and of its parts (``settle`` of the previous write, ``read``,
    ``h2d``, ``grad``, ``update`` with its device-to-host copy,
    ``write``)."""
    import threading

    from ..core.history import is_sequentially_correct
    from ..pdb.server import ShardCluster
    from ..runtime.fault import Backoff, ShardDeathPlan
    from ..tree import ravel

    device = resolve_device(args.device)
    cfg, params, _opt, sync, spec = build(args, device)
    grad_fn = make_lm_grad_fn(cfg, sync)
    flat, unravel = ravel(params)
    del params
    n, dtype = flat.numel(), flat.dtype
    p, m, bounds, owned = _server_layout(args, n)
    theta0 = flat.cpu()
    del flat
    policy = {"datacentric": "dc", "bsp": "bsp", "ssp": "ssp"}[args.mode]

    plan = None
    snapshot_dir = args.snapshot_dir or None
    scratch = None                      # a snapshot directory of our own
    if args.kill_shard_at_step >= 0:
        plan = ShardDeathPlan(kill_at_step=args.kill_shard_at_step,
                              shard=args.shards - 1, restart=True)
        if snapshot_dir is None:
            import tempfile
            scratch = tempfile.TemporaryDirectory(prefix="pdb-shards-")
            snapshot_dir = scratch.name

    cluster = ShardCluster([theta0[a:b] for a, b in zip(bounds[:-1],
                                                         bounds[1:])],
                           p, args.shards, policy=policy, delta=args.delta,
                           record=True, snapshot_dir=snapshot_dir,
                           batched=args.rpc != "per-op")
    del theta0
    losses: list[float] = []
    steps: list[dict] = []
    errors: list[BaseException] = []
    n_threads = torch.get_num_threads()   # see core.threaded.run_parallel
    sync_dev = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    t0 = time.time()

    def worker(k: int, db) -> None:
        try:
            torch.set_num_threads(n_threads)
            for itr in range(1, args.steps + 1):
                if k == 0 and plan is not None:
                    plan.maybe_kill(itr, cluster)
                ts = [time.perf_counter()]
                db.settle()
                ts.append(time.perf_counter())
                vals = db.read_all(k, itr)
                ts.append(time.perf_counter())
                theta = torch.empty(n, dtype=dtype, device=device)
                for c, v in enumerate(vals):
                    theta[bounds[c]:bounds[c + 1]].copy_(v)
                del vals
                sync_dev()
                ts.append(time.perf_counter())
                batch = make_lm_batch(spec, (itr - 1) * p + k, device)
                loss, grads = grad_fn(unravel(theta), batch)
                g, _ = ravel(grads)
                del grads
                sync_dev()
                ts.append(time.perf_counter())
                # two roundings, as numpy's theta - lr * g: the product,
                # then the difference (no fused multiply-add)
                new = [(c, itr, (theta[bounds[c]:bounds[c + 1]]
                                 - args.lr * g[bounds[c]:bounds[c + 1]])
                        .cpu()) for c in owned[k]]
                del theta, g
                ts.append(time.perf_counter())
                # one write_batch per owner shard for the whole owned group
                # (per-chunk round-trips on the per-op path)
                db.write_many(k, new)
                ts.append(time.perf_counter())
                steps.append(dict(worker=k, itr=itr, loss=float(loss),
                                  step=ts[-1] - ts[0], **{
                    name: b - a for name, a, b in zip(
                        ("settle", "read", "h2d", "grad", "update", "write"),
                        ts, ts[1:])}))
                if k == 0:
                    losses.append(float(loss))
                    if (itr - 1) % args.log_every == 0 or itr == args.steps:
                        print(f"step {itr - 1:5d} loss {float(loss):.4f} "
                              f"[server] {(time.time() - t0):.1f}s",
                              flush=True)
        except BaseException as e:
            errors.append(e)
            raise

    # the drill's clients wait out a shard's restart: a fork of the
    # cluster's forkserver, ~0.05 s, against 15 s of retries
    backoff = Backoff(max_retries=12)
    with cluster:
        clients = [cluster.make_client(k, backoff=backoff)
                   for k in range(p)]
        threads = [threading.Thread(target=worker, args=(k, clients[k]),
                                    daemon=True) for k in range(p)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for c in clients:     # drain in-flight fire-and-forget broadcasts
            c.flush()         # so pull() sees fully-settled shard state
        pulled = cluster.pull()
        retries = sum(c.telemetry.stats.retried_steps for c in clients)
        cache_hits = sum(c.stats["cache_hits"] + c.stats["cache_validated"]
                         for c in clients)
        for c in clients:
            c.close()
    if scratch is not None:
        scratch.cleanup()
    tele = pulled.summary()
    tele["retried_steps"] += retries
    seq_ok = is_sequentially_correct(pulled.history, p)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) "
          f"[server: {args.shards} shards x {p} workers, {m} chunks, "
          f"{tele['reads']}r/{tele['writes']}w "
          f"max_staleness={tele['max_staleness']:.0f} "
          f"cache_served={cache_hits} rpc_retries={retries} "
          f"seq_correct={seq_ok}]")
    if device.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")
    return {"first_loss": losses[0], "final_loss": losses[-1],
            "telemetry": tele, "sequentially_correct": seq_ok,
            "rpc_retries": retries, "steps": steps}


def server_replay(args) -> tuple[torch.Tensor, list[float]]:
    """The one-thread sequential replay of ``--backend server`` at delta 0:
    at each iteration every worker reads theta_{itr-1} and writes its
    owned chunks, with ``run_server_backend``'s layout, batches and update.
    Returns the final raveled theta (on the CPU) and worker 0's losses."""
    from ..tree import ravel
    device = resolve_device(args.device)
    cfg, params, _opt, sync, spec = build(args, device)
    grad_fn = make_lm_grad_fn(cfg, sync)
    theta, unravel = ravel(params)
    del params
    p, _m, bounds, owned = _server_layout(args, theta.numel())
    losses = []
    for itr in range(1, args.steps + 1):
        new = theta.clone()
        for k in range(p):
            loss, grads = grad_fn(unravel(theta),
                                  make_lm_batch(spec, (itr - 1) * p + k,
                                                device))
            g, _ = ravel(grads)
            for c in owned[k]:
                a, b = bounds[c], bounds[c + 1]
                new[a:b] = theta[a:b] - args.lr * g[a:b]
            if k == 0:
                losses.append(float(loss))
        theta = new
    return theta.cpu(), losses


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--remat", choices=["none", "full", "dots"],
                    default="none",
                    help="none|full|dots: keep every activation, recompute "
                         "each layer in the backward, or keep only the "
                         "products with no batch dimensions")
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
                         "server: multi-process sharded parameter server "
                         "(shards store on the CPU, workers compute on "
                         "--device)")
    ap.add_argument("--shards", type=int, default=2,
                    help="server backend: number of shard processes")
    ap.add_argument("--workers", type=int, default=2,
                    help="server backend: number of client worker threads")
    ap.add_argument("--param-chunks", type=int, default=0,
                    help="server backend: chunks the raveled parameter "
                         "vector is split into (0 = 2*workers)")
    ap.add_argument("--kill-shard-at-step", type=int, default=-1,
                    help="server backend: kill+restart the last shard at "
                         "this step (shard-death drill)")
    ap.add_argument("--rpc", choices=["batched", "per-op"], default="batched",
                    help="server backend: protocol-v2 batched/pipelined "
                         "RPC (default) or per-chunk v1 round-trips")
    ap.add_argument("--snapshot-dir", default="",
                    help="server backend: shard snapshot directory "
                         "(crash-restart survival)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "versions)")
    ap.add_argument("--profile-steps", type=_step_range, default=None,
                    metavar="A:B",
                    help="engine backend: record steps A..B-1 under "
                         "torch.profiler and write their Chrome trace "
                         "(the program's spans over the device timeline)")
    ap.add_argument("--profile-out", default="train_trace.json",
                    help="where --profile-steps writes its trace")
    return ap.parse_args(argv)


def _step_range(text: str) -> tuple[int, int]:
    a, sep, b = text.partition(":")
    try:
        lo, hi = int(a), int(b)
    except ValueError:
        lo = hi = -1
    if not sep or not 0 <= lo < hi:
        raise argparse.ArgumentTypeError(f"want A:B with 0 <= A < B, got "
                                         f"{text!r}")
    return lo, hi


class _StepProfile:
    """``--profile-steps A:B``: ``torch.profiler`` (host and, on a card,
    device activities) over steps A..B-1, its Chrome trace written when
    step B begins or the run ends."""

    def __init__(self, window, path: str, device: torch.device):
        self.window, self.path, self.device = window, path, device
        self.prof = None

    def at_step(self, step: int) -> None:
        if self.window is None:
            return
        if step == self.window[1]:
            self.stop()
        if step == self.window[0]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        print(f"profile: steps {self.window[0]}..{self.window[1] - 1} -> "
              f"{self.path}", flush=True)


def main(argv=None) -> dict:
    apply_tuning()
    args = parse_args(argv)
    if args.backend == "server":
        return run_server_backend(args)

    device = resolve_device(args.device)
    cfg, params, opt, sync, spec = build(args, device)
    start = 0

    # one ParameterDB engine for both paths (sync dict state at delta=0,
    # device ring buffer otherwise) — see repro_torch.pdb.torch_backend
    router: dict = {}       # an MoE config's last lm_loss metrics
    engine = make_train_engine(cfg, opt, sync, params,
                               on_metrics=router.update if cfg.is_moe
                               else None)
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
    profiled = _StepProfile(args.profile_steps, args.profile_out, device)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        profiled.at_step(step)
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
            aux = (f"lb_loss {float(router['lb_loss']):.4f} router_entropy "
                   f"{float(router['router_entropy']):.4f} "
                   if router else "")
            print(f"step {step:5d} loss {loss:.4f} [{outcome}] {aux}"
                  f"{(time.time()-t0):.1f}s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, engine.commit(state))
    profiled.stop()
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
