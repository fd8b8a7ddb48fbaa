"""Reproduce the paper's Sec-6 experiments end to end (port of
``examples/paper_reproduction.py``).

1. LIVE: multi-threaded feature-partitioned linear regression under BSP vs
   data-centric RC/WC — verifies the bit-identical sequential-correctness
   claim on real threads and reports wall-clock; then delta = 2, bounded
   staleness (Sec 7), against the sequential loss.
2. SIMULATED: the Fig-2a/2e scaling curves from the calibrated
   discrete-event model (worker counts beyond what one machine exercises).

The data, theta and every update are f64 tensors on the card, or on the
CPU with ``--device cpu``.  ``--config synthetic`` is the paper's
synthetic set (960 features x 5,000 examples, 100 iterations);
``--config real_shape`` its real dataset's shape (150,360 features x
16,087 examples, 400 iterations; the sparse proxy, 19.35 GB dense, built
on the device).

    PYTHONPATH=src python -m repro_torch.launch.paper
    PYTHONPATH=src python -m repro_torch.launch.paper --device cpu
"""
from __future__ import annotations

import argparse

import torch

from ..configs import paper_lr
from ..core import threaded as T
from ..core.simulator import improvement_pct, trimmed_mean
from ..data.synthetic import regression_dataset, sparse_regression_dataset
from ..device import resolve_device

MODES = ("gd", "sgd", "minibatch")
N_WORKERS = 4
SIM_WORKERS = (6, 12, 16, 24, 32, 40)
SIM_SEEDS = 10                  # runs per point; the paper's statistic


def load(config: str, device: torch.device):
    """``(cfg, X, y)`` of a config, built on ``device``."""
    cfg = getattr(paper_lr, config)()
    make = regression_dataset if config == "synthetic" \
        else sparse_regression_dataset
    X, y = make(cfg.n_examples, cfg.n_features, seed=cfg.seed,
                device=device)
    return cfg, X, y


def live_linear_regression(cfg, X, y, n_workers: int, n_iters: int,
                           timeout: float | None = 300.0) -> dict:
    print("== live threaded linear regression (Sec 6 workload) ==")
    out = {}
    for mode in MODES:
        task = T.LRTask(X, y, lr=cfg.lr, n_iters=n_iters, mode=mode,
                        batch_size=cfg.batch_size, seed=cfg.seed)
        seq = T.run_sequential(task, n_workers)
        dc = T.run_parallel(task, n_workers, policy="dc", timeout=timeout)
        bsp = T.run_parallel(task, n_workers, policy="bsp", timeout=timeout)
        row = dict(dc_bit_identical=torch.equal(seq, dc.theta),
                   bsp_bit_identical=torch.equal(seq, bsp.theta),
                   dc_wall_s=dc.wall_time, bsp_wall_s=bsp.wall_time,
                   loss=T.loss(task, dc.theta))
        out[mode] = row
        print(f"  {mode:10s} bit-identical: dc={row['dc_bit_identical']}"
              f" bsp={row['bsp_bit_identical']}"
              f"  wall: dc={dc.wall_time * 1e3:8.1f}ms"
              f" bsp={bsp.wall_time * 1e3:8.1f}ms"
              f"  final-loss={row['loss']:.5f}")
    # delta > 0: bounded staleness (Sec 7) — converges, may differ
    task = T.LRTask(X, y, lr=cfg.lr, n_iters=n_iters, mode="gd")
    d2 = T.run_parallel(task, n_workers, policy="dc", delta=2,
                        timeout=timeout)
    out["delta2"] = dict(loss=T.loss(task, d2.theta),
                         sequential_loss=T.loss(
                             task, T.run_sequential(task, n_workers)))
    print(f"  delta=2    loss={out['delta2']['loss']:.5f} "
          f"(sequential {out['delta2']['sequential_loss']:.5f})")
    return out


def simulated_scaling() -> dict:
    print("== simulated Fig-2a (GD) and Fig-2e (SGD) improvement % ==")
    print("  workers |    GD   |   SGD")
    out = {}
    for p in SIM_WORKERS:
        gd = trimmed_mean([improvement_pct(
            dict(n_workers=p, n_iters=40, compute_mu=8.0, seed=s))
            for s in range(SIM_SEEDS)])
        sgd = trimmed_mean([improvement_pct(
            dict(n_workers=p, n_iters=40, compute_mu=0.5, seed=s))
            for s in range(SIM_SEEDS)])
        out[p] = (gd, sgd)
        print(f"  {p:7d} | {gd:6.1f}% | {sgd:6.1f}%")
    print("  (paper: GD 20%->55% rising; SGD 70-75% falling to 40-50%)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("synthetic", "real_shape"),
                    default="synthetic")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg, X, y = load(args.config, device)
    print(f"{args.config}: X {tuple(X.shape)} f64 on {device}")
    return dict(live=live_linear_regression(cfg, X, y, N_WORKERS,
                                            cfg.n_iters),
                simulated=simulated_scaling())


if __name__ == "__main__":
    main()
