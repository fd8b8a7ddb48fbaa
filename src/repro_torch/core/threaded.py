"""Live multi-threaded parameter-database runtime (port of
``repro.core.threaded``; paper Sec 6).

Real Python threads train a feature-partitioned linear-regression model
(the paper's prototype task) against the blocking ParameterDB backend
(:class:`repro_torch.pdb.ThreadedParameterDB`), under any consistency
policy: BSP barriers (Algorithm 2a), data-centric RC/WC constraints
(Algorithm 2b / Sec-7.1 protocol, exact or delta-relaxed), SSP per-worker
clocks, or unsynchronized Hogwild.  X, y and theta are f64 tensors on one
device: the card unless the caller's tensors lie on the CPU.

Correctness property (the paper's central claim): with ``delta=0`` the final
parameter vector is **bit-identical** to single-threaded sequential
execution, for GD, SGD and mini-batch — regardless of thread interleaving.
This holds because each worker's chunk update is a deterministic function of
the full-theta snapshot it read (whose value RC/WC pins to exactly the
previous iteration's writes) and a shared, pre-drawn sample schedule.  On
the card it also needs deterministic cuBLAS (``CUBLAS_WORKSPACE_CONFIG``
set before the first CUDA call) and every thread on the default stream,
which the threads here are.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Literal

import numpy as np
import torch

from ..data.synthetic import regression_dataset
from ..pdb import ThreadedParameterDB, make_policy
from .history import Op


@dataclasses.dataclass(frozen=True)
class LRTask:
    """A linear-regression training task (the paper's Sec-6 workload)."""
    X: torch.Tensor          # (n_examples, n_features)
    y: torch.Tensor          # (n_examples,)
    lr: float = 0.05
    n_iters: int = 30
    mode: Literal["gd", "sgd", "minibatch"] = "gd"
    batch_size: int = 100
    seed: int = 0

    def sample_schedule(self) -> torch.Tensor | None:
        """Pre-draw the SGD/mini-batch sample indices per iteration so every
        execution (sequential or parallel, any policy) sees the same data
        order — required for the bit-identical guarantee.  Drawn by numpy
        as in the JAX package, moved to X's device once."""
        n = self.X.shape[0]
        rng = np.random.default_rng(self.seed)
        if self.mode == "sgd":
            idx = rng.integers(0, n, size=(self.n_iters, 1))
        elif self.mode == "minibatch":
            idx = rng.integers(0, n, size=(self.n_iters, self.batch_size))
        else:
            return None
        return torch.from_numpy(idx).to(self.X.device)


def make_synthetic_lr(n_examples: int, n_features: int, seed: int = 0,
                      noise: float = 0.01,
                      device: str | torch.device | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Synthetic dataset in the style of Sec 6.1 (960 features, 5000 rows):
    ``data.synthetic.regression_dataset``."""
    return regression_dataset(n_examples, n_features, seed, noise, device)


def chunk_slices(n_features: int, n_workers: int) -> list[slice]:
    bounds = np.linspace(0, n_features, n_workers + 1).astype(int)
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def chunk_update(task: LRTask, theta: torch.Tensor, sl: slice, itr: int,
                 schedule: torch.Tensor | None) -> torch.Tensor:
    """New value for one feature chunk given a full-theta snapshot.
    Deterministic in (theta, itr) — the f_i of Equation 1.  ``X[:, sl].T``
    is a strided view that cuBLAS reads in place."""
    X, y = task.X, task.y
    if task.mode == "gd":
        resid = X @ theta - y
        g = X[:, sl].T @ resid / X.shape[0]
    else:
        idx = schedule[itr - 1]
        Xb = X[idx]
        resid = Xb @ theta - y[idx]
        g = Xb[:, sl].T @ resid / len(idx)
    return theta[sl] - task.lr * g


def run_sequential(task: LRTask, n_workers: int) -> torch.Tensor:
    """Algorithm 1: the single-threaded ground truth (same chunking)."""
    slices = chunk_slices(task.X.shape[1], n_workers)
    schedule = task.sample_schedule()
    theta = task.X.new_zeros(task.X.shape[1])
    for itr in range(1, task.n_iters + 1):
        snap = theta.clone()         # all reads precede all writes
        news = [chunk_update(task, snap, sl, itr, schedule) for sl in slices]
        for sl, v in zip(slices, news):
            theta[sl] = v
    return theta


# ---------------------------------------------------------------------------
# Parallel runners
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunStats:
    theta: torch.Tensor
    wall_time: float
    history: list[Op] | None
    staleness: dict | None = None


def run_parallel(task: LRTask, n_workers: int, policy: str = "dc",
                 delta: float = 0, record_history: bool = False,
                 timeout: float | None = 300.0) -> RunStats:
    """Train with ``n_workers`` real threads under the given policy
    ("bsp" | "dc" | "dc-array" | "ssp" | "hogwild").  ``timeout`` bounds
    each blocked DB op and each thread's join (None blocks forever).  The
    wall time ends after the device has finished the run's work."""
    d = task.X.shape[1]
    slices = chunk_slices(d, n_workers)
    schedule = task.sample_schedule()
    init = [task.X.new_zeros(sl.stop - sl.start) for sl in slices]

    db = ThreadedParameterDB(
        init, n_workers,
        policy=make_policy(policy, n_workers, delta, n_chunks=n_workers),
        record=record_history, timeout=timeout)

    errors: list[BaseException] = []
    # a new thread starts with the machine's default CPU thread count, not
    # the caller's: a CPU matvec would then sum in another order than the
    # caller's sequential run
    n_threads = torch.get_num_threads()

    def worker(i: int) -> None:
        try:
            torch.set_num_threads(n_threads)
            for itr in range(1, task.n_iters + 1):
                vals = db.read_all(i, itr)
                theta = torch.cat(vals)
                new = chunk_update(task, theta, slices[i], itr, schedule)
                db.write(i, i, itr, new)
        except BaseException as e:  # surface thread failures to the caller
            errors.append(e)
            raise

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_workers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("worker threads did not terminate (deadlock?)")
    return RunStats(db.theta(), wall, db.history, db.telemetry.summary())


def loss(task: LRTask, theta: torch.Tensor) -> float:
    r = task.X @ theta - task.y
    return float(0.5 * torch.mean(r * r))
