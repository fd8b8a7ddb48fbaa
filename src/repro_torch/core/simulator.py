"""Discrete-event simulation of parallel ML execution (own copy of
``repro.core.simulator``; paper Sec 6).

A numpy model of the host, not of the card: it holds no tensors, and its
draws and event order are the JAX package's, so a config gives the same
:class:`SimResult` there and here.

Models ``p`` workers executing the Def-3 program (read all chunks, compute,
write own chunk) under any consistency policy from
:mod:`repro_torch.pdb.policies` ("bsp", "dc", "dc-array", "ssp", "hogwild").
Cost model (calibrated against the paper's Sec-6 numbers):

  * each read / write op has a fixed latency (``read_cost`` / ``write_cost``:
    a shared-store round trip) and workers issue their ops serially;
  * BSP charges a barrier-crossing cost ``barrier_cost * p`` per barrier per
    iteration (centralized sense-barrier wakeup storm);
  * data-centric charges the Sec-5 admission-check cost per op: O(1) for
    reads (version compare), ``check_cost * p`` for writes (bit-vector scan)
    — the overhead the paper uses to explain the declining improvement for
    SGD at high worker counts;
  * compute times are lognormal with configurable skew, identical draws
    across policies for a given seed, so makespan differences are purely
    synchronization effects.

Why data-centric wins here (the paper's Sec-6.1 explanation): under BSP the
read barrier forces *every* worker's p reads to happen after the slowest
write — p*read_cost sits on the critical path of every worker, every
iteration.  Under RC/WC, a worker that finished early performs its write and
p-1 of its next-iteration reads while the straggler is still computing; only
the straggler's own chunk's read remains exposed.  The read/write latency is
absorbed by off-critical-path workers.

Time is in milliseconds.  All runs are deterministic given ``seed``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from ..pdb.policies import make_policy

READ, COMPUTE, WRITE, DONE = "read", "compute", "write", "done"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_workers: int = 8
    n_iters: int = 50
    policy: str = "dc"                 # "bsp" | "dc" | "dc-array" | "ssp" | "hogwild"
    delta: float = 0.0
    compute_mu: float = 8.0            # mean compute per iteration (ms)
    compute_sigma: float = 0.27        # lognormal sigma (task-time skew)
    read_cost: float = 0.127           # latency per chunk read (server RTT)
    write_cost: float = 0.198          # latency per chunk write
    check_cost: float = 0.036          # DC admission re-check, x p, per op
    barrier_cost: float = 0.087        # BSP barrier wakeup, x p, per barrier
    barrier_base: float = 2.06         # BSP fixed poll latency per crossing
    concurrent_reads: bool = True      # worker sends all read requests at once
    straggler_prob: float = 0.0
    straggler_factor: float = 8.0
    backup_tasks: bool = False         # speculative re-execution of stragglers
    backup_factor: float = 3.0         # backup kicks in at factor x mu
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    makespan: float
    total_block_time: float
    per_worker_finish: list[float]

    def speedup_vs(self, serial_makespan: float) -> float:
        return serial_makespan / self.makespan


@dataclasses.dataclass
class _Worker:
    itr: int = 1
    phase: str = READ
    unread: set = dataclasses.field(default_factory=set)
    inflight: int = 0
    blocked_since: float | None = None
    read_barrier_paid: bool = False   # BSP: one barrier charge per phase
    write_barrier_paid: bool = False
    finish: float = 0.0


def _compute_times(cfg: SimConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    sigma = cfg.compute_sigma
    mu_ln = math.log(cfg.compute_mu) - 0.5 * sigma * sigma
    t = rng.lognormal(mu_ln, sigma, size=(cfg.n_workers, cfg.n_iters))
    if cfg.straggler_prob > 0:
        mask = rng.random((cfg.n_workers, cfg.n_iters)) < cfg.straggler_prob
        t = np.where(mask, t * cfg.straggler_factor, t)
    if cfg.backup_tasks:
        t = np.minimum(t, cfg.backup_factor * cfg.compute_mu)
    return t


def simulate(cfg: SimConfig) -> SimResult:
    sched = make_policy(cfg.policy, cfg.n_workers, cfg.delta)
    times = _compute_times(cfg)
    p = cfg.n_workers
    is_bsp = cfg.policy == "bsp"

    workers = [_Worker(unread=set(range(p))) for _ in range(p)]
    events: list[tuple[float, int, str, int]] = []
    seq = 0
    block_time = 0.0
    blocked: set[int] = set()

    def push(t: float, kind: str, wid: int) -> None:
        nonlocal seq
        heapq.heappush(events, (t, seq, kind, wid))
        seq += 1

    def unblock(w: _Worker, wid: int, now: float) -> None:
        nonlocal block_time
        if w.blocked_since is not None:
            block_time += now - w.blocked_since
            w.blocked_since = None
            blocked.discard(wid)

    def try_advance(now: float, wid: int) -> None:
        w = workers[wid]
        if w.phase == READ:
            cand = [j for j in sorted(w.unread)
                    if sched.can_read(wid, j, w.itr)]
            if cand:
                unblock(w, wid, now)
                lat = cfg.read_cost
                if is_bsp and not w.read_barrier_paid:
                    lat += cfg.barrier_base + cfg.barrier_cost * p
                    w.read_barrier_paid = True
                if not is_bsp:
                    lat += cfg.check_cost * p   # deferred-op re-check scan
                if cfg.concurrent_reads:
                    # issue every admissible read at once (request-based
                    # server: responses arrive independently)
                    for j in cand:
                        w.unread.discard(j)
                        w.inflight += 1
                        push(now + lat, f"rdone:{j}", wid)
                else:
                    j = cand[0]
                    w.unread.discard(j)
                    w.inflight += 1
                    push(now + lat, f"rdone:{j}", wid)
            elif w.unread or w.inflight:
                if w.unread and w.blocked_since is None:
                    w.blocked_since = now
                    blocked.add(wid)
            else:
                w.phase = COMPUTE
                push(now + times[wid, w.itr - 1], "cdone", wid)
        elif w.phase == WRITE:
            if sched.can_write(wid, wid, w.itr):
                unblock(w, wid, now)
                lat = cfg.write_cost
                if is_bsp:
                    if not w.write_barrier_paid:
                        lat += cfg.barrier_base + cfg.barrier_cost * p
                        w.write_barrier_paid = True
                else:
                    lat += cfg.check_cost * p   # bit-vector scan
                push(now + lat, "wdone", wid)
                w.phase = "write-inflight"
            else:
                if w.blocked_since is None:
                    w.blocked_since = now
                    blocked.add(wid)

    def wake_blocked(now: float) -> None:
        for wid in list(blocked):
            try_advance(now, wid)

    for wid in range(p):
        try_advance(0.0, wid)

    makespan = 0.0
    while events:
        now, _, kind, wid = heapq.heappop(events)
        w = workers[wid]
        if kind.startswith("rdone:"):
            j = int(kind.split(":")[1])
            w.inflight -= 1
            sched.did_read(wid, j, w.itr)
            wake_blocked(now)       # a read may unblock pending writes
            try_advance(now, wid)
        elif kind == "cdone":
            w.phase = WRITE
            try_advance(now, wid)
        elif kind == "wdone":
            sched.did_write(wid, wid, w.itr)
            w.itr += 1
            if w.itr > cfg.n_iters:
                w.phase = DONE
                w.finish = now
                makespan = max(makespan, now)
            else:
                w.phase = READ
                w.unread = set(range(p))
                w.read_barrier_paid = False
                w.write_barrier_paid = False
            wake_blocked(now)       # a write may unblock pending reads
            if w.phase == READ:
                try_advance(now, wid)

    if blocked:
        raise RuntimeError(
            f"simulation deadlocked with workers {sorted(blocked)} blocked "
            f"(policy={cfg.policy}, delta={cfg.delta})")
    return SimResult(makespan, block_time, [w.finish for w in workers])


def serial_makespan(cfg: SimConfig) -> float:
    """Single-worker execution time of the same total work (for speedup
    curves, Fig 2b): all p partitions' compute done serially, no sync."""
    times = _compute_times(cfg)
    return float(times.sum()) + cfg.n_iters * cfg.n_workers * (
        cfg.read_cost + cfg.write_cost)


def improvement_pct(cfg_kwargs: dict, delta: float = 0.0) -> float:
    """Paper's headline metric: (T_bsp - T_dc) / T_bsp * 100 for the same
    workload (same seed => same compute-time draws)."""
    bsp = simulate(SimConfig(policy="bsp", **cfg_kwargs))
    dc = simulate(SimConfig(policy="dc", delta=delta, **cfg_kwargs))
    return (bsp.makespan - dc.makespan) / bsp.makespan * 100.0


def trimmed_mean(xs: list[float], drop: int = 2) -> float:
    """The paper's statistic: mean after dropping the `drop` fastest and
    slowest of 10 runs."""
    s = sorted(xs)
    core = s[drop:len(s) - drop] if len(s) > 2 * drop else s
    return float(np.mean(core))


def amdahl_speedup(p: int, serial_fraction: float = 0.01) -> float:
    """Theoretical asynchronous limit curve from Fig 2b."""
    return 1.0 / (serial_fraction + (1.0 - serial_fraction) / p)
