"""Shard-cluster orchestration (own copy of ``repro.pdb.server.cluster``):
spawn, initialize, kill/restart, collect.

:class:`ShardCluster` turns ``N`` shard server processes plus per-worker
:class:`~repro_torch.pdb.server.client.ClientParameterDB` instances into
one logical ParameterDB:

  * ``start()`` starts the shard processes (all together, then each
    one's port read over its pipe) and pushes each shard its hash-owned
    slice of the initial chunks.  They come from ``multiprocessing``'s
    *forkserver* context: a server process, started on first use from a
    fresh interpreter (no inherited state, no CUDA), imports the shard
    module — torch with it, a few seconds — once, and forks every shard
    of the caller's life from there, so a start or a drill's restart
    takes a fraction of a second (the JAX package spawns each shard anew:
    it imports numpy only);
  * ``kill_shard`` / ``restart_shard`` are the fault-drill hooks used by
    :class:`repro_torch.runtime.fault.ShardDeathPlan` — a restart rebinds
    the *same* port and (with ``snapshot_dir``) restores the shard's
    persisted state, so clients recover through reconnect-with-backoff
    alone;
  * ``pull()`` collects every shard's chunk values, Lamport-stamped Op
    history and staleness counters and reassembles the global view
    (``telemetry.merge_timed_histories`` / ``merge_stats``), on which
    ``repro_torch.core.history.is_sequentially_correct`` is the oracle.

The shards hold torch CPU tensors and never touch CUDA; the workers
compute wherever their tensors lie.

:func:`run_distributed_lr` is the Sec-6 workload on this backend — the
process-level twin of :func:`repro_torch.core.threaded.run_parallel`.

CLI::

    python -m repro_torch.pdb.server.cluster --smoke [--device cpu]

runs the conformance smoke (2 shards x 4 workers, on the card unless
``--device cpu``): dc/delta=0 must be bit-identical to sequential, and the
merged history must be sequentially correct.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import multiprocessing as mp
import os
import threading
import time
import weakref
from multiprocessing import forkserver, resource_tracker
from pathlib import Path

import torch

from ...core.history import Op
from ...runtime.fault import Backoff, retry_with_backoff
from ..telemetry import StalenessStats, merge_stats, merge_timed_histories, \
    summarize
from . import protocol as P
from . import shard as shard_mod
from .client import ClientParameterDB

SPAWN_TIMEOUT_S = 60.0          # a shard's wait to report its port
_SRC = str(Path(__file__).resolve().parents[3])   # the package's root


def _ensure_forkserver() -> None:
    """Start this process's forkserver, if it is not running, with the
    shard module imported.  Some Python 3.12 releases (3.12.3 among them)
    drop the caller's ``sys.path`` when the forkserver preloads, and the
    preload's ImportError is silent: every shard would then import torch
    itself.  So the package's root is on ``PYTHONPATH`` while the server
    starts."""
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = _SRC + (os.pathsep + old if old else "")
    try:
        forkserver.ensure_running()
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    global _stop_registered
    if not _stop_registered:
        atexit.register(stop_forkserver)
        _stop_registered = True


_stop_registered = False
_shards: weakref.WeakSet = weakref.WeakSet()    # every shard launched here


def stop_forkserver() -> None:
    """Stop this process's forkserver and ``multiprocessing``'s resource
    tracker, and wait until both have exited.  Left alone they exit only
    after their caller has: the forkserver then still tears torch down for
    a fraction of a second, a process that outlives the program.  Every
    shard holds both, so a shard still running is killed first.  Runs at
    exit once a cluster has started; a later cluster starts them again."""
    for proc in list(_shards):
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10.0)
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


@dataclasses.dataclass
class PullResult:
    """Global state reassembled from every shard."""
    values: dict[int, torch.Tensor]        # chunk id -> value (CPU)
    history: list[Op]                      # merged global Op history
    per_shard: list[list[tuple[int, Op]]]  # Lamport-stamped, per shard
    stats: StalenessStats                  # folded staleness counters
    versions: dict[int, int]
    cums: dict[int, float]

    def theta(self) -> torch.Tensor:
        return torch.cat([self.values[c] for c in sorted(self.values)])

    def summary(self) -> dict:
        return summarize(self.stats)


class ShardCluster:
    """N shard processes + init/teardown + fault drills + state collection."""

    def __init__(self, init_chunks, n_workers: int, n_shards: int = 2,
                 policy: str = "dc", delta=0, vbound: float | None = None,
                 record: bool = True, timeout: float = 60.0,
                 snapshot_dir: str | None = None, batched: bool = True):
        self.init_chunks = [torch.as_tensor(c, device="cpu").clone()
                            for c in init_chunks]
        self.p, self.m = n_workers, len(self.init_chunks)
        self.n_shards = n_shards
        self.policy, self.delta, self.vbound = policy, delta, vbound
        self.record, self.timeout = record, timeout
        self.snapshot_dir = snapshot_dir
        self.batched = batched
        self.procs: list[mp.process.BaseProcess | None] = [None] * n_shards
        self.addrs: list[tuple[str, int]] = [None] * n_shards
        self._ctx = mp.get_context("forkserver")
        self._ctx.set_forkserver_preload([shard_mod.__name__])
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def _snapshot_path(self, shard: int) -> str | None:
        if self.snapshot_dir is None:
            return None
        os.makedirs(self.snapshot_dir, exist_ok=True)
        return os.path.join(self.snapshot_dir, f"shard{shard}.pkl")

    def _launch(self, shard: int, port: int = 0):
        _ensure_forkserver()
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=shard_mod._spawn_entry,
            args=(child, self._snapshot_path(shard), port), daemon=True)
        proc.start()
        _shards.add(proc)
        child.close()
        return proc, parent

    def _await_port(self, shard: int, proc, parent) -> None:
        try:
            if not parent.poll(SPAWN_TIMEOUT_S):
                proc.kill()
                raise RuntimeError(f"shard {shard} did not report a port")
            bound = parent.recv()
        finally:
            parent.close()
        self.procs[shard] = proc
        self.addrs[shard] = ("127.0.0.1", bound)

    def _spawn(self, shard: int, port: int = 0) -> None:
        self._await_port(shard, *self._launch(shard, port))

    def _admin_rpc(self, shard: int, header: dict,
                   payload: bytes = b"") -> tuple[dict, bytes]:
        """One-shot control-plane RPC on a fresh connection, retried across
        the shard's restart window."""
        def attempt():
            sock = P.connect(self.addrs[shard], timeout=self.timeout + 10.0)
            try:
                P.send_msg(sock, header, payload)
                resp, rp = P.recv_msg(sock)
            finally:
                sock.close()
            if not resp.get("ok") and resp.get("retryable"):
                raise ConnectionResetError(resp.get("error", "retryable"))
            if not resp.get("ok"):
                raise RuntimeError(f"shard{shard}: {resp.get('error')}")
            return resp, rp

        return retry_with_backoff(attempt, Backoff(),
                                  describe=f"admin {header.get('op')} "
                                           f"-> shard{shard}")

    def _init_shard(self, shard: int) -> None:
        cfg = shard_mod.ShardConfig(
            shard_id=shard, n_shards=self.n_shards, n_workers=self.p,
            n_chunks=self.m, policy=self.policy, delta=self.delta,
            vbound=self.vbound, timeout=self.timeout, record=self.record)
        owned = {c: self.init_chunks[c]
                 for c in P.owned_chunks(shard, self.m, self.n_shards)}
        manifest, payload = P.pack_arrays(owned)
        self._admin_rpc(shard, {"op": "init", "config": cfg.to_header(),
                                "manifest": manifest}, payload)

    def start(self) -> "ShardCluster":
        launched = [self._launch(s) for s in range(self.n_shards)]
        for s, (proc, parent) in enumerate(launched):
            self._await_port(s, proc, parent)
        for s in range(self.n_shards):
            self._init_shard(s)
        self._started = True
        return self

    def __enter__(self) -> "ShardCluster":
        return self.start() if not self._started else self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self) -> None:
        live = [(s, p) for s, p in enumerate(self.procs)
                if p is not None and p.is_alive()]
        for s, _ in live:                 # every shard stops at once
            try:
                self._admin_rpc(s, {"op": "shutdown"})
            except Exception:
                pass
        for _, proc in live:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        self._started = False

    # -- fault drills (driven by runtime.fault.ShardDeathPlan) ---------------
    def kill_shard(self, shard: int) -> None:
        proc = self.procs[shard]
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(timeout=10.0)
        self.procs[shard] = None

    def restart_shard(self, shard: int) -> None:
        """Relaunch a killed shard on its original port.  With a snapshot
        the shard restores exactly where it died; without one it is
        re-initialized from the cluster's initial chunks (progress on that
        shard is lost — fine for drills, fatal for bit-identity)."""
        self._spawn(shard, port=self.addrs[shard][1])
        resp, _ = self._admin_rpc(shard, {"op": "ping"})
        if not resp.get("initialized"):
            self._init_shard(shard)

    # -- data plane ----------------------------------------------------------
    def make_client(self, worker: int,
                    backoff: Backoff | None = None) -> ClientParameterDB:
        return ClientParameterDB(
            worker, list(self.addrs), self.p, self.m, policy=self.policy,
            delta=self.delta, vbound=self.vbound, timeout=self.timeout,
            backoff=backoff, batched=self.batched)

    def pull(self) -> PullResult:
        values: dict[int, torch.Tensor] = {}
        per_shard, stats, versions, cums = [], [], {}, {}
        for s in range(self.n_shards):
            resp, payload = self._admin_rpc(s, {"op": "pull"})
            values.update(P.unpack_arrays(resp["manifest"], payload))
            per_shard.append([(int(t), Op(k, int(w), int(c), int(a)))
                              for t, k, w, c, a in resp["history"]])
            stats.append(StalenessStats(**resp["stats"]))
            versions.update({int(c): v for c, v in resp["versions"].items()})
            cums.update({int(c): v for c, v in resp["cums"].items()})
        return PullResult(values=values,
                          history=merge_timed_histories(per_shard),
                          per_shard=per_shard, stats=merge_stats(stats),
                          versions=versions, cums=cums)


# ---------------------------------------------------------------------------
# The Sec-6 workload on the sharded backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistributedRunStats:
    theta: torch.Tensor         # on the CPU
    wall_time: float
    history: list[Op]
    staleness: dict
    cache: dict                 # summed client cache counters
    retries: int                # rpc retries across all clients


def run_distributed_lr(task, n_workers: int, n_shards: int = 2,
                       policy: str = "dc", delta=0,
                       vbound: float | None = None,
                       record_history: bool = True,
                       timeout: float = 60.0,
                       snapshot_dir: str | None = None,
                       death_plan=None,
                       backoff: Backoff | None = None,
                       batched: bool = True
                       ) -> DistributedRunStats:
    """Train :class:`repro_torch.core.threaded.LRTask` with ``n_workers``
    client threads against ``n_shards`` shard processes — the process-level
    twin of :func:`repro_torch.core.threaded.run_parallel` (same chunking,
    same pre-drawn sample schedule, so dc/delta=0 stays bit-identical to
    sequential).  Each worker computes its ``chunk_update`` on the task's
    device (X's): the chunks it reads come off the wire as CPU tensors and
    go to that device, its write comes back to the CPU.

    ``death_plan`` (a :class:`repro_torch.runtime.fault.ShardDeathPlan`)
    injects a shard kill at a chosen iteration, fired by worker 0 — pair it
    with ``snapshot_dir`` so the restarted shard resumes where it died.

    ``batched=True`` (default) routes the hot paths through the protocol-v2
    batched/pipelined RPC layer; ``batched=False`` keeps the per-chunk v1
    round-trips.  The wall time ends after the device has finished the
    run's work."""
    from ...core.threaded import chunk_slices, chunk_update

    d = task.X.shape[1]
    dev = task.X.device
    slices = chunk_slices(d, n_workers)
    schedule = task.sample_schedule()
    init = [torch.zeros(sl.stop - sl.start, dtype=task.X.dtype)
            for sl in slices]

    cluster = ShardCluster(init, n_workers, n_shards, policy=policy,
                           delta=delta, vbound=vbound, record=record_history,
                           timeout=timeout, snapshot_dir=snapshot_dir,
                           batched=batched)
    errors: list[BaseException] = []
    clients: list[ClientParameterDB] = []
    # a new thread starts with the machine's default CPU thread count, not
    # the caller's: a CPU matvec would then sum in another order than the
    # caller's sequential run
    n_threads = torch.get_num_threads()

    def worker(i: int, db: ClientParameterDB) -> None:
        try:
            torch.set_num_threads(n_threads)
            for itr in range(1, task.n_iters + 1):
                if i == 0 and death_plan is not None:
                    death_plan.maybe_kill(itr, cluster)
                vals = db.read_all(i, itr)
                theta = torch.cat(vals).to(dev)
                new = chunk_update(task, theta, slices[i], itr, schedule)
                db.write(i, i, itr, new.cpu())
        except BaseException as e:
            errors.append(e)
            raise

    with cluster:
        clients = [cluster.make_client(i, backoff=backoff)
                   for i in range(n_workers)]
        threads = [threading.Thread(target=worker, args=(i, clients[i]),
                                    daemon=True)
                   for i in range(n_workers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout * task.n_iters)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise RuntimeError("distributed workers did not terminate "
                               "(deadlock?)")
        for c in clients:     # drain in-flight fire-and-forget broadcasts
            c.flush()         # so pull() sees fully-settled shard state
        pulled = cluster.pull()
        cache = {"cache_hits": 0, "cache_misses": 0,
                 "cache_validated": 0, "bytes_saved": 0}
        retries = 0
        for c in clients:
            for k in cache:
                cache[k] += c.stats[k]
            retries += c.telemetry.stats.retried_steps
            c.close()
    # shard stats can't see client-side reconnects; fold them in so one
    # summary describes the run's synchronization *and* fault behavior
    staleness = pulled.summary()
    staleness["retried_steps"] += retries
    return DistributedRunStats(theta=pulled.theta(), wall_time=wall,
                               history=pulled.history,
                               staleness=staleness,
                               cache=cache, retries=retries)


# ---------------------------------------------------------------------------
# CLI / CI smoke
# ---------------------------------------------------------------------------

def smoke(n_shards: int = 2, n_workers: int = 4, n_iters: int = 8,
          verbose: bool = True, modes: tuple[bool, ...] = (False, True),
          device: str | torch.device | None = None) -> bool:
    """dc/delta=0 on a live shard cluster must be bit-identical to
    sequential, with a sequentially-correct merged history — on the
    per-chunk v1 RPC path *and* the batched/pipelined v2 path (``modes``
    selects which), the workers on ``device`` (the card unless ``cpu``).
    Returns True on success."""
    from ...core.history import is_sequentially_correct
    from ...core.threaded import LRTask, make_synthetic_lr, run_sequential
    from ...device import resolve_device

    X, y = make_synthetic_lr(200, 24, seed=0, device=resolve_device(device))
    task = LRTask(X, y, n_iters=n_iters, mode="gd")
    expect = run_sequential(task, n_workers).cpu()
    ok = True
    for batched in modes:
        res = run_distributed_lr(task, n_workers, n_shards, policy="dc",
                                 delta=0, batched=batched)
        identical = bool(torch.equal(res.theta, expect))
        correct = is_sequentially_correct(res.history, n_workers)
        if verbose:
            print(f"shards={n_shards} workers={n_workers} iters={n_iters} "
                  f"policy=dc delta=0 rpc={'batched' if batched else 'per-op'}"
                  f" device={X.device}")
            print(f"  bit-identical to sequential: {identical}")
            print(f"  merged history sequentially correct: {correct} "
                  f"({len(res.history)} ops)")
            print(f"  staleness: {res.staleness}")
            print(f"  cache: {res.cache}  rpc retries: {res.retries}")
        ok = ok and identical and correct
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="distributed ParameterDB cluster driver")
    ap.add_argument("--smoke", action="store_true",
                    help="run the conformance smoke and exit nonzero on "
                         "failure")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--rpc", choices=["both", "batched", "per-op"],
                    default="both",
                    help="which RPC path(s) the smoke exercises")
    ap.add_argument("--device", default="cuda",
                    help="where the workers compute: cuda or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        modes = {"both": (False, True), "batched": (True,),
                 "per-op": (False,)}[args.rpc]
        ok = smoke(args.shards, args.workers, args.iters, modes=modes,
                   device=args.device)
        print("SMOKE PASS" if ok else "SMOKE FAIL")
        return 0 if ok else 1
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
