"""The port's sharded parameter server (``repro_torch.pdb.server``) with
real shard processes, on the CPU, against the JAX package's.

* The server rows of ``tests/test_pdb_conformance.py`` on the port: at
  delta 0, dc, dc-array and bsp on both RPC paths give theta bit for bit
  the port's ``run_sequential`` (and within 1e-12 relative of JAX's on the
  same f64 data: torch and numpy sum the matvec in another order), with
  complete, sequentially-correct merged histories; cache hits at delta 1;
  SSP's clock bound; op counts; the order-preserving merge over 3 shards.
* ``tests/test_pdb_server.py``'s cluster tests: the vap validation, the
  stall diagnostic carried to the client (JAX's message, word for word)
  and the kill-and-restart drill (bit-identity kept, retries counted).
* Mixed clusters: a port client on JAX shards and a JAX client on port
  shards, computing JAX's updates, give the theta bits of an all-JAX run;
  driven in lockstep on the per-op path, also its Lamport-stamped
  per-shard histories, op for op and stamp for stamp.
* A program that ran a cluster (and a drill) leaves no process of its
  session behind when it exits: the forkserver and the resource tracker
  stop before it does.

Every cluster run has a timeout of its own (``TIMEOUT``: each blocked op,
each thread's join), so a hang fails the test instead of the session.  A
drill's restarted shard is forked from the cluster's forkserver (a few
hundredths of a second); its clients retry over a 53 s backoff window
all the same.
"""
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import history as JH  # noqa: E402
from repro.core import threaded as JT  # noqa: E402
from repro.pdb.server import ShardCluster as JShardCluster  # noqa: E402
from repro.pdb.server import client as jclient  # noqa: E402
from repro_torch.core import history as H  # noqa: E402
from repro_torch.core import threaded as T  # noqa: E402
from repro_torch.pdb import WaitTimeout, ssp_clock_bound_violations  # noqa
from repro_torch.pdb.server import (ShardCluster, run_distributed_lr,  # noqa
                                    shard_of)
from repro_torch.pdb.server.client import ClientParameterDB  # noqa: E402
from repro_torch.runtime.fault import Backoff, ShardDeathPlan  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 30.0
SEQ_POLICIES = ["bsp", "dc", "dc-array"]
DRILL_BACKOFF = Backoff(max_retries=30)       # 53 s of retries


@pytest.fixture(scope="module")
def data():
    return T.make_synthetic_lr(120, 24, seed=0, device="cpu")


def _task(data, **kw):
    X, y = data
    kw.setdefault("n_iters", 6)
    return T.LRTask(X, y, mode="gd", **kw)


def _jtask(task):
    """JAX's LRTask on the port task's f64 data."""
    return JT.LRTask(task.X.numpy(), task.y.numpy(), lr=task.lr,
                     n_iters=task.n_iters, mode=task.mode)


def _ops(history) -> list[tuple]:
    """(kind, worker, chunk, itr) of each op: the two packages' Op classes
    do not compare equal to each other."""
    return [(op.kind, op.worker, op.chunk, op.itr) for op in history]


def _stamped(per_shard) -> list[list[tuple]]:
    return [[(t, *_ops([op])[0]) for t, op in part] for part in per_shard]


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# the conformance matrix's server rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["per-op", "batched"])
@pytest.mark.parametrize("policy", SEQ_POLICIES)
def test_server_delta0_bit_identical(data, policy, batched):
    task = _task(data)
    workers = 4
    seq = T.run_sequential(task, workers)
    res = run_distributed_lr(task, workers, n_shards=2, policy=policy,
                             delta=0, batched=batched, timeout=TIMEOUT)
    assert res.theta.dtype == torch.float64
    assert torch.equal(res.theta, seq)
    assert _rel(res.theta.numpy(),
                JT.run_sequential(_jtask(task), workers)) <= 1e-12
    assert H.is_complete(res.history, workers, task.n_iters)
    assert H.is_sequentially_correct(res.history, workers)
    assert res.staleness["max_staleness"] == 0
    assert res.staleness["stale_reads"] == 0


@pytest.mark.parametrize("batched", [False, True], ids=["per-op", "batched"])
def test_server_delta_relaxed_cache_hits(data, batched):
    task = _task(data, n_iters=8)
    res = run_distributed_lr(task, 4, n_shards=2, policy="dc-array", delta=1,
                             batched=batched, timeout=TIMEOUT)
    assert res.staleness["max_staleness"] <= 1
    assert res.cache["cache_hits"] > 0
    assert res.cache["bytes_saved"] > 0
    zero = torch.zeros(24, dtype=torch.float64)
    assert T.loss(task, res.theta) < T.loss(task, zero)


@pytest.mark.parametrize("batched", [False, True], ids=["per-op", "batched"])
def test_server_ssp_clock_bound(data, batched):
    task = _task(data, n_iters=8)
    res = run_distributed_lr(task, 4, n_shards=2, policy="ssp", delta=2,
                             batched=batched, timeout=TIMEOUT)
    assert H.is_complete(res.history, 4, 8)
    assert ssp_clock_bound_violations(res.history, 4, 2) == []
    assert res.staleness["max_staleness"] <= 2


@pytest.mark.parametrize("batched", [False, True], ids=["per-op", "batched"])
def test_server_op_counts_match_other_backends(data, batched):
    task = _task(data, n_iters=4)
    p = 3
    res = run_distributed_lr(task, p, n_shards=2, policy="hogwild",
                             batched=batched, timeout=TIMEOUT)
    assert res.staleness["reads"] == p * p * task.n_iters
    assert res.staleness["writes"] == p * task.n_iters
    assert H.is_complete(res.history, p, task.n_iters)


def test_server_merged_history_is_order_preserving(data):
    task = _task(data, n_iters=4)
    workers = 4
    slices = T.chunk_slices(task.X.shape[1], workers)
    schedule = task.sample_schedule()
    init = [torch.zeros(sl.stop - sl.start, dtype=torch.float64)
            for sl in slices]
    with ShardCluster(init, workers, n_shards=3, policy="dc", delta=0,
                      timeout=TIMEOUT) as cluster:
        def worker(i, db):
            for itr in range(1, task.n_iters + 1):
                theta = torch.cat(db.read_all(i, itr))
                db.write(i, i, itr, T.chunk_update(task, theta, slices[i],
                                                   itr, schedule))
            db.close()

        threads = [threading.Thread(
            target=worker, args=(i, cluster.make_client(i)), daemon=True)
            for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT * task.n_iters)
        assert not any(t.is_alive() for t in threads)
        pulled = cluster.pull()
    parts = [[op for _, op in part] for part in pulled.per_shard]
    assert H.is_order_preserving_merge(pulled.history, parts)
    assert H.is_sequentially_correct(pulled.history, workers)
    assert torch.equal(pulled.theta(), T.run_sequential(task, workers))
    for shard_idx, part in enumerate(parts):
        assert all(shard_of(op.chunk, 3) == shard_idx for op in part)


# ---------------------------------------------------------------------------
# vap, stalls, shard death
# ---------------------------------------------------------------------------

def test_vap_conditional_reads_validate_within_bound(data):
    task = _task(data)
    loose = run_distributed_lr(task, 3, n_shards=2, policy="vap",
                               vbound=1e9, timeout=TIMEOUT)
    tight = run_distributed_lr(task, 3, n_shards=2, policy="vap",
                               vbound=0.0, timeout=TIMEOUT)
    assert loose.cache["cache_validated"] > 0
    assert loose.cache["bytes_saved"] > tight.cache["bytes_saved"]
    assert H.is_complete(loose.history, 3, task.n_iters)
    assert T.loss(task, tight.theta) < T.loss(
        task, torch.zeros(24, dtype=torch.float64))


def test_shard_stall_carries_jax_diagnostic_to_client():
    """A stalled admission wait on a shard surfaces client-side as the
    WaitTimeout diagnostic naming the op and the shard: the words of
    JAX's, from a JAX cluster in the same state."""
    msgs = []
    for cluster_cls, init in (
            (ShardCluster, [torch.zeros(2), torch.zeros(2)]),
            (JShardCluster, [np.zeros(2), np.zeros(2)])):
        with cluster_cls(init, n_workers=2, n_shards=1, policy="dc",
                         timeout=0.2) as cluster:
            db = cluster.make_client(0)
            with pytest.raises(Exception) as ei:
                db.read(0, 0, 3)          # needs w[pi0][2]: never happens
            assert type(ei.value).__name__ == "WaitTimeout"
            msgs.append(str(ei.value))
            db.close()
    assert isinstance(ei.value, Exception)
    msg = msgs[0]
    assert "timed out" in msg and "r0[pi0][3]" in msg and "shard0" in msg
    assert msgs[0] == msgs[1]


def test_shard_kill_restart_preserves_bit_identity():
    """Kill shard 1 at iteration 4 and restart it from its snapshot: the
    clients recover by reconnect-with-backoff, the retries show in the
    telemetry, and delta 0 stays bit for bit sequential."""
    X, y = T.make_synthetic_lr(120, 24, seed=2, device="cpu")
    task = T.LRTask(X, y, n_iters=8, mode="gd")
    expect = T.run_sequential(task, 4)
    plan = ShardDeathPlan(kill_at_step=4, shard=1, restart=True)
    with tempfile.TemporaryDirectory() as snap:
        res = run_distributed_lr(task, 4, n_shards=2, policy="dc", delta=0,
                                 snapshot_dir=snap, death_plan=plan,
                                 backoff=DRILL_BACKOFF, timeout=TIMEOUT)
    assert plan.fired
    assert res.retries > 0
    assert res.staleness["retried_steps"] >= res.retries
    assert torch.equal(res.theta, expect)
    assert H.is_complete(res.history, 4, task.n_iters)
    assert H.is_sequentially_correct(res.history, 4)


def test_client_waittimeout_is_the_ports():
    """The port's client raises the port's WaitTimeout (a JAX shard's
    stall included)."""
    with JShardCluster([np.zeros(2)], n_workers=1, n_shards=1, policy="dc",
                       timeout=0.2) as cluster:
        db = ClientParameterDB(0, cluster.addrs, 1, 1, policy="dc",
                               timeout=0.2)
        with pytest.raises(WaitTimeout, match=r"r0\[pi0\]\[3\]"):
            db.read(0, 0, 3)
        db.close()


# ---------------------------------------------------------------------------
# mixed clusters: the port's client and shards speak JAX's protocol
# ---------------------------------------------------------------------------

N_WORKERS, N_ITERS = 3, 4


def _mixed_run(cluster, make_client, task, threaded: bool):
    """Drive JAX's Sec-6 updates through ``make_client(i)`` clients on
    ``cluster``: in lockstep from this thread (every worker's reads of an
    iteration, then every write), or on one thread per worker."""
    slices = JT.chunk_slices(task.X.shape[1], N_WORKERS)
    clients = [make_client(i) for i in range(N_WORKERS)]

    def update(i, vals, itr):
        theta = np.concatenate([np.asarray(v) for v in vals])
        return JT.chunk_update(task, theta, slices[i], itr, None)

    if threaded:
        errors = []

        def worker(i):
            try:
                for itr in range(1, N_ITERS + 1):
                    new = update(i, clients[i].read_all(i, itr), itr)
                    clients[i].write(i, i, itr, new)
            except BaseException as e:
                errors.append(e)
                raise

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(N_WORKERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT * N_ITERS)
        assert not errors and not any(t.is_alive() for t in threads)
    else:
        for itr in range(1, N_ITERS + 1):
            reads = [c.read_all(i, itr) for i, c in enumerate(clients)]
            for i, c in enumerate(clients):
                c.write(i, i, itr, update(i, reads[i], itr))
    for c in clients:
        c.flush()
    pulled = cluster.pull()
    for c in clients:
        c.close()
    return np.asarray(pulled.theta()), pulled


def _mixed_clusters(batched: bool):
    """theta and pull of an all-JAX run, a port client on JAX shards and a
    JAX client on port shards, at delta 0 (dc)."""
    X, y = JT.make_synthetic_lr(90, 15, seed=3)
    task = JT.LRTask(X, y, n_iters=N_ITERS, mode="gd")
    slices = JT.chunk_slices(15, N_WORKERS)
    kw = dict(n_workers=N_WORKERS, n_shards=2, policy="dc", delta=0,
              timeout=TIMEOUT, batched=batched)
    out = {}
    for name, cluster_cls, client_cls, zeros in (
            ("jax", JShardCluster, jclient.ClientParameterDB, np.zeros),
            ("port_client_jax_shards", JShardCluster, ClientParameterDB,
             np.zeros),
            ("jax_client_port_shards", ShardCluster,
             jclient.ClientParameterDB,
             lambda n: torch.zeros(n, dtype=torch.float64))):
        init = [zeros(sl.stop - sl.start) for sl in slices]
        with cluster_cls(init, **kw) as cluster:
            def make_client(i, cluster=cluster, client_cls=client_cls):
                return client_cls(i, list(cluster.addrs), N_WORKERS,
                                  len(init), policy="dc", delta=0,
                                  timeout=TIMEOUT, batched=batched)
            for threaded in (False, True) if not batched else (True,):
                out[name, threaded] = _mixed_run(cluster, make_client, task,
                                                 threaded)
                if not threaded:        # lockstep: a fresh cluster after
                    break
    return out, JT.run_sequential(task, N_WORKERS)


def test_mixed_clusters_lockstep_per_op_equal_all_jax():
    """Per-op RPC driven in lockstep from one thread: every message is
    synchronous, so the port's peers must reproduce an all-JAX run's
    theta bits and every shard's Lamport-stamped history exactly."""
    out, seq = _mixed_clusters(batched=False)
    theta, pulled = out["jax", False]
    assert np.array_equal(theta, seq)
    for name in ("port_client_jax_shards", "jax_client_port_shards"):
        got, gp = out[name, False]
        assert got.dtype == np.float64
        assert np.array_equal(got, theta), name
        assert _stamped(gp.per_shard) == _stamped(pulled.per_shard), name
        assert _ops(gp.history) == _ops(pulled.history), name
        assert gp.versions == pulled.versions, name
        assert gp.cums == pulled.cums, name
        assert JH.is_complete(pulled.history, N_WORKERS, N_ITERS)
        assert JH.is_sequentially_correct(pulled.history, N_WORKERS)


def test_mixed_clusters_batched_threads_equal_all_jax():
    """Batched RPC on real threads: theta bit for bit the all-JAX run's,
    and the same ops (the interleaving, so the order, is the threads')."""
    out, seq = _mixed_clusters(batched=True)
    theta, pulled = out["jax", True]
    assert np.array_equal(theta, seq)
    for name in ("port_client_jax_shards", "jax_client_port_shards"):
        got, gp = out[name, True]
        assert np.array_equal(got, theta), name
        assert sorted(_ops(gp.history)) == sorted(_ops(pulled.history)), name
        oracle = JH if name == "port_client_jax_shards" else H
        assert oracle.is_complete(gp.history, N_WORKERS, N_ITERS)
        assert oracle.is_sequentially_correct(gp.history, N_WORKERS)


def _session_pids(sid: int) -> list[int]:
    pids = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            pids.append(int(stat.parent.name))
    return pids


@pytest.mark.skipif(not Path("/proc/self/stat").exists(),
                    reason="reads the process table from /proc")
@pytest.mark.parametrize("kill", [False, True], ids=["clean", "drill"])
def test_program_that_ran_a_cluster_leaves_no_process(kill):
    """The forkserver and the resource tracker stop when the program that
    started them exits, before it has: nothing of its session is left."""
    code = (
        "import torch\n"
        "from repro_torch.pdb.server import ShardCluster\n"
        "c = ShardCluster([torch.zeros(4, dtype=torch.float64)] * 4, 2,\n"
        "                 n_shards=2).start()\n"
        + ("c.kill_shard(1)\nc.restart_shard(1)\n" if kill else "")
        + "c.shutdown()\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            start_new_session=True)
    assert proc.wait(timeout=120) == 0
    assert _session_pids(proc.pid) == []
