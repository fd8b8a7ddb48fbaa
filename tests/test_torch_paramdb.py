"""The port's ParameterDB stores (``repro_torch.pdb.db``) against the JAX
package's, and the policy x store conformance matrix of
``tests/test_pdb_conformance.py`` on the port (its server rows wait for
the port's sharded backend; its JAX-engine rows are mirrored in
``tests/test_torch_pdb.py``).

* ``run_interleaved`` picks JAX's op sequence for the same seed (the same
  history), and its theta is within 1e-10 of JAX's numpy run.
* At delta = 0 the sequentially-correct policies (bsp, dc, dc-array) give
  a theta bit-identical to ``run_sequential`` through both stores, with
  complete, sequentially-correct histories and no stale read.
* The same telemetry flows through both stores; SSP keeps its clock bound
  under the fuzzer and on real threads; the in-process store raises on an
  inadmissible op, the threaded one times out with JAX's diagnostic.
* The telemetry merges equal JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import threaded as JT  # noqa: E402
from repro.pdb import InProcessParameterDB as JInProcess  # noqa: E402
from repro.pdb import make_policy as jmake_policy  # noqa: E402
from repro.pdb import run_interleaved as jrun_interleaved  # noqa: E402
from repro.pdb import telemetry as JTel  # noqa: E402
from repro_torch.core import history as H  # noqa: E402
from repro_torch.core import threaded as T  # noqa: E402
from repro_torch.pdb import (InadmissibleOp, InProcessParameterDB,  # noqa: E402
                             SSPPolicy, ThreadedParameterDB, WaitTimeout,
                             make_policy, merge_stats,
                             merge_timed_histories, random_schedule,
                             run_interleaved, ssp_clock_bound_violations)
from repro_torch.pdb.telemetry import StalenessStats  # noqa: E402

torch.set_num_threads(1)

SEQ_POLICIES = ["bsp", "dc", "dc-array"]
ALL_POLICIES = SEQ_POLICIES + ["ssp", "hogwild"]
TIMEOUT = 30


@pytest.fixture(scope="module")
def data():
    return T.make_synthetic_lr(120, 24, seed=0, device="cpu")


def _task(data, **kw):
    X, y = data
    kw.setdefault("n_iters", 6)
    return T.LRTask(X, y, mode="gd", **kw)


def _inprocess_theta(task, n_workers, policy, delta=0, seed=0):
    slices = T.chunk_slices(task.X.shape[1], n_workers)
    schedule = task.sample_schedule()
    init = [torch.zeros(sl.stop - sl.start, dtype=torch.float64)
            for sl in slices]
    db = InProcessParameterDB(
        init, n_workers,
        policy=make_policy(policy, n_workers, delta, n_chunks=n_workers),
        record=True)

    def update(worker, snap, itr):
        return T.chunk_update(task, snap, slices[worker], itr, schedule)

    return run_interleaved(db, task.n_iters, update, seed=seed), db


def _ops(h):
    return [(o.kind, o.worker, o.chunk, o.itr) for o in h]


# ---------------------------------------------------------------------------
# run_interleaved against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,delta", [("bsp", 0), ("dc", 0), ("dc", 2),
                                          ("ssp", 1), ("hogwild", 0)])
@pytest.mark.parametrize("mode", ["gd", "minibatch"])
def test_run_interleaved_equals_jax(policy, delta, mode):
    X, y = JT.make_synthetic_lr(90, 20, seed=4)
    for seed in range(3):
        jtask = JT.LRTask(X, y, n_iters=5, mode=mode, batch_size=7, seed=2)
        task = T.LRTask(torch.from_numpy(X), torch.from_numpy(y), n_iters=5,
                        mode=mode, batch_size=7, seed=2)
        theta, db = _inprocess_theta(task, 3, policy, delta, seed)
        slices = JT.chunk_slices(20, 3)
        sched = jtask.sample_schedule()
        jdb = JInProcess([np.zeros(sl.stop - sl.start) for sl in slices], 3,
                         policy=jmake_policy(policy, 3, delta, n_chunks=3),
                         record=True)
        want = jrun_interleaved(
            jdb, 5, lambda i, s, a: JT.chunk_update(jtask, s, slices[i], a,
                                                    sched), seed=seed)
        assert _ops(db.history) == _ops(jdb.history)
        assert db.telemetry.summary() == jdb.telemetry.summary()
        np.testing.assert_allclose(theta.numpy(), want, rtol=1e-10,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# delta=0 bit-identity + history oracle, for every (policy, store) pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", SEQ_POLICIES)
@pytest.mark.parametrize("workers", [2, 4])
def test_inprocess_delta0_bit_identical(data, policy, workers):
    task = _task(data)
    seq = T.run_sequential(task, workers)
    for seed in range(3):
        theta, db = _inprocess_theta(task, workers, policy, seed=seed)
        assert torch.equal(theta, seq)
        assert H.is_complete(db.history, workers, task.n_iters)
        assert H.is_sequentially_correct(db.history, workers)


@pytest.mark.parametrize("policy", SEQ_POLICIES)
@pytest.mark.parametrize("workers", [2, 4])
def test_threaded_delta0_bit_identical(data, policy, workers):
    task = _task(data)
    seq = T.run_sequential(task, workers)
    stats = T.run_parallel(task, workers, policy=policy, record_history=True,
                           timeout=TIMEOUT)
    assert torch.equal(stats.theta, seq)
    assert H.is_complete(stats.history, workers, task.n_iters)
    assert H.is_sequentially_correct(stats.history, workers)
    assert stats.staleness["max_staleness"] == 0
    assert stats.staleness["stale_reads"] == 0
    assert stats.staleness["ahead_reads"] == 0


@pytest.mark.parametrize("backend", ["inproc", "threaded"])
def test_delta_relaxed_still_converges(data, backend):
    task = _task(data, n_iters=25, lr=0.3)
    if backend == "threaded":
        theta = T.run_parallel(task, 4, policy="dc", delta=2,
                               timeout=TIMEOUT).theta
    else:
        theta, _ = _inprocess_theta(task, 4, "dc", delta=2, seed=1)
    init_loss = T.loss(task, torch.zeros(task.X.shape[1],
                                         dtype=torch.float64))
    assert T.loss(task, theta) < 0.9 * init_loss


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_op_counts_uniform_across_backends(data, policy):
    task = _task(data, n_iters=4)
    p = 3
    delta = 1 if policy in ("dc", "dc-array", "ssp") else 0
    _, db = _inprocess_theta(task, p, policy, delta=delta, seed=0)
    stats = T.run_parallel(task, p, policy=policy, delta=delta,
                           record_history=True, timeout=TIMEOUT)
    for s in (db.telemetry.summary(), stats.staleness):
        assert s["reads"] == p * p * task.n_iters
        assert s["writes"] == p * task.n_iters


# ---------------------------------------------------------------------------
# SSP: clock bound respected, under the fuzzer and on real threads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slack", [0, 1, 3])
@pytest.mark.parametrize("p,n", [(2, 4), (4, 3)])
def test_ssp_clock_bound_random_schedule(slack, p, n):
    for seed in range(8):
        h = random_schedule("ssp", p, n, seed=seed, delta=slack)
        assert len(h) == p * n * (p + 1)
        assert ssp_clock_bound_violations(h, p, slack) == []


def test_ssp_random_schedule_can_exceed_smaller_bound():
    assert any(ssp_clock_bound_violations(
        random_schedule("ssp", 3, 4, seed=s, delta=3), 3, 1)
        for s in range(20))


def test_ssp_threaded_respects_bound(data):
    task = _task(data, n_iters=8)
    stats = T.run_parallel(task, 4, policy="ssp", delta=2,
                           record_history=True, timeout=TIMEOUT)
    assert H.is_complete(stats.history, 4, 8)
    assert ssp_clock_bound_violations(stats.history, 4, 2) == []


def test_ssp_policy_admission_unit():
    s = SSPPolicy(2, slack=1)
    assert s.can_read(0, 0, 1) and s.can_read(0, 0, 2)
    assert not s.can_read(0, 0, 3)
    assert s.can_write(0, 0, 99)
    s.did_write(1, 1, 1)
    assert not s.can_read(0, 0, 3)
    s.did_write(0, 0, 1)
    assert s.can_read(0, 0, 3)
    with pytest.raises(ValueError):
        SSPPolicy(2, slack=-1)


# ---------------------------------------------------------------------------
# Non-blocking vs blocking stores; values; the device of the chunks
# ---------------------------------------------------------------------------

def test_inprocess_raises_on_inadmissible():
    db = InProcessParameterDB([torch.zeros(2), torch.zeros(2)], 2,
                              policy="dc")
    with pytest.raises(InadmissibleOp, match=r"r0\[pi0\]\[2\]"):
        db.read(0, 0, 2)
    db.read(0, 0, 1)
    with pytest.raises(InadmissibleOp, match=r"w0\[pi0\]\[1\]"):
        db.write(0, 0, 1, torch.ones(2))


def test_threaded_db_timeout_surfaces_deadlock():
    from repro.pdb import ThreadedParameterDB as JThreaded
    db = ThreadedParameterDB([torch.zeros(1)], 1, policy="dc", timeout=0.05)
    jdb = JThreaded([np.zeros(1)], 1, policy="dc", timeout=0.05)
    with pytest.raises(WaitTimeout, match="timed out") as got:
        db.read(0, 0, 5)
    with pytest.raises(RuntimeError) as want:
        jdb.read(0, 0, 5)
    assert str(got.value) == str(want.value)
    assert (got.value.kind, got.value.worker, got.value.chunk,
            got.value.itr) == ("r", 0, 0, 5)


def test_reads_are_copies_and_chunks_take_the_device():
    init = [np.arange(3.0), np.arange(2.0)]
    db = InProcessParameterDB(init, 2, policy="dc", device="cpu")
    init[0][0] = 99.0                     # the store holds its own copy
    v = db.read(0, 0, 1)
    v.add_(5.0)                           # and a read is a copy too
    assert db.chunks[0].tolist() == [0.0, 1.0, 2.0]
    assert db.chunks[0].dtype == torch.float64
    assert db.device == torch.device("cpu")
    assert db.theta().tolist() == [0.0, 1.0, 2.0, 0.0, 1.0]
    vals = db.values()
    vals[1].zero_()
    assert db.chunks[1].tolist() == [0.0, 1.0]


# ---------------------------------------------------------------------------
# Telemetry merges against JAX's
# ---------------------------------------------------------------------------

def test_merges_equal_jax():
    h = random_schedule("dc", 3, 2, seed=3)
    # three shards, one per chunk, stamped with interleaved clocks
    parts = [[(2 * k + c % 2, op) for k, op in
              enumerate(H.chunk_projection(h, c))] for c in range(3)]
    merged = merge_timed_histories(parts)
    jparts = [[(ts, op) for ts, op in part] for part in parts]
    assert merged == JTel.merge_timed_histories(jparts)
    assert H.is_order_preserving_merge(
        merged, [[op for _, op in part] for part in parts])
    assert H.is_sequentially_correct(merged, 3)

    stats, jstats = [], []
    for k, (reads, stale) in enumerate(((5, 1), (3, 0), (7, 2))):
        s = StalenessStats(reads=reads, writes=k, observed_reads=reads,
                           stale_reads=stale, ahead_reads=k % 2,
                           max_staleness=stale, min_staleness=-k,
                           sum_staleness=stale * 1.5, retried_steps=k,
                           skipped_steps=1)
        stats.append(s)
        jstats.append(JTel.StalenessStats(**vars(s)))
    assert vars(merge_stats(stats)) == vars(JTel.merge_stats(jstats))
