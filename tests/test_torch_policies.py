"""The port's consistency policies (``repro_torch.pdb.policies``, the
``repro_torch.core.scheduler`` names) against the JAX package's.

* Every policy's ``can_read`` / ``can_write`` decisions equal the JAX
  policy's exactly: both replay the same admissible history op by op, and
  after every op every read and write of a window of iterations is probed
  on both sides; ``random_schedule`` gives the same history for the same
  seed under all six policies ``make_policy`` knows.
* The unit cases of ``tests/test_pdb_policies.py`` and
  ``tests/test_scheduler.py``, on the port: Hogwild (delta = inf),
  per-chunk delays, ``SyncConfig.delay_for`` / ``to_policy``, the Sec-5
  bit vector, the Sec-7.1 delta arrays, BSP barriers and total progress.
"""
import math

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.pdb import make_policy as jmake_policy  # noqa: E402
from repro.pdb import random_schedule as jrandom_schedule  # noqa: E402
from repro_torch.core import history as H  # noqa: E402
from repro_torch.core import threaded as T  # noqa: E402
from repro_torch.core.scheduler import (BSPScheduler,  # noqa: E402
                                        BitVectorScheduler, DeltaScheduler,
                                        random_schedule)
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.pdb import (POLICIES, BSPPolicy, BitVectorPolicy,  # noqa: E402
                             DeltaPolicy, SSPPolicy, ValueBoundPolicy,
                             make_policy)

torch.set_num_threads(1)

# (policy, delta): every name make_policy accepts, relaxed ones at two delays
CASES = [("bsp", 0), ("dc", 0), ("dc", 1), ("dc", 2), ("dc-array", 0),
         ("dc-array", 2), ("ssp", 0), ("ssp", 2), ("hogwild", 0),
         ("vap", 0.5)]


def _probe(pol, p, n):
    """Every admission decision of a window of iterations."""
    out = []
    for a in range(1, n + 3):
        for i in range(p):
            out.append(pol.can_write(i, i, a))
            out.extend(pol.can_read(i, j, a) for j in range(p))
    return out


def test_policy_names_match_jax():
    from repro.pdb import POLICIES as JPOLICIES
    assert POLICIES == JPOLICIES
    assert {c[0] for c in CASES} == set(POLICIES)


@pytest.mark.parametrize("policy,delta", CASES,
                         ids=[f"{p}-{d}" for p, d in CASES])
@pytest.mark.parametrize("p,n", [(2, 4), (4, 3)])
def test_admission_decisions_equal_jax(policy, delta, p, n):
    """Replay JAX's random admissible histories through both policies and
    compare every decision after every op, and the final clocks."""
    for seed in range(4):
        h = jrandom_schedule(policy, p, n, seed=seed, delta=delta)
        pt, pj = make_policy(policy, p, delta), jmake_policy(policy, p, delta)
        assert type(pt).__name__ == type(pj).__name__
        assert _probe(pt, p, n) == _probe(pj, p, n)
        for op in h:
            if op.kind == "r":
                assert pt.can_read(op.worker, op.chunk, op.itr)
                pt.did_read(op.worker, op.chunk, op.itr)
                pj.did_read(op.worker, op.chunk, op.itr)
            else:
                assert pt.can_write(op.worker, op.chunk, op.itr)
                pt.did_write(op.worker, op.chunk, op.itr)
                pj.did_write(op.worker, op.chunk, op.itr)
            assert _probe(pt, p, n) == _probe(pj, p, n)
        assert pt.clocks.as_dict() == pj.clocks.as_dict()
        for c in range(p):
            for a in range(1, n + 2):
                assert pt.cache_admissible(c, a - 1, a) == \
                    pj.cache_admissible(c, a - 1, a)
                assert pt.describe(0, c, a) == pj.describe(0, c, a)


@pytest.mark.parametrize("policy,delta", CASES,
                         ids=[f"{p}-{d}" for p, d in CASES])
def test_random_schedule_equals_jax(policy, delta):
    for seed in range(6):
        h = random_schedule(policy, 3, 3, seed=seed, delta=delta)
        want = jrandom_schedule(policy, 3, 3, seed=seed, delta=delta)
        assert [tuple(vars(o).values()) for o in h] == \
            [tuple(vars(o).values()) for o in want]


def test_make_policy_types_and_errors():
    assert isinstance(make_policy("bsp", 3), BSPPolicy)
    assert isinstance(make_policy("dc", 3), BitVectorPolicy)
    assert isinstance(make_policy("dc", 3, 1), DeltaPolicy)
    assert isinstance(make_policy("dc-array", 3), DeltaPolicy)
    assert isinstance(make_policy("vap", 3, vbound=0.1), ValueBoundPolicy)
    assert make_policy("vap", 3, vbound=0.1).vbound == 0.1
    with pytest.raises(ValueError, match="unknown policy"):
        make_policy("nope", 3)
    with pytest.raises(ValueError):
        ValueBoundPolicy(2, vbound=-1)


# ---------------------------------------------------------------------------
# tests/test_pdb_policies.py on the port
# ---------------------------------------------------------------------------

class TestHogwild:
    def test_everything_admissible(self):
        d = DeltaPolicy(3, delta=math.inf)
        assert d.hogwild
        for itr in (1, 7, 10 ** 9):
            assert d.can_read(0, 1, itr)
            assert d.can_write(2, 2, itr)

    def test_make_policy_hogwild_alias(self):
        d = make_policy("hogwild", 4)
        assert isinstance(d, DeltaPolicy) and d.hogwild
        d2 = make_policy("dc", 4, delta=math.inf)
        assert isinstance(d2, DeltaPolicy) and d2.hogwild

    def test_random_schedule_total_progress(self):
        for seed in range(5):
            h = random_schedule("dc", 3, 4, seed=seed, delta=math.inf)
            assert len(h) == 3 * 4 * 4

    def test_hogwild_interleavings_reach_beyond_rcwc(self):
        found = False
        for seed in range(20):
            h = random_schedule("dc", 3, 3, seed=seed, delta=math.inf)
            if not H.satisfies_rcwc(h, 3):
                found = True
                break
        assert found

    def test_threaded_hogwild_completes(self):
        X, y = T.make_synthetic_lr(100, 18, seed=1, device="cpu")
        task = T.LRTask(X, y, n_iters=6, mode="gd")
        stats = T.run_parallel(task, 3, policy="hogwild",
                               record_history=True, timeout=30)
        assert H.is_complete(stats.history, 3, 6)
        assert torch.isfinite(stats.theta).all()


class TestPerChunkDelta:
    def test_per_chunk_read_gates(self):
        d = DeltaPolicy(2, delta=[0, 2])
        assert not d.can_read(0, 0, 2)
        assert d.can_read(0, 1, 2)
        assert d.can_read(0, 1, 3)
        assert not d.can_read(0, 1, 4)

    def test_scalar_delta_property(self):
        assert DeltaPolicy(2, delta=[1, 3]).delta == 3
        assert DeltaPolicy(2, delta=2).delta == 2

    def test_length_mismatch_rejected(self):
        with pytest.raises(ValueError):
            DeltaPolicy(2, delta=[0, 1], n_chunks=3)

    def test_negative_rejected(self):
        with pytest.raises(ValueError):
            DeltaPolicy(2, delta=[0, -1])


class TestDelayFor:
    def test_default_uniform_delta(self):
        assert SyncConfig(delta=3).delay_for(("blocks", "attn")) == 3

    def test_exact_prefix_match(self):
        s = SyncConfig(delta=3, group_delays=(("embed", 0),))
        assert s.delay_for(("embed",)) == 0
        assert s.delay_for(("head",)) == 3

    def test_longest_prefix_wins(self):
        s = SyncConfig(delta=4, group_delays=(
            ("blocks", 1), ("blocks/0", 2), ("blocks/0/attn", 3)))
        assert s.delay_for(("blocks", "0", "attn")) == 3
        assert s.delay_for(("blocks", "0", "mlp")) == 2
        assert s.delay_for(("blocks", "7")) == 1
        assert s.delay_for(("embed",)) == 4

    def test_order_independent(self):
        a = SyncConfig(delta=4, group_delays=(("b", 1), ("b/0", 2)))
        b = SyncConfig(delta=4, group_delays=(("b/0", 2), ("b", 1)))
        assert a.delay_for(("b", "0")) == b.delay_for(("b", "0")) == 2

    def test_to_policy_modes(self):
        assert isinstance(SyncConfig(mode="bsp").to_policy(4), BSPPolicy)
        assert isinstance(SyncConfig().to_policy(4), BitVectorPolicy)
        assert isinstance(SyncConfig(delta=2).to_policy(4), DeltaPolicy)
        p = SyncConfig(mode="ssp", delta=2).to_policy(4)
        assert isinstance(p, SSPPolicy) and p.slack == 2


# ---------------------------------------------------------------------------
# tests/test_scheduler.py on the port
# ---------------------------------------------------------------------------

class TestBitVector:
    def test_initial_reads_allowed(self):
        s = BitVectorScheduler(3)
        assert all(s.can_read(i, j, 1) for i in range(3) for j in range(3))

    def test_read_ahead_blocked(self):
        assert not BitVectorScheduler(2).can_read(0, 1, 2)

    def test_write_requires_all_reads(self):
        s = BitVectorScheduler(2)
        s.did_read(0, 0, 1)
        assert not s.can_write(0, 0, 1)
        s.did_read(1, 0, 1)
        assert s.can_write(0, 0, 1)

    def test_write_zeroes_bits(self):
        s = BitVectorScheduler(2)
        for w in range(2):
            s.did_read(w, 0, 1)
        s.did_write(0, 0, 1)
        assert s.bits[0] == [False, False]
        assert s.version[0] == 1
        assert not s.can_write(0, 0, 2)

    def test_read_version_gate(self):
        s = BitVectorScheduler(2)
        for w in range(2):
            s.did_read(w, 0, 1)
        s.did_write(0, 0, 1)
        assert s.can_read(1, 0, 2)
        assert not s.can_read(1, 0, 3)


class TestDelta:
    def test_delta0_equals_bitvector(self):
        b, d = BitVectorScheduler(3), DeltaScheduler(3, delta=0)
        for w in range(3):
            assert b.can_read(w, 0, 1) == d.can_read(w, 0, 1)
            b.did_read(w, 0, 1)
            d.did_read(w, 0, 1)
        assert b.can_write(0, 0, 1) == d.can_write(0, 0, 1) is True

    def test_stale_read_allowed(self):
        d = DeltaScheduler(2, delta=1)
        assert d.can_read(0, 1, 2)
        assert not d.can_read(0, 1, 3)

    def test_write_min_gate(self):
        d = DeltaScheduler(2, delta=1)
        d.did_read(0, 0, 2)
        d.did_read(1, 0, 1)
        assert d.can_write(0, 0, 2)
        assert not d.can_write(0, 0, 3)

    def test_hogwild_limit(self):
        d = DeltaScheduler(2, delta=math.inf)
        assert d.hogwild
        assert d.can_read(0, 1, 10 ** 6)
        assert d.can_write(0, 0, 10 ** 6)

    def test_negative_delta_rejected(self):
        with pytest.raises(ValueError):
            DeltaScheduler(2, delta=-1)


class TestBSP:
    def test_read_barrier(self):
        s = BSPScheduler(2)
        assert s.can_read(0, 0, 1)
        assert not s.can_read(0, 0, 2)
        s.did_write(0, 0, 1)
        assert not s.can_read(0, 0, 2)
        s.did_write(1, 1, 1)
        assert s.can_read(0, 0, 2)

    def test_write_barrier_global(self):
        s = BSPScheduler(2)
        for j in range(2):
            s.did_read(0, j, 1)
        assert not s.can_write(0, 0, 1)
        for j in range(2):
            s.did_read(1, j, 1)
        assert s.can_write(0, 0, 1)


@pytest.mark.parametrize("policy", ["bsp", "dc", "dc-array"])
@pytest.mark.parametrize("p,n", [(2, 3), (4, 3), (6, 2)])
def test_total_progress(policy, p, n):
    for seed in range(5):
        assert len(random_schedule(policy, p, n, seed=seed)) == \
            p * n * (p + 1)


def test_progress_with_delta():
    for seed in range(5):
        assert len(random_schedule("dc", 3, 4, seed=seed, delta=2)) == 3 * 4 * 4
