"""The port's discrete-event simulator (``repro_torch.core.simulator``)
against the JAX package's: the same ``SimResult`` exactly for every
policy, stragglers, backup tasks and read modes; the same improvement,
serial makespan, trimmed mean and Amdahl curve; and
``tests/test_simulator.py``'s Fig-2 trends on the port."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import simulator as JS  # noqa: E402
from repro_torch.core.simulator import (SimConfig, amdahl_speedup,  # noqa: E402
                                        improvement_pct, serial_makespan,
                                        simulate, trimmed_mean)

CONFIGS = [
    dict(policy="bsp", n_workers=6, n_iters=12, seed=0),
    dict(policy="dc", n_workers=6, n_iters=12, seed=1),
    dict(policy="dc", delta=2, n_workers=8, n_iters=10, seed=2,
         straggler_prob=0.1),
    dict(policy="dc-array", n_workers=5, n_iters=10, seed=3,
         concurrent_reads=False),
    dict(policy="ssp", delta=1, n_workers=6, n_iters=10, seed=4),
    dict(policy="hogwild", n_workers=7, n_iters=8, seed=5,
         compute_mu=0.5),
    dict(policy="dc", n_workers=16, n_iters=8, seed=6, straggler_prob=0.05,
         straggler_factor=20.0, backup_tasks=True),
    dict(policy="bsp", n_workers=4, n_iters=8, seed=7, compute_sigma=0.8),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=[
    f"{c['policy']}-{c['n_workers']}-{c['seed']}" for c in CONFIGS])
def test_sim_result_equals_jax(kw):
    got = simulate(SimConfig(**kw))
    want = JS.simulate(JS.SimConfig(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert serial_makespan(SimConfig(**kw)) == \
        JS.serial_makespan(JS.SimConfig(**kw))


def test_improvement_and_curves_equal_jax():
    for kw, delta in ((dict(n_workers=6, n_iters=10, seed=0), 0),
                      (dict(n_workers=12, n_iters=10, compute_mu=0.5,
                            seed=1), 1)):
        assert improvement_pct(kw, delta) == JS.improvement_pct(kw, delta)
    xs = [3.0, 1.0, 9.0, 4.0, 2.0, 8.0, 7.0]
    assert trimmed_mean(xs) == JS.trimmed_mean(xs)
    assert trimmed_mean(xs[:3], drop=2) == JS.trimmed_mean(xs[:3], drop=2)
    for p in (1, 6, 40):
        assert amdahl_speedup(p, 0.02) == JS.amdahl_speedup(p, 0.02)
    assert dataclasses.asdict(SimConfig()) == dataclasses.asdict(
        JS.SimConfig())


# ---------------------------------------------------------------------------
# tests/test_simulator.py on the port
# ---------------------------------------------------------------------------

def test_dc_beats_bsp_gd_regime():
    assert improvement_pct(dict(n_workers=16, n_iters=30, seed=0)) > 5.0


def test_improvement_grows_with_workers_gd():
    imps = [improvement_pct(dict(n_workers=p, n_iters=30, seed=1))
            for p in (6, 16, 40)]
    assert imps[0] < imps[-1]


def test_sgd_regime_high_improvement_declining():
    i6 = improvement_pct(dict(n_workers=6, n_iters=30, compute_mu=0.5,
                              seed=0))
    i40 = improvement_pct(dict(n_workers=40, n_iters=30, compute_mu=0.5,
                               seed=0))
    assert i6 > 50.0
    assert i40 < i6


def test_minibatch_declines_less_than_sgd():
    def decline(mu):
        return improvement_pct(dict(n_workers=6, n_iters=30, compute_mu=mu,
                                    seed=2)) - \
            improvement_pct(dict(n_workers=40, n_iters=30, compute_mu=mu,
                                 seed=2))
    assert decline(0.5) > decline(2.5)


def test_delta_absorbs_stragglers():
    base = dict(n_workers=16, n_iters=30, straggler_prob=0.05, seed=1)
    assert improvement_pct(base, delta=2) > improvement_pct(base, delta=0) \
        + 10.0


def test_backup_tasks_cap_stragglers():
    cfg = dict(n_workers=16, n_iters=30, straggler_prob=0.05,
               straggler_factor=20.0, seed=3)
    plain = simulate(SimConfig(policy="dc", **cfg))
    backed = simulate(SimConfig(policy="dc", backup_tasks=True, **cfg))
    assert backed.makespan < plain.makespan


def test_deterministic():
    cfg = SimConfig(n_workers=8, n_iters=20, seed=5)
    assert simulate(cfg).makespan == simulate(cfg).makespan


def test_same_workload_across_policies():
    zero = dict(n_workers=8, n_iters=10, seed=7, read_cost=0, write_cost=0,
                barrier_cost=0, barrier_base=0, check_cost=0)
    a = simulate(SimConfig(policy="bsp", **zero))
    b = simulate(SimConfig(policy="dc", **zero))
    assert a.makespan == pytest.approx(b.makespan, rel=1e-9)


def test_speedup_below_amdahl():
    cfg = SimConfig(policy="dc", n_workers=16, n_iters=30, seed=0)
    sp = serial_makespan(cfg) / simulate(cfg).makespan
    assert 1.0 < sp < 16.0
    assert sp < amdahl_speedup(16, 0.01) * 1.05
    assert simulate(cfg).speedup_vs(serial_makespan(cfg)) == sp


def test_trimmed_mean_drops_extremes():
    xs = [100.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 0.0]
    assert trimmed_mean(xs) == pytest.approx(sum(range(2, 8)) / 6, rel=1e-9)
