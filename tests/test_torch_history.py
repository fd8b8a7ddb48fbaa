"""The port's Op-history model (``repro_torch.core.history``) against the
JAX package's, and the paper's Theorems 1-3 on the port.

* Every predicate (complete, RC/WC and their delta forms, the barriers,
  BSP, strictly sequential, sequentially correct, order-preserving merge)
  gives JAX's answer on the same histories: the paper's H1-H3, the
  generators' histories and random admissible histories of every policy.
* ``execute_history`` / ``sequential_result`` / ``default_update`` give
  JAX's f64 results bit for bit.
* ``tests/test_history.py`` on the port, with seeded loops over
  ``random_schedule`` in place of hypothesis' draws: BSP and RC/WC
  histories are sequentially correct (syntactically and, executed against
  a non-commuting update, semantically), BSP is a strict subset of RC/WC,
  delta admits more, and the delta=0 engines agree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import history as JH  # noqa: E402
from repro_torch.core import history as H  # noqa: E402
from repro_torch.core.scheduler import random_schedule  # noqa: E402

torch.set_num_threads(1)


def _to_jax(h):
    return [JH.Op(o.kind, o.worker, o.chunk, o.itr) for o in h]


def _histories():
    """(name, port history, n_workers, n_iters) over every source."""
    out = [("h1", H.normalize_history(H.paper_h1()), 2, 2),
           ("h2", H.normalize_history(H.paper_h2()), 2, 2),
           ("h3", H.normalize_history(H.paper_h3()), 2, 2),
           ("seq", H.sequential_history(3, 2), 3, 2),
           ("bsp", H.bsp_history(3, 2, read_perm=[2, 0, 1],
                                 write_perm=[1, 2, 0]), 3, 2)]
    for policy, delta in (("bsp", 0), ("dc", 0), ("dc", 2), ("ssp", 1),
                          ("hogwild", 0)):
        for seed in range(4):
            out.append((f"{policy}{delta}-{seed}",
                        random_schedule(policy, 3, 3, seed=seed,
                                        delta=delta), 3, 3))
    return out


HISTORIES = _histories()


@pytest.mark.parametrize("name,h,p,n", HISTORIES,
                         ids=[c[0] for c in HISTORIES])
def test_predicates_equal_jax(name, h, p, n):
    j = _to_jax(h)
    assert H.is_complete(h, p, n) == JH.is_complete(j, p, n)
    for delta in (0, 1, 2):
        assert H.satisfies_read_constraint(h, delta) == \
            JH.satisfies_read_constraint(j, delta)
        assert H.satisfies_write_constraint(h, p, delta) == \
            JH.satisfies_write_constraint(j, p, delta)
        assert H.satisfies_rcwc(h, p, delta) == JH.satisfies_rcwc(j, p, delta)
    assert H.satisfies_read_barrier(h, p) == JH.satisfies_read_barrier(j, p)
    assert H.satisfies_write_barrier(h, p) == JH.satisfies_write_barrier(j, p)
    assert H.satisfies_bsp(h, p) == JH.satisfies_bsp(j, p)
    assert H.is_strictly_sequential(h, p) == JH.is_strictly_sequential(j, p)
    assert H.is_sequentially_correct(h, p) == \
        JH.is_sequentially_correct(j, p)
    parts = [H.chunk_projection(h, c) for c in range(p)]
    assert H.is_order_preserving_merge(h, parts) == \
        JH.is_order_preserving_merge(j, [_to_jax(x) for x in parts]) is True
    assert H.is_order_preserving_merge(h[::-1], parts) == \
        JH.is_order_preserving_merge(j[::-1], [_to_jax(x) for x in parts])


def test_generators_and_ops_equal_jax():
    for got, want in ((H.sequential_history(3, 2),
                       JH.sequential_history(3, 2)),
                      (H.bsp_history(2, 3), JH.bsp_history(2, 3)),
                      (H.paper_h2(), JH.paper_h2()),
                      (sum(H.worker_program(1, 3, 2), []),
                       sum(JH.worker_program(1, 3, 2), []))):
        assert [repr(o) for o in got] == [repr(o) for o in want]
    assert H.r(1, 2, 3) == H.Op("r", 1, 2, 3)
    assert H.w(1, 1, 3) < H.Op("w", 2, 2, 1)
    with pytest.raises(ValueError, match="bad op kind"):
        H.Op("x", 0, 0, 1)


@pytest.mark.parametrize("policy", ["bsp", "dc", "ssp", "hogwild"])
def test_execute_history_equals_jax(policy):
    """The interpreter's f64 results are JAX's bit for bit, on admissible
    and on racy histories."""
    for seed in range(3):
        h = random_schedule(policy, 3, 3, seed=seed, delta=1)
        upd, jupd = H.default_update(3, 2, seed), JH.default_update(3, 2,
                                                                    seed)
        got = H.execute_history(h, 3, 2, upd)
        assert np.array_equal(got, JH.execute_history(_to_jax(h), 3, 2, jupd))
        theta0 = np.arange(6, dtype=np.float64)
        assert np.array_equal(H.sequential_result(3, 3, 2, upd, theta0),
                              JH.sequential_result(3, 3, 2, jupd, theta0))


# ---------------------------------------------------------------------------
# tests/test_history.py on the port
# ---------------------------------------------------------------------------

class TestPaperExamples:
    def test_h1_is_bsp_and_rcwc(self):
        h1 = H.normalize_history(H.paper_h1())
        assert H.satisfies_bsp(h1, 2) and H.satisfies_rcwc(h1, 2)
        assert H.is_sequentially_correct(h1, 2)

    def test_h2_is_rcwc_but_not_bsp(self):
        h2 = H.normalize_history(H.paper_h2())
        assert not H.satisfies_bsp(h2, 2)
        assert H.satisfies_rcwc(h2, 2)
        assert H.is_sequentially_correct(h2, 2)

    def test_h3_rejected(self):
        h3 = H.normalize_history(H.paper_h3())
        assert not H.satisfies_bsp(h3, 2)
        assert not H.satisfies_rcwc(h3, 2)
        assert not H.is_sequentially_correct(h3, 2)

    def test_h2_semantically_equal_h3_not(self):
        upd = H.default_update(2, 3, seed=1)
        seq = H.sequential_result(2, 2, 3, upd)
        h2 = H.normalize_history(H.paper_h2())
        h3 = H.normalize_history(H.paper_h3())
        assert np.allclose(H.execute_history(h2, 2, 3, upd), seq)
        assert not np.allclose(H.execute_history(h3, 2, 3, upd), seq)

    def test_seq_executions_fig1(self):
        seq1 = H.sequential_history(2, 2)
        assert H.is_strictly_sequential(seq1, 2)
        assert H.is_sequentially_correct(seq1, 2)


# the (p, n, seed) draws that stand in for hypothesis' strategies
DRAWS = [(p, n, seed) for p in (2, 3, 5) for n in (1, 2, 4)
         for seed in (0, 7, 4242)]


def test_bsp_schedules_are_sequential():
    """Theorem 1: BSP => sequential ML computation."""
    for p, n, seed in DRAWS:
        h = random_schedule("bsp", p, n, seed=seed)
        assert H.is_complete(h, p, n)
        assert H.satisfies_bsp(h, p)
        assert H.is_sequentially_correct(h, p)


def test_rcwc_schedules_are_sequential():
    """Theorem 2: RC/WC => sequential ML computation (syntactic)."""
    for p, n, seed in DRAWS:
        h = random_schedule("dc", p, n, seed=seed)
        assert H.is_complete(h, p, n)
        assert H.satisfies_rcwc(h, p)
        assert H.is_sequentially_correct(h, p)


def test_rcwc_schedules_semantically_equal_sequential():
    """Theorem 2, the strong form: executing any RC/WC-admissible
    interleaving gives exactly the sequential answer."""
    for p in (2, 3, 4):
        for n in (1, 3):
            for seed in (1, 99, 1234):
                h = random_schedule("dc", p, n, seed=seed)
                upd = H.default_update(p, 2, seed=seed % 17)
                np.testing.assert_array_equal(
                    H.execute_history(h, p, 2, upd),
                    H.sequential_result(p, n, 2, upd))


def test_bsp_subset_rcwc():
    """Theorem 3: every BSP execution is RC/WC ..."""
    for p, n, seed in DRAWS:
        assert H.satisfies_rcwc(random_schedule("bsp", p, n, seed=seed), p)


def test_rcwc_strictly_larger():
    """... and strictly so."""
    assert any(not H.satisfies_bsp(random_schedule("dc", 3, 2, seed=s), 3)
               for s in range(200))


def test_delta_schedules_satisfy_async_constraints():
    for p in (2, 4):
        for n in (2, 4):
            for delta in (1, 2):
                for seed in (0, 5):
                    h = random_schedule("dc", p, n, seed=seed, delta=delta)
                    assert H.is_complete(h, p, n)
                    assert H.satisfies_read_constraint(h, delta=delta)
                    assert H.satisfies_write_constraint(h, p, delta=delta)


def test_delta_admits_non_sequential_histories():
    assert any(not H.is_sequentially_correct(
        random_schedule("dc", 3, 3, seed=s, delta=2), 3) for s in range(300))


def test_delta_zero_matches_bitvector_engine():
    """Sec 7.1 engine at delta=0 == Sec 5 bit-vector engine."""
    for seed in range(50):
        assert random_schedule("dc", 3, 3, seed=seed) == \
            random_schedule("dc-array", 3, 3, seed=seed)
