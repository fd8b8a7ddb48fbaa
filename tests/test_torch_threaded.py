"""The port's Sec-6 runtime (``repro_torch.core.threaded``), its data
(``data.synthetic``'s regression sets), model (``models.regression``),
config (``configs.paper_lr``) and entry point (``launch.paper``) against
the JAX package's.

* The regression sets draw JAX's bits: X and the sparse set's coordinates
  and values exactly, y within 1e-12 relative.
* Threaded theta on real threads is bit-identical to the port's own
  ``run_sequential`` at delta 0 (dc, dc-array, bsp; GD, SGD, mini-batch),
  and within 1e-10 relative of JAX's numpy run on the same data.
* ``regression.grad_step`` matches ``jax.grad`` in f32 at 1e-6, and
  ``chunked_grad_step`` equals it.
* ``tests/test_threaded.py`` on the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_lr as jpaper_lr  # noqa: E402
from repro.core import threaded as JT  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import regression as jreg  # noqa: E402
from repro_torch.configs import paper_lr  # noqa: E402
from repro_torch.core import history as H  # noqa: E402
from repro_torch.core import threaded as T  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.launch import paper  # noqa: E402
from repro_torch.models import regression as reg  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 30


@pytest.fixture(scope="module")
def data():
    return T.make_synthetic_lr(160, 36, seed=0, device="cpu")


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# data, config, model against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,seed", [(160, 36, 0), (50, 7, 3)])
def test_regression_dataset_bits_equal_jax(n, d, seed):
    X, y = syn.regression_dataset(n, d, seed=seed, noise=0.05, device="cpu")
    jX, jy = jsyn.regression_dataset(n, d, seed=seed, noise=0.05)
    assert X.dtype == y.dtype == torch.float64
    assert np.array_equal(X.numpy(), jX)
    assert _rel(y.numpy(), jy) <= 1e-12
    tX, ty = T.make_synthetic_lr(n, d, seed=seed, noise=0.05, device="cpu")
    assert torch.equal(tX, X) and torch.equal(ty, y)
    assert np.array_equal(JT.make_synthetic_lr(n, d, seed=seed,
                                               noise=0.05)[0], jX)


@pytest.mark.parametrize("n,d,density", [(40, 500, 0.003), (25, 300, 0.05)])
def test_sparse_regression_dataset_bits_equal_jax(n, d, density):
    X, y = syn.sparse_regression_dataset(n, d, density=density, seed=2,
                                         device="cpu")
    jX, jy = jsyn.sparse_regression_dataset(n, d, density=density, seed=2)
    assert np.array_equal(X.numpy(), jX)
    assert _rel(y.numpy(), jy) <= 1e-12
    cols, vals, _, _ = syn.sparse_regression_coords(n, d, density, seed=2)
    for i in range(n):        # the coordinates are exactly JAX's non-zeros
        assert sorted(cols[i]) == sorted(np.flatnonzero(jX[i]))
        assert np.array_equal(jX[i, cols[i]], vals[i])


def test_regression_sets_default_to_the_card(monkeypatch):
    """No device means the card; without one that is an error, never a
    silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (syn.regression_dataset, syn.sparse_regression_dataset,
                 T.make_synthetic_lr):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(4, 3)


def test_paper_lr_configs_equal_jax():
    for name in ("synthetic", "real_shape"):
        assert dataclasses.asdict(getattr(paper_lr, name)()) == \
            dataclasses.asdict(getattr(jpaper_lr, name)())
    rs = paper_lr.real_shape()
    assert (rs.n_features, rs.n_examples, rs.mode, rs.n_iters) == \
        (150_360, 16_087, "sgd", 400)


def test_grad_step_matches_jax_grad():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(64, 24)).astype(np.float32)
    y = rng.normal(size=64).astype(np.float32)
    th = rng.normal(size=24).astype(np.float32)
    got = reg.grad_step(torch.from_numpy(th), torch.from_numpy(X),
                        torch.from_numpy(y), 0.1)
    want = np.asarray(jreg.grad_step(jnp.asarray(th), jnp.asarray(X),
                                     jnp.asarray(y), 0.1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(reg.loss(torch.from_numpy(th), torch.from_numpy(X),
                          torch.from_numpy(y))) == pytest.approx(
        float(jreg.loss(jnp.asarray(th), jnp.asarray(X), jnp.asarray(y))),
        rel=1e-6)
    for chunks in (1, 3, 5):
        np.testing.assert_allclose(
            reg.chunked_grad_step(torch.from_numpy(th), torch.from_numpy(X),
                                  torch.from_numpy(y), 0.1, chunks).numpy(),
            got.numpy(), rtol=1e-6, atol=1e-6)
    z = reg.init_theta(24, device="cpu")
    assert z.dtype == torch.float32 and not z.any()


def test_chunked_grad_step_equals_grad_step_f64():
    X, y = syn.regression_dataset(40, 12, seed=1, device="cpu")
    th = torch.linspace(-1, 1, 12, dtype=torch.float64)
    np.testing.assert_allclose(reg.chunked_grad_step(th, X, y, 0.3, 4),
                               reg.grad_step(th, X, y, 0.3), rtol=1e-12)


# ---------------------------------------------------------------------------
# threaded runs against JAX's numpy runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["gd", "sgd", "minibatch"])
@pytest.mark.parametrize("policy", ["dc", "dc-array", "bsp"])
def test_threaded_theta_matches_jax(data, mode, policy):
    X, y = data
    kw = dict(n_iters=8, mode=mode, batch_size=12, seed=3)
    task = T.LRTask(X, y, **kw)
    jtask = JT.LRTask(X.numpy(), y.numpy(), **kw)
    par = T.run_parallel(task, 4, policy=policy, timeout=TIMEOUT)
    assert torch.equal(par.theta, T.run_sequential(task, 4))
    assert _rel(par.theta.numpy(), JT.run_sequential(jtask, 4)) <= 1e-10
    assert _rel(par.theta.numpy(),
                JT.run_parallel(jtask, 4, policy=policy).theta) <= 1e-10
    assert T.loss(task, par.theta) == pytest.approx(
        JT.loss(jtask, par.theta.numpy()), rel=1e-12)


def test_sample_schedule_is_jax_on_the_device(data):
    X, y = data
    for mode in ("sgd", "minibatch"):
        s = T.LRTask(X, y, n_iters=5, mode=mode, batch_size=4,
                     seed=9).sample_schedule()
        js = JT.LRTask(X.numpy(), y.numpy(), n_iters=5, mode=mode,
                       batch_size=4, seed=9).sample_schedule()
        assert s.device == X.device and np.array_equal(s.numpy(), js)
    assert T.LRTask(X, y).sample_schedule() is None


def test_paper_cli_runs_on_the_cpu(capsys, monkeypatch):
    """The entry point's two parts on the CPU (4 iterations, a shorter
    simulated table): at the synthetic set's width a CPU matvec runs on
    several threads, so this also holds the worker threads to the
    caller's thread count."""
    monkeypatch.setattr(paper, "SIM_WORKERS", (4,))
    monkeypatch.setattr(paper, "SIM_SEEDS", 2)
    cfg, X, y = paper.load("synthetic", torch.device("cpu"))
    assert tuple(X.shape) == (cfg.n_examples, cfg.n_features)
    live = paper.live_linear_regression(cfg, X, y, paper.N_WORKERS, 4,
                                        timeout=30)
    for mode in paper.MODES:
        assert live[mode]["dc_bit_identical"]
        assert live[mode]["bsp_bit_identical"]
    d2 = live["delta2"]
    assert np.isfinite(d2["loss"]) and d2["loss"] <= 1.5 * \
        d2["sequential_loss"]
    from repro.core.simulator import improvement_pct, trimmed_mean
    assert paper.simulated_scaling()[4] == tuple(trimmed_mean([improvement_pct(
        dict(n_workers=4, n_iters=40, compute_mu=mu, seed=s))
        for s in range(2)]) for mu in (8.0, 0.5))
    assert "bit-identical: dc=True bsp=True" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# tests/test_threaded.py on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["gd", "sgd", "minibatch"])
@pytest.mark.parametrize("workers", [2, 4, 6])
def test_bit_identical_to_sequential(data, mode, workers):
    X, y = data
    task = T.LRTask(X, y, n_iters=8, mode=mode, batch_size=12, seed=3)
    seq = T.run_sequential(task, workers)
    par = T.run_parallel(task, workers, policy="dc", timeout=TIMEOUT)
    assert torch.equal(seq, par.theta)


@pytest.mark.parametrize("workers", [2, 5])
def test_bsp_also_bit_identical(data, workers):
    X, y = data
    task = T.LRTask(X, y, n_iters=8, mode="gd")
    assert torch.equal(T.run_sequential(task, workers),
                       T.run_parallel(task, workers, policy="bsp",
                                      timeout=TIMEOUT).theta)


def test_recorded_history_is_rcwc_and_sequential(data):
    X, y = data
    task = T.LRTask(X, y, n_iters=6, mode="gd")
    h = T.run_parallel(task, 4, policy="dc", record_history=True,
                       timeout=TIMEOUT).history
    assert H.is_complete(h, 4, 6)
    assert H.satisfies_rcwc(h, 4)
    assert H.is_sequentially_correct(h, 4)


def test_delta_converges_but_may_differ(data):
    X, y = data
    task = T.LRTask(X, y, n_iters=30, mode="gd", lr=0.3)
    seq = T.run_sequential(task, 4)
    par = T.run_parallel(task, 4, policy="dc", delta=2, timeout=TIMEOUT)
    init_loss = T.loss(task, torch.zeros(X.shape[1], dtype=torch.float64))
    assert T.loss(task, par.theta) < 0.9 * init_loss
    assert float(torch.linalg.norm(par.theta - seq)) < 1.0


def test_chunking_covers_all_features():
    slices = T.chunk_slices(37, 5)
    covered = sorted(i for sl in slices for i in range(sl.start, sl.stop))
    assert covered == list(range(37))
    assert slices == JT.chunk_slices(37, 5)


def test_sequential_matches_plain_gd(data):
    X, y = data
    task = T.LRTask(X, y, n_iters=10, mode="gd")
    theta_chunked = T.run_sequential(task, 6)
    theta = torch.zeros(X.shape[1], dtype=torch.float64)
    for _ in range(10):
        theta = theta - task.lr * (X.T @ (X @ theta - y)) / X.shape[0]
    np.testing.assert_allclose(theta_chunked, theta, rtol=1e-12)


def test_worker_failure_surfaces(data):
    """An exception in a worker thread is raised by run_parallel."""
    X, y = data
    task = T.LRTask(X, y[:-1], n_iters=3, mode="gd")     # y one row short
    with pytest.raises(RuntimeError):
        T.run_parallel(task, 2, policy="dc", timeout=5)
