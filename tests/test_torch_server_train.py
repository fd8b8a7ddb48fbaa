"""The port's ``--backend server`` training path
(``repro_torch.launch.train.run_server_backend``) and its raveling
(``repro_torch.tree.ravel``) against the JAX package's, on the CPU.

* ``ravel`` gives ``jax.flatten_util.ravel_pytree``'s vector bit for bit on
  the smoke configs' parameters, and ``unravel`` gives the leaves back.
* ``python -m repro_torch.launch.train --backend server`` on the
  llama3.2-1b smoke config (2 shards x 2 workers, 4 steps, delta 0), on
  both RPC paths, against ``repro.launch.train.main`` with the same flags,
  both sides given JAX's parameters and batches: the same read/write
  counts, max_staleness 0, sequentially correct, first and final loss
  within 1e-4 relative (f32 sums in another order over bf16 compute).
* The pulled theta is bit for bit the one-thread sequential replay
  (``server_replay``), and the shard-death drill finishes with retries
  and the final loss of the run without the kill.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.flatten_util import ravel_pytree  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import LMBatchSpec as JLMBatchSpec  # noqa: E402
from repro.data import make_lm_batch as jmake_lm_batch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.pdb.server.client import ClientParameterDB  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.pdb.server import ShardCluster  # noqa: E402
from repro_torch.tree import leaves_with_path, ravel  # noqa: E402

torch.set_num_threads(1)

CLI = ["--arch", "llama3.2-1b", "--smoke", "--steps", "4", "--batch", "2",
       "--seq", "16", "--lr", "3e-3", "--log-every", "100", "--backend",
       "server", "--shards", "2", "--workers", "2", "--delta", "0"]


def _jax_params(arch, seed=0):
    cfg = jconfigs.get_smoke_config(arch)
    return jparamlib.init_tree(jtf.model_specs(cfg), jax.random.PRNGKey(seed),
                               dtype=cfg.param_dtype)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "smollm-360m",
                                  "rwkv6-1.6b", "recurrentgemma-2b",
                                  "mixtral-8x7b"])
def test_ravel_is_ravel_pytree(arch):
    jp = _jax_params(arch)
    jflat, _ = ravel_pytree(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    flat, unravel = ravel(tp)
    assert flat.dtype == torch.float32
    assert np.array_equal(flat.numpy(), np.asarray(jflat))
    back = unravel(flat.clone())
    for (pa, a), (pb, b) in zip(leaves_with_path(back),
                                leaves_with_path(tp)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_ravel_mixed_dtypes_round_trip():
    tree = {"b": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "a": {"x": torch.ones(2, dtype=torch.float16),
                  "y": torch.full((1, 2), 0.5)}}
    flat, unravel = ravel(tree)
    assert flat.dtype == torch.float32 and flat.numel() == 10
    back = unravel(flat)
    assert back["b"].dtype == torch.int32 and torch.equal(back["b"],
                                                          tree["b"])
    assert torch.equal(back["a"]["x"], tree["a"]["x"])
    assert torch.equal(back["a"]["y"], tree["a"]["y"])


@pytest.fixture
def jax_inputs(monkeypatch):
    """The port's CLI given JAX's smoke parameters (seed 0) and JAX's
    batches, so the two CLIs start from the same point."""
    real_build = ttrain.build
    jspec = {}

    def build(args, device):
        cfg, _params, opt, sync, spec = real_build(args, device)
        jspec["spec"] = JLMBatchSpec(batch=spec.batch, seq_len=spec.seq_len,
                                     vocab_size=spec.vocab_size,
                                     seed=spec.seed)
        params = params_from_numpy(
            jax.tree.map(np.asarray, _jax_params(args.arch, args.seed)),
            device=device)
        return cfg, params, opt, sync, spec

    def make_lm_batch(spec, step, device=None):
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in jmake_lm_batch(jspec["spec"], step).items()}

    monkeypatch.setattr(ttrain, "build", build)
    monkeypatch.setattr(ttrain, "make_lm_batch", make_lm_batch)


@pytest.fixture
def pulls(monkeypatch):
    """Every ``ShardCluster.pull`` result of the test, in order."""
    got = []
    real = ShardCluster.pull

    def pull(self):
        got.append(real(self))
        return got[-1]
    monkeypatch.setattr(ShardCluster, "pull", pull)
    return got


@pytest.fixture
def jax_writes_settled(monkeypatch):
    """JAX's server CLI pulls the shards right after its workers join,
    without flushing its clients (``src/repro/launch/train.py:137-143``);
    in batched mode each worker's last ``write_batch`` is settled only at
    its next exchange, so under load the pull can reach a shard first and
    count 14 writes for 16 (ROADMAP §C).  Each ``write_many`` of the JAX
    clients is flushed here, so every write is acknowledged before the
    pull, as the port's CLI flushes its clients before pulling."""
    real = ClientParameterDB.write_many

    def write_many(self, worker, writes):
        real(self, worker, writes)
        self.flush()
    monkeypatch.setattr(ClientParameterDB, "write_many", write_many)


@pytest.mark.parametrize("rpc", ["batched", "per-op"])
def test_server_backend_tracks_jax(jax_inputs, pulls, jax_writes_settled,
                                   rpc):
    flags = CLI + ["--rpc", rpc]
    want = jtrain.main(flags)
    got = ttrain.main(flags + ["--device", "cpu"])
    assert set(want) <= set(got)
    for key in ("reads", "writes", "max_staleness", "stale_reads"):
        assert got["telemetry"][key] == want["telemetry"][key], key
    assert got["telemetry"]["reads"] == 2 * 4 * 4 and \
        got["telemetry"]["writes"] == 4 * 4
    assert got["telemetry"]["max_staleness"] == 0
    assert got["sequentially_correct"] and want["sequentially_correct"]
    assert got["rpc_retries"] == 0
    for key in ("first_loss", "final_loss"):
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    assert len(got["steps"]) == 2 * 4
    assert all(s["step"] >= s["grad"] >= 0 for s in got["steps"])
    # the pulled theta: bit for bit the one-thread sequential replay
    theta, losses = ttrain.server_replay(
        ttrain.parse_args(flags + ["--device", "cpu"]))
    assert torch.equal(pulls[-1].theta(), theta)
    assert losses[0] == got["first_loss"] and losses[-1] == got["final_loss"]


def test_server_backend_shard_death_drill(capsys):
    """Kill the last shard at step 2 and restart it from its snapshot: the
    run finishes with retries, and at delta 0 on the final loss of the run
    without the kill."""
    flags = CLI + ["--device", "cpu"]
    clean = ttrain.main(flags)
    drill = ttrain.main(flags + ["--kill-shard-at-step", "2"])
    assert drill["rpc_retries"] > 0
    assert drill["telemetry"]["retried_steps"] >= drill["rpc_retries"]
    assert drill["final_loss"] == clean["final_loss"]
    assert drill["sequentially_correct"]
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("final loss ") and \
        "[server: 2 shards x 2 workers, 4 chunks, 32r/16w " \
        "max_staleness=0 " in out[-1]
    assert [line.split()[:4] for line in out[:1]] == [
        ["step", "0", "loss", f"{clean['first_loss']:.4f}"]]


def test_server_backend_wants_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(CLI)


def test_server_layout_is_jaxs():
    """Chunk bounds by ``np.linspace`` and chunk c owned by worker c % p,
    as the JAX CLI lays the vector out."""
    args = ttrain.parse_args(CLI + ["--param-chunks", "5", "--workers", "3"])
    p, m, bounds, owned = ttrain._server_layout(args, 103)
    assert (p, m) == (3, 5)
    assert bounds == [0, 20, 41, 61, 82, 103]
    assert owned == {0: [0, 3], 1: [1, 4], 2: [2]}
    assert ttrain._server_layout(ttrain.parse_args(CLI), 10)[1] == 4  # 2p


def test_launch_counts_lose_nothing_to_threads():
    """The server's worker threads launch kernels at once: ``count`` must
    not lose an increment (more threads than cores, a short switch
    interval)."""
    import sys
    import threading

    from repro_torch.kernels import _build
    saved = dict(_build.launches)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launches()
        threads = [threading.Thread(target=lambda: [
            _build.count("flash_attention") for _ in range(5000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _build.launches["flash_attention"] == 16 * 5000
    finally:
        sys.setswitchinterval(interval)
        _build.launches.update(saved)
