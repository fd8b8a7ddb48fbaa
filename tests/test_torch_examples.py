"""The port's examples (``examples/torch_*.py``) run on the CPU in seconds:
the quickstart trains 20 steps and decodes through the dense cache;
train_100m, at the llama3.2-1b smoke config in f32, checkpoints and
resumes to the uninterrupted run's losses bit for bit; serve_batched
serves statically and, at its default arch (the JAX example's rwkv6-1.6b),
raises the engine's named ``ValueError``.  (``test_torch_isolation.py``
checks that they import neither ``jax`` nor ``repro``.)"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_and_decodes_on_cpu(capsys):
    out = _load("torch_quickstart").main(["--device", "cpu"])
    assert len(out["losses"]) == 20
    assert all(math.isfinite(v) for v in out["losses"])
    vocab = tconfigs.get_smoke_config("llama3.2-1b").vocab_size
    assert len(out["decoded"]) == 9
    assert all(0 <= t < vocab for t in out["decoded"])
    assert "decoded token ids:" in capsys.readouterr().out


def test_train_100m_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    mod = _load("torch_train_100m")
    assert mod.config_100m().d_model == 768
    smoke = dataclasses.replace(tconfigs.get_smoke_config("llama3.2-1b"),
                                dtype=torch.float32)
    monkeypatch.setattr(mod, "config_100m", lambda: smoke)
    common = ["--batch", "2", "--seq", "16", "--device", "cpu",
              "--ckpt-every", "1"]
    whole = mod.main(common + ["--steps", "3",
                               "--ckpt-dir", str(tmp_path / "whole")])
    cut = str(tmp_path / "cut")
    first = mod.main(common + ["--steps", "2", "--ckpt-dir", cut])
    resumed = mod.main(common + ["--steps", "3", "--resume",
                                 "--ckpt-dir", cut])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["start"] == 2
    assert first["losses"] == whole["losses"][:2]
    assert resumed["losses"] == whole["losses"][2:]
    assert all(math.isfinite(v) for v in whole["losses"])


def test_serve_batched_serves_statically_on_cpu():
    mod = _load("torch_serve_batched")
    out = mod.main(["--arch", "llama3.2-1b", "--device", "cpu",
                    "--requests", "4", "--rate", "4", "--batch", "2"])
    rep = out["report"]
    assert rep.mode == "static" and rep.n_requests == 4
    assert all(len(v) > 0 for v in rep.outputs.values())


def test_serve_batched_default_arch_raises_the_engines_error():
    mod = _load("torch_serve_batched")
    with pytest.raises(ValueError, match="attention-free"):
        mod.main(["--device", "cpu", "--requests", "2"])
