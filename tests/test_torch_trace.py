"""The port's spans (``repro_torch.trace``): free when no profiler records,
where the work happens when one does, and no change to what a step
computes.

* With no profiler recording, ``span`` opens no ``record_function``.
* Under ``torch.profiler``, one delta-2 engine step of the olmo smoke
  config opens ``pdb.step``, ``pdb.commit_ring`` and ``pdb.read_stale``
  once, ``model.attn``, ``model.mlp`` and ``model.layer`` once a layer
  (twice under remat ``full``, the second time inside a backward range),
  ``model.head`` and ``opt.update`` once.
* Three delta-2 steps give the same bits with and without the profiler,
  under every remat policy (``dots``' checkpoint policy sees the
  profiler's own operators).
* ``launch/train.py --profile-steps`` writes a Chrome trace holding the
  spans.
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.data import LMBatchSpec, make_lm_batch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_train_engine  # noqa: E402
from repro_torch.models import paramlib  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402
from repro_torch.optim import OptConfig, make_optimizer  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "olmo-1b"
CPU = torch.device("cpu")
BACKWARD = "autograd::engine::evaluate_function: "


def _engine(remat: str):
    cfg = get_smoke_config(ARCH)
    params = paramlib.init_tree(
        model_specs(cfg), torch.Generator().manual_seed(0),
        dtype=cfg.param_dtype)
    engine = make_train_engine(cfg, make_optimizer(OptConfig(lr=3e-3)),
                               SyncConfig(delta=2, remat=remat), params)
    spec = LMBatchSpec(batch=2, seq_len=16, vocab_size=cfg.vocab_size)
    return cfg, engine, engine.init_state(), spec


def _n_layers(cfg) -> int:
    return sum(g.n * len(g.pattern) for g in cfg.groups)


def _steps(remat: str, n: int, profiled: bool):
    _, engine, state, spec = _engine(remat)
    losses = []
    for i in range(n):
        batch = make_lm_batch(spec, i, CPU)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                state, m = engine.step_fn(state, batch)
        else:
            state, m = engine.step_fn(state, batch)
        engine.record_step()
        losses.append(m["loss"])
    return losses, leaves(engine.commit(state).params)


def test_span_is_free_without_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(*a, **kw):
        calls.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert trace.span("pdb.step") is trace.span("model.attn")
    _steps("full", 1, profiled=False)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("pdb.step"):
            pass
    assert calls == [("pdb.step",)]


def _spans(tmp_path, remat: str):
    """(name, start, end, inside a backward range) of every program span
    of one delta-2 step (the engine's third: the ring is read back)."""
    cfg, engine, state, spec = _engine(remat)
    for i in range(2):
        state, _ = engine.step_fn(state, make_lm_batch(spec, i, CPU))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step_fn(state, make_lm_batch(spec, 2, CPU))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    backward = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e["name"].startswith(BACKWARD)]
    out = []
    for e in events:
        if e.get("cat") == "user_annotation":
            a, b = e["ts"], e["ts"] + e["dur"]
            out.append((e["name"], any(s <= a and b <= t
                                       for s, t in backward)))
    return cfg, out


@pytest.mark.parametrize("remat", ["none", "full"])
def test_spans_of_one_engine_step(tmp_path, remat):
    cfg, spans = _spans(tmp_path, remat)
    names = [n for n, _ in spans]
    layers = _n_layers(cfg)
    twice = 2 if remat == "full" else 1
    for name in ("pdb.step", "pdb.commit_ring", "pdb.read_stale",
                 "model.grad", "model.head", "opt.update"):
        assert names.count(name) == 1, name
    for name in ("model.attn", "model.mlp", "model.layer"):
        assert names.count(name) == twice * layers, name
        # the second forward of a layer runs inside the backward
        assert sum(inside for n, inside in spans if n == name) == \
            (twice - 1) * layers, name
    assert names.count("model.norm") == twice * 2 * layers + 1
    assert not any(inside for n, inside in spans
                   if not n.startswith("model."))
    assert all(n.split(".")[0] in ("pdb", "model", "opt") for n in names)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_profiling_changes_no_bits(remat):
    plain_losses, plain_params = _steps(remat, 3, profiled=False)
    traced_losses, traced_params = _steps(remat, 3, profiled=True)
    for a, b in zip(plain_losses, traced_losses):
        assert torch.equal(a, b)
    for a, b in zip(plain_params, traced_params):
        assert torch.equal(a, b)


def test_train_cli_writes_the_spans(tmp_path):
    out = tmp_path / "steps.json"
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                "--batch", "2", "--seq", "16", "--delta", "2",
                "--profile-steps", "1:3", "--profile-out", str(out)])
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"pdb.step", "pdb.commit_ring", "pdb.read_stale", "model.grad",
            "model.attn", "model.mlp", "model.norm", "model.head",
            "opt.update"} <= names
    steps = [e for e in json.loads(out.read_text())["traceEvents"]
             if e.get("name") == "pdb.step" and e.get("ph") == "X"]
    assert len(steps) == 2


def test_the_program_does_not_know_the_benchmark():
    root = pathlib.Path(train.__file__).resolve().parents[1]
    for path in root.rglob("*.py"):
        assert "perfbench" not in path.read_text(), path
