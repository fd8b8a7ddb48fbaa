"""The yardstick's counts against hand counts at one shape each, and the
per-layer readers on a hand-made trace."""
import json

import pytest

from perfbench import counts, devtrace
from perfbench.cells import HERE


def test_live_pairs():
    assert counts.live_pairs(4, True, 0) == 10
    assert counts.live_pairs(4, True, 2) == 1 + 2 + 2 + 2
    assert counts.live_pairs(4, True, 4096) == 10
    assert counts.live_pairs(4, False, 0) == 16


def test_flash_counts():
    # B1 S4 H2 KV1 hd8: q, o 64 values, k, v 32, bf16; lse 8 floats
    assert counts.flash_fwd(1, 4, 2, 1, 8) == (2 * (64 + 32 + 32 + 64)
                                               + 4 * 8, 4 * 8 * 2 * 10)
    # q, o, dO, dQ 64 values each, k, v, dK, dV 32: 384 bf16 + lse
    assert counts.flash_bwd(1, 4, 2, 1, 8) == (2 * 384 + 4 * 8,
                                               10 * 8 * 2 * 10)


def test_bound():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12, "float32") == pytest.approx(1.0)


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_model_flops_per_token():
    # olmo-1b: tied, no norm weights, so its weights are its parameters
    olmo = _config("olmo-1b")
    assert counts.model_flops_per_token(olmo, 2048) == pytest.approx(
        6 * 1_176_764_416 + 12 * 16 * 128 * 1024.5 * 16)
    with pytest.raises(ValueError):
        counts.model_flops_per_token(dict(olmo, n_experts=8), 2048)


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def hand_trace(tmp_path):
    """One step 0-100 us on the host: grad_fn 10-50, opt_update 60-80;
    a ring kernel launched at 5, flash at 20 and 30, an optimizer kernel
    at 65, one launched outside every span."""
    ev = [_event("user_annotation", "perfbench.step", 0, 100),
          _event("user_annotation", "perfbench.grad_fn", 10, 40),
          _event("user_annotation", "perfbench.opt_update", 60, 20),
          _event("cpu_op", "aten::mm", 21, 3)]
    for corr, (t_launch, name, t_run, dur) in enumerate((
            (5, "ring_gather_kernel", 100, 10),
            (20, "void flash_fwd_kernel<1>", 110, 30),
            (30, "void flash_bwd_dq_kernel<1>", 150, 50),
            (65, "vectorized_elementwise_kernel", 200, 20),
            (200, "stray_kernel", 300, 5))):
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", t_launch, 1,
                         correlation=corr))
        ev.append(_event("kernel", name, t_run, dur, correlation=corr))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return devtrace.read_chrome_trace(str(path))


class Run:
    def __init__(self, trace):
        self.trace, self.steps, self.window_s = trace, 1, 250e-6
        self.busy_s = trace.busy_us() / 1e6
        self.cfg = _config("olmo-1b")
        self.traffic = {"batch": 1, "seq": 4}
        self.launches = {"flash_attention": 1, "flash_attention_bwd": 1}
        self.tokens_per_s = 1e6


def test_readers_on_a_hand_trace(tmp_path):
    from perfbench.metrics import (device_idle, engine_self_ms,
                                   flash_roofline, grad_ms, optimizer_ms,
                                   train_mfu)
    run = Run(hand_trace(tmp_path))
    assert engine_self_ms.read(run) == pytest.approx(0.010)
    assert grad_ms.read(run) == pytest.approx(0.080)
    assert optimizer_ms.read(run) == pytest.approx(0.020)
    assert run.busy_s == pytest.approx(115e-6)
    assert device_idle.read(run) == pytest.approx(100 * (1 - 115 / 250))
    bound = counts.bound_s(*counts.flash_fwd(1, 4, 16, 16, 128)) + \
        counts.bound_s(*counts.flash_bwd(1, 4, 16, 16, 128))
    assert flash_roofline.read(run) == pytest.approx(100 * bound / 80e-6)
    assert train_mfu.read(run) == pytest.approx(
        100 * counts.model_flops_per_token(run.cfg, 4) * 1e6 / 989e12)
    bd = devtrace.breakdown(run.trace)
    assert bd["device_ops"][0] == ["void flash_bwd_dq_kernel<1>", 50e-6]
    assert len(bd["idle_gaps"]) == 2


def test_unattributed_ops_have_no_span(tmp_path):
    tr = hand_trace(tmp_path)
    assert [op.span for op in tr.ops][-1] is None
