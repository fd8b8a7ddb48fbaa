"""rwkv6-1.6b's files: its parts described and referenced, its counts
against hand counts, the WKV kernels' roofline share on a hand-made trace,
and the time mix's spans read from a CPU profile of the program's Finch
block."""
import dataclasses
import json

import pytest

from perfbench import counts, devtrace, harness, kinds
from perfbench.cells import HERE, load_cell
from perfbench.metrics import time_mix_ms, wkv_ms, wkv_roofline
from perfbench.tests.test_perfbench_parts import _event

CELL = "rwkv6-1.6b-train-d2-s4096-remat"
CONF = json.loads((HERE / "configs" / "rwkv6-1.6b.json").read_text())
D, H, HD, FF, V = 2048, 32, 64, 7168, 65536


def test_its_parts_are_described():
    assert kinds.missing(CONF) == []
    assert [p.__name__.rsplit(".", 1)[1] for p in kinds.parts(CONF)] == \
        ["mix_rwkv6", "ffn_rwkv6_chan"] * 24 + ["head"]
    cell = load_cell(CELL)
    assert cell.config == CONF and cell.chips == 1
    tr = cell.traffic
    assert (tr["batch"], tr["seq"], tr["delta"], tr["remat"]) == \
        (2, 4096, 2, "full")
    assert [m["name"] for m in cell.per_layer
            if m.get("workloads") == [CELL]] == \
        ["time_mix_ms", "wkv_ms", "wkv_roofline"]


def test_model_flops_per_token():
    time_mix = 5 * D * D + 2 * D * 64 + 2 * D * 5 * 32
    chan_mix = 2 * D * FF + D * D
    wkv = (5 + 14) * HD * HD * H
    assert counts.model_flops_per_token(CONF, 4096) == \
        6 * (24 * (time_mix + chan_mix) + D * V) + 24 * wkv
    # the products' weights, then a layer's 16 vectors of d (seven token
    # shifts', the decay base, bonus and group norm's two, two norms' two),
    # the final norm's two and the embedding
    assert 24 * (time_mix + chan_mix) + D * V + 24 * 16 * D + 2 * D \
        + V * D == CONF["parameters"]


@pytest.mark.parametrize("remat,fwd", [("none", 1), ("full", 2)])
def test_launches_and_sources(remat, fwd):
    cell = load_cell(CELL)
    cell.traffic = dict(cell.traffic, remat=remat)
    assert harness.expected_launches(cell, 10, 1) == {
        "rwkv6_scan": 24 * fwd * 10, "rwkv6_scan_bwd": 24 * 10,
        "ring_gather": 10}
    assert harness.kernel_sources(cell) == ("rwkv6_scan", "ring_gather")


class Run:
    def __init__(self, trace, cfg, traffic, launches):
        self.trace, self.steps, self.window_s = trace, 1, 1.0
        self.busy_s = trace.busy_us() / 1e6
        self.cfg, self.traffic, self.launches = cfg, traffic, launches
        self.tokens_per_s = 1e6


WKV_KERNELS = ("void rwkv6_fwd_sum_kernel<__nv_bfloat16, 64>(...)",
               "void rwkv6_fwd_kernel<__nv_bfloat16, 64>(...)",
               "void rwkv6_bwd_sum_kernel<__nv_bfloat16, 64>(...)",
               "void rwkv6_bwd_dv_kernel<__nv_bfloat16, 64>(...)",
               "void rwkv6_bwd_kernel<__nv_bfloat16, 64>(...)",
               "rwkv6_du_kernel(double const*, float*, int, int)")


def test_wkv_roofline_on_a_hand_trace(tmp_path):
    """Two forward launches and one backward at the cell's shape, every
    WKV kernel 100 us, beside a product that is not theirs: the bound of
    the three launches over the six kernels' 600 us."""
    ev = []
    names = WKV_KERNELS + ("nvjet_hsh_mm",)
    for corr, name in enumerate(names):
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", corr, 0.5,
                         correlation=corr))
        ev.append(_event("kernel", name, 1000 + 200 * corr, 100, tid=7,
                         correlation=corr))
    path = tmp_path / "wkv.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    cell = load_cell(CELL)
    run = Run(devtrace.read_chrome_trace(str(path)), cell.config,
              cell.traffic, {"rwkv6_scan": 2, "rwkv6_scan_bwd": 1})
    n = 2 * 4096 * H * HD              # elements of r, k, v, w
    fwd = max((3 * 2 * n + 4 * n + 4 * H * HD + 2 * n) / 3.35e12,
              5 * HD * n / 67e12)
    bwd = max((4 * 2 * n + 4 * n + 4 * H * HD + 3 * 2 * n + 4 * n
               + 4 * H * HD) / 3.35e12, 14 * HD * n / 67e12)
    assert wkv_roofline.read(run) == pytest.approx(
        100 * (2 * fwd + bwd) / 600e-6)
    run.launches = {}
    assert wkv_roofline.read(run) is None


def _profile_finch_step(tmp_path, remat):
    """A delta-2 step of the Finch block at smoke widths profiled on the
    CPU; each product (``aten::mm``, ``aten::bmm``) given a launch and a
    device op of its own, 1 us each."""
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import rwkv6_1_6b
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.launch.steps import make_train_engine
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    cfg = dataclasses.replace(rwkv6_1_6b.smoke_config(), mix_lora=8)
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(0),
                                dtype=cfg.param_dtype)
    engine = make_train_engine(cfg, make_optimizer(OptConfig(lr=1e-3)),
                               SyncConfig(delta=2, remat=remat), params)
    spec = LMBatchSpec(batch=2, seq_len=8, vocab_size=cfg.vocab_size)
    state = engine.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step_fn(state, make_lm_batch(spec, 0, torch.device("cpu")))
    path = tmp_path / "cpu.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    products = [e for e in data["traceEvents"] if e.get("ph") == "X"
                and e.get("name") in ("aten::mm", "aten::bmm")]
    for corr, e in enumerate(products, start=10 ** 6):
        data["traceEvents"].append(_event(
            "cuda_runtime", "cudaLaunchKernel", e["ts"], 0, tid=e["tid"],
            correlation=corr))
        data["traceEvents"].append(_event(
            "kernel", "mm", e["ts"], 1, tid=7, correlation=corr))
    path.write_text(json.dumps(data))
    return devtrace.read_chrome_trace(str(path))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_time_mix_spans_on_a_real_profile(tmp_path, remat):
    """The time mix's products land in ``model.time_mix``, the WKV's (the
    plain recurrence's batched products on the CPU) in ``model.wkv``, in
    the forward, the backward and, under remat, the recompute; the
    readers sum them a step."""
    trace = _profile_finch_step(tmp_path, remat)
    count: dict = {}
    for op in trace.ops:
        count[op.part, op.phase] = count.get((op.part, op.phase), 0) + 1
    phases = ("forward", "backward") + (("recompute",) if remat == "full"
                                        else ())
    for part in ("model.time_mix", "model.wkv", "model.mlp"):
        assert {ph for p, ph in count if p == part} == set(phases), part
    layers = 2
    # r, k, v, g, the output, the LoRAs' A, W1 and W2; the five B batched
    assert count["model.time_mix", "forward"] == 9 * layers
    assert count["model.mlp", "forward"] == 3 * layers
    assert count.get(("model.time_mix", "recompute"), 0) == \
        (9 * layers if remat == "full" else 0)
    run = Run(trace, CONF, {"batch": 2, "seq": 8}, {})
    ms = {p: sum(n for (q, _), n in count.items() if q == p) / 1e3
          for p in ("model.time_mix", "model.wkv")}
    assert wkv_ms.read(run) == pytest.approx(ms["model.wkv"])
    assert time_mix_ms.read(run) == pytest.approx(
        ms["model.time_mix"] + ms["model.wkv"])


def test_readers_find_nothing_without_the_spans(tmp_path):
    """On a program without the time mix's spans (the parent of this
    configuration) the two readers return None and do not raise."""
    from perfbench.tests.test_perfbench_counts import hand_trace
    run = Run(hand_trace(tmp_path), CONF, {"batch": 2, "seq": 8}, {})
    assert time_mix_ms.read(run) is None and wkv_ms.read(run) is None
    assert wkv_roofline.read(run) is None
