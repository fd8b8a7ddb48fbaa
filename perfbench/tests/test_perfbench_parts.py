"""``perfbench/parts.py``: each device operation's ``part`` and ``phase``
from the program's spans, on a hand-made trace with a second (autograd)
thread, on a trace without program spans, on a real CPU profile of the
program, and on the card's flash launches; and the same part and phase
on each ``devtrace.DeviceOp`` of the harness's trace, read by the
per-layer metrics."""
import json

import pytest

from perfbench import parts
from perfbench.tests.test_perfbench_counts import hand_trace

MAIN, AUTOGRAD = 101, 202          # host thread ids; 1 is MAIN's own number
BWD = parts.BACKWARD_PREFIX


def _event(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _program_trace(tmp_path):
    """One step 0-100 us: the ring's read 2-9 with its commit 3-6; the
    gradient 11-49, one layer's attention 13-18 and MLP 20-28 and the head
    29-31 in the forward; on the autograd thread the MLP's product's
    backward 32-36, attention's backward 37-46 with a recompute of the
    layer 39-45 inside it; the optimizer 61-79."""
    ev = [_event("user_annotation", "perfbench.step", 0, 100),
          _event("user_annotation", "pdb.step", 1, 98),
          _event("user_annotation", "pdb.read_stale", 2, 7),
          _event("user_annotation", "pdb.commit_ring", 3, 3),
          _event("user_annotation", "model.grad", 11, 38),
          _event("user_annotation", "model.layer", 12, 17),
          _event("user_annotation", "model.attn", 13, 5),
          _event("user_annotation", "model.mlp", 20, 8),
          _event("user_annotation", "model.head", 29, 2),
          _event("user_annotation", "opt.update", 61, 18),
          # forward operators and the nodes they made; the view records
          # the number the product's node takes next
          _event("cpu_op", "FlashAttention", 14, 2, **{
              "Sequence number": 8, "Fwd thread id": 0}),
          _event("cpu_op", "aten::view", 19, 0.5, **{
              "Sequence number": 9, "Fwd thread id": 0}),
          _event("cpu_op", "aten::mm", 21, 3, **{
              "Sequence number": 9, "Fwd thread id": 0}),
          _event("cpu_op", BWD + "MmBackward0", 32, 4, tid=AUTOGRAD, **{
              "Sequence number": 9, "Fwd thread id": 1}),
          _event("cpu_op", BWD + "FlashAttentionBackward", 37, 9,
                 tid=AUTOGRAD, **{"Sequence number": 8,
                                  "Fwd thread id": 1}),
          # the recompute, its own operators numbered on the autograd
          # thread (9 again: no node the backward runs)
          _event("user_annotation", "model.layer", 39, 6, tid=AUTOGRAD),
          _event("user_annotation", "model.attn", 40, 3, tid=AUTOGRAD),
          _event("cpu_op", "aten::mm", 41, 1, tid=AUTOGRAD, **{
              "Sequence number": 9, "Fwd thread id": 0})]
    launches = (            # launch us, thread, kernel, run us, dur us
        (4, MAIN, "index_copy_kernel", 100, 6),
        (7, MAIN, "ring_gather_kernel", 110, 4),
        (15, MAIN, "void flash_fwd_kernel<1>", 120, 10),
        (22, MAIN, "nvjet_mm", 130, 20),
        (30, MAIN, "logsumexp_kernel", 150, 3),
        (33, AUTOGRAD, "nvjet_mm_dx", 160, 30),
        (38, AUTOGRAD, "void flash_bwd_dq_kernel<1>", 190, 25),
        (41, AUTOGRAD, "void flash_fwd_kernel<1>", 215, 10),
        (44, AUTOGRAD, "add_kernel", 225, 2),
        (46, AUTOGRAD, "void flash_bwd_dkdv_kernel<1>", 227, 8),
        (65, MAIN, "vectorized_elementwise_kernel", 240, 20),
        (90, MAIN, "randint_kernel", 260, 1),
        (200, MAIN, "stray_kernel", 300, 5))
    for corr, (t, tid, name, run, dur) in enumerate(launches):
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", t, 0.5,
                         tid=tid, correlation=corr))
        ev.append(_event("kernel", name, run, dur, tid=7, correlation=corr))
    path = tmp_path / "program.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_part_and_phase_of_each_device_op(tmp_path):
    ops = parts.read(str(_program_trace(tmp_path)))
    assert [(op.name, op.part, op.phase) for op in ops] == [
        ("index_copy_kernel", "pdb.commit_ring", "forward"),
        ("ring_gather_kernel", "pdb.read_stale", "forward"),
        ("void flash_fwd_kernel<1>", "model.attn", "forward"),
        ("nvjet_mm", "model.mlp", "forward"),
        ("logsumexp_kernel", "model.head", "forward"),
        ("nvjet_mm_dx", "model.mlp", "backward"),
        ("void flash_bwd_dq_kernel<1>", "model.attn", "backward"),
        ("void flash_fwd_kernel<1>", "model.attn", "recompute"),
        ("add_kernel", "model.layer", "recompute"),
        ("void flash_bwd_dkdv_kernel<1>", "model.attn", "backward"),
        ("vectorized_elementwise_kernel", "opt.update", "forward"),
        ("randint_kernel", "pdb.step", "forward"),
        ("stray_kernel", None, "forward")]


def test_ms_by_part_and_the_command(tmp_path, capsys):
    path = _program_trace(tmp_path)
    got = parts.ms_by_part(parts.read(str(path)))
    assert got["by_part"]["model.attn"] == pytest.approx(0.053)  # 10+25+10+8
    assert got["by_part"]["model.mlp"] == pytest.approx(0.050)
    assert got["by_part"]["pdb.commit_ring"] == pytest.approx(0.006)
    assert got["by_part"]["None"] == pytest.approx(0.005)
    assert got["by_part_phase"]["model.attn|recompute"] == \
        pytest.approx(0.010)
    assert got["total"] == pytest.approx(0.144)
    assert parts.main([str(path), "--steps", "2"]) == 0
    halved = json.loads(capsys.readouterr().out)
    assert halved["total"] == pytest.approx(0.072)


def test_a_trace_without_program_spans(tmp_path):
    hand_trace(tmp_path)
    ops = parts.read(str(tmp_path / "trace.json"))
    assert len(ops) == 5
    assert {(op.part, op.phase) for op in ops} == {(None, "forward")}


def _profile_step(tmp_path, remat):
    """A delta-2 step of the program's olmo smoke config profiled on the
    CPU; each ``aten::mm`` given a launch and a device op of its own."""
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import LMBatchSpec, make_lm_batch
    from repro_torch.launch.steps import make_train_engine
    from repro_torch.models import paramlib
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    cfg = get_smoke_config("olmo-1b")
    params = paramlib.init_tree(model_specs(cfg),
                                torch.Generator().manual_seed(0),
                                dtype=cfg.param_dtype)
    engine = make_train_engine(cfg, make_optimizer(OptConfig(lr=1e-3)),
                               SyncConfig(delta=2, remat=remat), params)
    spec = LMBatchSpec(batch=2, seq_len=16, vocab_size=cfg.vocab_size)
    state = engine.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step_fn(state, make_lm_batch(spec, 0, torch.device("cpu")))
    path = tmp_path / "cpu.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    mms = [e for e in data["traceEvents"]
           if e.get("ph") == "X" and e.get("name") == "aten::mm"]
    for corr, e in enumerate(mms, start=10 ** 6):
        data["traceEvents"].append(_event(
            "cuda_runtime", "cudaLaunchKernel", e["ts"], 0, tid=e["tid"],
            correlation=corr))
        data["traceEvents"].append(_event(
            "kernel", "mm", e["ts"], 1, tid=7, correlation=corr))
    path.write_text(json.dumps(data))
    return cfg, parts.read(str(path))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_attribution_on_a_real_profile(tmp_path, remat):
    """Every product of the step lands in attention, the MLP or the head;
    the backward finds its forward's span by sequence number; under remat
    the layer's products run a second time, as recompute."""
    cfg, ops = _profile_step(tmp_path, remat)
    count: dict = {}
    for op in ops:
        count[op.part, op.phase] = count.get((op.part, op.phase), 0) + 1
    layers = sum(g.n * len(g.pattern) for g in cfg.groups)
    assert {p for p, _ in count} == {"model.attn", "model.mlp",
                                     "model.head"}
    # q, k, v, o a layer; gate, up, down; the head's logits
    assert count["model.attn", "forward"] == 4 * layers
    assert count["model.mlp", "forward"] == 3 * layers
    assert count["model.head", "forward"] == 1
    # each product's backward: the input's gradient and the weight's
    assert count["model.attn", "backward"] == 2 * 4 * layers
    assert count["model.mlp", "backward"] == 2 * 3 * layers
    assert count["model.head", "backward"] == 2
    recomputed = 1 if remat == "full" else 0
    assert count.get(("model.attn", "recompute"), 0) == \
        recomputed * 4 * layers
    assert count.get(("model.mlp", "recompute"), 0) == \
        recomputed * 3 * layers


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_flash_attribution_on_the_card(tmp_path, remat):
    """The tiny cell's steps through the kernels under the profiler: every
    flash operation is attention's, the forward's as many as its launches
    (a second forward a layer under remat, as recompute), the backward's
    in the backward phase."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    import tiny
    from perfbench import harness
    from repro_torch.kernels import _build
    cell = tiny.cell(tiny.DENSE, remat=remat)
    device = torch.device("cuda")
    _build.build_all(harness.kernel_sources(cell))
    prog = harness.build_program(cell, 2 ** 31 + 7, device)
    for i in range(3):
        prog.state, _ = prog.engine.step_fn(prog.state, prog.feed(i))
    torch.cuda.synchronize()
    before = dict(_build.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3, 6):
            prog.state, _ = prog.engine.step_fn(prog.state, prog.feed(i))
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _build.launches.items()}
    path = tmp_path / "card.json"
    prof.export_chrome_trace(str(path))
    ops = parts.read(str(path))
    want = harness.expected_launches(cell, 3, 1)
    fwd = [op for op in ops if "flash_fwd_kernel" in op.name]
    bwd = [op for op in ops if "flash_bwd_" in op.name]
    dq = [op for op in bwd if "flash_bwd_dq_kernel" in op.name]
    assert len(fwd) == launches["flash_attention"] == \
        want["flash_attention"]
    assert len(dq) == launches["flash_attention_bwd"] == \
        want["flash_attention_bwd"]
    assert {op.part for op in fwd + bwd} == {"model.attn"}
    assert {op.phase for op in bwd} == {"backward"}
    recomputed = sum(op.phase == "recompute" for op in fwd)
    assert recomputed == (len(fwd) // 2 if remat == "full" else 0)


def _readers():
    from perfbench.metrics import (attn_ms, device_idle, engine_self_ms,
                                   flash_roofline, grad_ms, lm_head_ms,
                                   mlp_ms, norm_ms, optimizer_ms,
                                   recompute_ms, ring_commit_ms,
                                   ring_read_ms, train_mfu)
    return {m.__name__.rsplit(".", 1)[1]: m.read for m in (
        engine_self_ms, grad_ms, optimizer_ms, flash_roofline, train_mfu,
        device_idle, ring_commit_ms, ring_read_ms, attn_ms, mlp_ms,
        norm_ms, lm_head_ms, recompute_ms)}


def test_the_harness_trace_carries_parts_and_phases(tmp_path):
    """``devtrace`` gives each device operation ``parts.read``'s part and
    phase, keeps its benchmark span, and the readers read them: the
    seven of the program's parts, and the six of the benchmark's spans as
    before (device ms a step; the hand trace is one step)."""
    from perfbench import devtrace
    from perfbench.tests.test_perfbench_counts import Run
    path = str(_program_trace(tmp_path))
    trace = devtrace.read_chrome_trace(path)
    assert [(op.name, op.part, op.phase) for op in trace.ops] == \
        [(op.name, op.part, op.phase) for op in parts.read(path)]
    assert {op.span for op in trace.ops} == {"perfbench.step", None}
    run = Run(trace)
    run.launches = {"flash_attention": 2, "flash_attention_bwd": 1}
    got = {k: read(run) for k, read in _readers().items()}
    assert got == pytest.approx({
        "engine_self_ms": 0.139, "grad_ms": 0.0, "optimizer_ms": 0.0,
        "flash_roofline": got["flash_roofline"], "train_mfu":
        got["train_mfu"], "device_idle": 100 * (1 - 0.144 / 0.25),
        "ring_commit_ms": 0.006, "ring_read_ms": 0.004,
        "attn_ms": 0.053, "mlp_ms": 0.050, "norm_ms": None,
        "lm_head_ms": 0.003, "recompute_ms": 0.012})
    # flash: the two forwards 10 + 10 us, the backward 25 + 8
    assert got["flash_roofline"] == pytest.approx(
        100 * (2 * counts_bound("fwd") + counts_bound("bwd")) / 53e-6)


def counts_bound(which):
    from perfbench import counts
    fn = counts.flash_fwd if which == "fwd" else counts.flash_bwd
    return counts.bound_s(*fn(1, 4, 16, 16, 128))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_parts_of_a_real_profile_reach_the_harness(tmp_path, remat):
    from perfbench import devtrace
    _, ops = _profile_step(tmp_path, remat)
    trace = devtrace.read_chrome_trace(str(tmp_path / "cpu.json"))
    assert [(op.name, op.part, op.phase) for op in trace.ops] == \
        [(op.name, op.part, op.phase) for op in ops]
