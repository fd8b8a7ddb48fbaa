"""One run of one cell: set-up, the measured window, the traced steps, and
the comparison with the plain reference that decides ``correct``.

The entry the window drives is the program's ParameterDB train engine,
built as ``repro_torch.launch.train`` builds it (``pdb.torch_backend.
make_engine`` over ``launch.steps.make_lm_grad_fn`` and the optimizer of
``optim.make_optimizer``), its step called as that loop calls it:
``engine.step_fn(state, batch)`` then ``engine.record_step()``.

Set-up builds the engine once from the seed's weights and drives it
through its first ``checked_steps`` steps on the window's own feed; those
steps' losses, the first gradient as AdamW received it (its first moment
after one step, over 1 - b1) and each leaf's change after the last of
them are kept, and the same engine goes on into the window.  After the
window the program is freed and the reference follows the same steps
from the same weights and batches (``reference/train.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import inspect
import os
import sys
import tempfile
import time

from . import compare, devtrace, faults, feed, kinds
from .cells import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_STEPS = 3
GIB = 2 ** 30


# ---------------------------------------------------------------------------
# the program's side
# ---------------------------------------------------------------------------

def program_config(config: dict):
    """The program's ``ModelConfig`` from the configuration file: every key
    of the file that names one of its fields."""
    import torch
    from repro_torch.models.config import BlockGroup, ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    kw["groups"] = tuple(BlockGroup(tuple(g["pattern"]), g["n"])
                         for g in config["groups"])
    kw["dtype"] = getattr(torch, config["dtype"])
    kw["param_dtype"] = getattr(torch, config["param_dtype"])
    return ModelConfig(**kw)


def _state_parts(state) -> tuple[dict, dict]:
    """(parameters, optimizer state) of an engine state: the delta-stale
    ``DelayedState`` or the synchronous {"params", "opt"}."""
    if isinstance(state, dict):
        return state["params"], state["opt"]
    return state.params, state.opt_state


@dataclasses.dataclass
class Program:
    specs: dict
    engine: object
    state: object
    feed: object                # step index -> the batch the engine gets


def build_program(cell: Cell, seed: int, device, trace: bool = False,
                  variant: str | None = None) -> Program:
    """The engine and its initial state for ``seed``.  ``variant`` plants
    a control or a fault (``faults.py``); the benchmark's runs use
    none.  With ``trace`` the gradient function and the optimizer's
    update run inside spans of their own."""
    import torch
    from repro_torch.core.sync import SyncConfig
    from repro_torch.launch.steps import make_lm_grad_fn
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.pdb.torch_backend import make_engine
    tr = cell.traffic
    cfg = program_config(cell.config)
    specs = model_specs(cfg)
    params = feed.make_params(specs, seed, device)
    sync = SyncConfig(mode=tr["mode"], delta=tr["delta"], remat=tr["remat"])
    opt = make_optimizer(OptConfig(**tr["optimizer"],
                                   **faults.opt_overrides(variant)))
    grad_fn = faults.grad_fn(variant, make_lm_grad_fn(cfg, sync))
    update = opt.update
    if trace:
        grad_fn = _in_span("perfbench.grad_fn", grad_fn)
        update = _in_span("perfbench.opt_update", update)
    engine = make_engine(params, grad_fn, opt._replace(update=update), sync)
    engine.step_fn = faults.step_fn(variant, engine.step_fn)
    state = engine.init_state()
    del params

    def batch(i: int) -> dict:
        b = feed.make_batch(seed, i, tr["batch"], tr["seq"],
                            cfg.vocab_size, device)
        return faults.batch(variant, b)
    _sync(device)
    return Program(specs, engine, state, batch)


def _in_span(name: str, fn):
    import torch

    def spanned(*args):
        with torch.profiler.record_function(name):
            return fn(*args)
    return spanned


@dataclasses.dataclass
class Readings:
    """What the compared steps produced: each step's loss, the first
    gradient's norm a leaf as the optimizer received it, and each leaf's
    change over the steps."""
    losses: list[float]
    first_grad_norms: dict
    change_norms: dict


def checked_steps(prog: Program, cell: Cell, seed: int, device
                  ) -> Readings:
    """Drive the engine through its first steps and read what they
    produced; the engine's state moves on, for the window."""
    import torch
    tr = cell.traffic
    b1 = tr["optimizer"]["b1"]
    losses, first = [], {}
    for i in range(tr["checked_steps"]):
        prog.state, m = prog.engine.step_fn(prog.state, prog.feed(i))
        prog.engine.record_step()
        losses.append(m["loss"])
        if i == 0:
            moments = _state_parts(prog.state)[1]["m"]
            first = {p: torch.linalg.vector_norm(x) / (1 - b1)
                     for p, x in feed.leaf_items(moments)}
    specs = dict(feed.leaf_items(prog.specs))
    change = {}
    for path, x in feed.leaf_items(_state_parts(prog.state)[0]):
        x0 = feed.make_leaf(path, specs[path], seed, device)
        change[path] = torch.linalg.vector_norm(x.float() - x0)
        del x0
    return Readings([float(v) for v in losses],
                    {k: float(v) for k, v in first.items()},
                    {k: float(v) for k, v in change.items()})


def expected_launches(cell: Cell, steps: int, n_ring_groups: int) -> dict:
    """The kernels a step launches: each part's as its description says
    (``kinds/``; attention: one flash forward a layer, two under remat,
    whose backward recomputes the layer, and one backward), and one ring
    read per ring group."""
    cfg, tr = cell.config, cell.traffic
    want: dict = {}
    for desc in kinds.parts(cfg):
        for k, n in desc.launches(cfg, tr).items():
            want[k] = want.get(k, 0) + n * steps
    want["ring_gather"] = n_ring_groups * steps if tr["delta"] else 0
    return want


@contextlib.contextmanager
def plain_versions_counted():
    """Count calls of the program's plain kernel versions (every public
    function of ``repro_torch.kernels.ref``, which the dispatch looks up
    at each call) while the block runs."""
    from repro_torch.kernels import ref
    names = [n for n, f in vars(ref).items()
             if inspect.isfunction(f) and not n.startswith("_")
             and f.__module__ == ref.__name__]
    calls = dict.fromkeys(names, 0)
    saved = {n: getattr(ref, n) for n in names}

    def counted(n):
        def fn(*a, **kw):
            calls[n] += 1
            return saved[n](*a, **kw)
        return fn
    for n in names:
        setattr(ref, n, counted(n))
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(ref, n, f)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, variant: str | None = None) -> dict:
    """One run: returns the result line as a dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``trace``
    ``breakdown``, and last ``checks``)."""
    import torch
    from repro_torch.kernels import _build
    tr = cell.traffic
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        _build.build_all(kernel_sources(cell))
    with plain_versions_counted() as plain:
        prog = build_program(cell, seed, device, trace=trace,
                             variant=variant)
        mine = checked_steps(prog, cell, seed, device)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        done = tr["checked_steps"]
        retries = (torch.cuda.memory_stats().get("num_alloc_retries", 0)
                   if on_card else 0)
        before = dict(_build.launches)
        losses, t0 = [], time.perf_counter()
        deadline = t0 + seconds
        traced = None
        while True:
            if trace and traced is None and losses and (
                    time.perf_counter() + TRACED_STEPS * (
                        (time.perf_counter() - t0) / len(losses))
                    >= deadline):
                traced = trace_steps(prog, cell, done, device)
                losses.extend(traced.losses)
                done += TRACED_STEPS
                break
            prog.state, m = prog.engine.step_fn(prog.state, prog.feed(done))
            prog.engine.record_step()
            losses.append(m["loss"])
            done += 1
            if not trace and time.perf_counter() >= deadline:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        if traced is not None:
            # the window closed with the traced steps; the profiler's own
            # start and the trace's reading are the benchmark's, not the
            # program's
            window_s = traced.end - t0 - traced.profiler_start_s
        launches = {k: v - before[k] for k, v in _build.launches.items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        alloc = torch.cuda.memory_stats()
    steps = len(losses)
    tokens_per_s = steps * tr["batch"] * tr["seq"] / window_s
    loss_values = torch.stack(losses).float().cpu()
    nonfinite = int((~torch.isfinite(loss_values)).sum())
    tele = prog.engine.telemetry.summary()
    n_groups = len({x.dtype for _, x in
                    feed.leaf_items(_state_parts(prog.state)[0])})
    want = expected_launches(cell, steps, n_groups)
    prog = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    theirs = reference_readings(cell, seed, device)
    t_ref = time.perf_counter() - t_ref
    checks = compare.checks(mine, theirs, cell.limits)
    checks["nonfinite_losses"] = {"value": nonfinite, "limit": 0}
    checks["staleness_short"] = {
        "value": tr["delta"] - int(tele["max_staleness"]), "limit": 0}
    if on_card:
        checks["launch_mismatches"] = {
            "value": sum(launches.get(k, 0) != want.get(k, 0)
                         for k in launches), "limit": 0}
        checks["plain_version_calls"] = {"value": sum(plain.values()),
                                         "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": steps, "failed": nonfinite}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        run = traced.run
        run.tokens_per_s = tokens_per_s
        result["metrics"] = per_layer_metrics(cell, run)
        dev.update(busy_s=run.busy_s, window_s=run.window_s)
        result["device"] = dev
        result["breakdown"] = devtrace.breakdown(run.trace)
        result["trace_ops"] = {
            "device_ops": len(run.trace.ops),
            "unattributed_s": sum(op.dur_us for op in run.trace.ops
                                  if op.span is None) / 1e6}
    else:
        result["metrics"] = {
            "train_tokens_per_s": {"value": tokens_per_s, "unit": "tokens/s"},
            "train_peak_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        result["device"] = dev
    result["launches"] = {"window": launches, "expected": want}
    result["reference_s"] = t_ref
    if on_card:
        result["allocator"] = {
            "alloc_retries_setup": retries,
            "alloc_retries_window": alloc.get("num_alloc_retries", 0)
            - retries,
            "reserved_peak_gib": alloc.get("reserved_bytes.all.peak", 0)
            / GIB}
    result["checks"] = checks
    return result


def kernel_sources(cell: Cell) -> tuple[str, ...]:
    """The kernel sources to build before the run: the parts' (``kinds/``)
    and the ring's."""
    names = [s for desc in kinds.parts(cell.config) for s in desc.SOURCES]
    return tuple(dict.fromkeys(names + ["ring_gather"]))


class TracedRun:
    """What the per-layer readers read (``metrics/*.py``)."""

    def __init__(self, cell, trace, steps, window_s, launches):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.trace, self.steps, self.window_s = trace, steps, window_s
        self.busy_s = trace.busy_us() / 1e6
        self.launches = launches
        self.tokens_per_s = None


def trace_steps(prog: Program, cell: Cell, start: int, device):
    """The window's last ``TRACED_STEPS`` steps under ``torch.profiler``,
    each inside a ``perfbench.step`` span; the device is drained first,
    so the trace holds these steps' work alone.  Returns their losses,
    the ``TracedRun``, the host time their window ended and the seconds
    the profiler took to start."""
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    _sync(device)
    before = dict(_build.launches)
    losses = []
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    t_start = time.perf_counter()
    prof.start()
    t0 = time.perf_counter()
    for i in range(TRACED_STEPS):
        with torch.profiler.record_function("perfbench.step"):
            prog.state, m = prog.engine.step_fn(prog.state,
                                                prog.feed(start + i))
        prog.engine.record_step()
        losses.append(m["loss"])
    _sync(device)
    end = time.perf_counter()
    prof.stop()
    launches = {k: v - before[k] for k, v in _build.launches.items()}
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        tr = devtrace.read_chrome_trace(path)
    run = TracedRun(cell, tr, TRACED_STEPS, end - t0, launches)
    return types.SimpleNamespace(losses=losses, run=run, end=end,
                                 profiler_start_s=t0 - t_start)


def per_layer_metrics(cell: Cell, run: TracedRun) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"perfbench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def reference_readings(cell: Cell, seed: int, device,
                       numerics: str = "f32") -> Readings:
    """The reference's numbers for the checked steps: the same weights
    (made again from the seed) and batches, the configuration's and
    traffic's numbers, none of the program's code or state."""
    from .reference.train import AdamW, follow
    from repro_torch.models.transformer import model_specs
    tr = cell.traffic
    specs = model_specs(program_config(cell.config))
    tree0 = feed.make_params(specs, seed, device)
    batches = [_ref_batch(seed, i, tr, cell.config["vocab_size"], device)
               for i in range(tr["checked_steps"])]
    o = tr["optimizer"]
    traj = follow(tree0, batches, cell.config,
                  AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                        weight_decay=o["weight_decay"],
                        grad_clip=o["grad_clip"]),
                  tr["delta"], numerics)
    del tree0
    gc.collect()
    return Readings(traj.losses, traj.first_grad_norms, traj.change_norms)


def _ref_batch(seed, i, tr, vocab, device):
    def make():
        b = feed.make_batch(seed, i, tr["batch"], tr["seq"], vocab, device)
        return b["tokens"], b["labels"]
    return make


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({n.split(".")[0] for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})
