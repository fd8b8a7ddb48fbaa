"""Reading a ``torch.profiler`` trace of the traced steps into the records
the per-layer metrics read.

The profiler's Chrome trace holds, on the host, the benchmark's spans
(``user_annotation`` events named ``perfbench.*``), the operators
(``cpu_op``) and the CUDA API calls that launched device work
(``cuda_runtime``, ``cuda_driver``); on the device, the kernels, copies
and fills.  A device operation and the call that launched it share a
``correlation`` id, so each device operation is charged to the innermost
benchmark span open on the host when it was launched, and is given the
``part`` and ``phase`` that the program's own spans (``pdb.*``,
``model.*``, ``opt.*``) give it (``parts.py``).
"""
from __future__ import annotations

import bisect
import dataclasses
import json

from .parts import DEVICE_CATS, LAUNCH_CATS, read_events

SPAN_PREFIX = "perfbench."


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    span: str | None          # innermost benchmark span at its launch
    part: str | None          # the program span whose work it did
    phase: str                # forward, backward or recompute


@dataclasses.dataclass
class Trace:
    ops: list[DeviceOp]
    spans: list[tuple[str, float, float]]    # (name, start_us, end_us)
    host_ops: list[tuple[str, float, float]]  # operators, for the gaps

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out: list[list[float]] = []
        for op in sorted(self.ops, key=lambda o: o.start_us):
            a, b = op.start_us, op.start_us + op.dur_us
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]


def _innermost(spans: list[tuple[str, float, float]], t: float
               ) -> str | None:
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else None


def read_chrome_trace(path: str) -> Trace:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, host_ops, launches, device = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.append((e["name"], ts, ts + dur))
        elif cat == "cpu_op":
            host_ops.append((e["name"], ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat in DEVICE_CATS:
            device.append((e["name"], ts, dur, args.get("correlation")))
    ops = []
    for (name, ts, dur, corr), p in zip(device, read_events(events),
                                        strict=True):
        at = launches.get(corr)
        ops.append(DeviceOp(name, ts, dur,
                            None if at is None else _innermost(spans, at),
                            p.part, p.phase))
    return Trace(ops, spans, host_ops)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and
    the longest idle gaps of the device, each named by the innermost
    benchmark span and operator open on the host when the gap began."""
    by_name: dict[str, float] = {}
    for op in trace.ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.dur_us
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = trace.busy_intervals()
    host = sorted(trace.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = []
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, end)
        ops = [h for h in host[max(0, i - 200):i] if h[2] >= end]
        op = min(ops, key=lambda h: h[2] - h[1])[0] if ops else "no operator"
        span = _innermost(trace.spans, end) or "no span"
        gaps.append((f"{span} / {op}"[:120], nxt - end))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:120], us / 1e6] for n, us in device_ops],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps[:top]]}
