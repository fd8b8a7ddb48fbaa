"""Device time by the program's own spans: each device operation of a
``torch.profiler`` Chrome trace with the program span whose work it did
(its ``part``) and its ``phase``.

    python3 perfbench/parts.py TRACE.json [--steps N]

reads a trace, such as the one ``python -m repro_torch.launch.train
--profile-steps A:B`` writes, and prints one JSON line: device ms a step
(over ``--steps``, default 1) by part and phase, and by part.

The program marks its work with spans (``src/repro_torch/trace.py``:
``pdb.*``, ``model.*``, ``opt.*``).  A device operation and the call that
launched it share a ``correlation`` id.  An operation launched in the
forward takes the innermost program span open on its launching thread.
Autograd launches the backward from inside ``evaluate_function`` ranges,
often on a thread of its own; such a range carries its node's ``Sequence
number`` and ``Fwd thread id``, and the forward operator that made the
node carries the same sequence number on the forward thread, so a
backward operation takes the innermost program span around that forward
operator.  A program span opened inside a backward range is remat's
second forward: its operations take that span and the phase
``recompute``.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PROGRAM_PREFIXES = ("pdb.", "model.", "opt.")
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "


@dataclasses.dataclass
class PartOp:
    name: str
    start_us: float
    dur_us: float
    part: str | None          # the program span whose work it did
    phase: str                # forward, backward or recompute


class _Nested:
    """Intervals of one thread, nested as a call stack nests them: the
    innermost one open at a time, by bisection and a walk to its
    parents."""

    def __init__(self, items: list[tuple[float, float, object]]):
        self.items = sorted(items, key=lambda it: (it[0], -it[1]))
        self.starts = [it[0] for it in self.items]
        self.parent, stack = [], []
        for i, (a, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> tuple[float, float, object] | None:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return self.items[i] if i >= 0 else None


_NONE = _Nested([])


class _Parts:
    """(part, phase) of a launch on a host thread at a time, from the
    program's spans, the backward ranges and the forward operators that
    carry a sequence number."""

    def __init__(self, spans: dict, backward: dict, seq_ops: list):
        self.spans = {tid: _Nested(v) for tid, v in spans.items()}
        self.backward = {tid: _Nested(v) for tid, v in backward.items()}
        # the latest forward operator of each (thread, sequence number):
        # the one that made the node; operators inside a backward range
        # (a recompute's) make no node the backward runs
        fwd: dict = {}
        for tid, seq, ts in seq_ops:
            if self.backward.get(tid, _NONE).at(ts) is None:
                fwd[tid, seq] = max(ts, fwd.get((tid, seq), ts))
        # the forward thread of each ``Fwd thread id`` (the profiler's own
        # number of it): the thread whose forward operators hold most of
        # its nodes' sequence numbers, none where two threads tie
        votes: dict = {}
        threads = {tid for tid, _ in fwd}
        for ranges in backward.values():
            for a, _, (fwd_id, seq) in ranges:
                for tid in threads:
                    if fwd.get((tid, seq), a) < a:
                        v = votes.setdefault(fwd_id, {})
                        v[tid] = v.get(tid, 0) + 1
        self.thread = {}
        for fwd_id, v in votes.items():
            best = sorted(v.values())[-2:]
            if len(best) == 1 or best[0] < best[1]:
                self.thread[fwd_id] = max(v, key=v.get)
        self.fwd = fwd

    def at(self, tid, t: float) -> tuple[str | None, str]:
        span = self.spans.get(tid, _NONE).at(t)
        rng = self.backward.get(tid, _NONE).at(t)
        if rng is None:
            return (span[2] if span else None), "forward"
        if span is not None and span[0] >= rng[0]:
            return span[2], "recompute"
        fwd_id, seq = rng[2]
        tid_f = self.thread.get(fwd_id)
        ts = self.fwd.get((tid_f, seq))
        made = None if ts is None else self.spans.get(tid_f, _NONE).at(ts)
        return (made[2] if made else None), "backward"


def read(path: str) -> list[PartOp]:
    """Every device operation of the Chrome trace at ``path``, in the
    trace's order, with its part and phase."""
    with open(path) as fh:
        return read_events(json.load(fh)["traceEvents"])


def read_events(events: list) -> list[PartOp]:
    """``read`` of a trace's ``traceEvents``, already loaded."""
    program, backward, seq_ops, launches, device = {}, {}, [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        name, tid = e["name"], e.get("tid")
        if cat == "user_annotation" and name.startswith(PROGRAM_PREFIXES):
            program.setdefault(tid, []).append((ts, ts + dur, name))
        elif cat == "cpu_op":
            seq = args.get("Sequence number")
            if name.startswith(BACKWARD_PREFIX):
                backward.setdefault(tid, []).append(
                    (ts, ts + dur, (args.get("Fwd thread id"), seq)))
            elif seq is not None:
                seq_ops.append((tid, seq, ts))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (ts, tid)
        elif cat in DEVICE_CATS:
            device.append((name, ts, dur, args.get("correlation")))
    parts = _Parts(program, backward, seq_ops)
    ops = []
    for name, ts, dur, corr in device:
        at = launches.get(corr)
        part, phase = (None, "forward") if at is None else \
            parts.at(at[1], at[0])
        ops.append(PartOp(name, ts, dur, part, phase))
    return ops


def ms_by_part(ops: list[PartOp], steps: int = 1) -> dict:
    """Device ms a step by part and phase (``"<part>|<phase>"``) and by
    part, the largest first; ``"None"`` is work outside every span."""
    both: dict = {}
    part: dict = {}
    for op in ops:
        ms = op.dur_us / 1e3 / steps
        key = f"{op.part}|{op.phase}"
        both[key] = both.get(key, 0.0) + ms
        part[str(op.part)] = part.get(str(op.part), 0.0) + ms

    def ranked(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return {"by_part_phase": ranked(both), "by_part": ranked(part),
            "total": sum(part.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--steps", type=int, default=1,
                    help="steps the trace holds (ms are per step)")
    args = ap.parse_args(argv)
    print(json.dumps(ms_by_part(read(args.trace), args.steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
