#!/usr/bin/env python3
"""The full-width training phase of ``chip_smoke.py`` for one architecture,
run from this checkout and from another (an earlier commit unpacked under
the ignored ``build/``) in turns: other, this, this, other, each turn a
fresh process on the same card.  Each turn prints chip_smoke's own lines
(8 counted steps at batch 4 x 512, delta 2, AdamW, exact launch counts,
then ``torch.profiler`` over 2 more steps); the summary gives each turn's
step p50, tokens/s, peak memory, the device's idle share and the device
ms of every kernel group.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 tools/train_turns.py build/parent [--arch recurrentgemma-2b]

With no other checkout, two turns of this one.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(root: Path, arch: str) -> None:
    """One turn: chip_smoke's full-width training phase from ``root``."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    if not torch.cuda.is_available():
        raise SystemExit("train_turns: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"turn {root}: {cs.smi()}", flush=True)
    _build.build_all()
    cs.full_width_training(torch, ops, ref, arch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", help="another checkout's root")
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(Path(args.one).resolve(), args.arch)
        return 0
    roots = [ROOT, ROOT]
    if args.other:
        other = Path(args.other).resolve()
        roots = [other, ROOT, ROOT, other]
    summary = []
    for root in roots:
        out = subprocess.run(
            [sys.executable, __file__, "--one", str(root), "--arch",
             args.arch], capture_output=True, text=True)
        print(out.stdout, out.stderr[-2000:], flush=True)
        if out.returncode:
            return out.returncode
        turn = dict(checkout=str(root))
        for line in out.stdout.splitlines():
            head, _, body = line.partition(": ")
            if head == "full-width training":
                d = json.loads(body)
                turn.update(step_s_p50=d["step_s_p50_after_first"],
                            tokens_per_s=d["tokens_per_s"],
                            peak_mem_gib=d["peak_mem_gib"])
            elif head == f"train profile {args.arch}":
                d = json.loads(body)
                turn.update(idle_share=d["device_idle_share"],
                            busy_ms=d["device_busy_ms"],
                            ms_by_group=d["device_ms_by_group"])
        summary.append(turn)
    print("turns", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
