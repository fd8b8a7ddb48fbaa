"""Readings that set a cell's limits (``limits/<cell>.json``): the gaps of
the program's checked steps to the reference over many seeds (the lower
reading), and those of the controls and the planted faults (the upper
ones), at the cell's own size, in one process.

    python3 perfbench/calibrate.py --workload <name> \
        --runs 1,2,3:program,int8,fp8,half_batch,grad_leaf_zeroed \
        --runs 4,5,6:program

``program`` is the benchmark's own set-up; ``fp8`` is the reference put
in the program's place at float8 precision; the others are planted in
the program (``faults.py``).  The reference runs once a seed.  Each
reading is a JSON line on standard output.  Not part of a benchmark run.
"""
import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings_for_seed(cell, seed: int, variants, device) -> list[dict]:
    import torch
    from perfbench import compare, harness
    got, secs = {}, {}
    for v in variants:
        if v == "fp8":
            continue
        t = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        try:
            prog = harness.build_program(
                cell, seed, device, variant=None if v == "program" else v)
            got[v] = harness.checked_steps(prog, cell, seed, device)
        except torch.cuda.OutOfMemoryError as e:
            got[v] = f"out of memory: {str(e)[:200]}"
        prog = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        secs[v] = time.perf_counter() - t
    t = time.perf_counter()
    ref = harness.reference_readings(cell, seed, device)
    secs["reference"] = time.perf_counter() - t
    if "fp8" in variants:
        t = time.perf_counter()
        got["fp8"] = harness.reference_readings(cell, seed, device, "fp8")
        secs["fp8"] = time.perf_counter() - t
    out = []
    for v in variants:
        line = {"workload": cell.name, "seed": seed, "variant": v,
                "seconds": secs[v], "reference_seconds": secs["reference"],
                "reference_losses": ref.losses}
        if isinstance(got[v], str):
            line["error"] = got[v]
        else:
            line.update(compare.gaps(got[v], ref), losses=got[v].losses,
                        leaves=compare.leaf_gaps(got[v], ref))
        out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", action="append", required=True,
                    metavar="SEEDS:VARIANTS",
                    help="comma-separated seeds, a colon, the variants "
                         "each of them runs; repeatable")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.cells import load_cell
    cell = load_cell(args.workload)
    os.environ.update(cell.traffic["env"])
    import torch
    from repro_torch.kernels import _build
    from perfbench import harness
    device = torch.device("cuda")
    _build.build_all(harness.kernel_sources(cell))
    for spec in args.runs:
        seeds, variants = spec.split(":")
        for seed in (int(s) for s in seeds.split(",")):
            for line in readings_for_seed(cell, seed, variants.split(","),
                                          device):
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
