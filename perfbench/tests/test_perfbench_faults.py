"""The comparison that decides ``correct``, driven through a whole run of
the harness on the CPU at a size it holds (the look for a card skipped):
a sound run is correct, and each fault a training cell can have, and the
controls, make it not correct."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import tiny
from perfbench import compare, harness
from perfbench.cells import ROOT

SEED = 2 ** 31 + 101
CPU = torch.device("cpu")


def run(cell, variant=None, trace=False):
    return harness.run_cell(cell, SEED, 0.5, trace, CPU,
                            time.perf_counter(), variant=variant)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    r = run(tiny.cell(tiny.DENSE), trace=trace)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("variant", ["unchanged", "half_batch",
                                     "grad_leaf_zeroed", "int8"])
def test_faults_and_int8_control_are_not_correct(variant):
    r = run(tiny.cell(tiny.DENSE), variant=variant)
    assert not r["correct"], r["checks"]


def test_fp8_control_is_not_correct():
    cell = tiny.cell(tiny.DENSE)
    ref = harness.reference_readings(cell, SEED, CPU)
    fp8 = harness.reference_readings(cell, SEED, CPU, "fp8")
    checks = compare.checks(fp8, ref, cell.limits)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "olmo1b-train-d2",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_py(ROOT, env)
    assert proc.returncode != 0 and _no_result(proc)


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and _no_result(proc)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_tiny_cell_on_the_card(remat):
    """The tiny cell through the kernels: correct, every launch as the
    model says, no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(tiny.cell(tiny.DENSE, remat=remat), SEED, 1.0,
                         False, torch.device("cuda"), time.perf_counter())
    assert r["correct"], json.dumps(r["checks"])
    assert r["checks"]["launch_mismatches"]["value"] == 0
