"""The port's dry run (``repro_torch.launch.dryrun`` and ``costmodel``) on
small fake meshes, in a subprocess of its own (the fake process group is
process-wide), against hand reckoning and the JAX package's specs.

* A fully sharded matmul on a (4, 2) mesh counts 1/8 of its global FLOPs.
* The llama3.2-1b smoke config's train cell (global batch 8 x 32) on
  (4, 2) ``data, model`` and (2, 2, 2) ``pod, data, model``, as JAX's
  ``test_small_mesh_dryrun_subprocess``: ``bsp`` communicates by an
  all-reduce, ``datacentric`` by a reduce-scatter and an all-gather; the
  per-device argument bytes are those reckoned from JAX's ``resolve_spec``
  on the same mesh (parameters, m, v, step, batch); every number is
  finite.
* JAX's trip-count band (tests/test_costmodel.py): the 6-layer smoke
  model's full-remat gradients count 0.7-2.0x the analytic 8 N D / 8
  FLOPs per device.  The port's eager count is already the corrected one:
  the 1-layer model's count plus 5 x ``group_body_cost`` equals it.
* The memory tracker on cases reckoned by hand.
* ``--all`` builds JAX's 34-cell sweep (the cells compared, not run).
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core.sync_jax import ACTIVATION_RULES, RULES  # noqa: E402
from repro.launch.sharding import resolve_spec  # noqa: E402
from repro.models.transformer import model_specs  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}

SNIPPET = """
import dataclasses, json, math
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import dryrun
from repro_torch.launch.costmodel import (CostMode, corrected_terms,
                                          group_body_cost, place_tree)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.shapes import ShapeCell
from repro_torch.launch.sharding import tree_specs
from repro_torch.launch.steps import make_lm_grad_fn
from repro_torch.models import paramlib
from repro_torch.models.config import BlockGroup
from repro_torch.models.transformer import model_specs
from torch.distributed.tensor import Replicate

dryrun.fake_world(8)
out = {}
mesh = make_test_mesh((4, 2), ("data", "model"))

# 1. a fully sharded matmul
x = place_tree(("data", None), torch.empty(64, 32, device="meta"), mesh)
w = place_tree((None, "model"), torch.empty(32, 16, device="meta"), mesh)
with CostMode() as cm:
    y = x @ w
out["matmul"] = {"flops": cm.flops, "global": 2 * 64 * 32 * 16,
                 "local_shape": list(y.to_local().shape)}

# 2. the train cells
cfg = get_smoke_config("llama3.2-1b")
for name, shape, axes in (("4x2", (4, 2), ("data", "model")),
                          ("2x2x2", (2, 2, 2), ("pod", "data", "model"))):
    m = make_test_mesh(shape, axes)
    for mode in ("bsp", "datacentric"):
        r = dryrun.measure_cell(cfg, ShapeCell("t", 32, 8, "train"), m,
                                SyncConfig(mode=mode))
        out[name + "/" + mode] = r

# 3. the trip-count band
B, S, N = 8, 64, 6
sync = SyncConfig(remat="full")


def grad_flops(n):
    c = dataclasses.replace(cfg, groups=(BlockGroup(("attn",), n),))
    specs = model_specs(c)
    like = paramlib.abstract_tree(specs, c.param_dtype)
    params = place_tree(tree_specs(paramlib.axes_tree(specs), like, mesh,
                                   sync.param_rules), like, mesh)
    batch = {k: place_tree(("data", None),
                           torch.empty(B, S, dtype=torch.int32,
                                       device="meta"), mesh)
             for k in ("tokens", "labels")}
    with CostMode() as cm:
        make_lm_grad_fn(c, sync, act_specs=dryrun.make_act_specs(mesh))(
            params, batch)
    return c, cm.flops, paramlib.param_count(specs)


c6, f6, n6 = grad_flops(N)
_, f1, _ = grad_flops(1)
body = group_body_cost(c6, 0, mesh, sync.param_rules, "train", B, S, "full")
corr = corrected_terms({"cost": {"flops_per_device": f1,
                                 "bytes_per_device": 0.0}}, [body])
out["tripcount"] = {"flops": f6, "corrected": corr["flops_per_device"],
                    "analytic": 8.0 * n6 * B * S / 8, "body": body["flops"]}

# 4. memory, by hand
with CostMode() as cm:
    a = torch.empty(1 << 18, device="meta")      # 1 MiB
    b = a * 2                                    # 2 MiB live
    del a
    c = b + 1                                    # 2 MiB live
    del b
out["mem_plain"] = [cm.peak, cm.live]
x = place_tree(("data", None), torch.empty(64, 1024, device="meta"), mesh)
cm = CostMode()
held = cm.hold(x)                                # 16 x 1024 x 4 = 64 KiB
with cm:
    full = x.redistribute(mesh, [Replicate(), Replicate()])   # + 256 KiB
    del full
out["mem_sharded"] = [held, cm.peak, cm.live]
print(json.dumps(out))
"""


def _run(code, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


@pytest.fixture(scope="module")
def result():
    out = _run(SNIPPET)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sharded_matmul_counts_local_flops(result):
    r = result["matmul"]
    assert r["local_shape"] == [16, 8]
    assert r["flops"] * 8 == r["global"]


def _jax_arg_bytes(axes):
    """Parameters, AdamW's m and v (f32), its int32 step and the batch,
    local per device as JAX's ``resolve_spec`` lays them out."""
    mesh = type("M", (), {"shape": axes})()
    cfg = jconfigs.get_smoke_config("llama3.2-1b")
    total = 0
    for spec in jax.tree.leaves(model_specs(cfg), is_leaf=lambda x: hasattr(
            x, "axes")):
        ps = resolve_spec(spec.axes, spec.shape, mesh, RULES["datacentric"])
        local = math.prod(
            n // math.prod(axes[a] for a in
                           (() if e is None else (e,) if isinstance(e, str)
                            else e)) for n, e in zip(spec.shape, ps))
        total += 3 * 4 * local
    total += 4                                              # step
    ps = resolve_spec(("batch", "seq"), (8, 32), mesh, ACTIVATION_RULES)
    rows = 8 // math.prod(axes[a] for a in (
        (ps[0],) if isinstance(ps[0], str) else ps[0]))
    return total + 3 * 4 * rows * 32           # tokens, labels, mask


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["bsp", "datacentric"])
def test_small_mesh_train_cell(result, mesh, mode):
    r = result[f"{mesh}/{mode}"]
    coll = r["collectives"]
    if mode == "bsp":
        assert coll.get("all-reduce_count", 0) > 0, coll
    else:
        assert coll.get("reduce-scatter_count", 0) > 0, coll
        assert coll.get("all-gather_count", 0) > 0, coll
    assert r["n_chips"] == 8 and r["status"] == "ok"
    nums = [*r["memory"].values(), *r["cost"].values(),
            *r["roofline"].values(), r["collective_bytes_per_device"]]
    assert all(isinstance(v, str) or math.isfinite(v) for v in nums)
    assert r["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    if mode == "datacentric":
        assert r["memory"]["argument_bytes_per_device"] == \
            _jax_arg_bytes(MESHES[mesh])
    m = r["memory"]
    assert m["peak_bytes_per_device"] == (m["argument_bytes_per_device"]
                                          + m["output_bytes_per_device"]
                                          + m["temp_bytes_per_device"])


def test_tripcount_band(result):
    r = result["tripcount"]
    assert 0.7 < r["flops"] / r["analytic"] < 2.0, r
    assert r["corrected"] == pytest.approx(r["flops"], rel=1e-9)


def test_memory_tracker_by_hand(result):
    assert result["mem_plain"] == [2 << 20, 1 << 20]
    held, peak, live = result["mem_sharded"]
    assert held == 16 * 1024 * 4
    assert peak == held + 64 * 1024 * 4 and live == held


def test_cli_all_builds_jax_sweep():
    """``--all``'s cells are JAX's sweep, compared without running them:
    ``applicable_shapes`` over ``all_arch_ids()``, 34 cells, every config
    of the zoo (nothing is refused any more)."""
    from repro.launch.shapes import applicable_shapes as japplicable
    want = [(arch, shp) for arch in jconfigs.all_arch_ids()
            for shp in japplicable(jconfigs.get_config(arch))]
    out = _run("""
        import json
        from repro_torch.launch.dryrun import sweep_cells
        print(json.dumps(sweep_cells()))
        """, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = [tuple(c) for c in json.loads(out.stdout.strip().splitlines()[-1])]
    assert got == want and len(got) == 34
