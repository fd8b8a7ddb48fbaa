"""Multi-device dry run: trace every (arch x shape x mesh) cell of the
sharded steps on a simulated mesh and count what one GPU would do (port
of ``repro.launch.dryrun``).

The mesh is PyTorch's fake process group (``FakeStore``, backend
``"fake"``) at world 256 (16 x 16, ``data, model``) or 512 (2 x 16 x 16,
``pod, data, model``), and every local shard is a ``meta`` tensor: the
steps of ``launch/steps.py`` run eagerly on DTensors laid out by the
sync mode's rules, on rank 0's shards, with no data and no device
(DTensor's sharding propagation runs under a fake mode of its own,
which ``costmodel.CostMode`` leaves out of the count).  It runs on the
host and says so (``"simulated"`` in each result); the kernels' places
are taken by their plain versions (``kernels/ops.py`` routes ``meta``
shards there).  The fake group is process-wide, so the CLI and every
test run it in a process of their own.  Each cell's JSON holds:

  memory       -- per-device argument / output / temp / peak bytes: the
                  arguments' and outputs' local-shard bytes exactly, the
                  peak from the live local storage during the step
                  (``costmodel.CostMode``), temp = peak - arguments -
                  outputs
  cost         -- per-device FLOPs and bytes accessed (local shards)
  collectives  -- result bytes and count of each collective DTensor
                  issued, under JAX's kind names
  roofline     -- seconds per step for compute / memory / collective at
                  the H100 constants of ``launch/mesh.py``, and which
                  bounds the step

PyTorch lowers a shard-to-shard redistribution on a CPU mesh as an
all-gather and a local chunk (gloo has no all-to-all), so a layout change
that NCCL would run as an all-to-all is counted as that all-gather.
Every config of the zoo has its sharded route, so ``--all`` runs JAX's
34 cells.  On ``meta`` shards the attention and the grouped MoE FFN run
their plain versions, and the two recurrences a stand-in that counts
what their plain loops would (``costmodel.scan_standin``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import all_arch_ids, get_config
from ..core.sync import SyncConfig
from ..models import paramlib
from ..models.transformer import model_specs
from ..optim.optimizers import OptConfig, make_optimizer
from ..tree import tree_map
from .costmodel import (CostMode, _local, _nbytes, _tensors, cost_dict,
                        place_tree)
from .mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16, make_production_mesh,
                   production_shape)
from .shapes import (ShapeCell, applicable_shapes, cell_of,
                     decode_cache_specs, input_specs)
from .sharding import (activation_rules, opt_state_shardings, placements,
                       tree_shardings, tree_specs)
from .steps import make_decode_step, make_prefill_step, make_train_step

def fake_world(n: int) -> None:
    """The process-wide fake process group at world size ``n`` (rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_act_specs(mesh, sp: bool = False) -> dict:
    """Activation layouts (placements on ``mesh``): block I/O split over
    the dp axes; logits (and the CE one-hot) also vocab-split over
    ``model``.  ``sp`` (``REPRO_SP=1``) also splits block I/O's sequence
    over ``model`` (sequence parallelism); ``REPRO_DP_OVER_MODEL=1`` uses
    ``model`` as more data parallelism."""
    names = mesh.mesh_dim_names
    if os.environ.get("REPRO_DP_OVER_MODEL") == "1":
        dp = ("pod", "data", "model") if "pod" in names else \
            ("data", "model")
        return {"act": placements((dp, None, None), mesh),
                "logits": placements((dp, None, None), mesh)}
    dp = ("pod", "data") if "pod" in names else "data"
    seq_ax = "model" if sp else None
    # logits keep vocab (not seq) on `model` -- one axis, one dim
    return {"act": placements((dp, seq_ax, None), mesh),
            "logits": placements((dp, None, "model"), mesh)}


def _cache_layout(cache, c_shard, mesh):
    return tree_map(lambda t, pl: t.redistribute(mesh, pl), cache, c_shard)


def build_cell(cfg, shape: str | ShapeCell, mesh, sync: SyncConfig,
               act_specs: dict | None = None):
    """(step fn, args): the cell's step and its arguments as DTensors
    with ``meta`` shards."""
    specs = model_specs(cfg)
    like = paramlib.abstract_tree(specs, cfg.param_dtype)
    params = place_tree(tree_specs(paramlib.axes_tree(specs), like, mesh,
                                   sync.param_rules), like, mesh)
    if act_specs is None:
        act_specs = make_act_specs(mesh,
                                   sp=os.environ.get("REPRO_SP") == "1")
    cell = cell_of(shape)
    batch_like, batch_axes = input_specs(cfg, cell)
    batch = place_tree(tree_specs(batch_axes, batch_like, mesh,
                                  activation_rules()), batch_like, mesh)

    if cell.kind == "train":
        opt = make_optimizer(OptConfig(name="adamw",
                                       compression=sync.compression))
        step = make_train_step(cfg, opt, sync, act_specs=act_specs)
        p_shard = tree_map(lambda t: t.placements, params)
        opt_state = opt.init(params)
        opt_state = tree_map(lambda t, pl: t.redistribute(mesh, pl),
                             opt_state,
                             opt_state_shardings(p_shard, opt_state, mesh))
        return step, (params, opt_state, batch)

    cache_like, cache_ax = decode_cache_specs(cfg, cell)
    c_shard = tree_shardings(cache_ax, cache_like, mesh, activation_rules())
    if cell.kind == "prefill":
        step = make_prefill_step(cfg, cache_len=cell.seq_len,
                                 remat=sync.remat, act_specs=act_specs)

        def prefill_fn(p, b):
            with torch.no_grad():
                logits, cache = step(p, b)
                return logits, _cache_layout(cache, c_shard, mesh)
        return prefill_fn, (params, batch)

    step = make_decode_step(cfg, act_specs=act_specs)
    cache = place_tree(tree_specs(cache_ax, cache_like, mesh,
                                  activation_rules()), cache_like, mesh)

    def decode_fn(p, c, b):
        with torch.no_grad():
            return step(p, c, b)
    return decode_fn, (params, cache, batch)


def model_flops(cfg, shape_name: str | ShapeCell) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params), 2*N per decoded
    token; prefill = 2*N*D.  MoE counts activated experts only."""
    specs = model_specs(cfg)
    n_total = paramlib.param_count(specs)
    if cfg.is_moe:
        moe_per_layer = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
        n_moe_layers = sum(1 for k in cfg.layer_kinds if k != "xattn")
        inactive = (cfg.n_experts - cfg.top_k) / cfg.n_experts
        n_active = n_total - moe_per_layer * n_moe_layers * inactive
    else:
        n_active = n_total
    cell = cell_of(shape_name)
    D = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        return 6.0 * n_active * D
    if cell.kind == "prefill":
        return 2.0 * n_active * D
    return 2.0 * n_active * cell.global_batch      # one token per sequence


def collective_bytes(mode: CostMode) -> dict[str, float]:
    """{kind: result bytes, kind + '_count': n} of the collectives counted
    (the counterpart of JAX's ``parse_collective_bytes``)."""
    return dict(mode.collectives)


def _local_storages(tree) -> dict[int, int]:
    out = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def cell_tag(arch: str, shape_name: str, multi_pod: bool,
             sync: SyncConfig) -> str:
    return (f"{arch.replace('.', '_')}__{shape_name}__"
            f"{'multi' if multi_pod else 'single'}__{sync.mode}"
            + (f"__{sync.remat}" if sync.remat != "full" else ""))


def count_step(fn, args) -> tuple[CostMode, dict]:
    """Run ``fn(*args)`` under a :class:`CostMode` whose live storage
    starts with the arguments'; returns (mode, memory dict)."""
    mode = CostMode()
    arg_bytes = mode.hold(args)
    held = _local_storages(args)
    with mode:
        out = fn(*args)
    out_bytes = sum(n for i, n in _local_storages(out).items()
                    if i not in held)
    peak = max(mode.peak, arg_bytes + out_bytes)
    return mode, {"argument_bytes_per_device": arg_bytes,
                  "output_bytes_per_device": out_bytes,
                  "temp_bytes_per_device": peak - arg_bytes - out_bytes,
                  "peak_bytes_per_device": peak}


def measure_cell(cfg, shape: str | ShapeCell, mesh, sync: SyncConfig
                 ) -> dict:
    """Build one cell on ``mesh`` (over the fake process group) and count
    its step; JAX's result keys, without the file and the names."""
    n_dev = mesh.size()
    t0 = time.time()
    fn, args = build_cell(cfg, shape, mesh, sync)
    mode, memory = count_step(fn, args)
    memory["parameter_bytes_per_device"] = sum(
        _nbytes(_local(t)) for t in _tensors(args[0]))
    t_trace = time.time() - t0
    coll = collective_bytes(mode)
    cost = cost_dict(mode)
    flops_dev, bytes_dev = cost["flops"], cost["bytes accessed"]
    coll_bytes = float(sum(v for k, v in coll.items()
                           if not k.endswith("_count")))
    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_bytes / LINK_BW
    mf = model_flops(cfg, shape)
    return {
        "mesh": "x".join(map(str, mesh.shape)),
        "n_chips": n_dev,
        "sync_mode": sync.mode, "remat": sync.remat,
        "env": {"dp_over_model":
                os.environ.get("REPRO_DP_OVER_MODEL") == "1",
                "sp": os.environ.get("REPRO_SP") == "1",
                "chunked_ce": os.environ.get("REPRO_CHUNKED_CE") == "1"},
        "simulated": "fake process group and meta tensors on the host; "
                     "H100 constants",
        "device": {"kind": "NVIDIA H100 SXM (datasheet constants)",
                   "peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
                   "link_bw": LINK_BW},
        "status": "ok",
        "trace_s": round(t_trace, 1),
        "memory": memory,
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev},
        "collectives": coll,
        "collective_bytes_per_device": coll_bytes,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "bottleneck": max(
                [("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)], key=lambda kv: kv[1])[0],
        },
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / flops_dev if flops_dev else 0.0,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             sync: SyncConfig, out_dir: str | None) -> dict:
    """One cell on the production mesh, written to ``out_dir``.  JAX's
    trip-count correction is not applied: the eager step runs, and is
    counted at, every layer."""
    shape, _ = production_shape(multi_pod)
    fake_world(math.prod(shape))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    result = {"arch": arch, "shape": shape_name,
              **measure_cell(get_config(arch), shape_name, mesh, sync)}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = cell_tag(arch, shape_name, multi_pod, sync)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def sweep_cells() -> list[tuple[str, str]]:
    """JAX's ``--all`` sweep: every arch with each of its applicable
    shapes (34 cells)."""
    return [(arch, shp) for arch in all_arch_ids()
            for shp in applicable_shapes(get_config(arch))]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--mode", choices=["datacentric", "bsp"],
                    default="datacentric")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    sync = SyncConfig(mode=args.mode, remat=args.remat)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells: list[tuple[str, str]] = []
    if args.all:
        cells = sweep_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells.append((args.arch, args.shape))

    failures = 0
    for multi in meshes:
        for arch, shp in cells:
            tag = f"{arch}/{shp}/{'multi' if multi else 'single'}"
            out_tag = cell_tag(arch, shp, multi, sync)
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, out_tag + ".json")):
                print(f"SKIP {tag}")
                continue
            try:
                r = run_cell(arch, shp, multi, sync, args.out)
                rl = r["roofline"]
                print(f"OK   {tag}: trace={r['trace_s']}s "
                      f"peak={r['memory']['peak_bytes_per_device']/2**30:.2f}"
                      f"GiB compute={rl['compute_s']*1e3:.2f}ms "
                      f"memory={rl['memory_s']*1e3:.2f}ms "
                      f"coll={rl['collective_s']*1e3:.2f}ms "
                      f"-> {rl['bottleneck']}", flush=True)
            except Exception as e:
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    with open(os.path.join(args.out, out_tag + ".json"),
                              "w") as f:
                        json.dump({"arch": arch, "shape": shp,
                                   "mesh": "multi" if multi else "single",
                                   "status": "fail",
                                   "error": f"{type(e).__name__}: {e}"}, f)
    print(f"done; {failures} failures")
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
