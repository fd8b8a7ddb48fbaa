"""Shared code of the sharded-step tests of the MoE, recurrent and vision
configs (``tests/test_torch_sharding_*.py``, ``test_torch_dryrun_zoo_*.py``,
``test_torch_dryrun_ep.py``): the port's sharded steps on 4 CPU ranks
over gloo (a (2, 2) ``data, model`` mesh) against the JAX package's
unsharded steps on the same numpy inputs, and the dry run's small train
cells on fake meshes against JAX's specs.

A *job* is one smoke config (at f32, with overrides such as
``n_experts``) and its inputs: JAX's initial parameters, ``STEPS`` train
batches, a prompt and ``DECODES`` next tokens, and the vision model's
media.  :func:`make_job` runs JAX's ``make_train_step`` (AdamW, remat
``full``; on one device the sync mode changes no number, so one run
serves both modes), ``prefill`` and ``decode_step``, and, for an MoE
config, ``moe_ffn``'s aux losses on one input.  :func:`run_ranks` runs the
worker below (which imports no JAX) on 4 ranks, one thread each, meeting
through a ``FileStore``: for every job the sharded ``make_train_step`` in
``datacentric`` and ``bsp`` with ``dryrun.make_act_specs``' layouts, the
sharded prefill and decode steps with the cache laid out by
``cache_axes``, and the sharded ``moe_ffn``'s aux losses.  A job's
``env`` is set in both processes around its runs.
"""
from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core.sync_jax import ACTIVATION_RULES, RULES
from repro.core.sync_jax import SyncConfig as JSyncConfig
from repro.launch import steps as jsteps
from repro.launch.sharding import resolve_spec
from repro.models import moe as jmoe
from repro.models import paramlib as jparamlib
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
B, STEPS, DECODES = 4, 2, 2
LR = 3e-4
# ROADMAP §C's AdamW guide, as tests/test_torch_mesh_exec.py
ATOL = {"params": 2e-5 + LR / 20, "m": 2e-5, "v": 2e-5}

WORKER = r'''
import dataclasses, os, sys
import torch
import torch.distributed as dist

rank, world, store_path, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.costmodel import CostMode
from repro_torch.launch.dryrun import make_act_specs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import paramlib
from repro_torch.models.moe import moe_ffn
from repro_torch.models.transformer import cache_axes, model_specs
from repro_torch.optim.optimizers import OptConfig, make_optimizer
from repro_torch.tree import leaves_with_path, tree_map

mesh = make_test_mesh((2, 2))
act = make_act_specs(mesh)
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "mask": ("batch", "seq"), "media": ("batch", None, None)}


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def put(tree, axes):
    return sh.distribute_tree(tree, sh.batch_shardings(
        {k: axes[k] for k in tree}, tree, mesh), mesh)


def run(job):
    cfg = dataclasses.replace(get_smoke_config(job["arch"]),
                              dtype=torch.float32, **job["overrides"])
    axes = paramlib.axes_tree(model_specs(cfg))
    media = job.get("media")
    res = {}
    for mode in job["modes"]:
        sync = SyncConfig(mode=mode, remat="full")
        p_shard = sh.tree_shardings(axes, job["params"], mesh,
                                    sync.param_rules)
        params = sh.distribute_tree(job["params"], p_shard, mesh)
        opt = make_optimizer(OptConfig(name="adamw", lr=job["lr"]))
        state = opt.init(params)
        step = make_train_step(cfg, opt, sync, act_specs=act)
        metrics, coll = [], {}
        for i, b in enumerate(job["batches"]):
            b = put(dict(b, **({"media": media} if media is not None
                               else {})), BATCH_AXES)
            with CostMode() as cm:
                params, state, m = step(params, state, b)
            if i == 0:
                coll = {k: v for k, v in cm.collectives.items()
                        if k.endswith("_count")}
            metrics.append({k: full(v) for k, v in m.items()})
        kept = all(p.placements == tuple(pl) for (_, p), (_, pl) in
                   zip(leaves_with_path(params), leaves_with_path(p_shard)))
        res[mode] = {"metrics": metrics, "kept": kept, "coll": coll,
                     "params": sh.full_tree(params),
                     "m": sh.full_tree(state["m"]),
                     "v": sh.full_tree(state["v"])}

    sync = SyncConfig(mode="datacentric")
    params = sh.distribute_tree(job["params"], sh.tree_shardings(
        axes, job["params"], mesh, sync.param_rules), mesh)
    with torch.no_grad():
        pb = put({"tokens": job["prompt"],
                  **({"media": media} if media is not None else {})},
                 BATCH_AXES)
        logits, cache = make_prefill_step(cfg, job["L"], act_specs=act)(
            params, pb)
        c_shard = sh.tree_shardings(cache_axes(cfg), cache, mesh,
                                    sh.activation_rules())
        cache = tree_map(lambda t, pl: t.redistribute(mesh, pl), cache,
                         c_shard)
        res["cache_placements"] = {
            p: str(t.placements) for p, t in leaves_with_path(cache)}
        outs = [logits.full_tensor()]
        dec = make_decode_step(cfg, act_specs=act)
        for i, tok in enumerate(job["next"]):
            db = put({"tokens": tok,
                      **({"media": media} if media is not None else {})},
                     {**BATCH_AXES, "tokens": ("batch", None)})
            db["pos"] = torch.tensor(job["prompt"].shape[1] + i,
                                     dtype=torch.int32)
            lg, cache = dec(params, cache, db)
            outs.append(lg.full_tensor()[:, 0])
        res["logits"] = torch.stack(outs)
        if job.get("aux_x") is not None:
            lp = tree_map(lambda t: t[0], params["groups"]["g0"]["s0"]["ffn"])
            x = put({"x": job["aux_x"]}, {"x": ("batch", None, None)})["x"]
            _, aux = moe_ffn(lp, x, cfg)
            res["aux"] = {k: v.full_tensor() for k, v in aux.items()}
    return res


jobs = torch.load(inp)
results = {}
for name, job in jobs.items():
    saved = {k: os.environ.get(k) for k in job["env"]}
    os.environ.update(job["env"])
    try:
        results[name] = run(job)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
if rank == 0:
    torch.save(results, out)
dist.destroy_process_group()
'''


def _paths(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, p) if isinstance(v, dict) else {p: v.numpy()})
    return out


def _set_gates(tree: dict, seed: int = 0) -> dict:
    """The xattn slots' gates drawn in [0.5, 1.5): they init to 0, and
    tanh(0) would hide the layer."""
    rng = np.random.default_rng(seed)
    for g in tree["groups"].values():
        for slot in g.values():
            if "gate" in slot["mix"]:
                slot["mix"]["gate"] = rng.uniform(
                    0.5, 1.5, slot["mix"]["gate"].shape).astype(np.float32)
    return tree


def make_job(arch: str, S: int, L: int, seed: int = 0, env=None,
             aux: bool = False, modes=("datacentric", "bsp"),
             **overrides) -> tuple[dict, dict]:
    """(the worker's job, JAX's reference results) of one smoke config at
    f32 with ``overrides``, batch ``B`` x ``S``, cache length ``L``, its
    sharded train step in ``modes``; ``env`` is set around JAX's runs
    here and the worker's there."""
    env = dict(env or {})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    # JAX's hook constrains to a mesh's axes: a one-device (data, model)
    # mesh, whose constraint changes no value
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    try:
        with jax.set_mesh(mesh):
            job, want = _make_job(arch, S, L, seed, env, aux, overrides)
            return dict(job, modes=tuple(modes)), want
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _make_job(arch, S, L, seed, env, aux, overrides):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype=jnp.float32, **overrides)
    jp0 = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(seed))
    npp = _set_gates(jax.tree.map(np.asarray, jp0), seed)
    jp0 = jax.tree.map(jnp.asarray, npp)
    rng = np.random.default_rng(seed + 7)
    media = None
    if jcfg.frontend == "vision":
        media = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_frontend)).astype(np.float32)
    batches = []
    for _ in range(STEPS):
        tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        batches.append({"tokens": tokens,
                        "labels": np.roll(tokens, -1, axis=1), "mask": mask})
    prompt = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    nxt = [rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
           for _ in range(DECODES)]
    jmedia = None if media is None else jnp.asarray(media)

    jo = jopt.make_optimizer(jopt.OptConfig(name="adamw", lr=LR))
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jo, JSyncConfig(mode="datacentric", remat="full")))
    jp, js, metrics = jp0, jo.init(jp0), []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if jmedia is not None:
            jb["media"] = jmedia
        jp, js, m = jstep(jp, js, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    want = {"metrics": metrics, "params": _paths(jp), "m": _paths(js["m"]),
            "v": _paths(js["v"])}
    logits, cache = jtf.prefill(jp0, jnp.asarray(prompt), jcfg, cache_len=L,
                                media=jmedia)
    outs = [np.asarray(logits)]
    for i, tok in enumerate(nxt):
        lg, cache = jtf.decode_step(jp0, cache, jnp.asarray(tok),
                                    jnp.asarray(S + i, jnp.int32), jcfg,
                                    media=jmedia)
        outs.append(np.asarray(lg)[:, 0])
    want["logits"] = np.stack(outs)
    aux_x = None
    if aux:
        aux_x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        lp = jax.tree.map(lambda t: t[0], jp0["groups"]["g0"]["s0"]["ffn"])
        _, a = jmoe.moe_ffn(lp, jnp.asarray(aux_x), jcfg)
        want["aux"] = {k: float(v) for k, v in a.items()}
    job = {"arch": arch, "overrides": overrides, "env": env, "lr": LR,
           "L": L, "params": _to_torch(npp),
           "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                       for b in batches],
           "prompt": torch.from_numpy(prompt),
           "next": [torch.from_numpy(t) for t in nxt],
           "media": None if media is None else torch.from_numpy(media),
           "aux_x": None if aux_x is None else torch.from_numpy(aux_x)}
    return job, want


def run_ranks(tmp, jobs: dict, timeout: int = 240) -> dict:
    """The worker on ``WORLD`` ranks over ``jobs`` {name: job}; rank 0's
    results {name: ...}."""
    inp, out = tmp / "inputs.pt", tmp / "result.pt"
    torch.save(jobs, inp)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD),
         str(tmp / "store"), str(inp), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return torch.load(out)


def check_train(want: dict, got: dict, mode: str) -> None:
    """The sharded step against JAX's: losses rtol 1e-5, the MoE router's
    metrics atol 2e-5, parameters, m and v at ``ATOL``; every leaf kept
    its parameter's placements; the mode's collectives."""
    g = got[mode]
    for wm, gm in zip(want["metrics"], g["metrics"]):
        np.testing.assert_allclose(float(gm["loss"]), wm["loss"], rtol=1e-5)
        for k in ("total_loss", "lb_loss", "router_entropy"):
            np.testing.assert_allclose(float(gm[k]), wm[k], rtol=0,
                                       atol=2e-5, err_msg=k)
    assert g["kept"], "a leaf left its parameter's placements"
    for name, atol in ATOL.items():
        gf = flat(g[name])
        assert set(gf) == set(want[name])
        for k, v in gf.items():
            np.testing.assert_allclose(v, want[name][k], rtol=0, atol=atol,
                                       err_msg=f"{name} {k}")
    coll = g["coll"]
    if mode == "bsp":
        assert coll.get("all-reduce_count", 0) > 0, coll
    else:
        assert coll.get("reduce-scatter_count", 0) > 0, coll
        assert coll.get("all-gather_count", 0) > 0, coll


def check_serve(want: dict, got: dict, atol: float = 1e-5) -> None:
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the dry run's small train cells
# ---------------------------------------------------------------------------

DRY_MESHES = {"4x2": {"data": 4, "model": 2},
              "2x2x2": {"pod": 2, "data": 2, "model": 2}}
DRY_CELL = (32, 8)          # seq, global batch

DRY_SNIPPET = """
import dataclasses, json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import dryrun
from repro_torch.launch.costmodel import group_body_cost
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.shapes import ShapeCell

archs = json.loads(sys.argv[1])
dryrun.fake_world(8)
out = {}
for arch in archs:
    cfg = get_smoke_config(arch)
    for name, shape, axes in (("4x2", (4, 2), ("data", "model")),
                              ("2x2x2", (2, 2, 2), ("pod", "data", "model"))):
        m = make_test_mesh(shape, axes)
        for mode in ("bsp", "datacentric"):
            out[f"{arch}/{name}/{mode}"] = dryrun.measure_cell(
                cfg, ShapeCell("t", %d, %d, "train"), m,
                SyncConfig(mode=mode))
    # one layer of each group standalone, as JAX's trip-count correction
    sync = SyncConfig()
    out[f"{arch}/body"] = [group_body_cost(cfg, gi, m, sync.param_rules,
                                           "train", %d, %d, "full")
                           for gi in range(len(cfg.groups))]
print(json.dumps(out))
""" % (DRY_CELL + DRY_CELL[::-1])


def run_python(code: str, *args: str, env=None, timeout: int = 300):
    e = dict(os.environ, PYTHONPATH=SRC, **(env or {}))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                           *args], capture_output=True, text=True, env=e,
                          timeout=timeout)


def jax_arg_bytes(arch: str, axes: dict) -> int:
    """Per-device argument bytes of a ``DRY_CELL`` train cell as JAX's
    ``resolve_spec`` lays them out under ``datacentric``: parameters and
    AdamW's m and v (f32), its int32 step, the batch (tokens, labels and
    mask; the vision model's f32 media)."""
    mesh = type("M", (), {"shape": axes})()
    cfg = jconfigs.get_smoke_config(arch)
    S, Bg = DRY_CELL

    def local(shape, spec):
        return math.prod(
            n // math.prod(axes[a] for a in
                           (() if e is None else (e,) if isinstance(e, str)
                            else e)) for n, e in zip(shape, spec))
    total = 4                                               # step
    for spec in jax.tree.leaves(jtf.model_specs(cfg),
                                is_leaf=lambda x: hasattr(x, "axes")):
        ps = resolve_spec(spec.axes, spec.shape, mesh, RULES["datacentric"])
        total += 3 * 4 * local(spec.shape, ps)
    ps = resolve_spec(("batch", "seq"), (Bg, S), mesh, ACTIVATION_RULES)
    total += 3 * 4 * local((Bg, S), ps)
    if cfg.frontend == "vision":
        shape = (Bg, cfg.n_frontend_tokens, cfg.d_frontend)
        ps = resolve_spec(("batch", None, None), shape, mesh,
                          ACTIVATION_RULES)
        total += 4 * local(shape, ps)
    return total


def check_group_bodies(bodies: list, cfg_groups: int) -> None:
    """``group_body_cost`` of each group on the (2, 2, 2) mesh (the last
    the snippet builds): FLOPs and bytes positive and finite, collectives
    counted, ``n`` the group's repeats."""
    assert len(bodies) == cfg_groups
    for b in bodies:
        assert b["n"] >= 1 and b["flops"] > 0 and b["bytes"] > 0, b
        assert all(math.isfinite(v) for v in (b["flops"], b["bytes"],
                                              *b["collectives"].values()))
        assert b["collectives"], b


def check_dry_cell(r: dict, arch: str, mesh: str, mode: str) -> None:
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
    if mode == "datacentric":
        assert r["memory"]["argument_bytes_per_device"] == \
            jax_arg_bytes(arch, DRY_MESHES[mesh])
