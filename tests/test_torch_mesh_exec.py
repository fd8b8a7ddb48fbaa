"""The port's sharded steps, executed on 4 CPU ranks over gloo (a (2, 2)
``data, model`` mesh), against the JAX package's unsharded steps on the
same numpy inputs (the llama3.2-1b smoke config at f32).

* ``make_train_step`` in ``datacentric`` and ``bsp`` (3 AdamW steps at
  lr 3e-4, remat ``full``, ``dryrun.make_act_specs``' activation layouts)
  against JAX's jitted ``make_train_step``: losses rtol 1e-5, m and v
  atol 2e-5, parameters atol 2e-5 + lr/20 (ROADMAP §C's AdamW guide, the
  bound of ``test_torch_zoo.py``'s AdamW engine test: the ranks' f32
  partial sums meet in another order, and Adam's normalised step turns
  that into up to 1e-5 of an element whose gradient is near 0); every
  leaf keeps its parameter's placements, and the step's collectives are
  those of its mode (``bsp``: an all-reduce; ``datacentric``: a
  reduce-scatter and an all-gather).
* ``make_prefill_step`` and 3 ``make_decode_step``s, the cache laid out
  by ``cache_axes`` (batch over ``data``, ring slots over ``model``),
  against JAX's ``prefill`` / ``decode_step`` logits: atol 1e-5.

The ranks are subprocesses (the worker below, which imports no JAX), one
thread each, meeting through a ``FileStore`` under ``tmp_path``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.sync_jax import SyncConfig as JSyncConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402

ARCH = "llama3.2-1b"
B, S, L, STEPS, DECODES = 4, 16, 32, 3, 3
WORLD = 4

WORKER = r'''
import dataclasses, sys
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
from repro_torch.models.transformer import cache_axes, model_specs
from repro_torch.optim.optimizers import OptConfig, make_optimizer
from repro_torch.tree import leaves_with_path, tree_map

data = torch.load(inp)
cfg = dataclasses.replace(get_smoke_config(data["arch"]),
                          dtype=torch.float32)
mesh = make_test_mesh((2, 2))
act = make_act_specs(mesh)
axes = paramlib.axes_tree(model_specs(cfg))
res = {}
for mode in ("datacentric", "bsp"):
    sync = SyncConfig(mode=mode, remat="full")
    p_shard = sh.tree_shardings(axes, data["params"], mesh,
                                sync.param_rules)
    params = sh.distribute_tree(data["params"], p_shard, mesh)
    opt = make_optimizer(OptConfig(name="adamw"))
    state = opt.init(params)
    step = make_train_step(cfg, opt, sync, act_specs=act)
    losses, coll = [], {}
    for i, b in enumerate(data["batches"]):
        b = sh.distribute_tree(b, sh.batch_shardings(
            {k: ("batch", "seq") for k in b}, b, mesh), mesh)
        if i == 0:
            with CostMode() as cm:
                params, state, m = step(params, state, b)
            coll = {k: v for k, v in cm.collectives.items()
                    if k.endswith("_count")}
        else:
            params, state, m = step(params, state, b)
        assert bool(torch.isfinite(m["loss"]).all())
        losses.append(m["loss"].full_tensor())
    kept = all(p.placements == tuple(pl) for (_, p), (_, pl) in
               zip(leaves_with_path(params), leaves_with_path(p_shard)))
    kept &= all(t.placements == p.placements for t, p in zip(
        [t for _, t in leaves_with_path(state["m"])],
        [t for _, t in leaves_with_path(params)]))
    res[mode] = {"losses": torch.stack(losses), "kept": kept, "coll": coll,
                 "params": sh.full_tree(params),
                 "m": sh.full_tree(state["m"]), "v": sh.full_tree(state["v"])}

sync = SyncConfig(mode="datacentric")
params = sh.distribute_tree(data["params"], sh.tree_shardings(
    axes, data["params"], mesh, sync.param_rules), mesh)
prompt = sh.distribute_tree({"tokens": data["prompt"]}, sh.batch_shardings(
    {"tokens": ("batch", "seq")}, {"tokens": data["prompt"]}, mesh), mesh)
with torch.no_grad():
    logits, cache = make_prefill_step(cfg, data["L"], act_specs=act)(
        params, prompt)
    c_shard = sh.tree_shardings(cache_axes(cfg), cache, mesh,
                                sh.activation_rules())
    cache = tree_map(lambda t, pl: t.redistribute(mesh, pl), cache, c_shard)
    res["cache_placements"] = [str(t.placements)
                               for _, t in leaves_with_path(cache)]
    outs = [logits.full_tensor()]
    dec = make_decode_step(cfg, act_specs=act)
    for i, tok in enumerate(data["next"]):
        tok = sh.distribute_tree({"tokens": tok}, sh.batch_shardings(
            {"tokens": ("batch", None)}, {"tokens": tok}, mesh), mesh)
        tok["pos"] = torch.tensor(data["prompt"].shape[1] + i,
                                  dtype=torch.int32)
        lg, cache = dec(params, cache, tok)
        outs.append(lg.full_tensor()[:, 0])
res["logits"] = torch.stack(outs)
if rank == 0:
    torch.save(res, out)
dist.destroy_process_group()
'''


def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v.numpy()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's reference results and the 4 ranks' results (rank 0's)."""
    tmp = tmp_path_factory.mktemp("mesh_exec")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype=jnp.float32)
    jp0 = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
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

    want = {}
    for mode in ("datacentric", "bsp"):
        jo = jopt.make_optimizer(jopt.OptConfig(name="adamw"))
        jstep = jax.jit(jsteps.make_train_step(
            jcfg, jo, JSyncConfig(mode=mode, remat="full")))
        jp, js, losses = jp0, jo.init(jp0), []
        for b in batches:
            jp, js, m = jstep(jp, js, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            losses.append(float(m["loss"]))
        want[mode] = {"losses": np.array(losses), "params": _jpaths(jp),
                      "m": _jpaths(js["m"]), "v": _jpaths(js["v"])}
    logits, cache = jtf.prefill(jp0, jnp.asarray(prompt), jcfg, cache_len=L)
    outs = [np.asarray(logits)]
    for i, tok in enumerate(nxt):
        lg, cache = jtf.decode_step(jp0, cache, jnp.asarray(tok),
                                    jnp.asarray(S + i, jnp.int32), jcfg)
        outs.append(np.asarray(lg)[:, 0])
    want["logits"] = np.stack(outs)

    inp, out = tmp / "inputs.pt", tmp / "result.pt"
    torch.save({"arch": ARCH, "L": L,
                "params": _to_torch(jax.tree.map(np.asarray, jp0)),
                "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                            for b in batches],
                "prompt": torch.from_numpy(prompt),
                "next": [torch.from_numpy(t) for t in nxt]}, inp)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD),
         str(tmp / "store"), str(inp), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return want, torch.load(out)


@pytest.mark.parametrize("mode", ["datacentric", "bsp"])
def test_sharded_train_step_matches_jax(runs, mode):
    want, got = runs
    w, g = want[mode], got[mode]
    np.testing.assert_allclose(g["losses"].numpy(), w["losses"], rtol=1e-5)
    assert g["kept"], "a leaf left its parameter's placements"
    for name, atol in (("params", 2e-5 + 3e-4 / 20), ("m", 2e-5),
                       ("v", 2e-5)):
        gf = _flat(g[name])
        assert set(gf) == set(w[name])
        for k, v in gf.items():
            np.testing.assert_allclose(v, w[name][k], rtol=0, atol=atol,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("mode", ["datacentric", "bsp"])
def test_sharded_train_step_collectives(runs, mode):
    coll = runs[1][mode]["coll"]
    if mode == "bsp":
        assert coll.get("all-reduce_count", 0) > 0, coll
    else:
        assert coll.get("reduce-scatter_count", 0) > 0, coll
        assert coll.get("all-gather_count", 0) > 0, coll


def test_sharded_prefill_and_decode_match_jax(runs):
    want, got = runs
    # the ring: batch over data, slots over model (cache_axes)
    assert set(got["cache_placements"]) == {
        "(Shard(dim=1), Shard(dim=2))"}, got["cache_placements"]
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               rtol=0, atol=1e-5)
