"""The port's multi-device tables and pure functions against the JAX
package's, exactly, with no device and no process group: the sync rules,
``resolve_spec`` (JAX's own cases, and every leaf of every arch's
full-width parameters, caches and inputs on the production meshes), the
cache axes, the shape cells, ``model_flops``, the trip-count arithmetic,
the placements a spec becomes, and the tuning contract."""
import os
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import sync_jax  # noqa: E402
from repro.launch import costmodel as jcost  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch import tuning as jtuning  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import sync as tsync  # noqa: E402
from repro_torch.launch import costmodel as tcost  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import tuning as ttuning  # noqa: E402
from repro_torch.models import paramlib as tparamlib  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
# importing JAX's dry run forces 512 host devices for later JAX starts:
# undo it for the processes this worker spawns afterwards
if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

ARCHS = tuple(jconfigs.all_arch_ids())
MODES = ("datacentric", "bsp", "ssp")
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
CELLS = [(a, s) for a in ARCHS
         for s in jshapes.applicable_shapes(jconfigs.get_config(a))]


class FakeMesh:
    """JAX's duck-typed mesh (``resolve_spec`` reads ``.shape``)."""
    def __init__(self, axes):
        self.shape = dict(axes)


def _jleaves(tree, is_leaf=None):
    return {"/".join(str(getattr(p, "key", p)) for p in path): x
            for path, x in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=is_leaf)}


def _tleaves(tree):
    return {"/".join(path): x for path, x in leaves_with_path(tree)}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_rules_are_jax_rules(mode):
    assert tsync.RULES[mode] == sync_jax.RULES[mode]
    assert tsync.SyncConfig(mode=mode).param_rules == \
        sync_jax.SyncConfig(mode=mode).param_rules
    assert tsync.ACTIVATION_RULES == sync_jax.ACTIVATION_RULES
    assert tsync._TP_RULES == sync_jax._TP_RULES


@pytest.mark.parametrize("dp_over_model", [False, True])
def test_activation_rules_are_jax_rules(monkeypatch, dp_over_model):
    if dp_over_model:
        monkeypatch.setenv("REPRO_DP_OVER_MODEL", "1")
    else:
        monkeypatch.delenv("REPRO_DP_OVER_MODEL", raising=False)
    assert tsharding.activation_rules() == jsharding.activation_rules()


# ---------------------------------------------------------------------------
# resolve_spec
# ---------------------------------------------------------------------------

# tests/test_sharding.py's cases: (axes, shape, mesh, rules)
SINGLE, POD = MESHES
SPEC_CASES = [
    (("embed", "ffn"), (4096, 14336), SINGLE, "datacentric"),
    (("embed", "ffn"), (4096, 14336), SINGLE, "bsp"),
    (("experts", "embed", "ffn"), (8, 4096, 14336), SINGLE, "datacentric"),
    (("experts", "embed", "ffn"), (16, 5120, 8192), SINGLE, "datacentric"),
    (("ffn", "ffn2"), (7680, 7680), SINGLE, "datacentric"),
    (("batch", "seq"), (256, 4096), POD, "act"),
    (("batch", "seq"), (256, 4096), SINGLE, "act"),
    (("batch", "seq"), (1, 524288), SINGLE, "act"),
    (("layers", "batch", "kv_seq", "kv_heads", None),
     (32, 128, 32768, 8, 128), SINGLE, "act"),
]
WANT = [("data", "model"), (None, "model"), (None, "data", "model"),
        ("model", "data", None), ("model", None), (("pod", "data"), None),
        ("data", None), (None, None), (None, "data", "model", None, None)]


@pytest.mark.parametrize("case,want", list(zip(SPEC_CASES, WANT)))
def test_resolve_spec_jax_cases(case, want):
    axes, shape, mesh, rules = case
    jrules = (sync_jax.ACTIVATION_RULES if rules == "act"
              else sync_jax.RULES[rules])
    trules = (tsync.ACTIVATION_RULES if rules == "act"
              else tsync.RULES[rules])
    got = tsharding.resolve_spec(axes, shape, mesh, trules)
    assert got == tuple(jsharding.resolve_spec(axes, shape, FakeMesh(mesh),
                                               jrules)) == want


def _resolve_all(specs_j, specs_t, shapes_j, shapes_t, mesh, jrules, trules):
    for k in specs_j:
        j = tuple(jsharding.resolve_spec(specs_j[k], shapes_j[k], FakeMesh(
            mesh), jrules))
        t = tsharding.resolve_spec(specs_t[k], shapes_t[k], mesh, trules)
        assert t == j, (k, t, j)


@pytest.mark.parametrize("dp_over_model", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_full_width(monkeypatch, arch, dp_over_model):
    """Every leaf of the full-width parameters (each mode's rules), of the
    decode caches and of the step inputs (the activation rules, which
    ``REPRO_DP_OVER_MODEL`` changes) on both production meshes."""
    if dp_over_model:
        monkeypatch.setenv("REPRO_DP_OVER_MODEL", "1")
    else:
        monkeypatch.delenv("REPRO_DP_OVER_MODEL", raising=False)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jspecs = _jleaves(jtf.model_specs(jcfg),
                      is_leaf=lambda x: hasattr(x, "axes"))
    tspecs = dict(tparamlib.leaves(ttf.model_specs(tcfg)))
    assert set(jspecs) == set(tspecs)
    for mesh in MESHES:
        for mode in MODES:
            _resolve_all({k: v.axes for k, v in jspecs.items()},
                         {k: v.axes for k, v in tspecs.items()},
                         {k: v.shape for k, v in jspecs.items()},
                         {k: v.shape for k, v in tspecs.items()}, mesh,
                         sync_jax.RULES[mode], tsync.RULES[mode])
        for shape in jshapes.applicable_shapes(jcfg):
            jin, jax_axes = jshapes.input_specs(jcfg, shape)
            tin, tax = tshapes.input_specs(tcfg, shape)
            _resolve_all(jax_axes, tax, {k: v.shape for k, v in jin.items()},
                         {k: v.shape for k, v in tin.items()}, mesh,
                         jsharding.activation_rules(),
                         tsharding.activation_rules())
            if jshapes.SHAPES[shape].kind == "train":
                continue
            jc, jca = jshapes.decode_cache_specs(jcfg, shape)
            tc, tca = tshapes.decode_cache_specs(tcfg, shape)
            _resolve_all(_jleaves(jca, is_leaf=_is_axes), _tleaves(tca),
                         {k: v.shape for k, v in _jleaves(jc).items()},
                         {k: v.shape for k, v in _tleaves(tc).items()},
                         mesh, jsharding.activation_rules(),
                         tsharding.activation_rules())


# ---------------------------------------------------------------------------
# axes, shapes, flops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_are_jax_axes(arch):
    assert ttf.cache_axes(tconfigs.get_config(arch)) == \
        jtf.cache_axes(jconfigs.get_config(arch))


def _dtype_name(d):
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_cache_specs_are_jax_specs(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tshapes.applicable_shapes(tcfg) == jshapes.applicable_shapes(jcfg)
    jin, jaxes = jshapes.input_specs(jcfg, shape)
    tin, taxes = tshapes.input_specs(tcfg, shape)
    assert taxes == jaxes and set(tin) == set(jin)
    for k in jin:
        assert tuple(tin[k].shape) == tuple(jin[k].shape), k
        assert _dtype_name(tin[k].dtype) == str(jin[k].dtype), k
        assert tin[k].device.type == "meta"
    jc, jca = jshapes.decode_cache_specs(jcfg, shape)
    tc, tca = tshapes.decode_cache_specs(tcfg, shape)
    assert tca == jca
    jl, tl = _jleaves(jc), _tleaves(tc)
    assert set(jl) == set(tl)
    for k in jl:
        assert tuple(tl[k].shape) == tuple(jl[k].shape), k
        assert _dtype_name(tl[k].dtype) == str(jl[k].dtype), k


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_is_jax_model_flops(arch, shape):
    assert tdryrun.model_flops(tconfigs.get_config(arch), shape) == \
        jdryrun.model_flops(jconfigs.get_config(arch), shape)


def test_shape_cells_are_jax_cells():
    assert {k: vars(v) for k, v in tshapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jshapes.SHAPES.items()}


def test_corrected_terms_is_jax_arithmetic():
    full = {"cost": {"flops_per_device": 1e12, "bytes_per_device": 3e9},
            "collectives": {"all-gather": 5e6}}
    bodies = [{"flops": 2e11, "bytes": 1e8, "n": 4,
               "collectives": {"all-gather": 1e6, "reduce-scatter": 2e6}},
              {"flops": 7e10, "bytes": 3e7, "n": 1,
               "collectives": {"all-reduce": 9e5}}]
    assert tcost.corrected_terms(full, bodies) == \
        jcost.corrected_terms(full, bodies)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,names,want", [
    (("data", "model"), ("data", "model"), (Shard(0), Shard(1))),
    (("model", None, "data"), ("data", "model"), (Shard(2), Shard(0))),
    ((None, None), ("data", "model"), (Replicate(), Replicate())),
    ((("pod", "data"), None, "model"), ("pod", "data", "model"),
     (Shard(0), Shard(0), Shard(2))),
    ((("data", "model"), None), ("pod", "data", "model"),
     (Replicate(), Shard(0), Shard(0))),
])
def test_placements(spec, names, want):
    mesh = types.SimpleNamespace(mesh_dim_names=names)
    assert tsharding.placements(spec, mesh) == want


def test_placements_refuse_axes_out_of_mesh_order():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError):
        tsharding.placements((("data", "pod"),), mesh)


def test_local_shape_and_opt_state_shardings():
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert tsharding.local_shape((256, 4096, 2048),
                                 (("pod", "data"), None, "model"),
                                 mesh) == (8, 4096, 128)
    names = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(2, 2))
    p = {"a": (Shard(0), Replicate()), "b": {"c": (Replicate(), Shard(1))}}
    like = {"m": {"a": 0, "b": {"c": 0}}, "v": {"a": 0, "b": {"c": 0}},
            "step": 0}
    got = tsharding.opt_state_shardings(p, like, names)
    assert got["m"] == p and got["v"] == p
    assert got["step"] == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# tuning
# ---------------------------------------------------------------------------

def test_tuning_contract(monkeypatch):
    """Both packages' ``apply_tuning``: a no-op under ``REPRO_TUNE=0``;
    otherwise it returns what it set and sets nothing twice."""
    for name in ("PYTORCH_CUDA_ALLOC_CONF", "XLA_FLAGS"):
        # setenv first, so that teardown also undoes what the tuning sets
        # (delenv of an unset name records nothing to restore)
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    monkeypatch.setenv("REPRO_TUNE", "0")
    assert ttuning.apply_tuning("gpu") == [] == jtuning.apply_tuning("gpu")
    assert "PYTORCH_CUDA_ALLOC_CONF" not in os.environ
    monkeypatch.setenv("REPRO_TUNE", "1")
    assert ttuning.apply_tuning("cpu", host_device_count=4,
                                enable_x64=False) == []
    first = ttuning.apply_tuning("gpu")
    assert first == ["PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True"]
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:True"
    assert ttuning.apply_tuning("gpu") == []
    jfirst = jtuning.apply_tuning("gpu")
    assert jfirst and jtuning.apply_tuning("gpu") == []
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "backend:native")
    assert ttuning.apply_tuning("gpu") == []
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "backend:native"
