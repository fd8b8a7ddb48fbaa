"""The weights bridge and the config copies.

* A checkpoint written by the JAX package (``repro.checkpoint``: manifest
  + path-keyed ``.npy`` shards, bf16 stored as a uint16 view) reads back in
  the port bit for bit, f32 and bf16 leaves, single- and multi-shard.
* ``params_from_numpy`` keeps the JAX tree's paths, shapes and bits.
* The port's configs equal the JAX configs field by field, dtypes mapped.
* The port's ``init_tree`` draws from an explicit generator.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, params_from_numpy  # noqa
from repro_torch.models import paramlib as tparamlib  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402

torch.set_num_threads(1)

DTYPE_MAP = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or a numpy/jax array, for bit equality."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tree():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((6, 5)).astype(np.float32)
    return {"groups": {"g0": {"s0": {"mix": {
                "wq": jnp.asarray(rng.standard_normal((3, 4, 8)),
                                  jnp.float32),
                "wo": jnp.asarray(f32).astype(jnp.bfloat16)}}}},
            "embedding": jnp.asarray(rng.standard_normal((7, 4)),
                                     jnp.bfloat16),
            "final_norm": {"scale": jnp.ones((4,), jnp.float32)},
            "step": jnp.asarray(3, jnp.int32)}


@pytest.mark.parametrize("shard_bytes", [None, 40])
def test_jax_checkpoint_reads_back_bit_for_bit(tmp_path, monkeypatch,
                                               shard_bytes):
    if shard_bytes is not None:              # force multi-shard leaves
        monkeypatch.setattr(jckpt, "_SHARD_BYTES", shard_bytes)
    tree = _tree()
    jckpt.save_checkpoint(str(tmp_path), 7, tree)
    got = load_checkpoint(str(tmp_path), 7, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == 5
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        assert node.dtype == DTYPE_MAP.get(leaf.dtype, node.dtype)
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(_bits(node), _bits(leaf))
    assert got["groups"]["g0"]["s0"]["mix"]["wo"].dtype == torch.bfloat16


def test_params_from_numpy_keeps_paths_and_bits():
    tree = jax.tree.map(np.asarray, _tree())
    got = params_from_numpy(tree, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(_bits(node), _bits(leaf))


@pytest.mark.parametrize("arch", tconfigs.all_arch_ids())
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_jax(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    j = getattr(jconfigs, get)(arch)
    t = getattr(tconfigs, get)(arch)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    for field in ("dtype", "param_dtype"):
        assert DTYPE_MAP[jd.pop(field)] == td.pop(field)
    # the port's one field of its own: 0 is the JAX package's rwkv6 block
    assert td.pop("mix_lora") == 0
    assert jd == td
    assert t.hd == j.hd and t.layer_kinds == j.layer_kinds


def test_ported_archs():
    """The port carries the JAX package's whole zoo, id for id."""
    assert sorted(tconfigs.all_arch_ids()) == sorted(jconfigs.all_arch_ids())
    assert len(tconfigs.all_arch_ids()) == 10
    for arch in jconfigs.all_arch_ids():
        assert tconfigs.get_smoke_config(arch).name == \
            jconfigs.get_smoke_config(arch).name


def test_init_tree_is_seeded_by_the_generator():
    cfg = tconfigs.get_smoke_config("llama3.2-1b")
    specs = model_specs(cfg)
    a = tparamlib.init_tree(specs, torch.Generator().manual_seed(0))
    b = tparamlib.init_tree(specs, torch.Generator().manual_seed(0))
    c = tparamlib.init_tree(specs, torch.Generator().manual_seed(1))
    wq = ("groups", "g0", "s0", "mix", "wq")

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    assert torch.equal(at(a, wq), at(b, wq))
    assert not torch.equal(at(a, wq), at(c, wq))
    assert at(a, wq).shape == (2, cfg.d_model, cfg.n_heads * cfg.hd)
    assert at(a, wq).dtype == torch.float32
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))
    # normal draw x 1/sqrt(fan_in); embedding x 0.02
    assert abs(at(a, wq).std().item() * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(a["embedding"].std().item() / 0.02 - 1) < 0.1
