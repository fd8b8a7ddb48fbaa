"""AdamW's one-pass update (``repro_torch.kernels.adamw``) on the CPU.

The wrapper takes the plain version for a CPU leaf; these tests hold that
plain version, the arithmetic the CUDA kernel repeats element by element,
bit for bit to the functional update written out pass by pass (f32 and
bf16 leaves, with and without the clip, after the int8 compression), and
hold the update to its functional contract.  The kernel itself is held to
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s ``adamw`` phase); the optimizer to JAX's in
``tests/test_torch_train.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as kadamw
from repro_torch.optim import optimizers as topt
from repro_torch.tree import leaves, tree_map

HYPER = dict(lr=0.05, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _tree(rng, dtype):
    def leaf(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return {"a": leaf(4, 6), "z": {"b": leaf(1003), "c": leaf(2, 3)},
            "norm": {}}


def _spec_update(cfg, grads, state, params):
    """AdamW as the functional update wrote it, one whole-leaf pass per
    operation: the specification the plain version and the kernel keep."""
    step = state["step"] + 1
    new_state = {}
    if cfg.compression == "int8":
        grads, new_state["residual"] = topt.compress_grads(
            grads, state["residual"])
    scale = (topt._clip_scale(grads, cfg.grad_clip) if cfg.grad_clip > 0
             else None)
    t = step.float()
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)

    def gf(g):
        return (g if scale is None else g * scale.to(g.dtype)).float()

    m = tree_map(lambda m, g: m * cfg.b1 + gf(g) * (1 - cfg.b1),
                 state["m"], grads)
    v = tree_map(lambda v, g: v * cfg.b2 + gf(g) * (1 - cfg.b2) * gf(g),
                 state["v"], grads)
    p = tree_map(lambda p, m, v: (p.float() - (
        m / bc1 / (torch.sqrt(v / bc2) + cfg.eps)
        + p.float() * cfg.weight_decay) * cfg.lr).to(p.dtype),
        params, m, v)
    new_state.update(m=m, v=v, step=step)
    return p, new_state


def _assert_trees_equal(got, want):
    assert tree_map(lambda _: None, got) == tree_map(lambda _: None, want)
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_plain_version_is_the_functional_update(dtype, clip, compression):
    rng = np.random.default_rng(7)
    cfg = topt.OptConfig(name="adamw", grad_clip=clip,
                         compression=compression, **HYPER)
    opt = topt.make_optimizer(cfg)
    params = _tree(rng, dtype)
    got_p, got_s = params, opt.init(params)
    want_p, want_s = params, opt.init(params)
    for _ in range(3):
        grads = _tree(rng, dtype)
        got_p, got_s = opt.update(grads, got_s, got_p)
        want_p, want_s = _spec_update(cfg, grads, want_s, want_p)
        _assert_trees_equal(got_p, want_p)
        _assert_trees_equal(got_s, want_s)
    assert int(got_s["step"]) == 3


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_update_is_functional(clip):
    """The given grads, state and params keep their values, and no
    returned tensor shares storage with one of them."""
    rng = np.random.default_rng(8)
    opt = topt.make_optimizer(topt.OptConfig(name="adamw", grad_clip=clip,
                                             **HYPER))
    params = _tree(rng, torch.float32)
    state = opt.update(_tree(rng, torch.float32), opt.init(params),
                       params)[1]
    grads = _tree(rng, torch.float32)
    given = {"grads": grads, "state": state, "params": params}
    before = tree_map(torch.clone, given)
    new_p, new_s = opt.update(grads, state, params)
    _assert_trees_equal(given, before)
    storages = {x.untyped_storage().data_ptr() for x in leaves(given)}
    for x in leaves({"params": new_p, "state": new_s}):
        assert x.untyped_storage().data_ptr() not in storages


def test_the_kernel_count_stays_at_zero_on_the_cpu():
    rng = np.random.default_rng(9)
    kadamw.counts.reset()
    opt = topt.make_optimizer(topt.OptConfig(name="adamw", **HYPER))
    params = _tree(rng, torch.float32)
    opt.update(_tree(rng, torch.float32), opt.init(params), params)
    assert (kadamw.counts.launches, kadamw.counts.elements) == (0, 0)


def test_meta_leaves_take_the_plain_version():
    """The dry run's ``meta`` shards take the plain passes, whose shapes
    and dtypes it counts."""
    p = torch.empty((3, 5), device="meta")
    m, v = torch.empty_like(p), torch.empty_like(p)
    bc = torch.empty((), device="meta")
    outs = kadamw.adamw(p, m, v, p, bc, bc, bc, **HYPER)
    assert [(o.device.type, o.shape, o.dtype) for o in outs] == [
        ("meta", p.shape, torch.float32)] * 3


def _leaf_args(**over):
    p = torch.zeros(8, 4)
    args = dict(g=torch.zeros(8, 4), m=torch.zeros(8, 4),
                v=torch.zeros(8, 4), p=p, scale=None, bc1=torch.ones(()),
                bc2=torch.ones(()))
    args.update(over)
    return args


@pytest.mark.parametrize("what,over", [
    ("non-contiguous p", dict(p=torch.zeros(4, 8).t())),
    ("non-contiguous g", dict(g=torch.zeros(4, 8).t())),
    ("f16 p", dict(p=torch.zeros(8, 4, dtype=torch.float16))),
    ("bf16 m", dict(m=torch.zeros(8, 4, dtype=torch.bfloat16))),
    ("v of another shape", dict(v=torch.zeros(32))),
    ("a scale of one element, not 0-d", dict(scale=torch.ones(1))),
    ("an f64 bias correction", dict(bc1=torch.ones((), dtype=torch.float64))),
])
def test_the_kernel_refuses_what_it_does_not_take(what, over):
    """Checked before anything is built or launched."""
    with pytest.raises(ValueError):
        kadamw.adamw_kernel(**_leaf_args(**over), **HYPER)


@pytest.fixture
def mesh():
    """A (1, 1) ``data, model`` mesh on a one-rank gloo group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                              "model"))
    finally:
        if own:
            dist.destroy_process_group()


@pytest.mark.parametrize("clip", [False, True])
def test_a_dtensor_leaf_is_updated_on_its_local_shard(mesh, clip):
    """The card's route for a sharded leaf (the update on the local shard,
    the outputs rewrapped in the leaf's layout) gives the bits of the
    update of the DTensors themselves; g, m or v in another layout is
    refused."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    rng = np.random.default_rng(10)
    layout = [Replicate(), Shard(1)]

    def leaf(s, positive=False):
        x = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
        return distribute_tensor(x.abs() * s if positive else x * s, mesh,
                                 layout)
    g, m, v, p = leaf(1e-2), leaf(1e-3), leaf(1e-3, True), leaf(0.02)
    scale = distribute_tensor(torch.tensor(0.3721), mesh,
                              [Replicate(), Replicate()]) if clip else None
    bc = distribute_tensor(torch.tensor(0.1), mesh,
                           [Replicate(), Replicate()])
    got = kadamw.on_local_shards(kadamw.adamw_plain, g, m, v, p, scale, bc,
                                 bc, **HYPER)
    want = kadamw.adamw_plain(g, m, v, p, scale, bc, bc, **HYPER)
    for a, b in zip(got, want):
        assert a.placements == b.placements and a.shape == b.shape
        assert torch.equal(a.to_local(), b.to_local())
    other = distribute_tensor(m.full_tensor(), mesh,
                              [Replicate(), Replicate()])
    with pytest.raises(ValueError, match="placements"):
        kadamw.on_local_shards(kadamw.adamw_plain, g, other, v, p, scale,
                               bc, bc, **HYPER)
