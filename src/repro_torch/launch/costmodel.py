"""Per-device cost of a step, counted on each rank's local shards (port of
``repro.launch.costmodel``).

JAX reads FLOPs and bytes from the compiled per-device executable; the
port counts what one rank executes.  :class:`CostMode` is a dispatch mode
that lets DTensor desugar every op first (it declines ops on DTensors), so
it sees the aten ops on the local shards and the functional collectives
that DTensor's redistributions issue:

  * FLOPs: ``torch.utils.flop_counter``'s formulas at the local shapes
    (``FlopCounterMode`` itself counts a DTensor op at its global size);
  * bytes accessed: the tensor inputs and outputs of each op that is not a
    view or a collective;
  * collectives: result bytes and count per kind, under JAX's names
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``);
  * memory: the bytes of live local storage, and their peak, from the
    storages the ops return (a storage counts from the op that makes it
    until it is freed).

Eager PyTorch runs every layer, so the port has no scan whose body the
count visits once: the count of a step is the whole step, and
:func:`corrected_terms` (JAX's correction, full + (n - 1) x body) is
kept for the arithmetic only.  :func:`group_body_cost` counts one layer
standalone under the step's shardings, as JAX's does.
"""
from __future__ import annotations

import weakref

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..models import paramlib
from ..models.config import ModelConfig
from ..models.transformer import _apply_block, _remat_wrap, model_specs
from ..tree import leaves
from .sharding import (activation_rules, local_shape, placements,
                       resolve_spec, tree_specs)

# functional collective op name -> JAX's HLO kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")
# ops that return their input in eager but a new tensor on meta or fake
# tensors: their output takes the input's storage over in the count
_ALIASING = ("wait_tensor", "_wrap_tensor_autograd")


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class CostMode(TorchDispatchMode):
    """Counts, for one rank, the FLOPs, bytes, collectives and live
    storage of the ops run under it (see the module docstring).  Storages
    that exist before the count (parameters, optimizer state, batch,
    cache) are registered with :meth:`hold`, so that ops writing into
    them in place add nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()    # storage -> bytes
        self._frees = WeakIdKeyDictionary()   # storage -> its finalizer
        self._fake_mode = None

    def __enter__(self):
        self._fake_mode = active_fake_mode()
        return super().__enter__()

    def _free(self, n: int) -> None:
        self.live -= n

    def _add_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self._frees[st] = weakref.finalize(st, self._free, n)

    def _alias(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        s, d = src.untyped_storage(), dst.untyped_storage()
        if d in self._seen or s not in self._seen:
            self._add_storage(dst)
            return
        n = self._seen[s]
        self._frees[s].detach()
        self._seen[d] = n
        self._frees[d] = weakref.finalize(d, self._free, n)

    def hold(self, tree) -> int:
        """Register the local storages of a tree's tensors as live; returns
        their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._add_storage(_local(t))
        self.peak = max(self.peak, self.live)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor desugars; we see its shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                active_fake_mode() is not self._fake_mode:
            # DTensor's sharding propagation runs ops at the global shapes
            # under a fake mode of its own: not work of this rank
            return out
        ns = getattr(func, "namespace", "")
        name = func._overloadpacket.__name__
        if name in _ALIASING and isinstance(out, torch.Tensor):
            self._alias(args[0], out)
            return out
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                n = sum(_nbytes(t) for t in _tensors(out))
                self.collectives[kind] = self.collectives.get(kind, 0) + n
                self.collectives[kind + "_count"] = \
                    self.collectives.get(kind + "_count", 0) + 1
        elif not func.is_view:
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            self.bytes += sum(_nbytes(t) for t in
                              _tensors(args) + _tensors(kwargs)
                              + _tensors(out))
        for t in _tensors(out):
            self._add_storage(t)
        self.peak = max(self.peak, self.live)
        return out


def cost_dict(mode: CostMode) -> dict:
    """JAX's ``cost_analysis`` keys from a finished count."""
    return {"flops": float(mode.flops), "bytes accessed": float(mode.bytes)}


def _slot_specs_for_group(cfg: ModelConfig, gi: int) -> dict:
    """One layer's parameter specs of group ``gi`` (the stacked dim
    removed)."""
    def strip(node):
        if isinstance(node, paramlib.P):
            return paramlib.P(node.shape[1:], node.axes[1:], node.init,
                              node.scale, node.fan_in_dim, node.dtype)
        return {k: strip(v) for k, v in node.items()}
    return strip(model_specs(cfg)["groups"][f"g{gi}"])


def _meta_dtensor(shape, dtype, spec, mesh, requires_grad=False):
    """A DTensor of global ``shape`` laid out by ``spec`` whose local
    shard is a ``meta`` tensor (shape and dtype, no storage)."""
    loc = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                      device="meta")
    strides = torch.empty(shape, device="meta").stride()
    t = DTensor.from_local(loc, mesh, placements(spec, mesh),
                           run_check=False, shape=torch.Size(shape),
                           stride=strides)
    return t.requires_grad_() if requires_grad else t


def place_tree(specs_tree, like_tree, mesh, requires_grad=False):
    """DTensors with ``meta`` shards for a tree of tensors (``meta`` ones
    will do) and their resolved specs."""
    def walk(s, t):
        if isinstance(t, dict):
            return {k: walk(s[k], t[k]) for k in t}
        return _meta_dtensor(tuple(t.shape), t.dtype, s, mesh,
                             requires_grad and t.is_floating_point())
    return walk(specs_tree, like_tree)


def group_body_cost(cfg: ModelConfig, gi: int, mesh, rules, kind: str,
                    B: int, S: int, remat: str) -> dict:
    """One layer of group ``gi``, standalone under the step's shardings:
    its forward for ``prefill``, and for ``train`` the forward plus, under
    ``autograd``, remat's recomputed forward and the backward, on
    ``meta`` shards over a (fake) process group's mesh.  Returns {flops,
    bytes, collectives, n}.  (``decode`` is counted as the forward of one
    token.)"""
    g = cfg.groups[gi]
    specs = _slot_specs_for_group(cfg, gi)
    like = paramlib.abstract_tree(specs, cfg.param_dtype)
    params = place_tree(tree_specs(paramlib.axes_tree(specs), like, mesh,
                                   rules), like, mesh, kind == "train")
    seq = 1 if kind == "decode" else S
    x_spec = resolve_spec(("batch", None, None), (B, seq, cfg.d_model),
                          mesh, activation_rules())
    x = _meta_dtensor((B, seq, cfg.d_model), cfg.dtype, x_spec, mesh,
                      kind == "train")
    pos_spec = resolve_spec(("batch", None), (B, seq), mesh,
                            activation_rules())
    positions = _meta_dtensor((B, seq), torch.int64, pos_spec, mesh)

    def body(xc, lp):
        for si, k in enumerate(g.pattern):
            xc, _ = _apply_block(lp[f"s{si}"], k, xc, cfg, positions)
        return xc

    mode = CostMode()
    with mode:
        if kind == "train":
            out = _remat_wrap(body, remat)(x, params)
            ct = torch.ones_like(out, dtype=torch.float32)
            loss = torch.sum(out.float() * ct)
            torch.autograd.grad(loss, [x] + leaves(params))
        else:
            with torch.no_grad():
                body(x, params)
    coll = {k: v for k, v in mode.collectives.items()
            if not k.endswith("_count")}
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "collectives": coll, "n": g.n}


def corrected_terms(full_result: dict, body_costs: list[dict]) -> dict:
    """full_module + sum_g (n_g - 1) * body_g for every term (JAX's
    trip-count correction; the port's eager count needs none)."""
    flops = full_result["cost"]["flops_per_device"]
    byts = full_result["cost"]["bytes_per_device"]
    coll = dict(full_result.get("collectives", {}))
    for b in body_costs:
        k = b["n"] - 1
        if k <= 0:
            continue
        flops += k * b["flops"]
        byts += k * b["bytes"]
        for kind, v in b["collectives"].items():
            coll[kind] = coll.get(kind, 0.0) + k * v
    return {"flops_per_device": flops, "bytes_per_device": byts,
            "collectives": coll}
