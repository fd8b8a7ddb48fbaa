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
from concurrent.futures import ThreadPoolExecutor

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _disable_current_modes,
                                         _get_current_dispatch_mode_stack)
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


def _active_cost_mode() -> CostMode | None:
    """The innermost :class:`CostMode` on the dispatch-mode stack."""
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, CostMode):
            return m
    return None


def _meta_like(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


_SCAN_COSTS: dict = {}


def _scan_cost(plain, args: tuple, n_seq: int, T: int, grad: bool) -> dict:
    """What :class:`CostMode` counts for ``plain(*args)`` with the
    sequence dim (dim 1 of the first ``n_seq`` args) at length ``T``, on
    ``meta`` tensors: the forward's FLOPs, bytes and the storage it leaves
    live beside its inputs (its outputs and, under ``grad``, what its
    backward keeps); the backward's FLOPs and bytes; the outputs' shapes
    and dtypes."""
    xs = [_meta_like(a.shape[:1] + (T,) + a.shape[2:] if i < n_seq
                     else a.shape, a.dtype) for i, a in enumerate(args)]
    need = [grad and a.requires_grad for a in args]
    xs = [x.requires_grad_() if n else x for x, n in zip(xs, need)]
    fwd = CostMode()
    held = fwd.hold(xs)
    with torch.set_grad_enabled(grad), fwd:
        out = plain(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    r = {"flops": fwd.flops, "bytes": fwd.bytes, "live": fwd.live - held,
         "outs": [(tuple(o.shape), o.dtype) for o in outs],
         "bwd_flops": 0, "bwd_bytes": 0}
    if grad:
        ys = [o for o in outs if o.requires_grad]
        cts = [torch.ones_like(y) for y in ys]
        bwd = CostMode()
        with bwd:
            torch.autograd.grad(ys, [x for x, n in zip(xs, need) if n], cts,
                                allow_unused=True)
        r["bwd_flops"], r["bwd_bytes"] = bwd.flops, bwd.bytes
    return r


_FIT = (2, 3, 4)         # the lengths the counts are fitted through


def _scan_counts(plain, args: tuple, n_seq: int, grad: bool) -> dict:
    """:func:`_scan_cost` at the args' own length T: counted directly up
    to ``_FIT[-1]`` steps, else a quadratic through the counts at
    ``_FIT``.  From 2 steps on every step of the plain loop is the same
    ops at the same shapes and strides (a step's select of a 1-step
    input is contiguous, so 1 is left out), every other forward op
    scales with T, and the backward adds one full-length zero gradient a
    step (``select``'s): each count is a polynomial of degree <= 2 in T,
    which three lengths fix exactly (``tests/test_torch_sharding_
    recurrent.py`` holds it to the loop at 8 and 16 steps)."""
    T = args[0].shape[1]
    key = (plain, tuple((a.shape[:1] + a.shape[2:] if i < n_seq
                         else a.shape, a.dtype, a.requires_grad)
                        for i, a in enumerate(args)), n_seq, grad)
    lengths = (T,) if T <= _FIT[-1] else _FIT
    for n in lengths:
        if (key, n) not in _SCAN_COSTS:
            # a thread of its own: none of the caller's dispatch modes,
            # grad mode or saved-tensor hooks (a remat checkpoint's, which
            # would take the count's own graph for the layer's)
            with ThreadPoolExecutor(1) as pool:
                _SCAN_COSTS[key, n] = pool.submit(
                    _scan_cost, plain, args, n_seq, n, grad).result()
    if T <= _FIT[-1]:
        return _SCAN_COSTS[key, T]
    c2, c3, c4 = (_SCAN_COSTS[key, n] for n in _FIT)
    j = T - _FIT[0]

    def fit(a, b, c):
        return a + j * (b - a) + j * (j - 1) // 2 * (c - 2 * b + a)
    r = {k: fit(c2[k], c3[k], c4[k])
         for k in ("flops", "bytes", "live", "bwd_flops", "bwd_bytes")}
    r["outs"] = [(tuple(fit(*d) for d in zip(s2, s3, s4)), dt)
                 for (s2, dt), (s3, _), (s4, _) in
                 zip(c2["outs"], c3["outs"], c4["outs"])]
    return r


class _ScanStandIn(torch.autograd.Function):
    """The recurrence's place on ``meta`` shards: outputs of the plain
    route's shapes, and the plain route's counts added to the active
    :class:`CostMode` -- forward FLOPs and bytes, the storage its
    backward keeps (one ``meta`` block saved for the backward, so that
    remat drops and recomputes it as it would the loop's), backward FLOPs
    and bytes."""

    @staticmethod
    def forward(ctx, plain, n_seq, *args):
        grad = any(ctx.needs_input_grad[2:])
        c = _scan_counts(plain, args, n_seq, grad)
        mode = _active_cost_mode()
        with _disable_current_modes():
            outs = [_meta_like(s, dt) for s, dt in c["outs"]]
            kept = c["live"] - sum(_nbytes(o) for o in outs)
            blob = _meta_like((kept,), torch.uint8) if grad else None
        if mode is not None:
            mode.flops += c["flops"]
            mode.bytes += c["bytes"]
            for t in outs + ([blob] if grad else []):
                mode._add_storage(t)
            mode.peak = max(mode.peak, mode.live)
        if grad:
            ctx.save_for_backward(blob)
            ctx.bwd = (c["bwd_flops"], c["bwd_bytes"],
                       [(a.shape, a.dtype) for a in args])
        return tuple(outs) if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        flops, byts, shapes = ctx.bwd
        mode = _active_cost_mode()
        with _disable_current_modes():
            gs = [_meta_like(s, dt) if need else None
                  for (s, dt), need in zip(shapes, ctx.needs_input_grad[2:])]
        if mode is not None:
            mode.flops += flops
            mode.bytes += byts
            for g in gs:
                if g is not None:
                    mode._add_storage(g)
            mode.peak = max(mode.peak, mode.live)
        return (None, None, *gs)


def scan_standin(plain, args: tuple, n_seq: int):
    """``plain(*args)`` (a recurrence's plain version: a Python loop over
    the sequence dim, dim 1 of the first ``n_seq`` args) on ``meta``
    tensors without running the loop: the dry run's cost of the scan is
    the plain route's, as JAX's dry run counts its XLA route.  Its
    FLOPs, bytes and the storage its backward keeps are counted at three
    short lengths once per shape and fitted (:func:`_scan_counts`);
    differentiable, its backward counted likewise."""
    return _ScanStandIn.apply(plain, n_seq, *args)


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
    ``meta`` shards over a (fake) process group's mesh.  Every layer kind
    runs: the MoE FFN (its aux losses dropped), the recurrences (through
    :func:`scan_standin`) and ``xattn`` against projected media of the
    config's (B, N, d) laid out as the batch.  Returns {flops, bytes,
    collectives, n}.  (``decode`` is counted as the forward of one
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
    media = None
    if cfg.frontend == "vision":        # the projected media of xattn
        shape = (B, cfg.n_frontend_tokens, cfg.d_model)
        media = _meta_dtensor(shape, cfg.dtype, resolve_spec(
            ("batch", None, None), shape, mesh, activation_rules()), mesh)

    def body(xc, lp):
        for si, k in enumerate(g.pattern):
            xc, _ = _apply_block(lp[f"s{si}"], k, xc, cfg, positions, media)
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
