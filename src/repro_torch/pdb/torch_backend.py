"""Device backend of the ParameterDB: the delta-staleness ring buffer (port
of ``repro.pdb.jax_backend``).

The paper's admissible-delay semantics is mapped onto *steps*: the
gradient at step ``alpha`` is evaluated at the parameters of step
``alpha - delta`` and applied to the parameters of step ``alpha``.  A ring
buffer holds the last ``delta + 1`` parameter versions; per-partition-group
delays (the Sec-7.1 per-chunk version arrays) let different parts of the
model read different staleness levels.  ``delta = 0`` is bit-identical to
synchronous training.

Two ring layouts, as in the JAX package:

* **tree**: every parameter leaf stacked ``(delta + 1, ...)``;
* **packed**: leaves grouped by (admissible delay, dtype), flattened in the
  JAX package's leaf order (sorted dict keys) and concatenated into one
  ``(delta + 1, N)`` row per group, N zero-padded to a multiple of 128
  elements, under the JAX package's keys (``d2_float32``).  A stale read is
  then one ``ring_gather`` kernel launch per group; the gathered row is
  unpacked into views, which become the gradient's leaves, so the
  gradient lands per leaf with no concatenation.  Packing round-trips bit
  for bit, so both layouts give the same bits.

``packed=None`` picks the layout from the parameters' device: packed on
the card (where the kernel runs), tree on the CPU.

Differences from the JAX engine, both for memory at full width:

* the ring is updated **in place** (``index_copy_`` at a device index; the
  ring pointer never visits the host), and the write of a step's new
  parameters into their slot is deferred to the moment the new state is
  next read, stepped or committed (``commit_ring``).  A step therefore
  touches no slot that its own state still needs, and a driver that
  rejects a step (a non-finite loss) or retries it still holds an intact
  prior state.  A state is superseded once its successor has been
  stepped; checkpoints are taken of committed states.
* the step returns the same dict of parameters and optimizer state as a
  functional update would, but drops the stale copy and the gradients as
  soon as it no longer needs them.

:class:`TrainEngine` wraps the synchronous path (delta=0, no ring) and the
delayed path behind one step interface, with the Op-history / staleness
telemetry of the JAX engine: each training step is the single logical
worker executing its Def-3 program over the partition groups (read every
group at its configured delay, write every group).
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Any, Callable, NamedTuple

import torch

from ..kernels import ops as kops
from ..trace import span
from ..tree import (Path, leaves, leaves_with_path, structure, tree_map,
                    unflatten)
from .telemetry import Telemetry

PyTree = Any
_LANE = 128   # packed rows are padded to this many elements, as in JAX


@dataclasses.dataclass
class DelayedState:
    params: PyTree          # current theta[alpha]
    hist: PyTree            # (delta+1, ...) ring of versions (tree or packed)
    ptr: torch.Tensor       # 0-d int32: ring slot of theta[alpha]
    opt_state: PyTree
    step: torch.Tensor      # 0-d int32

    # the JAX package flattens this registered node by field position, so
    # its checkpoints key the fields "0".."4"
    FIELDS = ("params", "hist", "ptr", "opt_state", "step")

    def as_tree(self) -> dict:
        return {str(i): getattr(self, f) for i, f in enumerate(self.FIELDS)}

    @classmethod
    def from_tree(cls, tree: dict) -> "DelayedState":
        return cls(*(tree[str(i)] for i in range(len(cls.FIELDS))))


def dtype_name(dt: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``, ``bfloat16``), as the
    JAX package's group keys and checkpoints spell it."""
    return str(dt).removeprefix("torch.")


class _PackGroup(NamedTuple):
    key: str                              # "d<delay>_<dtype>"
    delay: int
    dtype: torch.dtype
    idxs: tuple[int, ...]                 # flat-leaf indices in this group
    shapes: tuple[tuple[int, ...], ...]
    sizes: tuple[int, ...]
    pad: int                              # zero-pad to the lane multiple


def _leaf_delay(path: Path, delta: int,
                delay_for: Callable[[Path], int] | None) -> int:
    return delta if delay_for is None else min(delay_for(path), delta)


def _pack_plan(params: PyTree, delta: int,
               delay_for: Callable[[Path], int] | None
               ) -> tuple[list[_PackGroup], PyTree]:
    lv = leaves_with_path(params)
    by_key: dict[tuple, list] = {}
    for i, (path, leaf) in enumerate(lv):
        d = _leaf_delay(path, delta, delay_for)
        by_key.setdefault((d, dtype_name(leaf.dtype)), []).append(
            (i, tuple(leaf.shape), leaf.dtype))
    plan = []
    for (d, dtname) in sorted(by_key):
        members = by_key[(d, dtname)]
        sizes = tuple(int(torch.Size(s).numel()) for _, s, _ in members)
        plan.append(_PackGroup(
            key=f"d{d}_{dtname}", delay=d, dtype=members[0][2],
            idxs=tuple(m[0] for m in members),
            shapes=tuple(m[1] for m in members),
            sizes=sizes, pad=(-sum(sizes)) % _LANE))
    return plan, structure(params)


def _pack_rows(plan: list[_PackGroup], flat: list) -> dict:
    rows = {}
    for g in plan:
        parts = [flat[i].reshape(-1).to(g.dtype) for i in g.idxs]
        if g.pad:
            parts.append(parts[0].new_zeros(g.pad))
        rows[g.key] = parts[0] if len(parts) == 1 else torch.cat(parts)
    return rows


def _unpack_rows(plan: list[_PackGroup], rows: dict,
                 like: PyTree) -> PyTree:
    out: list = [None] * sum(len(g.idxs) for g in plan)
    for g in plan:
        row, off = rows[g.key], 0
        for i, shape, sz in zip(g.idxs, g.shapes, g.sizes):
            out[i] = row.narrow(0, off, sz).view(shape)
            off += sz
    return unflatten(like, out)


def _resolve_packed(packed: bool | None, params: PyTree) -> bool:
    """Default layout follows the kernel route: packed for parameters on
    the card, tree on the CPU."""
    if packed is not None:
        return packed
    return leaves(params)[0].device.type == "cuda"


def init_delayed_state(params: PyTree, opt_init: Callable[[PyTree], PyTree],
                       delta: int, packed: bool | None = None,
                       delay_for: Callable[[Path], int] | None = None
                       ) -> DelayedState:
    """Ring buffer starts filled with theta[0] (the paper's convention that
    reads clipped below iteration 1 see the initial values).  ``packed``
    selects the grouped (size, N) layout; it must match the
    ``make_delayed_step`` that consumes the state."""
    size = delta + 1
    dev = leaves(params)[0].device
    if _resolve_packed(packed, params):
        plan, _ = _pack_plan(params, delta, delay_for)
        rows = _pack_rows(plan, leaves(params))
        hist = {k: r[None].expand((size,) + r.shape).clone()
                for k, r in rows.items()}
    else:
        hist = tree_map(
            lambda x: x[None].expand((size,) + x.shape).clone(), params)
    return DelayedState(params=params, hist=hist,
                        ptr=torch.zeros((), dtype=torch.int32, device=dev),
                        opt_state=opt_init(params),
                        step=torch.zeros((), dtype=torch.int32, device=dev))


def make_delayed_step(
    grad_fn: Callable[[PyTree, Any], tuple[torch.Tensor, PyTree]],
    opt_update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]],
    delta: int,
    delay_for: Callable[[Path], int] | None = None,
    packed: bool | None = None,
) -> Callable[[DelayedState, Any], tuple[DelayedState, dict]]:
    """Build the delayed-gradient step.

    grad_fn(params, batch) -> (loss, grads)
    opt_update(grads, opt_state, params) -> (new_params, new_opt_state)
    delay_for(path) -> per-leaf delay in [0, delta]; default: uniform delta.
    packed: the grouped ring layout with one ``ring_gather`` per group
        (default: packed on the card, tree on the CPU).  The returned step
        exposes its stale read as ``step.read_stale`` and the deferred
        ring write as ``step.commit_ring``.
    """
    size = delta + 1
    cache: dict = {}

    def layout(params: PyTree):
        # static, derived once — one engine, one tree structure
        if "packed" not in cache:
            cache["packed"] = _resolve_packed(packed, params)
            cache["plan"] = _pack_plan(params, delta, delay_for)
        return cache["packed"], cache["plan"]

    def commit_ring(state: DelayedState) -> DelayedState:
        """Write ``state.params`` into its ring slot (in place; writing
        the same values again is harmless)."""
        use_packed, (plan, _) = layout(state.params)
        with span("pdb.commit_ring"):
            at = state.ptr.view(1).long()
            if use_packed:
                rows = _pack_rows(plan, leaves(state.params))
                for g in plan:
                    state.hist[g.key].index_copy_(0, at, rows[g.key][None])
            else:
                for h, p in zip(leaves(state.hist), leaves(state.params)):
                    h.index_copy_(0, at, p[None].to(h.dtype))
        return state

    def read_stale(state: DelayedState) -> PyTree:
        with span("pdb.read_stale"):
            commit_ring(state)
            use_packed, (plan, like) = layout(state.params)
            if use_packed:
                rows = {g.key: kops.ring_gather(
                            state.hist[g.key],
                            torch.remainder(state.ptr - g.delay, size))
                        for g in plan}
                return _unpack_rows(plan, rows, like)
            out = []
            for path, h in leaves_with_path(state.hist):
                d = _leaf_delay(path, delta, delay_for)
                idx = torch.remainder(state.ptr - d, size)
                out.append(h.index_select(0, idx.view(1))[0])
            return unflatten(like, out)

    def step(state: DelayedState, batch: Any) -> tuple[DelayedState, dict]:
        with span("pdb.step"):
            stale_params = read_stale(state)
            loss, grads = grad_fn(stale_params, batch)
            del stale_params
            new_params, new_opt = opt_update(grads, state.opt_state,
                                             state.params)
            del grads
            new_state = DelayedState(
                params=new_params, hist=state.hist,
                ptr=torch.remainder(state.ptr + 1, size), opt_state=new_opt,
                step=state.step + 1)
            return new_state, {"loss": loss,
                               "staleness": torch.full((), delta,
                                                       dtype=torch.int32,
                                                       device=loss.device)}

    step.read_stale = read_stale
    step.commit_ring = commit_ring
    return step


# ---------------------------------------------------------------------------
# Unified train engine (the one entry point for launch/train.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainEngine:
    """One step interface over both execution paths.

    ``step(state, batch)`` runs the update and records the step's Def-3 ops
    (one logical worker, one chunk per partition group) into the shared
    telemetry.  The recorded version of each read mirrors the ring buffer's
    indexing (reads clipped below step 1 see the initial values), so warmup
    staleness ramps 0..delay exactly as on the device.

    Drivers that may *discard* a step's result (e.g. the fault layer
    skipping a non-finite step) should call ``step_fn`` directly and then
    ``record_step()`` only for accepted steps, so the Op history matches
    the actual parameter evolution.  ``commit(state)`` completes a state's
    ring before it is checkpointed (the identity at delta=0).

    ``on_card``: the parameters live on a card; after ``WARM_STEPS``
    recorded steps the engine freezes the interpreter's heap
    (:func:`_freeze_heap`) until it is itself collected.
    """

    init_state: Callable[[], Any]
    step_fn: Callable[[Any, Any], tuple[Any, dict]]
    telemetry: Telemetry
    delta: int
    group_delays: tuple[int, ...]                     # delay per chunk/group
    commit: Callable[[Any], Any] = lambda state: state
    on_card: bool = False

    def __post_init__(self):
        self._itr = 0

    def step(self, state: Any, batch: Any) -> tuple[Any, dict]:
        new_state, metrics = self.step_fn(state, batch)
        self.record_step()
        return new_state, metrics

    def record_step(self) -> None:
        """Log one committed step's ops into the shared telemetry."""
        self._itr += 1
        itr = self._itr
        for g, d in enumerate(self.group_delays):
            self.telemetry.on_read(0, g, itr, version=max(itr - 1 - d, 0))
        for g in range(len(self.group_delays)):
            self.telemetry.on_write(0, g, itr)
        if self.on_card and itr == WARM_STEPS:
            _freeze_heap(self)

    @property
    def history(self):
        return self.telemetry.history


# recorded steps after which a training engine on a card freezes the heap
WARM_STEPS = 2
_heap_frozen_by: list = []          # the engine that froze it, while it lives


def _freeze_heap(engine: TrainEngine) -> None:
    """Collect what is garbage, then move every object alive out of the
    cycle collector's reach, until ``engine`` is collected; once at a time
    in a process.  After the first steps the heap holds what training keeps
    to its end (the framework's modules, the parameters, what the first
    steps built lazily), and a full collection walks all of it: ~0.1 s of
    host time every few steps under remat, whose checkpoints promote
    thousands of short-lived objects a step, while the card waits for
    launches.  Objects made later are collected as before, and the frozen
    ones again once the engine is gone."""
    if _heap_frozen_by:
        return
    gc.collect()
    gc.freeze()
    _heap_frozen_by.append(weakref.finalize(engine, _unfreeze_heap))


def _unfreeze_heap() -> None:
    gc.unfreeze()
    _heap_frozen_by.clear()


def make_engine(params: PyTree,
                grad_fn: Callable[[PyTree, Any], tuple[torch.Tensor, PyTree]],
                opt: Any, sync: Any,
                record_history: bool = False) -> TrainEngine:
    """Build the unified engine from a grad function and a SyncConfig-like
    object (``delta``, ``group_delays``, ``delay_for``, ``packed_ring``).

    delta == 0: plain synchronous dict state {"params", "opt"} (the JAX
    package's checkpoint layout); otherwise: :class:`DelayedState` ring
    buffer with per-group delays.

    ``init_state()`` hands ``params`` over to the first state, once: the
    engine keeps no reference to them, so they go with that state rather
    than stay alive, a parameter-sized copy, for the whole run.
    """
    held = [params]

    def handed_over() -> PyTree:
        if not held:
            raise RuntimeError("init_state() hands the initial parameters "
                               "over once; build another engine for "
                               "another initial state")
        return held.pop()

    delta = int(getattr(sync, "delta", 0))
    group_delays_cfg = tuple(getattr(sync, "group_delays", ()) or ())
    lv = leaves_with_path(params)
    if delta > 0 and group_delays_cfg:
        delays = tuple(min(sync.delay_for(path), delta) for path, _ in lv)
    else:
        delays = tuple(delta for _ in lv)
    telemetry = Telemetry(record_history=record_history)
    on_card = bool(lv) and lv[0][1].device.type == "cuda"

    if delta == 0:
        def init_state():
            p = handed_over()
            return {"params": p, "opt": opt.init(p)}

        def sync_step(state, batch):
            with span("pdb.step"):
                loss, grads = grad_fn(state["params"], batch)
                new_params, new_opt = opt.update(grads, state["opt"],
                                                 state["params"])
                return ({"params": new_params, "opt": new_opt},
                        {"loss": loss,
                         "staleness": torch.zeros((), dtype=torch.int32,
                                                  device=loss.device)})

        return TrainEngine(
            init_state=init_state, step_fn=sync_step, telemetry=telemetry,
            delta=0, group_delays=delays, on_card=on_card)

    delay_for = sync.delay_for if group_delays_cfg else None
    packed = _resolve_packed(getattr(sync, "packed_ring", None), params)
    raw = make_delayed_step(grad_fn, opt.update, delta, delay_for,
                            packed=packed)

    def init_state():
        return init_delayed_state(handed_over(), opt.init, delta,
                                  packed=packed, delay_for=delay_for)

    return TrainEngine(
        init_state=init_state, step_fn=raw, telemetry=telemetry,
        delta=delta, group_delays=delays, commit=raw.commit_ring,
        on_card=on_card)
