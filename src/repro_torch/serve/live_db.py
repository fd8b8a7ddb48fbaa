"""Parameter reads for serving: bounded-stale gets over a ParameterDB
(port of ``repro.serve.live_db``).

The serving engine never owns its weights.  It holds a handle whose
``get()`` returns the current parameter tree (and whose ``device`` says
where it lives, read without a recorded access); two implementations:

  * :class:`StaticParams` — frozen weights (plain serving, no trainer);
  * :class:`LiveParamDB` — a trainer publishes new weights while the
    server reads, with the data-centric admissible-delay contract (paper
    Sec 7) applied per parameter group: leaves are grouped by their
    resolved ``SyncConfig.delay_for`` delay, and a group's served copy is
    refreshed only once its staleness would exceed the group's delay.
    Every access is recorded as an :class:`repro_torch.core.history.Op`
    in a shared :class:`repro_torch.pdb.telemetry.Telemetry` (trainer =
    worker 0, server = worker 1, chunk = delay group), so
    ``history.is_sequentially_correct`` remains the one semantic oracle
    and tests can assert the per-read staleness bound from the log.

Versioning convention matches the rest of the repo: ``publish(params,
itr)`` installs the weights produced by training iteration ``itr``
(1-based); version 0 is the initial tree.  A server read while ``itr``
iterations have completed is an op of the in-progress iteration
``alpha = itr + 1``, observing some version ``v <= itr`` with staleness
``(alpha - 1) - v = itr - v`` — the same formula Telemetry applies.

The port's engine feeds ``get()``'s tree straight to the model, so a
handle holds serving copies (``serving_params``).  A published tree is
snapshot at ``publish``: every leaf is cast or cloned, never kept by
reference, since a trainer updates its tensors in place (the ring write is
deferred) and a stale read must still serve the values of the version it
records.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

import torch

from ..core.sync import SyncConfig
from ..models.config import ModelConfig
from ..models.paramlib import P
from ..models.transformer import model_specs
from ..pdb.telemetry import Telemetry
from ..tree import leaves, leaves_with_path, structure, unflatten

# leaves the JAX package always casts to cfg.dtype before use
_CAST_PREFIX = "w"
_CAST_NAMES = ("embedding", "lm_head", "frontend_proj")


def serving_leaf(name: str, leaf: Any, cfg: ModelConfig, spec: P) -> Any:
    """The serving copy of one master leaf called ``name`` with the spec
    ``spec``: the weight matrices (``w*``), ``embedding``, ``lm_head`` and
    ``frontend_proj`` cast to ``cfg.dtype`` — bit-identical to the per-use
    cast, which then costs nothing — unless the spec keeps the leaf f32
    (the model reads it in f32: the RG-LRU's gate matrices), and every
    other leaf (norm scales, the MoE router and the xattn gates, read as
    f32) as it is."""
    if spec.keep_f32:
        return leaf
    if name.startswith(_CAST_PREFIX) or name in _CAST_NAMES:
        return leaf.to(cfg.dtype)
    return leaf


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """A serving copy of an f32 master tree of ``model_specs(cfg)``, leaf
    by leaf (``serving_leaf``)."""

    def walk(node, specs):
        return {k: walk(v, specs[k]) if isinstance(v, dict)
                else serving_leaf(k, v, cfg, specs[k])
                for k, v in node.items()}

    return walk(params, model_specs(cfg))


class StaticParams:
    """Frozen-weight handle: ``get()`` always returns the same tree."""

    def __init__(self, params: Any):
        self._params = params

    def get(self) -> Any:
        return self._params

    @property
    def device(self) -> torch.device:
        return leaves(self._params)[0].device


@dataclasses.dataclass(frozen=True)
class ReadRecord:
    """One server-side group read (the test hook for the delay bound)."""
    chunk: int          # delay-group index
    delay: int          # the group's admissible delay d_g
    itr: int            # alpha: in-progress iteration at read time
    version: int        # published version the read observed

    @property
    def staleness(self) -> int:
        return (self.itr - 1) - self.version


class _Group:
    def __init__(self, chunk: int, delay: int, idxs: list[int]):
        self.chunk, self.delay, self.idxs = chunk, delay, idxs


class LiveParamDB:
    """Serve-while-train parameter handle with per-group admissible delays.

    ``publish`` (trainer side) swaps in a snapshot of the full tree; ``get``
    (server side) rebuilds its view group by group, keeping a group's
    previous copy as long as its staleness stays within ``delay_for`` and
    refreshing it from the latest publish the moment it would not.  Both
    run under one lock, so each call is atomic against the other and the
    recorded Op history is a real total order.

    ``params`` and every published tree are f32 master trees of
    ``model_specs(cfg)``; the handle holds their serving copies
    (``serving_params``), which is what the engine reads.
    """

    def __init__(self, params: Any, sync: SyncConfig,
                 telemetry: Telemetry | None = None, *,
                 cfg: ModelConfig):
        self.sync = sync
        self.cfg = cfg
        self.telemetry = telemetry or Telemetry(record_history=True)
        self._lock = threading.Lock()
        pairs = leaves_with_path(params)
        self._paths = [path for path, _ in pairs]
        self._structure = structure(params)
        by_delay: dict[int, list[int]] = {}
        for i, path in enumerate(self._paths):
            by_delay.setdefault(sync.delay_for(path), []).append(i)
        self._groups = [_Group(chunk, d, by_delay[d])
                        for chunk, d in enumerate(sorted(by_delay))]
        self._latest = self._snapshot(params)
        self._version = 0
        self._cached = list(self._latest)
        self._cached_version = [0] * len(self._groups)
        self.read_log: list[ReadRecord] = []

    def _snapshot(self, params: Any) -> list:
        """The leaves to serve for ``params``: its serving copy, with a
        clone wherever ``serving_params`` returns the caller's tensor."""
        out = leaves(serving_params(params, self.cfg))
        return [o.clone() if o is s else o
                for o, s in zip(out, leaves(params))]

    @property
    def n_chunks(self) -> int:
        """Chunk count for ``is_sequentially_correct(history, n_chunks)``."""
        return len(self._groups)

    @property
    def version(self) -> int:
        return self._version

    @property
    def device(self) -> torch.device:
        return self._latest[0].device

    def publish(self, params: Any, itr: int) -> None:
        """Install the weights produced by training iteration ``itr``.

        Records the trainer's Def-3 program for the iteration: read every
        group (it read version ``itr - 1`` to compute the update), then
        write every group.
        """
        snap = self._snapshot(params)
        with self._lock:
            if itr != self._version + 1:
                raise ValueError(
                    f"publish({itr}) out of order; last was {self._version}")
            for g in self._groups:
                self.telemetry.on_read(0, g.chunk, itr, version=itr - 1)
            self._latest = snap
            self._version = itr
            for g in self._groups:
                self.telemetry.on_write(0, g.chunk, itr)

    def get(self) -> Any:
        """The server's view: per group, the cached copy while it is
        admissibly stale, else a refresh to the latest publish."""
        with self._lock:
            itr = self._version
            alpha = itr + 1
            for g in self._groups:
                v = self._cached_version[g.chunk]
                if itr - v > g.delay:
                    for i in g.idxs:
                        self._cached[i] = self._latest[i]
                    v = itr
                    self._cached_version[g.chunk] = v
                self.telemetry.on_read(1, g.chunk, alpha, version=v)
                self.read_log.append(
                    ReadRecord(chunk=g.chunk, delay=g.delay,
                               itr=alpha, version=v))
            return unflatten(self._structure, list(self._cached))
