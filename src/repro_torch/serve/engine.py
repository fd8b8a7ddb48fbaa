"""Request-level serving engine: continuous batching over a paged KV cache
(port of ``repro.serve.engine``, whole-prompt path).

The engine owns ``batch_size`` sequence *slots* backed by one paged KV
cache (:mod:`repro_torch.serve.paged_cache`).  Requests arrive on an
open-loop clock (:mod:`repro_torch.serve.workload`); the scheduler joins a
new sequence the moment a slot frees up and evicts it the moment it
finishes — decode never drains the batch.  Every decode step runs the full
(B,) batch with per-sequence positions; idle slots sit at pos 0 with their
page tables on the junk page.

Admission is a whole-prompt prefill (B=1, through the flash-attention
kernel on the card) scattered into freshly allocated pages.  Decoding is
greedy ``argmax`` (the first maximum, as ``jnp.argmax``).  The static
baseline is the same engine with ``continuous=False``: admission only when
every slot is free and a full batch has arrived.

Chunked prefill, the prefix cache and sampling (``prefill_chunk > 0``,
``prefix_cache=True``, ``temperature > 0``) come with slice 3 of the port
and raise ``NotImplementedError`` here.

Two clocks: ``"wall"`` (arrivals in seconds, ``time.perf_counter``, each
step ending in a device sync) for benchmarking, ``"steps"`` (arrivals in
scheduler-tick indices) for deterministic tests.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import check_supported, decode_step, prefill
from .live_db import StaticParams, serving_params
from .paged_cache import (PageAllocator, init_paged_cache, make_evict_fn,
                          make_join_fn)
from .workload import Request

_SLICE3 = "slice 3 of the port (chunked prefill, prefix cache, sampling)"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (model architecture comes from ModelConfig)."""
    batch_size: int = 4          # sequence slots (B_max)
    page_size: int = 8           # tokens per KV page
    cache_len: int = 128         # logical ring length for full-attn layers
    continuous: bool = True      # False = static drain-the-batch baseline
    clock: str = "wall"          # "wall" (seconds) | "steps" (ticks)
    warmup: bool = True          # kernel build + library set-up off the clock
    prefill_chunk: int = 0       # 0 = whole-prompt prefill
    prefix_cache: bool = False
    temperature: float = 0.0     # 0 = greedy argmax
    top_p: float = 1.0

    def __post_init__(self):
        if self.clock not in ("wall", "steps"):
            raise ValueError(f"unknown clock {self.clock!r}")
        if self.prefill_chunk > 0:
            raise NotImplementedError(f"prefill_chunk comes with {_SLICE3}")
        if self.prefix_cache:
            raise NotImplementedError(f"prefix_cache comes with {_SLICE3}")
        if self.temperature != 0.0 or self.top_p != 1.0:
            raise NotImplementedError(f"sampling comes with {_SLICE3}")


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    arrival: float
    t_first: float               # clock at first token (end of prefill)
    t_done: float                # clock at last token
    tokens: tuple[int, ...]

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival

    @property
    def ttft(self) -> float:
        """Time to first token (queueing + prefill)."""
        return self.t_first - self.arrival


@dataclasses.dataclass
class ServeReport:
    mode: str                    # "continuous" | "static"
    n_requests: int
    total_tokens: int
    duration: float              # clock units (s or ticks)
    tokens_per_sec: float        # tokens / duration (per-tick for "steps")
    latency_p50: float
    latency_p99: float
    ttft_p50: float
    ttft_p99: float
    decode_steps: int
    utilization: float           # mean fraction of live slots per decode step
    outputs: dict[int, tuple[int, ...]]


class _Slot:
    __slots__ = ("req", "remaining", "tokens", "t_first")

    def __init__(self, req: Request):
        self.req = req
        self.remaining = 0
        self.tokens: list[int] = []
        self.t_first = 0.0


class ServeEngine:
    """One model, one paged cache, ``batch_size`` sequence slots.

    ``params`` is a parameter tree (wrapped in :class:`StaticParams` as a
    serving copy, see ``live_db.serving_params``) or a handle with
    ``get()``.  The device is the one the parameters live on.
    """

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig):
        check_supported(cfg)
        self.cfg, self.scfg = cfg, scfg
        if isinstance(params, Mapping):
            self.db = StaticParams(serving_params(params, cfg))
        elif hasattr(params, "get"):
            self.db = params
        else:
            raise TypeError("params: a parameter tree or a handle with get()")
        self.device = self.db.get()["embedding"].device
        B = scfg.batch_size
        self.alloc = PageAllocator(cfg, B, scfg.cache_len, scfg.page_size)
        self.cache = init_paged_cache(cfg, B, scfg.cache_len, scfg.page_size,
                                      device=self.device)
        self._join = make_join_fn(cfg, scfg.cache_len, scfg.page_size)
        self._evict = make_evict_fn(cfg, scfg.cache_len, scfg.page_size)
        self._tok = np.zeros((B, 1), np.int64)
        self._pos = np.zeros((B,), np.int64)
        self.slots: list[_Slot | None] = [None] * B
        self.decode_steps = 0
        self._live_slot_steps = 0
        self._finished: list[FinishedRequest] = []

    # -- device calls -----------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, params, prompt) -> tuple[int, dict]:
        tokens = torch.tensor([prompt], dtype=torch.int64, device=self.device)
        logits, dense = prefill(params, tokens, self.cfg,
                                cache_len=self.scfg.cache_len)
        return int(torch.argmax(logits[0])), dense

    def _decode(self, params) -> np.ndarray:
        tok = torch.from_numpy(self._tok).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        logits, self.cache = decode_step(params, self.cache, tok, pos,
                                         self.cfg)
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    # -- clock ------------------------------------------------------------

    def _now(self) -> float:
        if self.scfg.clock == "wall":
            return time.perf_counter() - self._t0
        return self._vnow

    def _advance_to(self, t: float) -> None:
        """Idle fast-forward to the next arrival."""
        if self.scfg.clock == "wall":
            time.sleep(max(0.0, t - self._now()))
        else:
            self._vnow = max(self._vnow, t)

    # -- admission --------------------------------------------------------

    def _free_slot(self) -> int | None:
        for b, s in enumerate(self.slots):
            if s is None:
                return b
        return None

    def _admit(self, req: Request) -> None:
        """Whole-prompt prefill admission.  The first token's clock reading
        is taken after the prefill (``int`` of the argmax has synced), so a
        wall-clock TTFT includes the request's own prefill."""
        params = self.db.get()
        first, dense = self._prefill(params, req.prompt)
        now = self._now()
        if req.gen_len <= 1:       # prompt-only request: done at prefill
            self._finished.append(FinishedRequest(
                req.rid, req.arrival, now, now, (first,)))
            return
        b = self._free_slot()
        if b is None:
            raise RuntimeError("admission with no free slot")
        rows = {L: torch.from_numpy(ids).to(self.device)
                for L, ids in self.alloc.alloc(b).items()}
        self.cache = self._join(self.cache, dense, b, rows)
        self._tok[b, 0] = first
        self._pos[b] = len(req.prompt)
        s = _Slot(req)
        s.remaining = req.gen_len - 1
        s.tokens = [first]
        s.t_first = now
        self.slots[b] = s

    def _try_admit(self, queue: deque, n_left: int) -> bool:
        admitted = False
        if self.scfg.continuous:
            while queue and self._free_slot() is not None:
                self._admit(queue.popleft())
                admitted = True
        else:
            # static baseline: wait for an empty engine AND a full batch
            # (or the tail of the workload), then admit the whole wave
            want = min(self.scfg.batch_size, n_left)
            if all(s is None for s in self.slots) and len(queue) >= want:
                for _ in range(want):
                    self._admit(queue.popleft())
                    admitted = True
        return admitted

    # -- retire -----------------------------------------------------------

    def _retire(self, b: int, now: float) -> None:
        s = self.slots[b]
        self._finished.append(FinishedRequest(
            s.req.rid, s.req.arrival, s.t_first, now, tuple(s.tokens)))
        self.cache = self._evict(self.cache, b)
        self.alloc.free_slot(b)
        self._tok[b, 0] = 0
        self._pos[b] = 0
        self.slots[b] = None

    # -- warmup -----------------------------------------------------------

    def _warmup(self, requests: list[Request]) -> None:
        """Build the kernels and set up the libraries before the clock
        starts: one prefill per distinct prompt length and one decode
        step.  The decode step runs with every slot idle, so its KV write
        lands in the junk page and no live state changes."""
        params = self.db.get()
        for S in sorted({len(r.prompt) for r in requests}):
            self._prefill(params, (0,) * S)
        self._decode(params)
        self._sync()

    # -- main loop --------------------------------------------------------

    def run(self, requests: list[Request],
            step_hook: Callable[[int], None] | None = None) -> ServeReport:
        """Serve ``requests`` to completion; returns the run report.
        ``step_hook(decode_step_index)`` fires after every decode step."""
        reqs = sorted(requests, key=lambda r: r.arrival)
        if self.scfg.warmup:
            self._warmup(reqs)
        pending = deque(reqs)
        queue: deque[Request] = deque()
        self._finished = []
        finished = self._finished
        self._t0 = time.perf_counter()
        self._vnow = 0.0

        while len(finished) < len(reqs):
            now = self._now()
            while pending and pending[0].arrival <= now:
                queue.append(pending.popleft())
            n_left = len(pending) + len(queue)
            admitted = self._try_admit(queue, n_left)
            live = [b for b, s in enumerate(self.slots) if s is not None]
            if not live:
                if not admitted and pending:
                    self._advance_to(pending[0].arrival)
                continue

            toks = self._decode(self.db.get())     # host copy: synced
            self.decode_steps += 1
            if self.scfg.clock == "steps":
                self._vnow += 1.0
            now = self._now()
            for b in live:
                s = self.slots[b]
                self._live_slot_steps += 1
                tk = int(toks[b])
                self._pos[b] += 1
                s.tokens.append(tk)
                self._tok[b, 0] = tk
                s.remaining -= 1
                if s.remaining == 0:
                    self._retire(b, now)
            if step_hook is not None:
                step_hook(self.decode_steps)

        duration = max(self._now(), 1e-9)
        lat = np.array([f.latency for f in finished])
        ttft = np.array([f.ttft for f in finished])
        total = sum(len(f.tokens) for f in finished)
        util = (self._live_slot_steps /
                (self.decode_steps * self.scfg.batch_size)
                if self.decode_steps else 0.0)
        return ServeReport(
            mode="continuous" if self.scfg.continuous else "static",
            n_requests=len(finished), total_tokens=total,
            duration=float(duration),
            tokens_per_sec=total / duration,
            latency_p50=float(np.percentile(lat, 50)),
            latency_p99=float(np.percentile(lat, 99)),
            ttft_p50=float(np.percentile(ttft, 50)),
            ttft_p99=float(np.percentile(ttft, 99)),
            decode_steps=self.decode_steps, utilization=util,
            outputs={f.rid: f.tokens for f in finished})
