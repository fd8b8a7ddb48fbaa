"""Request-level serving engine: continuous batching over a paged KV cache
(port of ``repro.serve.engine``).

The engine owns ``batch_size`` sequence *slots* backed by one paged KV
cache (:mod:`repro_torch.serve.paged_cache`).  Requests arrive on an
open-loop clock (:mod:`repro_torch.serve.workload`); the scheduler joins a
new sequence the moment a slot frees up and evicts it the moment it
finishes — decode never drains the batch.  Every decode step runs the full
(B,) batch with per-sequence positions; idle slots sit at pos 0 with their
page tables on the junk page.

Two prompt paths:

* **Whole-prompt prefill** (``prefill_chunk=0``): a B=1 prefill at
  admission (through the flash-attention kernel on the card) scattered
  into freshly allocated pages.  A long prompt stalls every decoding
  sequence for its full prefill.
* **Chunked prefill** (``prefill_chunk=C``): each scheduler tick runs at
  most one C-token chunk of the oldest pending prompt alongside the decode
  batch (through the ``prefill_page_attention`` kernel on the card).  A
  prefilling slot keeps its device page table on the junk page until
  *activation* (``make_activate_fn``), so interleaved decode steps cannot
  touch it; a recurrent layer carries its state outside the batch cache
  until then.  Chunks are end-aligned when sound (an attention-only
  model, a prompt within the smallest ring): the final chunk starts at
  ``S - C``, overlapping its predecessor by recomputing a few positions
  into the slot's private pages, so the first token comes straight from
  the final chunk's logits.  Otherwise (a recurrent carry, which would
  take the overlapped tokens twice; a prompt longer than a ring; a
  near-complete prefix hit) the sub-chunk remainder is teacher-forced
  through the decode path one token per tick (the "tail" phase).

With ``prefix_cache=True`` a radix trie over prompt tokens
(:mod:`repro_torch.serve.prefix_cache`) lets a new request adopt the
physical pages of its longest already-computed prefix: full page matches
are shared read-only under refcounts, a partially matched page is adopted
by copy, and a live slot about to overwrite a page it still shares (ring
wrap) gets a copy-on-write page first.  A model with a recurrent layer
neither adopts nor publishes prefixes: its state at a prefix's end is not
kept.  Finished prefills publish their
full pages back into the trie; LRU eviction of unreferenced trie leaves
feeds the allocator's free list under pressure.  Page copies and
page-table writes are in place on the pools.

Sampling: ``temperature=0`` is greedy ``argmax`` (the first maximum, as
``jnp.argmax``); otherwise softmax sampling at ``temperature`` with
nucleus ``top_p`` (the JAX package's filter, ties at the cutoff kept).
Each draw inverts the CDF of the filtered softmax (f32, vocabulary order)
at one uniform number that depends only on ``(sample_seed, rid, token
index)`` — a fixed integer hash on the host, uploaded with the step's
tokens — so continuous and static schedules draw the same tokens.  The
bits differ from the JAX package's ``fold_in`` keys; the invariance is the
same.

The static baseline is the same engine with ``continuous=False``:
admission only when every slot is free and a full batch has arrived.

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
from ..models.transformer import (SELF_ATTN_KINDS,
                                  decode_step, init_chunk_carry, prefill,
                                  prefill_chunk)
from .live_db import StaticParams, serving_params
from .paged_cache import (PageAllocator, init_paged_cache, make_activate_fn,
                          make_copy_page_fn, make_evict_fn, make_join_fn)
from .prefix_cache import PrefixCache
from .workload import Request


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (model architecture comes from ModelConfig)."""
    batch_size: int = 4          # sequence slots (B_max)
    page_size: int = 8           # tokens per KV page
    cache_len: int = 128         # logical ring length for full-attn layers
    continuous: bool = True      # False = static drain-the-batch baseline
    clock: str = "wall"          # "wall" (seconds) | "steps" (ticks)
    warmup: bool = True          # kernel build + library set-up off the clock
    prefill_chunk: int = 0       # chunk size; 0 = whole-prompt prefill
    prefix_cache: bool = False   # share prompt-prefix pages across requests
    prefix_seqs: int = -1        # pool headroom for retained prefixes, in
    #                              sequences' worth of pages (-1: batch_size)
    temperature: float = 0.0     # 0 = greedy argmax
    top_p: float = 1.0           # nucleus sampling mass (with temperature)
    sample_seed: int = 0         # base seed for sampling

    def __post_init__(self):
        if self.clock not in ("wall", "steps"):
            raise ValueError(f"unknown clock {self.clock!r}")
        if self.prefix_cache and self.prefill_chunk <= 0:
            # prefix adoption rides on the chunked path; default the chunk
            object.__setattr__(self, "prefill_chunk", self.page_size)
        if (self.prefix_cache or self.prefill_chunk > 0) \
                and not self.continuous:
            raise ValueError(
                "prefix_cache / prefill_chunk require continuous=True "
                "(the static baseline keeps whole-prompt prefill)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")


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
    ttft_p50: float              # time-to-first-token percentiles
    ttft_p99: float
    decode_steps: int
    prefill_chunks: int          # chunked-prefill device calls issued
    prefix_hit_rate: float       # fraction of prompt tokens adopted
    utilization: float           # mean fraction of live slots per decode step
    outputs: dict[int, tuple[int, ...]]


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def draw_uniform(seed: int, rid: int, ctr: int) -> float:
    """The uniform number in [0, 1) of draw ``ctr`` of request ``rid``:
    a fixed integer hash (splitmix64) of the triple, 24 bits kept, so it
    is exact in f32 and depends on nothing else."""
    h = _splitmix64(_splitmix64(_splitmix64(seed & _M64) ^ (rid & _M64))
                    ^ (ctr & _M64))
    return (h >> 40) * 2.0 ** -24


def nucleus_filter(lf: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest set of top logits whose softmax mass reaches
    ``top_p`` (``repro.serve.engine``'s rule: ``keep = cum - pr < top_p``,
    the cutoff is the smallest kept logit, ties at the cutoff are kept);
    the rest become ``-inf``.  lf: (B, V) f32."""
    srt = torch.sort(lf, dim=-1, descending=True).values
    pr = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(pr, dim=-1)
    keep = cum - pr < top_p
    cutoff = torch.where(keep, srt, torch.inf).min(dim=-1).values
    return torch.where(lf >= cutoff[:, None], lf, -torch.inf)


def sample_tokens(logits: torch.Tensor, u: torch.Tensor, temperature: float,
                  top_p: float) -> torch.Tensor:
    """Next tokens (B,) int64 from logits (B, V) and uniforms u (B,) f32:
    the first token whose CDF (f32, vocabulary order) over the filtered
    softmax exceeds ``u`` times the total mass, among tokens of non-zero
    probability."""
    lf = logits.float() / temperature
    if top_p < 1.0:
        lf = nucleus_filter(lf, top_p)
    probs = torch.softmax(lf, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    pos = probs > 0
    hit = (cdf > u[:, None] * cdf[:, -1:]) & pos
    first = torch.argmax(hit.to(torch.int8), dim=-1)
    # no hit (u times the mass rounded up to the mass): the last token of
    # non-zero probability
    V = probs.shape[-1]
    last = V - 1 - torch.argmax(pos.flip(-1).to(torch.int8), dim=-1)
    return torch.where(hit.any(dim=-1), first, last)


class _Slot:
    __slots__ = ("req", "phase", "remaining", "tokens", "t_first",
                 "fill_pos", "chunk_starts", "carry", "rows_dev",
                 "rows_host", "shared", "nodes")

    def __init__(self, req: Request):
        self.req = req
        self.phase = "decode"        # "prefill" | "tail" | "decode"
        self.remaining = 0
        self.tokens: list[int] = []
        self.t_first = 0.0
        self.fill_pos = 0            # prompt positions < this are computed
        self.chunk_starts: list[int] | None = []  # pending chunk starts
        self.carry: Any = None       # chunk carry (empty for attention)
        self.rows_dev: dict | None = None
        self.rows_host: dict | None = None
        self.shared: dict[int, set] = {}   # {L: logical page idx shared}
        self.nodes: list = []        # trie node refs to release at retire


class ServeEngine:
    """One model, one paged cache, ``batch_size`` sequence slots.

    ``params`` is a parameter tree (wrapped in :class:`StaticParams` as a
    serving copy, see ``live_db.serving_params``) or a handle with
    ``get()`` and ``device`` (:class:`StaticParams`, ``LiveParamDB``).
    The device is the one the parameters live on, taken from the handle
    without a ``get()``: the engine reads its weights where the JAX
    engine does (warmup, admission, each scheduler tick) and nowhere
    else, so a live handle records the same reads.
    """

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig):
        if cfg.frontend == "vision":
            raise NotImplementedError(
                "serving engine is text-only for now; vision archs need "
                "per-request media plumbing through admission and decode")
        self.cfg, self.scfg = cfg, scfg
        if isinstance(params, Mapping):
            self.db = StaticParams(serving_params(params, cfg))
        elif hasattr(params, "get") and hasattr(params, "device"):
            self.db = params
        else:
            raise TypeError("params: a parameter tree or a handle with "
                            "get() and device")
        self.device = self.db.device
        if not any(k in SELF_ATTN_KINDS for k in cfg.layer_kinds):
            raise ValueError(
                f"{cfg.name}: an attention-free model has no page class, "
                "and the JAX reference engine fails on it (min() of an "
                "empty page-class dict, repro/serve/engine.py:202, "
                "ROADMAP C); it is served through the model-level "
                "functions (prefill, decode_step, init_chunk_carry, "
                "prefill_chunk) until the reference is repaired")
        B = scfg.batch_size
        extra = 0
        if scfg.prefix_cache:
            extra = scfg.prefix_seqs if scfg.prefix_seqs >= 0 else B
        self.alloc = PageAllocator(cfg, B, scfg.cache_len, scfg.page_size,
                                   extra_seqs=extra)
        self.cache = init_paged_cache(cfg, B, scfg.cache_len, scfg.page_size,
                                      extra_seqs=extra, device=self.device)
        self._min_L = min(self.alloc.classes)
        if scfg.prefill_chunk > self._min_L:
            raise ValueError(
                f"prefill_chunk {scfg.prefill_chunk} exceeds the smallest "
                f"page-class ring ({self._min_L}); chunk scatter slots "
                "must stay unique within a chunk")
        # prefix adoption shares raw K/V pages: a recurrent layer would
        # also need its state at the prefix's end, which is not kept; and
        # an overlapping final chunk would feed a recurrent carry the
        # overlapped tokens twice
        self._all_attn = all(k in SELF_ATTN_KINDS for k in cfg.layer_kinds)
        self._can_adopt = scfg.prefix_cache and self._all_attn
        self.prefix = (PrefixCache(self.alloc, scfg.page_size)
                       if scfg.prefix_cache else None)
        self._join = make_join_fn(cfg, scfg.cache_len, scfg.page_size)
        self._evict = make_evict_fn(cfg, scfg.cache_len, scfg.page_size)
        self._activate = make_activate_fn(cfg, scfg.cache_len,
                                          scfg.page_size)
        self._copy = make_copy_page_fn(cfg, scfg.cache_len, scfg.page_size)
        self._carry0 = init_chunk_carry(cfg, device=self.device)
        self._tok = np.zeros((B, 1), np.int64)
        self._pos = np.zeros((B,), np.int64)
        self._rid = np.zeros((B,), np.int64)
        self._ctr = np.zeros((B,), np.int64)
        self.slots: list[_Slot | None] = [None] * B
        self._prefill_q: deque[int] = deque()
        self.decode_steps = 0
        self.prefill_chunks = 0
        self._live_slot_steps = 0
        self._finished: list[FinishedRequest] = []

    # -- device calls -----------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor, rids, ctrs) -> np.ndarray:
        """logits (B, V) on the device -> next tokens (B,) on the host
        (the copy syncs)."""
        temp = self.scfg.temperature
        if temp <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        u = np.array([draw_uniform(self.scfg.sample_seed, int(r), int(c))
                      for r, c in zip(rids, ctrs)], np.float32)
        u = torch.from_numpy(u).to(self.device)
        return sample_tokens(logits, u, temp, self.scfg.top_p).cpu().numpy()

    def _sample_one(self, logits: torch.Tensor, rid: int, ctr: int) -> int:
        """One token from (1, V) logits (prefill outputs)."""
        return int(self._sample(logits, [rid], [ctr])[0])

    def _prefill(self, params, prompt) -> tuple[torch.Tensor, dict]:
        tokens = torch.tensor([prompt], dtype=torch.int64, device=self.device)
        return prefill(params, tokens, self.cfg,
                       cache_len=self.scfg.cache_len)

    def _chunk(self, params, prompt, start: int, rows: dict,
               carry) -> tuple[torch.Tensor, Any]:
        C = self.scfg.prefill_chunk
        tokens = torch.tensor([prompt[start:start + C]], dtype=torch.int64,
                              device=self.device)
        logits, self.cache, carry = prefill_chunk(
            params, self.cache, tokens, start, rows, carry, self.cfg,
            self.scfg.cache_len)
        return logits, carry

    def _decode(self, params) -> np.ndarray:
        tok = torch.from_numpy(self._tok).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        logits, self.cache = decode_step(params, self.cache, tok, pos,
                                         self.cfg)
        return self._sample(logits[:, -1], self._rid, self._ctr)

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

    def _alloc_pages(self, L: int, k: int) -> np.ndarray:
        """Allocate under prefix-cache pressure: evict LRU trie leaves
        into the free list first if the class is short."""
        if self.prefix is not None:
            self.prefix.evict_for(L, k)
        return self.alloc.alloc_pages(L, k)

    def _admit(self, req: Request) -> None:
        """Whole-prompt prefill admission.  The first token's clock reading
        is taken after the prefill (the sampled token's host copy has
        synced), so a wall-clock TTFT includes the request's own prefill."""
        params = self.db.get()
        logits, dense = self._prefill(params, req.prompt)
        first = self._sample_one(logits, req.rid, 0)
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
        self._rid[b] = req.rid
        self._ctr[b] = 1
        s = _Slot(req)
        s.remaining = req.gen_len - 1
        s.tokens = [first]
        s.t_first = now
        self.slots[b] = s

    def _admit_chunked(self, req: Request) -> None:
        """Chunked-prefill admission: assign a slot and queue it.  The
        adoption lookup and chunk plan wait until the slot reaches the
        head of the prefill queue (``_plan_chunks``): by then any in-flight
        request sharing its prefix has activated and published its pages,
        so concurrent same-prefix arrivals miss at most once."""
        b = self._free_slot()
        if b is None:
            raise RuntimeError("admission with no free slot")
        s = _Slot(req)
        s.phase = "prefill"
        s.chunk_starts = None     # not planned yet
        self.slots[b] = s
        self._prefill_q.append(b)

    def _plan_chunks(self, b: int) -> None:
        """Adopt any cached prefix, allocate the rest of the slot's
        pages, and plan the chunk schedule."""
        s = self.slots[b]
        prompt, S = s.req.prompt, len(s.req.prompt)
        page = self.scfg.page_size
        C = self.scfg.prefill_chunk

        full, partial = [], None
        if self._can_adopt and S <= self._min_L:
            full, partial = self.prefix.lookup(prompt)
        a_pg = len(full)
        adopt = a_pg * page + (partial[1] if partial else 0)
        # Chunk plan.  Preferred: end-aligned chunks, the last one starting
        # at S - C so it covers the final prompt token and its logits give
        # the first generated token directly; the final chunk may overlap
        # the one before it (or the adopted prefix), recomputing a few
        # positions into the slot's private pages.  Overlap is only sound
        # when no ring wraps during the prompt (S <= the smallest ring) and
        # no layer carries recurrent state (the carry would take the
        # overlapped tokens twice).  Otherwise: non-overlapping chunks from
        # the adoption point, with the sub-chunk remainder teacher-forced
        # one token per tick through the decode path ("tail" phase) — for
        # a near-complete prefix hit that tail IS the fast path.
        overlap = (self._all_attn and S <= self._min_L and S >= C
                   and S - adopt > 2)
        if overlap:
            # chunks must only ever write the slot's private pages: cap
            # adoption at the last page boundary <= the final chunk start
            a_pg = min(a_pg, (S - C) // page)
            full, partial = full[:a_pg], None
            base = a_pg * page
            k = -(-(S - base) // C)
            s.chunk_starts = [base + i * C for i in range(k - 1)] + [S - C]
            s.fill_pos = base
        else:
            k = (S - adopt) // C
            s.chunk_starts = [adopt + i * C for i in range(k)]
            s.fill_pos = adopt
        if full:
            self.prefix.lease(full)           # released at retire
            s.nodes += full
        if partial:
            self.prefix.lease([partial[0]])   # guard during the copy below

        rows: dict[int, np.ndarray] = {}
        for L, npp in self.alloc.classes.items():
            ids = np.empty((npp,), np.int32)
            for i, node in enumerate(full):
                ids[i] = node.pages[L]
            ids[a_pg:] = self._alloc_pages(L, npp - a_pg)
            rows[L] = ids
        if partial:
            node, _t = partial
            for L in self.alloc.classes:
                self.cache = self._copy(self.cache, node.pages[L],
                                        int(rows[L][a_pg]), L=L,
                                        set_pt=False, b=0, idx=0)
            self.prefix.release([node], drop_pages=True)
        self.alloc.install(b, rows)

        s.rows_host = {L: self.alloc.tables[L][b] for L in rows}  # views
        s.rows_dev = {L: torch.from_numpy(ids).to(self.device)
                      for L, ids in rows.items()}
        s.carry = self._carry0
        s.shared = {L: set(range(a_pg)) for L in rows}

    def _try_admit(self, queue: deque, n_left: int) -> bool:
        admitted = False
        chunked = self.scfg.prefill_chunk > 0
        if self.scfg.continuous:
            while queue and self._free_slot() is not None:
                req = queue.popleft()
                if chunked:
                    self._admit_chunked(req)
                else:
                    self._admit(req)
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

    # -- chunked prefill / activation -------------------------------------

    def _prefill_tick(self, params) -> tuple[int, torch.Tensor | None] | None:
        """Run one chunk of the oldest pending prefill.  Returns
        ``(slot, last_logits)`` when that prefill just ran its final chunk
        (activation happens after this tick's decode)."""
        if not self._prefill_q:
            return None
        b = self._prefill_q[0]
        s = self.slots[b]
        if s.chunk_starts is None:     # head of queue: plan against the
            self._plan_chunks(b)       # freshest trie state
            if not s.chunk_starts:     # near-total hit: straight to tail
                self._prefill_q.popleft()
                return b, None
        start = s.chunk_starts.pop(0)
        logits, s.carry = self._chunk(params, s.req.prompt, start,
                                      s.rows_dev, s.carry)
        s.fill_pos = start + self.scfg.prefill_chunk
        self.prefill_chunks += 1
        if not s.chunk_starts:
            self._prefill_q.popleft()
            return b, logits
        return None

    def _activate_slot(self, b: int, last_logits, now: float) -> None:
        """Flip a prefilling slot live: install its page tables, then either
        take the first token straight from the final chunk's logits or
        trickle the sub-chunk prompt remainder through the decode path."""
        s = self.slots[b]
        S = len(s.req.prompt)
        self.cache = self._activate(self.cache, b, s.rows_dev, s.carry)
        self._rid[b] = s.req.rid
        if s.fill_pos == S:            # chunks covered the whole prompt
            first = self._sample_one(last_logits, s.req.rid, 0)
            s.phase = "decode"
            s.tokens = [first]
            s.remaining = s.req.gen_len - 1
            s.t_first = now
            self._tok[b, 0] = first
            self._pos[b] = S
            self._ctr[b] = 1
            self._insert_prefix(b)
            if s.remaining <= 0:
                self._retire(b, now)
        else:                          # remainder: teacher-forced decode
            s.phase = "tail"
            self._tok[b, 0] = s.req.prompt[s.fill_pos]
            self._pos[b] = s.fill_pos
            self._ctr[b] = 0

    def _insert_prefix(self, b: int) -> None:
        """Publish a freshly prefilled prompt's full pages to the trie."""
        s = self.slots[b]
        if not self._can_adopt or len(s.req.prompt) > self._min_L:
            return
        path, new_idx = self.prefix.insert(s.req.prompt, s.rows_host)
        s.nodes += path
        for L in s.shared:
            s.shared[L].update(new_idx)

    # -- copy-on-write ----------------------------------------------------

    def _cow_tick(self) -> None:
        """Before a decode step: any live slot about to write a page it
        shares with the prefix trie (ring wrap back into an adopted or
        published page) gets a private copy, its page table repointed in
        the same step."""
        page = self.scfg.page_size
        for b, s in enumerate(self.slots):
            if s is None or s.phase == "prefill":
                continue
            p = int(self._pos[b])
            for L, shared in s.shared.items():
                if not shared:
                    continue
                pg = (p % L) // page
                if pg not in shared:
                    continue
                src = int(s.rows_host[L][pg])
                dst = int(self._alloc_pages(L, 1)[0])
                self.cache = self._copy(self.cache, src, dst, L=L,
                                        set_pt=True, b=b, idx=pg)
                s.rows_host[L][pg] = dst   # view into alloc.tables
                self.alloc.decref(L, src)  # drop the slot's share
                shared.discard(pg)

    # -- retire -----------------------------------------------------------

    def _retire(self, b: int, now: float) -> None:
        s = self.slots[b]
        self._finished.append(FinishedRequest(
            s.req.rid, s.req.arrival, s.t_first, now, tuple(s.tokens)))
        if self.prefix is not None and s.nodes:
            self.prefix.release(s.nodes)
        self.cache = self._evict(self.cache, b)
        self.alloc.free_slot(b)
        self._tok[b, 0] = 0
        self._pos[b] = 0
        self._rid[b] = 0
        self._ctr[b] = 0
        self.slots[b] = None

    # -- warmup -----------------------------------------------------------

    def _warmup(self, requests: list[Request]) -> None:
        """Build the kernels and set up the libraries before the clock
        starts.  Chunked: one chunk, one activation and both kinds of page
        copy, all on the junk page (slot 0's table stays on it), so no
        live state changes.  Whole-prompt: one prefill per distinct prompt
        length.  Then the sampler and one decode step with every slot
        idle, whose KV write lands in the junk page."""
        params = self.db.get()
        if self.scfg.prefill_chunk > 0:
            junk = {L: torch.full((npp,), self.alloc.junk[L],
                                  dtype=torch.int32, device=self.device)
                    for L, npp in self.alloc.classes.items()}
            C = self.scfg.prefill_chunk
            self._chunk(params, (0,) * C, 0, junk, self._carry0)
            self._activate(self.cache, 0, junk, self._carry0)
            for L in self.alloc.classes:
                for set_pt in (False, True):
                    self._copy(self.cache, self.alloc.junk[L],
                               self.alloc.junk[L], L=L, set_pt=set_pt, b=0,
                               idx=0)
        else:
            for S in sorted({len(r.prompt) for r in requests}):
                self._prefill(params, (0,) * S)
        self._sample_one(torch.zeros((1, self.cfg.vocab_size),
                                     device=self.device), 0, 0)
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
            live = [b for b, s in enumerate(self.slots)
                    if s is not None and s.phase != "prefill"]
            if not live and not self._prefill_q:
                if not admitted and pending:
                    self._advance_to(pending[0].arrival)
                continue

            params = self.db.get()
            done_prefill = self._prefill_tick(params)
            if live:
                self._cow_tick()
                toks = self._decode(params)          # host copy: synced
                self.decode_steps += 1
            if self.scfg.clock == "steps":
                self._vnow += 1.0
            now = self._now()
            if done_prefill is not None:
                self._activate_slot(done_prefill[0], done_prefill[1], now)
            if not live:
                continue
            for b in live:
                s = self.slots[b]
                self._live_slot_steps += 1
                tk = int(toks[b])
                self._pos[b] += 1
                if s.phase == "tail":
                    p = int(self._pos[b])
                    if p < len(s.req.prompt):
                        self._tok[b, 0] = s.req.prompt[p]
                    else:          # tk is the first generated token
                        s.phase = "decode"
                        s.tokens = [tk]
                        s.remaining = s.req.gen_len - 1
                        s.t_first = now
                        self._tok[b, 0] = tk
                        self._ctr[b] = 1
                        self._insert_prefix(b)
                        if s.remaining <= 0:
                            self._retire(b, now)
                else:
                    s.tokens.append(tk)
                    self._tok[b, 0] = tk
                    self._ctr[b] += 1
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
            decode_steps=self.decode_steps,
            prefill_chunks=self.prefill_chunks,
            prefix_hit_rate=(self.prefix.hit_rate if self.prefix else 0.0),
            utilization=util,
            outputs={f.rid: f.tokens for f in finished})
