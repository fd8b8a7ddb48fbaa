"""Paged per-sequence decode caches: fixed-size pages + a free-list
allocator (port of ``repro.serve.paged_cache`` for attention layers).

The serving engine holds ``batch`` sequence *slots*.  Every attention
layer shares one pool of fixed-size pages, and each slot owns a page table
mapping its logical ring pages to physical pool pages.  Joining a sequence
allocates pages from a free list and scatters its prefilled ring into
them; evicting returns the pages.  The logical view (``slot = pos % L``)
is exactly the dense ring.

Layers with the same logical length L form one *page class*; all layers
of a class share one page table per slot.  Each class pool reserves one
extra *junk page* (id ``P - 1``): freed slots' tables point at it, so the
unconditional per-step KV write of an idle batch row lands there.

Unlike the JAX package, the device side is updated **in place**: ``join``
and ``evict`` write the pools and tables with indexed assignment
(``index_put_``) and return the same cache dict, and so does the decode
step's KV write (``models.attention.attention_decode_paged``).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import SELF_ATTN_KINDS


def page_classes(cfg: ModelConfig, cache_len: int,
                 page_size: int) -> dict[int, int]:
    """{logical length L: pages per sequence} over the model's attention
    kinds.  Every L must be a multiple of ``page_size`` so the ring
    modulus is preserved across the page boundary."""
    classes: dict[int, int] = {}
    for kind in set(cfg.layer_kinds):
        if kind not in SELF_ATTN_KINDS:
            continue
        L = cfg.kv_cache_len(kind, cache_len)
        if L % page_size != 0:
            raise ValueError(
                f"page_size {page_size} must divide cache length {L} "
                f"(kind {kind!r}; pick cache_len/window multiples of it)")
        classes[L] = L // page_size
    return classes


class PageAllocator:
    """Refcounted free-list page allocator over one engine's page classes.

    Pure host-side bookkeeping in numpy; the device copies of the tables
    inside the cache are written by ``join``/``evict``.  Pool capacity per
    class is ``batch * pages_per_seq + 1`` (the +1 is the junk page, id
    ``P - 1``), so allocation succeeds iff a sequence slot is free.  Each
    page carries a refcount (1 while a slot owns it), so a page freed twice
    raises instead of entering the free list twice; page sharing
    (``incref``) comes with the prefix cache.
    """

    def __init__(self, cfg: ModelConfig, batch: int, cache_len: int,
                 page_size: int):
        self.batch = batch
        self.page_size = page_size
        self.classes = page_classes(cfg, cache_len, page_size)
        cap = {L: batch * npp for L, npp in self.classes.items()}
        self.junk = dict(cap)
        self.free: dict[int, list[int]] = {
            L: list(range(n)) for L, n in cap.items()}
        self.refcount: dict[int, np.ndarray] = {
            L: np.zeros(n, np.int32) for L, n in cap.items()}
        self.tables: dict[int, np.ndarray] = {
            L: np.full((batch, npp), self.junk[L], np.int32)
            for L, npp in self.classes.items()}

    def n_free(self, L: int) -> int:
        return len(self.free[L])

    def alloc_pages(self, L: int, k: int) -> np.ndarray:
        """Pop ``k`` pages of class ``L`` off the free list (each born
        with refcount 1, owned by the caller)."""
        if len(self.free[L]) < k:
            raise RuntimeError(f"page pool exhausted (L={L})")
        ids = np.array([self.free[L].pop() for _ in range(k)], np.int32)
        self.refcount[L][ids] = 1
        return ids

    def decref(self, L: int, ids) -> None:
        for p in np.atleast_1d(np.asarray(ids, np.int64)):
            if self.refcount[L][p] <= 0:
                raise RuntimeError(f"page {p} over-freed (L={L})")
            self.refcount[L][p] -= 1
            if self.refcount[L][p] == 0:
                self.free[L].append(int(p))

    def alloc(self, b: int) -> dict[int, np.ndarray]:
        """Allocate slot ``b``'s pages in every class; returns the page-id
        rows ({L: (n_pp,) int32}) to hand to ``join``."""
        rows = {}
        for L, npp in self.classes.items():
            if (self.tables[L][b] != self.junk[L]).any():
                raise ValueError(f"slot {b} already holds pages (L={L})")
            if len(self.free[L]) < npp:
                raise RuntimeError(f"page pool exhausted (L={L})")
            rows[L] = self.alloc_pages(L, npp)
            self.tables[L][b] = rows[L]
        return rows

    def free_slot(self, b: int) -> None:
        """Drop slot ``b``'s reference on each of its pages; the table row
        goes back to the junk page."""
        for L in self.classes:
            row = self.tables[L][b]
            self.decref(L, row[row != self.junk[L]])
            self.tables[L][b] = self.junk[L]


def _walk_slots(cfg: ModelConfig):
    for gi, g in enumerate(cfg.groups):
        for si, kind in enumerate(g.pattern):
            yield f"g{gi}", f"s{si}", kind, g.n


def init_paged_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     page_size: int,
                     device: str | torch.device | None = None) -> dict:
    """Attention slots get {"pk", "pv": (n, P, page, KV, hd) pools,
    "pt": (n, B, n_pp) int32 tables} on ``device`` (default ``cuda``),
    tables starting at the junk page ``P - 1``.  ``pk`` and ``pv`` are
    separate tensors, since both are written in place."""
    dev = resolve_device(device)
    classes = page_classes(cfg, cache_len, page_size)
    cache: dict[str, Any] = {}
    for gkey, skey, kind, n in _walk_slots(cfg):
        if kind not in SELF_ATTN_KINDS:
            raise NotImplementedError(
                f"paged cache for layer kind {kind!r} comes with a later "
                "slice of the port")
        L = cfg.kv_cache_len(kind, cache_len)
        npp = classes[L]
        P = batch * npp + 1
        shape = (n, P, page_size, cfg.n_kv_heads, cfg.hd)
        cache.setdefault(gkey, {})[skey] = {
            "pk": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pv": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pt": torch.full((n, batch, npp), P - 1, dtype=torch.int32,
                             device=dev)}
    return cache


def make_join_fn(cfg: ModelConfig, cache_len: int,
                 page_size: int) -> Callable:
    """Build ``join(cache, dense, b, rows) -> cache``: scatter one
    sequence's dense prefill cache (``prefill(..., cache_len)`` with B=1)
    into paged slot ``b``, in place.  ``rows``: {L: (n_pp,) page ids}
    from ``PageAllocator.alloc``, as tensors on the cache's device."""

    def join(cache: dict, dense: dict, b: int,
             rows: dict[int, torch.Tensor]) -> dict:
        for gkey, skey, kind, n in _walk_slots(cfg):
            pc, dc = cache[gkey][skey], dense[gkey][skey]
            ids = rows[cfg.kv_cache_len(kind, cache_len)].long()
            npp = ids.shape[0]
            for name, src in (("pk", dc["k"]), ("pv", dc["v"])):
                pages = src[:, 0].reshape(n, npp, page_size,
                                          cfg.n_kv_heads, cfg.hd)
                pc[name][:, ids] = pages.to(pc[name].dtype)
            pc["pt"][:, b] = ids.to(torch.int32)
        return cache

    return join


def make_evict_fn(cfg: ModelConfig, cache_len: int,
                  page_size: int) -> Callable:
    """Build ``evict(cache, b) -> cache``: point slot ``b``'s page tables
    back at the junk page, in place (page data needs no clearing — a later
    join overwrites every page it allocates)."""

    def evict(cache: dict, b: int) -> dict:
        for gkey, skey, kind, n in _walk_slots(cfg):
            pc = cache[gkey][skey]
            pc["pt"][:, b] = pc["pk"].shape[1] - 1      # junk page id P - 1
        return cache

    return evict
