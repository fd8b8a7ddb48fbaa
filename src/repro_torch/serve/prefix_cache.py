"""Prompt-prefix cache: a radix trie over token IDs at page granularity
(own copy of ``repro.serve.prefix_cache``, over the port's allocator).

Requests in real serving traffic share long prompt prefixes (system
prompts, few-shot preambles).  Once one request has computed a prefix's
K/V pages, later requests can *adopt* those physical pages instead of
recomputing them — the trie maps page-sized token runs to the physical
page ids (one per page class) holding their K/V.

Granularity:

* **Nodes are one page of tokens** (``page_size`` ids).  A node's pages
  are only ever inserted from a slot whose whole prompt fit inside the
  smallest page-class ring (no wrap), so each physical page holds pure
  positional content for exactly those tokens in every class.
* **Adoption is token-granular.**  A full-node match shares the page
  read-only (refcount on both the node and, per class, the page).  A
  *partial* match — the prompt diverges mid-page, or the whole prompt is
  cached and the last token must be recomputed for its logits — adopts a
  private *copy* of that page and overwrites from the divergence point:
  copy-on-write at the adoption boundary.  Stale donor tokens past the
  match sit at ring slots ahead of the adopter's position, which the
  decode mask (``models.attention._ring_valid``) and the chunk mask
  (``ctx_pos`` in ``attention_prefill_paged``) reconstruct as dead,
  so a partially matched page never needs scrubbing.

Eviction is LRU over refcount-zero *leaf* nodes (interior nodes become
leaves as their children go), wired into the :class:`PageAllocator`
free list: ``evict_for`` frees nodes until an allocation can proceed, so
the trie soaks up all pool headroom and gives it back under pressure.

The trie itself is pure host-side bookkeeping; the engine issues the
device-side page copies (``paged_cache.make_copy_page_fn``).
"""
from __future__ import annotations

import itertools
from typing import Iterable

import numpy as np

from .paged_cache import PageAllocator


class _Node:
    __slots__ = ("key", "pages", "parent", "children", "ref", "last_used")

    def __init__(self, key: tuple, pages: dict, parent: "_Node | None"):
        self.key = key                    # page_size token ids
        self.pages = pages                # {L: physical page id}
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.ref = 0                      # live adopters (eviction guard)
        self.last_used = 0


class PrefixCache:
    """Radix trie of cached prompt prefixes over a shared page pool."""

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page = page_size
        self.root = _Node((), {}, None)
        self._clock = itertools.count(1)
        # stats
        self.lookups = 0
        self.hits = 0                     # lookups that adopted >= 1 token
        self.tokens_hit = 0
        self.tokens_seen = 0

    # -- internals --------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        node.last_used = next(self._clock)

    def _chunks(self, prompt) -> list[tuple]:
        p = self.page
        return [tuple(int(t) for t in prompt[i:i + p])
                for i in range(0, len(prompt) - len(prompt) % p, p)]

    # -- lookup / lease ---------------------------------------------------

    def lookup(self, prompt) -> tuple[list[_Node], tuple[_Node, int] | None]:
        """Longest cached prefix of ``prompt``, capped at ``len - 1``
        tokens (the last prompt token is always recomputed — its logits
        are not cached).  Returns ``(full_nodes, partial)``: nodes whose
        whole page is adopted shared, plus an optional ``(node, t)``
        tail whose first ``t`` (< page_size) tokens match and whose page
        the engine must adopt by copy."""
        self.lookups += 1
        self.tokens_seen += len(prompt)
        max_adopt = len(prompt) - 1
        full: list[_Node] = []
        node = self.root
        matched = 0
        partial: tuple[_Node, int] | None = None
        for key in self._chunks(prompt):
            child = node.children.get(key)
            if child is not None and matched + self.page <= max_adopt:
                full.append(child)
                node = child
                matched += self.page
                continue
            # divergence (or cap): find the child sharing the longest
            # proper token prefix of this page
            best, best_t = None, 0
            cap = min(self.page, max_adopt - matched)
            cand = [child] if child is not None else node.children.values()
            for c in cand:
                t = 0
                for a, btok in zip(c.key, key):
                    if a != btok or t >= cap:
                        break
                    t += 1
                if t > best_t:
                    best, best_t = c, t
            if best is not None:
                partial = (best, best_t)
                matched += best_t
            break
        if matched:
            self.hits += 1
            self.tokens_hit += matched
        return full, partial

    def lease(self, nodes: Iterable[_Node]) -> None:
        """Take one reference on each node (eviction guard) and, per page
        class, on its physical page.  The page references are the
        adopter's — they are dropped through ``PageAllocator.free_slot``
        once the ids sit in the slot's table; node references are
        dropped with :meth:`release`."""
        for node in nodes:
            node.ref += 1
            for L, pid in node.pages.items():
                self.alloc.incref(L, pid)
            self._touch(node)

    def release(self, nodes: Iterable[_Node],
                drop_pages: bool = False) -> None:
        """Drop node references taken by :meth:`lease` (or by
        :meth:`insert` for newly created nodes).  ``drop_pages`` also
        drops the per-class page references — only for leases whose ids
        never made it into a slot table (the transient guard around an
        admission-time partial-page copy)."""
        for node in nodes:
            if node.ref <= 0:
                raise RuntimeError("prefix node over-released")
            node.ref -= 1
            if drop_pages:
                for L, pid in node.pages.items():
                    self.alloc.decref(L, pid)

    # -- insert -----------------------------------------------------------

    def insert(self, prompt, rows: dict[int, np.ndarray]
               ) -> tuple[list[_Node], list[int]]:
        """Publish a freshly prefilled prompt's full pages into the trie.
        ``rows``: the slot's physical page rows per class.  Only whole
        pages strictly before the page the slot writes next are shared
        (a trailing partial page stays private).  Every node on the path
        gets one ``ref`` held by the inserting slot (release at retire);
        newly created nodes additionally take a trie-owned reference on
        the slot's physical pages.  Returns ``(path_nodes,
        new_logical_idx)`` — the logical page indices that are now
        shared and must be copy-on-write protected for this slot."""
        node = self.root
        path: list[_Node] = []
        new_idx: list[int] = []
        for i, key in enumerate(self._chunks(prompt)):
            child = node.children.get(key)
            if child is None:
                pages = {L: int(r[i]) for L, r in rows.items()}
                child = _Node(key, pages, node)
                node.children[key] = child
                for L, pid in pages.items():
                    self.alloc.incref(L, pid)
                new_idx.append(i)
            child.ref += 1
            self._touch(child)
            path.append(child)
            node = child
        return path, new_idx

    # -- eviction ---------------------------------------------------------

    def _evictable(self) -> _Node | None:
        best = None
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is self.root or n.children or n.ref > 0:
                continue
            if best is None or n.last_used < best.last_used:
                best = n
        return best

    def evict_one(self) -> bool:
        """Drop the least-recently-used unreferenced leaf, returning its
        pages' trie references (pages still shared with a live slot stay
        allocated until that slot frees them)."""
        node = self._evictable()
        if node is None:
            return False
        del node.parent.children[node.key]
        for L, pid in node.pages.items():
            self.alloc.decref(L, pid)
        return True

    def evict_for(self, L: int, need: int) -> None:
        """Evict until class ``L`` has ``need`` free pages (or nothing is
        evictable — the subsequent allocation then fails loudly)."""
        while self.alloc.n_free(L) < need and self.evict_one():
            pass

    # -- stats ------------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            cur = stack.pop()
            n += len(cur.children)
            stack.extend(cur.children.values())
        return n

    @property
    def hit_rate(self) -> float:
        """Fraction of prompt tokens served from the cache."""
        return self.tokens_hit / self.tokens_seen if self.tokens_seen else 0.0
