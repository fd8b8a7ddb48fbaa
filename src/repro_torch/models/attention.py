"""Self-attention with GQA, sliding windows, RoPE and a paged KV cache
(port of the serving half of ``repro.models.attention``).

The softmax path dispatches through :mod:`repro_torch.kernels.ops`, so the
CUDA kernels and their plain versions share one call site.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import apply_rope, rmsnorm
from .paramlib import P


def attn_specs(cfg: ModelConfig, kind: str,
               stack: tuple[int, ...] = ()) -> dict:
    lead = ("layers",) * len(stack)
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    specs = {
        "wq": P(stack + (d, nq * hd), lead + ("embed", "heads")),
        "wk": P(stack + (d, nkv * hd), lead + ("embed", "kv_heads")),
        "wv": P(stack + (d, nkv * hd), lead + ("embed", "kv_heads")),
        "wo": P(stack + (nq * hd, d), lead + ("heads", "embed")),
    }
    if kind == "xattn":
        specs["gate"] = P(stack + (1,), lead + (None,), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = P(stack + (hd,), lead + (None,), init="ones")
        specs["k_norm"] = P(stack + (hd,), lead + (None,), init="ones")
    return specs


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def _rope_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "attn" and cfg.rope_theta_global is not None:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    q = _split_heads(x @ params["wq"].to(dt), cfg.n_heads, cfg.hd)
    k = _split_heads(x @ params["wk"].to(dt), cfg.n_kv_heads, cfg.hd)
    v = _split_heads(x @ params["wv"].to(dt), cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    return q, k, v


def _ring_valid(pos: torch.Tensor, L: int, cfg: ModelConfig,
                kind: str) -> torch.Tensor:
    """Live-slot mask of a ring cache: entry at index i holds absolute
    position p with p % L == i, p <= pos, p > pos - L.  pos: scalar -> (L,);
    pos: (B,) -> (B, L).  ``torch.remainder`` is the floor modulo of
    ``jnp.mod``; ``pos - idx`` is negative for the slots ahead of pos."""
    idx = torch.arange(L, device=pos.device)
    if pos.ndim:
        pos = pos[:, None]
    abs_pos = pos - torch.remainder(pos - idx, L)
    valid = (abs_pos >= 0) & (abs_pos >= pos - (L - 1))
    if kind in ("local", "swa") and cfg.window:
        valid &= abs_pos > pos - cfg.window
    return valid


def attention_decode_paged(params: dict, x: torch.Tensor, cache: dict,
                           cfg: ModelConfig, kind: str,
                           pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode against a paged KV cache
    (:mod:`repro_torch.serve.paged_cache`).

    cache: {"pk", "pv": (P, page, KV, hd) page pools shared by all
    sequence slots, "pt": (B, n_pp) int32 page table}.  pos: (B,)
    per-sequence positions (idle slots sit at pos 0 with their tables on
    the junk page, so their write lands there).  The new K/V entry is
    written into the pools **in place** (``index_put_``); the returned
    cache is the same dict.  Idle rows all write pos 0 of the junk page:
    duplicate indices there are harmless, nothing reads junk content.
    """
    q, k_new, v_new = _qkv(params, x, cfg)
    theta = _rope_theta(cfg, kind)
    B = x.shape[0]
    posb = pos.expand(B) if pos.ndim == 0 else pos
    q = apply_rope(q, posb[:, None], theta)
    k_new = apply_rope(k_new, posb[:, None], theta)

    pk, pv, pt = cache["pk"], cache["pv"], cache["pt"]
    page = pk.shape[1]
    L = pt.shape[1] * page
    slot = torch.remainder(posb.long(), L)                       # (B,)
    phys = torch.gather(pt, 1, (slot // page)[:, None])[:, 0].long()
    off = slot % page
    pk.index_put_((phys, off), k_new[:, 0].to(pk.dtype))
    pv.index_put_((phys, off), v_new[:, 0].to(pv.dtype))

    k = kops.page_gather(pk, pt)                                 # (B, L, KV, hd)
    v = kops.page_gather(pv, pt)
    valid = _ring_valid(posb, L, cfg, kind)
    out = kops.attention_decode(q, k, v, valid)
    out = _merge_heads(out) @ params["wo"].to(x.dtype)
    return out, cache
