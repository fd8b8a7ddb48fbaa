"""Model composition for serving (port of ``repro.models.transformer``).

Entry points (plain functions over a params dict):

  model_specs(cfg)                                  -> P-spec tree
  prefill(params, tokens, cfg, cache_len)           -> (last_logits, cache)
  decode_step(params, cache, tokens, pos, cfg)      -> (logits, cache)

Parameters of each block-group slot are stacked ``(n, ...)`` as in the JAX
package, so paths match its checkpoints; the port loops over the stack
(``for i in range(g.n)``) where JAX scans.  This slice carries the dense
self-attention kinds (``attn``, and ``local``/``swa`` windows through the
same code); every other layer kind raises ``NotImplementedError`` naming
the slice that brings it.
"""
from __future__ import annotations

from typing import Any

import torch

from ..kernels import ops as kops
from . import attention as attn
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, apply_rope, embed_specs,
                     embed_tokens, lm_logits, mlp_specs, norm_specs)

SELF_ATTN_KINDS = ("attn", "local", "swa")
_LATER = {
    "xattn": "slice 6 (rest of the zoo: xattn, vision)",
    "rwkv6": "slice 5 (recurrent mixers: rwkv6_scan)",
    "rglru": "slice 5 (recurrent mixers: rglru_scan)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what later slices of the port
    bring: MoE, frontends and non-self-attention layer kinds."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers come with slice 4 (moe_grouped_ffn)")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend comes with slice 6")
    for kind in set(cfg.layer_kinds):
        if kind not in SELF_ATTN_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} comes with "
                f"{_LATER.get(kind, 'a later slice')}")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, kind: str, stack: tuple[int, ...]) -> dict:
    return {"ln1": norm_specs(cfg, stack),
            "mix": attn.attn_specs(cfg, kind, stack),
            "ln2": norm_specs(cfg, stack),
            "ffn": mlp_specs(cfg, stack)}


def model_specs(cfg: ModelConfig) -> dict:
    cfg.validate()
    check_supported(cfg)
    specs: dict[str, Any] = dict(embed_specs(cfg))
    specs["groups"] = {
        f"g{gi}": {f"s{si}": _block_specs(cfg, kind, (g.n,))
                   for si, kind in enumerate(g.pattern)}
        for gi, g in enumerate(cfg.groups)}
    specs["final_norm"] = norm_specs(cfg)
    return specs


def _at(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``(n, ...)`` subtree (views, no copies)."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Prefill (forward + dense ring cache construction)
# ---------------------------------------------------------------------------

def _fill_kv(cfg: ModelConfig, kind: str, k: torch.Tensor, v: torch.Tensor,
             cache_len: int) -> dict:
    """Place full-sequence K/V (B,S,KV,hd) into a ring cache of length L,
    consistent with the decode-side slot = pos % L convention.  A prompt
    longer than the ring keeps its last L positions only."""
    B, S, KV, hd = k.shape
    L = cfg.kv_cache_len(kind, cache_len)
    Lp = min(L, S)
    pos = S - Lp + torch.arange(Lp, device=k.device)
    slots = torch.remainder(pos, L)
    buf_k = k.new_zeros((B, L, KV, hd))
    buf_v = v.new_zeros((B, L, KV, hd))
    buf_k[:, slots] = k[:, S - Lp:]
    buf_v[:, slots] = v[:, S - Lp:]
    return {"k": buf_k, "v": buf_v}


def _prefill_block(bp: dict, kind: str, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor,
                   cache_len: int) -> tuple[torch.Tensor, dict]:
    h = apply_norm(bp["ln1"], x, cfg)
    q, kk, vv = attn._qkv(bp["mix"], h, cfg)
    theta = attn._rope_theta(cfg, kind)
    q = apply_rope(q, positions, theta)
    kk = apply_rope(kk, positions, theta)
    window = cfg.window if kind in ("local", "swa") else 0
    o = kops.attention(q, kk, vv, causal=True, window=window)
    mix = o.reshape(o.shape[:-2] + (-1,)) @ bp["mix"]["wo"].to(x.dtype)
    c = _fill_kv(cfg, kind, kk, vv, cache_len)
    x = x + mix
    h2 = apply_norm(bp["ln2"], x, cfg)
    return x + apply_mlp(bp["ffn"], h2, cfg), c


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Process a prompt: tokens (B, S) -> (last-position logits (B, V) f32,
    dense ring cache {g: {s: {"k", "v": (n, B, L, KV, hd)}}})."""
    check_supported(cfg)
    B, S = tokens.shape
    cache_len = cache_len or S
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)

    cache: dict[str, Any] = {}
    for gi, g in enumerate(cfg.groups):
        gp = params["groups"][f"g{gi}"]
        per_layer: dict[str, list] = {f"s{si}": [] for si in
                                      range(len(g.pattern))}
        for i in range(g.n):
            for si, kind in enumerate(g.pattern):
                x, c = _prefill_block(_at(gp[f"s{si}"], i), kind, x, cfg,
                                      positions, cache_len)
                per_layer[f"s{si}"].append(c)
        cache[f"g{gi}"] = {
            skey: {name: torch.stack([c[name] for c in cs])
                   for name in ("k", "v")}
            for skey, cs in per_layer.items()}

    x = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return lm_logits(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_block(bp: dict, kind: str, x: torch.Tensor, c: dict,
                  cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    if "pk" not in c:
        raise NotImplementedError(
            "dense ring decode caches are not ported; decode through the "
            "paged cache (repro_torch.serve.paged_cache)")
    h = apply_norm(bp["ln1"], x, cfg)
    mix, _ = attn.attention_decode_paged(bp["mix"], h, c, cfg, kind, pos)
    x = x + mix
    h2 = apply_norm(bp["ln2"], x, cfg)
    return x + apply_mlp(bp["ffn"], h2, cfg)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One decode step against a paged cache.  tokens: (B, 1); pos: (B,)
    per-sequence positions (or a scalar for all rows).  Returns (logits
    (B, 1, V) f32, cache); the cache's pools are updated in place."""
    check_supported(cfg)
    x = embed_tokens(params, tokens, cfg)
    for gi, g in enumerate(cfg.groups):
        gp, gc = params["groups"][f"g{gi}"], cache[f"g{gi}"]
        for i in range(g.n):
            for si, kind in enumerate(g.pattern):
                x = _decode_block(_at(gp[f"s{si}"], i), kind, x,
                                  _at(gc[f"s{si}"], i), cfg, pos)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params, x, cfg), cache
