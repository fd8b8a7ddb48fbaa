"""Model composition (port of ``repro.models.transformer``).

Entry points (plain functions over a params dict):

  model_specs(cfg)                                  -> P-spec tree
  forward(params, tokens, cfg, remat)               -> logits   [train path]
  lm_loss(params, batch, cfg, remat)                -> (loss, metrics)
  prefill(params, tokens, cfg, cache_len)           -> (last_logits, cache)
  decode_step(params, cache, tokens, pos, cfg)      -> (logits, cache)
  prefill_chunk(params, cache, tokens, start, rows, carry, cfg, cache_len)
                                                    -> (logits, cache, carry)

Parameters of each block-group slot are stacked ``(n, ...)`` as in the JAX
package, so paths match its checkpoints; the port loops over the stack
where JAX scans, taking each layer's parameters (and caches) with one
``unbind`` per stacked leaf, so the training backward stacks the
per-layer gradients once instead of scattering each layer's into a zero
tensor of the whole stack.  The port carries the self-attention kinds
(``attn``, and ``local``/``swa`` windows through the same code) with a
dense or a mixture-of-experts FFN (``models/moe.py``), and the recurrent
blocks on the training path (``model_specs``, ``forward``, ``lm_loss``):
RWKV-6 (``models/rwkv6.py``: time mix and channel mix) and the Griffin
RG-LRU block (``models/rglru.py``, with a gated MLP) of recurrentgemma;
their serving path raises ``NotImplementedError`` naming the queue item
that brings it (``check_servable``).  Every other layer kind raises
naming the slice that brings it, and so does ``lm_loss`` on an MoE config
(MoE training is a later slice).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from . import attention as attn
from .config import RECURRENT_KINDS, ModelConfig
from .layers import (apply_mlp, apply_norm, apply_rope, embed_specs,
                     embed_tokens, lm_logits, mlp_specs, norm_specs)
from .moe import moe_ffn, moe_specs
from .rglru import rglru_fwd, rglru_specs
from .rwkv6 import chan_mix_fwd, rwkv6_specs, time_mix_fwd

SELF_ATTN_KINDS = ("attn", "local", "swa")
_LATER = {
    "xattn": "slice 7 (rest of the zoo: xattn, vision)",
}
RECURRENT_SERVING = (
    "ROADMAP queue A item 1 (recurrent serving: rwkv6's time_mix_decode and "
    "init_rwkv_state, rglru_decode and init_rglru_state, the chunk carries "
    "and the paged cache's recurrent rows)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what later slices of the port
    bring: frontends and the layer kinds not ported yet."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend comes with slice 7")
    for kind in set(cfg.layer_kinds):
        if kind not in SELF_ATTN_KINDS + RECURRENT_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} comes with "
                f"{_LATER.get(kind, 'a later slice')}")


def check_servable(cfg: ModelConfig) -> None:
    """``check_supported``, and the serving paths take attention layers
    only: RWKV-6 and the RG-LRU train, their stateful decode comes later."""
    check_supported(cfg)
    for kind in RECURRENT_KINDS:
        if kind in cfg.layer_kinds:
            raise NotImplementedError(
                f"{cfg.name}: serving layer kind {kind!r} comes with "
                f"{RECURRENT_SERVING}")


def check_trainable(cfg: ModelConfig) -> None:
    """The training path takes dense configs only: MoE training needs a
    backward of the grouped FFN kernel and the router's aux losses in the
    loss, which come with a later slice of the port."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE training (a moe_grouped_ffn backward and the "
            "router aux losses in lm_loss) comes with a later slice of the "
            "port; MoE models serve")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, kind: str, stack: tuple[int, ...]) -> dict:
    if kind == "rwkv6":
        both = rwkv6_specs(cfg, stack)
        return {"ln1": norm_specs(cfg, stack), "mix": both["time"],
                "ln2": norm_specs(cfg, stack), "ffn": both["chan"]}
    ffn = (moe_specs(cfg, stack) if cfg.is_moe and kind != "xattn"
           else mlp_specs(cfg, stack))
    mix = (rglru_specs(cfg, stack) if kind == "rglru"
           else attn.attn_specs(cfg, kind, stack))
    return {"ln1": norm_specs(cfg, stack),
            "mix": mix,
            "ln2": norm_specs(cfg, stack),
            "ffn": ffn}


def _apply_ffn(bp: dict, kind: str, h: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """The block's FFN, as JAX's ``_apply_ffn``; the MoE router's aux
    losses are dropped (they only enter the training loss)."""
    if kind == "rwkv6":
        return chan_mix_fwd(bp["ffn"], h, cfg)
    if cfg.is_moe and kind != "xattn":
        return moe_ffn(bp["ffn"], h, cfg)[0]
    return apply_mlp(bp["ffn"], h, cfg)


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


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked ``(n, ...)`` subtree, one ``unbind``
    per leaf (views, no copies)."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Train forward and loss
# ---------------------------------------------------------------------------

def _apply_block(bp: dict, kind: str, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    h = apply_norm(bp["ln1"], x, cfg)
    if kind == "rwkv6":
        x = x + time_mix_fwd(bp["mix"], h, cfg)
    elif kind == "rglru":
        x = x + rglru_fwd(bp["mix"], h, cfg)
    else:
        x = x + attn.attention_fwd(bp["mix"], h, cfg, kind, positions)
    h2 = apply_norm(bp["ln2"], x, cfg)
    return x + _apply_ffn(bp, kind, h2, cfg)


def _remat_wrap(fn, remat: str):
    """``none`` keeps every activation; ``full`` recomputes each layer's in
    the backward (``jax.checkpoint`` of the JAX package's scan body)."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        raise NotImplementedError(
            "remat 'dots' (keep the matmul outputs, recompute the rest) "
            "comes with a later slice of the port")
    raise ValueError(f"unknown remat policy {remat!r}")


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            remat: str = "none") -> torch.Tensor:
    """Full-sequence forward.  tokens: (B, S) int -> logits (B, S, V) f32."""
    check_supported(cfg)
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for gi, g in enumerate(cfg.groups):

        def body(xc, slot_params, _g=g):
            for si, kind in enumerate(_g.pattern):
                xc = _apply_block(slot_params[f"s{si}"], kind, xc, cfg,
                                  positions)
            return xc

        layer = _remat_wrap(body, remat)
        for lp in _unstack(params["groups"][f"g{gi}"], g.n):
            x = layer(x, lp)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params, x, cfg)


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            remat: str = "none") -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy.  batch: tokens (B,S), labels (B,S), mask
    (B,S).  The label logit is picked with ``gather`` where the JAX package
    sums against a one-hot: both are exact in f32, every other term being
    0.  Dense models have no router losses, so the total is the loss; MoE
    configs raise (``check_trainable``)."""
    check_trainable(cfg)
    logits = forward(params, batch["tokens"], cfg, remat=remat).float()
    lse = torch.logsumexp(logits, dim=-1)                       # (B, S)
    correct = torch.gather(logits, -1,
                           batch["labels"].long()[..., None])[..., 0]
    nll = lse - correct
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics = {"loss": loss, "total_loss": loss, "lb_loss": zero,
               "router_entropy": zero}
    return loss, metrics


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
    return x + _apply_ffn(bp, kind, h2, cfg), c


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Process a prompt: tokens (B, S) -> (last-position logits (B, V) f32,
    dense ring cache {g: {s: {"k", "v": (n, B, L, KV, hd)}}})."""
    check_servable(cfg)
    B, S = tokens.shape
    cache_len = cache_len or S
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)

    cache: dict[str, Any] = {}
    for gi, g in enumerate(cfg.groups):
        gp = params["groups"][f"g{gi}"]
        per_layer: dict[str, list] = {f"s{si}": [] for si in
                                      range(len(g.pattern))}
        for lp in _unstack(gp, g.n):
            for si, kind in enumerate(g.pattern):
                x, c = _prefill_block(lp[f"s{si}"], kind, x, cfg,
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
    return x + _apply_ffn(bp, kind, h2, cfg)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One decode step against a paged cache.  tokens: (B, 1); pos: (B,)
    per-sequence positions (or a scalar for all rows).  Returns (logits
    (B, 1, V) f32, cache); the cache's pools are updated in place."""
    check_servable(cfg)
    x = embed_tokens(params, tokens, cfg)
    for gi, g in enumerate(cfg.groups):
        gp, gc = params["groups"][f"g{gi}"], cache[f"g{gi}"]
        for lp, lc in zip(_unstack(gp, g.n), _unstack(gc, g.n)):
            for si, kind in enumerate(g.pattern):
                x = _decode_block(lp[f"s{si}"], kind, x, lc[f"s{si}"], cfg,
                                  pos)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Chunked prefill (repro_torch.serve): one prompt chunk against the paged cache
# ---------------------------------------------------------------------------

def init_chunk_carry(cfg: ModelConfig) -> dict:
    """Per-slot recurrent carry for chunked prefill (B=1 per prefilling
    sequence), in the JAX package's tree shape.  Attention layers carry
    nothing — their state lives in the page pools — and they are the only
    kinds served (``check_servable``), so every leaf is empty here; the
    recurrent kinds' carries come with rwkv6 serving."""
    check_servable(cfg)
    return {f"g{gi}": {f"s{si}": {} for si in range(len(g.pattern))}
            for gi, g in enumerate(cfg.groups)}


def _chunk_block(bp: dict, kind: str, x: torch.Tensor, c: dict,
                 cfg: ModelConfig, rows: dict, start: int, cache_len: int,
                 pos: dict) -> torch.Tensor:
    h = apply_norm(bp["ln1"], x, cfg)
    L = cfg.kv_cache_len(kind, cache_len)
    tmp = {"pk": c["pk"], "pv": c["pv"], "pt": rows[L][None]}
    if L not in pos:                    # once per chunk and page class
        pos[L] = attn.chunk_positions(start, x.shape[1], tmp["pt"],
                                      c["pk"].shape[1])
    mix, _ = attn.attention_prefill_paged(bp["mix"], h, tmp, cfg, kind,
                                          start, pos[L])
    x = x + mix
    h2 = apply_norm(bp["ln2"], x, cfg)
    return x + _apply_ffn(bp, kind, h2, cfg)


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                  start: int, rows: dict, carry: dict, cfg: ModelConfig,
                  cache_len: int) -> tuple[torch.Tensor, dict, dict]:
    """Process one prompt chunk of an in-flight prefill against the paged
    cache.  tokens: (1, C) at absolute positions start..start+C-1; rows:
    {L: (n_pp,) int32 tensor} the slot's physical pages per page class
    (the batch page table stays on the junk page until activation, so
    decode steps interleave freely); carry: ``init_chunk_carry`` tree,
    returned as it came (attention layers carry nothing).  The chunk's K/V
    are written into the pools in place.  Returns (last-position logits
    (1, V) f32, cache, carry)."""
    check_servable(cfg)
    x = embed_tokens(params, tokens, cfg)
    pos: dict = {}
    for gi, g in enumerate(cfg.groups):
        gp, gc = params["groups"][f"g{gi}"], cache[f"g{gi}"]
        for lp, lc in zip(_unstack(gp, g.n), _unstack(gc, g.n)):
            for si, kind in enumerate(g.pattern):
                x = _chunk_block(lp[f"s{si}"], kind, x, lc[f"s{si}"], cfg,
                                 rows, start, cache_len, pos)
    x = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return lm_logits(params, x, cfg)[:, 0], cache, carry
