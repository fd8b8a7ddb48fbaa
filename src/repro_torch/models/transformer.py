"""Model composition (port of ``repro.models.transformer``).

Entry points (plain functions over a params dict):

  model_specs(cfg)                                  -> P-spec tree
  forward(params, tokens, cfg, remat, media, act_specs)
                                                    -> logits   [train path]
  lm_loss(params, batch, cfg, remat, act_specs)     -> (loss, metrics)
  prefill(params, tokens, cfg, cache_len, remat, media, act_specs)
                                                    -> (last_logits, cache)
  init_cache(cfg, batch, cache_len, device)         -> dense cache
  cache_axes(cfg)                                   -> its logical axes
  decode_step(params, cache, tokens, pos, cfg, media, act_specs)
                                                    -> (logits, cache)
  prefill_chunk(params, cache, tokens, start, rows, carry, cfg, cache_len,
                media, act_specs)                   -> (logits, cache, carry)

Parameters of each block-group slot are stacked ``(n, ...)`` as in the JAX
package, so paths match its checkpoints; the port loops over the stack
where JAX scans, taking each layer's parameters (and caches) with one
``unbind`` per stacked leaf, so the training backward stacks the
per-layer gradients once instead of scattering each layer's into a zero
tensor of the whole stack.  The port carries every layer kind of the
JAX package: the self-attention kinds (``attn``, and ``local``/``swa``
windows through the same code) with a dense or a mixture-of-experts FFN
(``models/moe.py``); the vision model's ``xattn`` (tanh-gated
cross-attention to the media, always with a dense FFN), whose ``media``
(B, N, d_frontend) every entry point projects once a call through
``frontend_proj`` and which keeps no cache; and the recurrent blocks:
RWKV-6 (``models/rwkv6.py``: time mix and channel mix) and the
Griffin RG-LRU block (``models/rglru.py``, with a gated MLP) of
recurrentgemma, on the training and the serving paths.  A recurrent
layer's serving cache is its state, one dense row per sequence slot
(rwkv6: ``S``, ``x_last``, ``cx_last``; rglru: ``h``, ``conv``), written
in place by ``decode_step``; ``prefill_chunk`` carries it outside the
cache (``init_chunk_carry``) until the slot goes live.  ``decode_step``
serves either cache: the dense one (``prefill``'s or ``init_cache``'s:
each attention layer a ring {"k", "v"}, read by ``decode_attention`` in
the JAX package's own form) or the paged one
(``repro_torch.serve.paged_cache``).  The audio frontend is a stub, as
in JAX: its inputs are codebook ids, taken as tokens.  The training forward
carries the MoE router's aux losses (summed over the layers, as JAX's
``_merge_aux``) into ``lm_loss``'s total; the serving paths drop them.
Remat ``none`` keeps every activation, ``full`` recomputes each layer in
the backward and ``dots`` keeps only the outputs of the products with no
batch dimensions (JAX's ``dots_with_no_batch_dims_saveable``);
``REPRO_CHUNKED_CE=1`` computes the loss over sequence chunks whose
logits the backward recomputes (JAX's ``_lm_loss_chunked``).

The entry points also run on DTensor parameters and inputs (the sharded
steps of ``launch/steps.py``): ``act_specs`` ({"act", "logits": DTensor
placements}) lays the residual stream and the logits out at JAX's
``with_sharding_constraint`` points, tensors made inside the model are
replicated on the mesh (``device.on_mesh_of``), parameters are gathered
over the batch's mesh dims where they are used (``device.param_for``),
sublayer outputs take the residual stream's layout (:func:`_residual`),
and the cross entropy of vocab-split logits takes JAX's one-hot sum.  On
plain tensors all of this is the identity: the bits do not change.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import on_mesh_of, param_for, resolve_device
from ..kernels import ops as kops
from ..trace import span
from . import attention as attn
from .config import RECURRENT_KINDS, ModelConfig
from .layers import (apply_mlp, apply_norm, apply_rope, embed_specs,
                     embed_tokens, lm_logits, mlp_specs, norm_specs)
from .moe import moe_ffn, moe_specs
from .paramlib import P
from .rglru import (init_rglru_state, rglru_decode, rglru_fwd, rglru_specs,
                    rglru_state_axes)
from .rwkv6 import (chan_mix_fwd, init_rwkv_state, rwkv6_specs,
                    rwkv_state_axes, time_mix_decode, time_mix_fwd)

SELF_ATTN_KINDS = ("attn", "local", "swa")


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


AUX_ZERO = {"lb_loss": 0.0, "z_loss": 0.0, "router_entropy": 0.0}


def _apply_ffn(bp: dict, kind: str, h: torch.Tensor,
               cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """The block's FFN and its aux losses, as JAX's ``_apply_ffn``: the MoE
    router's {lb_loss, z_loss, router_entropy} (f32 scalars), Python zeros
    for the others (no device work on a dense path)."""
    if kind == "rwkv6":
        return chan_mix_fwd(bp["ffn"], h, cfg), dict(AUX_ZERO)
    if cfg.is_moe and kind != "xattn":
        return moe_ffn(bp["ffn"], h, cfg)
    return apply_mlp(bp["ffn"], h, cfg), dict(AUX_ZERO)


def model_specs(cfg: ModelConfig) -> dict:
    cfg.validate()
    specs: dict[str, Any] = dict(embed_specs(cfg))
    if cfg.frontend == "vision":
        specs["frontend_proj"] = P((cfg.d_frontend, cfg.d_model),
                                   (None, "embed"))
    specs["groups"] = {
        f"g{gi}": {f"s{si}": _block_specs(cfg, kind, (g.n,))
                   for si, kind in enumerate(g.pattern)}
        for gi, g in enumerate(cfg.groups)}
    specs["final_norm"] = norm_specs(cfg)
    return specs


def _project_media(params: dict, media: torch.Tensor | None,
                   cfg: ModelConfig) -> torch.Tensor | None:
    """The vision model's media (B, N, d_frontend) in the model width
    (B, N, d), once a call as JAX does; None for the other frontends.
    Sharded media keep their batch split (``device.param_for``)."""
    if cfg.frontend != "vision":
        return None
    if media is None:
        raise ValueError(f"{cfg.name}: the vision frontend needs media "
                         f"(B, {cfg.n_frontend_tokens}, {cfg.d_frontend})")
    media = media.to(cfg.dtype)
    return media @ param_for(params["frontend_proj"], cfg.dtype, media)


def _wsc(x: torch.Tensor, act_specs: dict | None,
         name: str) -> torch.Tensor:
    """JAX's activation sharding constraint: a DTensor redistributed to
    the placements ``act_specs[name]`` on its mesh; a plain tensor, or a
    name without a spec, as it is."""
    if act_specs and name in act_specs and isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, act_specs[name])
    return x


def _residual(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """x + f.  On the sharded path a sublayer's output (often partial sums
    over ``model`` after a row-split product) is first laid out as the
    residual stream x (Megatron's all-reduce): otherwise DTensor would
    carry the partial sums into the next norm and products and gather
    weights there instead of reducing once."""
    if isinstance(f, DTensor) and isinstance(x, DTensor) \
            and f.placements != x.placements:
        f = f.redistribute(x.device_mesh, x.placements)
    return x + f


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked ``(n, ...)`` subtree, one ``unbind``
    per leaf (views, no copies)."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Train forward and loss
# ---------------------------------------------------------------------------

def _normed(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``apply_norm`` inside the training path's ``model.norm`` span."""
    with span("model.norm"):
        return apply_norm(p, x, cfg)


def _apply_block(bp: dict, kind: str, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor | None,
                 media: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, dict]:
    h = _normed(bp["ln1"], x, cfg)
    if kind == "rwkv6":
        x = _residual(x, time_mix_fwd(bp["mix"], h, cfg))
    elif kind == "rglru":
        x = _residual(x, rglru_fwd(bp["mix"], h, cfg))
    else:
        with span("model.attn"):
            f = (attn.cross_attention_fwd(bp["mix"], h, media, cfg)
                 if kind == "xattn" else
                 attn.attention_fwd(bp["mix"], h, cfg, kind, positions))
        x = _residual(x, f)
    h2 = _normed(bp["ln2"], x, cfg)
    with span("model.mlp"):
        f, aux = _apply_ffn(bp, kind, h2, cfg)
    return _residual(x, f), aux


def save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of remat ``dots``, JAX's
    ``dots_with_no_batch_dims_saveable``: keep the output of every product
    with no batch dimensions and recompute everything else, every custom
    ``autograd.Function`` included (flash, the MoE grouped FFN, WKV,
    RG-LRU: ``pallas_call`` outputs or batched einsums in JAX).  Such a
    product is ``aten.mm``: ``x @ W`` with a 3-D ``x`` folds into one
    whenever ``W`` requires grad, as every parameter does under training;
    the batched products (the plain attention's, the plain grouped FFN's
    einsums) lower to ``aten.bmm``.  The MoE router is written as ``@``
    for that reason: its einsum would lower to ``bmm``."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, remat: str):
    """``none`` keeps every activation; ``full`` recomputes each layer's in
    the backward (``jax.checkpoint`` of the JAX package's scan body);
    ``dots`` keeps what :func:`save_dots` keeps and recomputes the rest.
    Under ``full`` and ``dots`` every forward kernel of the layer launches
    a second time in the backward."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=partial(create_selective_checkpoint_contexts,
                               save_dots))
    raise ValueError(f"unknown remat policy {remat!r}")


def _forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    remat: str = "none", media: torch.Tensor | None = None,
                    act_specs: dict | None = None
                    ) -> tuple[torch.Tensor, dict]:
    """The forward up to the final norm (JAX's ``_forward_hidden``):
    (hidden (B, S, d), the FFNs' aux losses summed over the layers in
    layer order; Python zeros for a model without MoE layers)."""
    B, S = tokens.shape
    x = _wsc(embed_tokens(params, tokens, cfg), act_specs, "act")
    media = _project_media(params, media, cfg)
    positions = on_mesh_of(torch.arange(S, device=tokens.device)
                           .expand(B, S), x)
    aux = dict(AUX_ZERO)
    for gi, g in enumerate(cfg.groups):

        def body(xc, auxc, slot_params, _g=g):
            # inside the remat wrapper, so a recomputed layer opens its
            # spans again, within the backward
            with span("model.layer"):
                xc = _wsc(xc, act_specs, "act")
                for si, kind in enumerate(_g.pattern):
                    xc, a = _apply_block(slot_params[f"s{si}"], kind, xc,
                                         cfg, positions, media)
                    auxc = {k: auxc[k] + a[k] for k in AUX_ZERO}
                return xc, auxc

        layer = _remat_wrap(body, remat)
        for lp in _unstack(params["groups"][f"g{gi}"], g.n):
            x, aux = layer(x, aux, lp)
    return x, aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            remat: str = "none", media: torch.Tensor | None = None,
            act_specs: dict | None = None) -> torch.Tensor:
    """Full-sequence forward.  tokens: (B, S) int -> logits (B, S, V) f32;
    media: the vision model's (B, N, d_frontend) frontend tokens."""
    x, _ = _forward_hidden(params, tokens, cfg, remat, media, act_specs)
    return _wsc(lm_logits(params, apply_norm(params["final_norm"], x, cfg),
                          cfg), act_specs, "logits")


def _nll(params: dict, x: torch.Tensor, labels: torch.Tensor,
         cfg: ModelConfig, act_specs: dict | None = None) -> torch.Tensor:
    """Per-token cross entropy of the normed hidden x (B, S, d) against
    labels (B, S).  The label logit is picked with ``gather`` where the
    JAX package sums against a one-hot: both are exact in f32, every other
    term being 0.  Sharded logits (DTensors, their vocab split over
    ``model``) take JAX's one-hot sum, in the logits' layout."""
    with span("model.head"):
        logits = _wsc(lm_logits(params, x, cfg).float(), act_specs,
                      "logits")
        lse = torch.logsumexp(logits, dim=-1)                   # (B, S)
        if isinstance(logits, DTensor):
            vocab = on_mesh_of(torch.arange(logits.shape[-1],
                                            device=labels.device), labels)
            onehot = _wsc((labels[..., None] == vocab).float(), act_specs,
                          "logits")
            correct = torch.sum(logits * onehot, dim=-1)
        else:
            correct = torch.gather(logits, -1,
                                   labels.long()[..., None])[..., 0]
        return lse - correct


def _chunk_sums(params: dict, x: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, cfg: ModelConfig,
                act_specs: dict | None) -> tuple[torch.Tensor, torch.Tensor]:
    nll = _nll(params, x, labels, cfg, act_specs)
    return torch.sum(nll * mask), torch.sum(mask)


def _lm_loss_chunked(params: dict, batch: dict, cfg: ModelConfig,
                     remat: str, act_specs: dict | None = None,
                     n_chunks: int = 8) -> tuple[torch.Tensor, dict]:
    """``lm_loss`` over sequence chunks (JAX's ``_lm_loss_chunked``): the
    chunk count is ``min(n_chunks, S)`` stepped down until it divides S;
    each chunk's (B, c, V) logits, log-sum-exp and masked sums run inside
    a checkpoint, so autograd keeps none of its logits and the backward
    recomputes them a chunk at a time.  (total, count) add up in f32 in
    chunk order."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    hidden, aux = _forward_hidden(params, tokens, cfg, remat,
                                  batch.get("media"), act_specs)
    x = _normed(params["final_norm"], hidden, cfg)
    mask = batch.get("mask")
    mask = (torch.ones_like(tokens, dtype=torch.float32)
            if mask is None else mask.float())
    n_chunks = min(n_chunks, S)
    while S % n_chunks:
        n_chunks -= 1
    c = S // n_chunks
    tot = on_mesh_of(torch.zeros((), dtype=torch.float32,
                                 device=tokens.device), x)
    cnt = on_mesh_of(torch.zeros((), dtype=torch.float32,
                                 device=tokens.device), x)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        t, n = checkpoint(_chunk_sums, params, x[:, sl],
                          batch["labels"][:, sl], mask[:, sl], cfg,
                          act_specs, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return _with_router_losses(tot / torch.clamp(cnt, min=1.0), aux, cfg)


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            remat: str = "none",
            act_specs: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy plus the MoE router's losses, as JAX's
    ``lm_loss``: returns (total, {loss, total_loss, lb_loss,
    router_entropy}), total = loss + router_aux_coef * lb / n_moe +
    router_z_coef * z / n_moe (the layer sums over the MoE layer count;
    dense models: zeros, total == loss).  batch: tokens (B,S), labels
    (B,S), mask (B,S), and the vision model's media (B, N, d_frontend).
    ``REPRO_CHUNKED_CE=1``, read at each call as JAX
    reads it, takes the chunked path (:func:`_lm_loss_chunked`)."""
    if os.environ.get("REPRO_CHUNKED_CE") == "1":
        return _lm_loss_chunked(params, batch, cfg, remat, act_specs)
    hidden, aux = _forward_hidden(params, batch["tokens"], cfg, remat,
                                  batch.get("media"), act_specs)
    nll = _nll(params, _normed(params["final_norm"], hidden, cfg),
               batch["labels"], cfg, act_specs)
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return _with_router_losses(loss, aux, cfg)


def _with_router_losses(loss: torch.Tensor, aux: dict,
                        cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """(total, metrics) of ``lm_loss`` from the cross entropy and the
    layers' summed aux losses."""
    if not cfg.is_moe:              # JAX's total is loss + 0 * 0: loss
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"loss": loss, "total_loss": loss, "lb_loss": zero,
                      "router_entropy": zero}
    n_moe = sum(1 for k in cfg.layer_kinds if k != "xattn")
    total = (loss + cfg.router_aux_coef * aux["lb_loss"] / n_moe
             + cfg.router_z_coef * aux["z_loss"] / n_moe)
    metrics = {"loss": loss, "total_loss": total,
               "lb_loss": aux["lb_loss"] / n_moe,
               "router_entropy": aux["router_entropy"] / n_moe}
    return total, metrics


# ---------------------------------------------------------------------------
# Recurrent layers on the serving paths
# ---------------------------------------------------------------------------

def init_recurrent_state(cfg: ModelConfig, kind: str, batch: int,
                         stack: tuple[int, ...] = (),
                         device: str | torch.device = "cpu") -> dict:
    """The zero serving state of a recurrent layer kind: rwkv6's {"S",
    "x_last", "cx_last"}, rglru's {"h", "conv"}, each stack + (batch,
    ...)."""
    init = init_rwkv_state if kind == "rwkv6" else init_rglru_state
    return init(cfg, batch, stack, device)


def _recurrent_block(bp: dict, kind: str, x: torch.Tensor, state: dict,
                     cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """A recurrent layer over x (B, T, d) from its serving state: a
    prompt from the zero state (prefill), a chunk from the carry, a decode
    step from the cache rows.  Returns (x, the state after the last
    token, new tensors)."""
    h = apply_norm(bp["ln1"], x, cfg)
    if kind == "rwkv6":
        mix, new = time_mix_decode(bp["mix"], h, state, cfg)
    else:
        mix, new = rglru_decode(bp["mix"], h, state, cfg)
    x = _residual(x, mix)
    h2 = apply_norm(bp["ln2"], x, cfg)
    if kind == "rwkv6":
        f = chan_mix_fwd(bp["ffn"], h2, cfg, x_last=state["cx_last"])
        new["cx_last"] = h2[:, -1]
    else:
        f = _apply_ffn(bp, kind, h2, cfg)[0]
    return _residual(x, f), new


# ---------------------------------------------------------------------------
# Prefill (forward + dense ring cache construction)
# ---------------------------------------------------------------------------

def _zeros_as(t: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Zeros of ``shape`` in t's dtype and device and, for a DTensor, in
    its layout (``new_zeros`` would replicate them)."""
    z = t.new_zeros(shape)
    if isinstance(t, DTensor):
        z = z.redistribute(t.device_mesh, t.placements)
    return z


def _rows_as(state: dict, x: torch.Tensor) -> dict:
    """A state made inside the model (batch first) with its rows split
    as x's batch when x is a DTensor; as it is otherwise."""
    if not isinstance(x, DTensor):
        return state
    mesh = x.device_mesh
    rows = [p if p == Shard(0) else Replicate() for p in x.placements]
    return {k: on_mesh_of(t, x).redistribute(mesh, rows)
            for k, t in state.items()}


def _fill_kv(cfg: ModelConfig, kind: str, k: torch.Tensor, v: torch.Tensor,
             cache_len: int) -> dict:
    """Place full-sequence K/V (B,S,KV,hd) into a ring cache of length L,
    consistent with the decode-side slot = pos % L convention.  A prompt
    longer than the ring keeps its last L positions only."""
    B, S, KV, hd = k.shape
    L = cfg.kv_cache_len(kind, cache_len)
    Lp = min(L, S)
    pos = S - Lp + torch.arange(Lp, device=k.device)
    slots = on_mesh_of(torch.remainder(pos, L), k)
    buf_k = _zeros_as(k, (B, L, KV, hd))
    buf_v = _zeros_as(v, (B, L, KV, hd))
    buf_k[:, slots] = k[:, S - Lp:]
    buf_v[:, slots] = v[:, S - Lp:]
    return {"k": buf_k, "v": buf_v}


def _prefill_block(bp: dict, kind: str, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, cache_len: int,
                   media: torch.Tensor | None) -> tuple[torch.Tensor, dict]:
    """One layer of the whole-prompt prefill and its serving cache: the
    ring's K/V for attention; for a recurrence, its state after the prompt
    (run from the zero state through its stateful form, as in the JAX
    package); nothing for ``xattn``."""
    if kind in RECURRENT_KINDS:
        zero = init_recurrent_state(cfg, kind, x.shape[0], device=x.device)
        return _recurrent_block(bp, kind, x, _rows_as(zero, x), cfg)
    if kind == "xattn":
        return _apply_block(bp, kind, x, cfg, positions, media)[0], {}
    h = apply_norm(bp["ln1"], x, cfg)
    q, kk, vv = attn._qkv(bp["mix"], h, cfg)
    theta = attn._rope_theta(cfg, kind)
    q = apply_rope(q, positions, theta)
    kk = apply_rope(kk, positions, theta)
    window = cfg.window if kind in ("local", "swa") else 0
    o = kops.attention(q, kk, vv, causal=True, window=window)
    mix = o.reshape(o.shape[:-2] + (-1,)) @ param_for(bp["mix"]["wo"],
                                                      x.dtype, x)
    c = _fill_kv(cfg, kind, kk, vv, cache_len)
    x = _residual(x, mix)
    h2 = apply_norm(bp["ln2"], x, cfg)
    return _residual(x, _apply_ffn(bp, kind, h2, cfg)[0]), c


def _stack_layers(per_layer: dict[str, list[dict]]) -> dict:
    """{slot: [layer dicts]} -> {slot: {name: (n, ...) stacked}}."""
    return {skey: {name: torch.stack([c[name] for c in cs])
                   for name in cs[0]}
            for skey, cs in per_layer.items()}


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            cache_len: int | None = None, remat: str = "none",
            media: torch.Tensor | None = None,
            act_specs: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Process a prompt: tokens (B, S) -> (last-position logits (B, V) f32,
    dense cache {g: {s: stacked (n, B, ...) leaves}}: the ring's "k", "v"
    (n, B, L, KV, hd) for attention, "S", "x_last", "cx_last" for rwkv6,
    "h", "conv" for rglru, {} for xattn).  ``remat`` wraps each layer as
    the training forward does (it matters only under autograd)."""
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _wsc(embed_tokens(params, tokens, cfg), act_specs, "act")
    media = _project_media(params, media, cfg)
    positions = on_mesh_of(torch.arange(S, device=tokens.device)
                           .expand(B, S), x)

    cache: dict[str, Any] = {}
    for gi, g in enumerate(cfg.groups):

        def body(xc, slot_params, _g=g):
            xc = _wsc(xc, act_specs, "act")
            cs = {}
            for si, kind in enumerate(_g.pattern):
                xc, cs[f"s{si}"] = _prefill_block(
                    slot_params[f"s{si}"], kind, xc, cfg, positions,
                    cache_len, media)
            return xc, cs

        layer = _remat_wrap(body, remat)
        per_layer: dict[str, list] = {f"s{si}": [] for si in
                                      range(len(g.pattern))}
        for lp in _unstack(params["groups"][f"g{gi}"], g.n):
            x, cs = layer(x, lp)
            for skey, c in cs.items():
                per_layer[skey].append(c)
        cache[f"g{gi}"] = _stack_layers(per_layer)

    x = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return lm_logits(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Dense cache and decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: str | torch.device | None = None) -> dict:
    """The zero dense cache, in the JAX package's ``init_cache`` tree
    {g: {s: stacked (n, B, ...) leaves}}: an attention slot's ring
    (``attention.init_kv_cache``, L = ``cfg.kv_cache_len(kind,
    cache_len)``), a recurrent slot's rows (``init_recurrent_state``), on
    ``device`` (default ``cuda``); an ``xattn`` slot keeps nothing (its
    media are re-derived every step)."""
    dev = resolve_device(device)

    def slot(kind: str, n: int) -> dict:
        if kind in RECURRENT_KINDS:
            return init_recurrent_state(cfg, kind, batch, (n,), dev)
        if kind == "xattn":
            return {}
        return attn.init_kv_cache(cfg, kind, batch,
                                  cfg.kv_cache_len(kind, cache_len), (n,),
                                  dev)

    return {f"g{gi}": {f"s{si}": slot(kind, g.n)
                       for si, kind in enumerate(g.pattern)}
            for gi, g in enumerate(cfg.groups)}


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes of ``init_cache``'s tree, for the sharding rules."""
    def slot(kind: str) -> dict:
        if kind == "rwkv6":
            return rwkv_state_axes(1)
        if kind == "rglru":
            return rglru_state_axes(1)
        if kind == "xattn":
            return {}
        return attn.kv_cache_axes(kind, 1)

    return {f"g{gi}": {f"s{si}": slot(kind)
                       for si, kind in enumerate(g.pattern)}
            for gi, g in enumerate(cfg.groups)}


def _decode_block(bp: dict, kind: str, x: torch.Tensor, c: dict,
                  cfg: ModelConfig, pos: torch.Tensor,
                  media: torch.Tensor | None) -> torch.Tensor:
    """One layer of a decode step.  An attention layer writes its new K/V
    into its dense ring or, when ``c`` holds page pools ("pk"), into the
    pools; a recurrent one its new state into its rows of ``c`` (views of
    the stacked cache); all in place.  ``xattn`` reads the media."""
    if kind == "xattn":
        return _apply_block(bp, kind, x, cfg, None, media)[0]
    if kind in RECURRENT_KINDS:
        x, new = _recurrent_block(bp, kind, x, c, cfg)
        for name, t in new.items():
            c[name].copy_(t)
        return x
    decode = (attn.attention_decode_paged if "pk" in c
              else attn.attention_decode)
    h = apply_norm(bp["ln1"], x, cfg)
    mix, _ = decode(bp["mix"], h, c, cfg, kind, pos)
    x = _residual(x, mix)
    h2 = apply_norm(bp["ln2"], x, cfg)
    return _residual(x, _apply_ffn(bp, kind, h2, cfg)[0])


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig,
                media: torch.Tensor | None = None,
                act_specs: dict | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step against a dense cache (``prefill``'s or
    ``init_cache``'s) or a paged one.  tokens: (B, 1); pos: (B,)
    per-sequence positions or a scalar for all rows.  Returns (logits
    (B, 1, V) f32, cache); the cache's rings or pools and its recurrent
    rows are updated in place (every row's, idle ones included, as in the
    JAX package: a row's state never reaches another row).  ``media``:
    the vision model's frontend tokens, re-projected every step."""
    x = _wsc(embed_tokens(params, tokens, cfg), act_specs, "act")
    media = _project_media(params, media, cfg)
    pos = on_mesh_of(pos, x)
    for gi, g in enumerate(cfg.groups):
        gp, gc = params["groups"][f"g{gi}"], cache[f"g{gi}"]
        for lp, lc in zip(_unstack(gp, g.n), _unstack(gc, g.n)):
            for si, kind in enumerate(g.pattern):
                x = _decode_block(lp[f"s{si}"], kind, x, lc[f"s{si}"], cfg,
                                  pos, media)
    x = apply_norm(params["final_norm"], x, cfg)
    return _wsc(lm_logits(params, x, cfg), act_specs, "logits"), cache


# ---------------------------------------------------------------------------
# Chunked prefill (repro_torch.serve): one prompt chunk against the paged cache
# ---------------------------------------------------------------------------

def init_chunk_carry(cfg: ModelConfig,
                     device: str | torch.device | None = None) -> dict:
    """Per-slot recurrent carry for chunked prefill (B=1 per prefilling
    sequence), in the JAX package's tree shape.  Attention layers carry
    nothing — their state lives in the page pools; recurrent layers carry
    their zero serving state (``init_recurrent_state``) *outside* the
    batch cache, on ``device`` (default ``cuda``), so that interleaved
    decode steps cannot touch it (it is written into the cache row at
    activation)."""
    recurrent = any(k in RECURRENT_KINDS for k in cfg.layer_kinds)
    dev = resolve_device(device) if recurrent else None
    return {f"g{gi}": {
        f"s{si}": (init_recurrent_state(cfg, kind, 1, (g.n,), dev)
                   if kind in RECURRENT_KINDS else {})
        for si, kind in enumerate(g.pattern)}
        for gi, g in enumerate(cfg.groups)}


def _chunk_block(bp: dict, kind: str, x: torch.Tensor, c: dict, car: dict,
                 cfg: ModelConfig, rows: dict, start: int, cache_len: int,
                 pos: dict,
                 media: torch.Tensor | None) -> tuple[torch.Tensor, dict]:
    """One layer of a prompt chunk: attention against the paged context
    (its K/V written into the pools in place), a recurrence from its carry,
    cross-attention to the media.  Returns (x, the layer's new carry)."""
    if kind == "xattn":
        return _apply_block(bp, kind, x, cfg, None, media)[0], car
    if kind in RECURRENT_KINDS:
        return _recurrent_block(bp, kind, x, _rows_as(car, x), cfg)
    h = apply_norm(bp["ln1"], x, cfg)
    L = cfg.kv_cache_len(kind, cache_len)
    tmp = {"pk": c["pk"], "pv": c["pv"], "pt": rows[L][None]}
    if L not in pos:                    # once per chunk and page class
        pos[L] = attn.chunk_positions(start, x.shape[1], tmp["pt"],
                                      c["pk"].shape[1])
    mix, _ = attn.attention_prefill_paged(bp["mix"], h, tmp, cfg, kind,
                                          start, pos[L])
    x = _residual(x, mix)
    h2 = apply_norm(bp["ln2"], x, cfg)
    return _residual(x, _apply_ffn(bp, kind, h2, cfg)[0]), car


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                  start: int, rows: dict, carry: dict, cfg: ModelConfig,
                  cache_len: int, media: torch.Tensor | None = None,
                  act_specs: dict | None = None
                  ) -> tuple[torch.Tensor, dict, dict]:
    """Process one prompt chunk of an in-flight prefill against the paged
    cache.  tokens: (1, C) at absolute positions start..start+C-1; rows:
    {L: (n_pp,) int32 tensor} the slot's physical pages per page class
    (the batch page table stays on the junk page until activation, so
    decode steps interleave freely); carry: ``init_chunk_carry`` tree.
    The chunk's K/V are written into the pools in place.  Returns
    (last-position logits (1, V) f32, cache, the new carry: new tensors,
    the given carry is left as it was).  ``media``: the vision model's
    (1, N, d_frontend) frontend tokens."""
    x = _wsc(embed_tokens(params, tokens, cfg), act_specs, "act")
    media = _project_media(params, media, cfg)
    pos: dict = {}
    new_carry: dict[str, Any] = {}
    for gi, g in enumerate(cfg.groups):
        gp, gc = params["groups"][f"g{gi}"], cache[f"g{gi}"]
        per_layer: dict[str, list] = {f"s{si}": [] for si in
                                      range(len(g.pattern))}
        for lp, lc, lcar in zip(_unstack(gp, g.n), _unstack(gc, g.n),
                                _unstack(carry[f"g{gi}"], g.n)):
            x = _wsc(x, act_specs, "act")
            for si, kind in enumerate(g.pattern):
                x, car = _chunk_block(lp[f"s{si}"], kind, x, lc[f"s{si}"],
                                      lcar[f"s{si}"], cfg, rows, start,
                                      cache_len, pos, media)
                per_layer[f"s{si}"].append(car)
        new_carry[f"g{gi}"] = _stack_layers(per_layer)
    x = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return lm_logits(params, x, cfg)[:, 0], cache, new_carry
