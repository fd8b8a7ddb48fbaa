"""Mixture-of-Experts FFN with grouped one-hot dispatch (GShard/Switch
style); port of ``repro.models.moe``.

Tokens are split into groups; within a group a top-k router assigns
tokens to experts subject to a per-expert capacity, and dispatch/combine
are one-hot (G, g, E, C) tensors.  Which tokens an expert drops depends
on which tokens share the group, so a decode batch's routing depends on
the other rows in it (idle rows included), as in the JAX package.  The
expert computation goes through ``kernels.ops.moe_grouped_ffn``: the
hand-written kernel on the card, its plain version on the CPU.

The port reads the group size from ``cfg.moe_group_size`` only (the JAX
package's ``REPRO_MOE_GROUP`` override has no counterpart), and the JAX
package's expert-parallel sharding hook waits for the port's multi-device
work.  Aux losses follow Switch Transformer: load balance
(E * sum_e f_e * P_e) and the router z-loss.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops as kops
from .config import ModelConfig
from .paramlib import P


def moe_specs(cfg: ModelConfig, stack: tuple[int, ...] = ()) -> dict:
    lead = ("layers",) * len(stack)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": P(stack + (d, E), lead + ("embed", None), scale=0.02),
        "wg": P(stack + (E, d, f), lead + ("experts", "embed", "ffn")),
        "wu": P(stack + (E, d, f), lead + ("experts", "embed", "ffn")),
        "wd": P(stack + (E, f, d), lead + ("experts", "ffn", "embed")),
    }


def _group_tokens(x: torch.Tensor, group_size: int
                  ) -> tuple[torch.Tensor, int]:
    """(B, S, d) -> (G, g, d): the largest g <= group_size dividing B*S."""
    B, S, d = x.shape
    T = B * S
    g = min(group_size, T)
    while T % g != 0:
        g -= 1
    return x.reshape(T // g, g, d), g


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over the last axis; an index outside [0, n) gives a
    zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route(probs: torch.Tensor, k: int,
          capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing under a per-expert capacity: router probabilities
    (G, g, E) -> dispatch (G, g, E, C) bool and combine (G, g, E, C) f32.
    k rounds of top-1 (argmax takes the lowest index on ties, as
    lax.top_k does); a token's slot is its expert's running count (by
    cumsum, in token order), kept below the capacity; the combine weights
    are renormalised over the chosen experts (mixtral convention)."""
    G, g, E = probs.shape
    dev = probs.device
    remaining = probs
    combine = torch.zeros((G, g, E, capacity), dtype=torch.float32,
                          device=dev)
    dispatch = torch.zeros((G, g, E, capacity), dtype=torch.bool, device=dev)
    fill = torch.zeros((G, E), dtype=torch.int32, device=dev)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                 # (G, g)
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = _one_hot(idx, E)                             # (G, g, E)
        pos = fill[:, None, :] + (torch.cumsum(onehot, dim=1)
                                  - onehot).to(torch.int32)   # (G, g, E)
        keep = onehot.bool() & (pos < capacity)
        slot = _one_hot(torch.where(keep, pos, capacity), capacity)
        slot = slot * keep[..., None]                         # (G, g, E, C)
        dispatch |= slot.bool()
        combine = combine + slot * gate[..., None, None]
        fill = fill + onehot.sum(dim=1).to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    denom = combine.sum(dim=(2, 3), keepdim=True)
    return dispatch, combine / torch.clamp(denom, min=1e-9)


def moe_ffn(params: dict, x: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Returns (output (B, S, d), aux {lb_loss, z_loss, router_entropy})."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xg, g = _group_tokens(x, cfg.moe_group_size)
    # JAX's einsum("Ggd,dE->GgE"), written as @: a product with no batch
    # dimensions, which remat "dots" keeps (transformer.save_dots)
    logits = xg.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    capacity = max(math.ceil(g * k * cfg.capacity_factor / E), 1)
    dispatch, combine = route(probs, k, capacity)

    out = kops.moe_grouped_ffn(dispatch, combine, xg,
                               params["wg"].to(xg.dtype),
                               params["wu"].to(xg.dtype),
                               params["wd"].to(xg.dtype))

    # Switch-style aux losses
    me = probs.mean(dim=(0, 1))                               # router prob
    ce = _one_hot(torch.argmax(probs, dim=-1), E).mean(dim=(0, 1))
    aux = {"lb_loss": E * torch.sum(me * ce),
           "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
           "router_entropy": -torch.mean(torch.sum(
               probs * torch.log(probs + 1e-9), dim=-1))}
    return out.reshape(B, S, d), aux
