"""Mixture-of-Experts FFN with grouped one-hot dispatch (GShard/Switch
style); port of ``repro.models.moe``.

Tokens are split into groups; within a group a top-k router assigns
tokens to experts subject to a per-expert capacity, and dispatch/combine
are one-hot (G, g, E, C) tensors.  Which tokens an expert drops depends
on which tokens share the group, so a decode batch's routing depends on
the other rows in it (idle rows included), as in the JAX package.  The
expert computation goes through ``kernels.ops.moe_grouped_ffn``: the
hand-written kernel on the card, its plain version on the CPU.

On DTensors (the sharded steps) the router, the top-k rounds and the
capacity slots run on each rank's own token groups through ``local_map``
(a group's routing reads only its own tokens, so the bits are those of
one device), the weights are read through ``device.param_for``, and the
experts are split over ``model`` where E divides the axis, else their
ffn dim (``ops._moe_sharded``).  The aux losses take their means over
every group before any product.  ``REPRO_MOE_EP_CONSTRAINT=1`` with
``n_experts % 16 == 0`` lays the plain route's dispatched intermediates
(E, G, C, d) out with the experts over ``model`` and the groups over
``data``, as the JAX package's hook does; the kernel route ignores it.
The port reads the group size from ``cfg.moe_group_size`` only (the JAX
package's ``REPRO_MOE_GROUP`` override has no counterpart).  Aux losses
follow Switch Transformer: load balance (E * sum_e f_e * P_e) and the
router z-loss.
"""
from __future__ import annotations

import math
import os

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..device import on_mesh_of, param_for, replicated
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
    iota = on_mesh_of(torch.arange(n, device=idx.device), idx)
    return (idx[..., None] == iota).float()


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


def _route_groups(probs: torch.Tensor, k: int, capacity: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`route`; a DTensor runs on each rank's own groups (its G
    split kept, everything else whole) through ``local_map``."""
    if not isinstance(probs, DTensor):
        return route(probs, k, capacity)
    mesh = probs.device_mesh
    pl = [Shard(0) if p == Shard(0) else Replicate()
          for p in probs.placements]
    run = local_map(route, out_placements=(pl, pl),
                    in_placements=(pl, None, None), device_mesh=mesh)
    return run(probs.redistribute(mesh, pl), k, capacity)


def _ep_hook(cfg: ModelConfig):
    """The expert-parallel layout of the plain route's dispatched
    intermediates (E, G, C, d) (``REPRO_MOE_EP_CONSTRAINT=1``, read at
    each call, and ``n_experts % 16 == 0``, the JAX package's literal):
    the experts over ``model``, the token groups over ``data``, the rest
    whole (a dim that does not divide its axis, as a decode step's one
    group, stays whole there).  None when off; the identity on a plain
    tensor."""
    if os.environ.get("REPRO_MOE_EP_CONSTRAINT") != "1" \
            or cfg.n_experts % 16:
        return None

    def ep(t: torch.Tensor) -> torch.Tensor:
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        pl = [Replicate()] * mesh.ndim
        for i, name in enumerate(mesh.mesh_dim_names):
            dim = {"model": 0, "data": 1}.get(name)
            if dim is not None and t.shape[dim] % mesh.size(i) == 0:
                pl[i] = Shard(dim)
        return t.redistribute(mesh, pl)
    return ep


def moe_ffn(params: dict, x: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Returns (output (B, S, d), aux {lb_loss, z_loss, router_entropy})."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xg, g = _group_tokens(x, cfg.moe_group_size)
    # JAX's einsum("Ggd,dE->GgE"), written as @: a product with no batch
    # dimensions, which remat "dots" keeps (transformer.save_dots)
    logits = xg.float() @ param_for(params["router"], torch.float32, xg)
    probs = torch.softmax(logits, dim=-1)
    capacity = max(math.ceil(g * k * cfg.capacity_factor / E), 1)
    dispatch, combine = _route_groups(probs, k, capacity)

    dt = xg.dtype
    out = kops.moe_grouped_ffn(dispatch, combine, xg,
                               param_for(params["wg"], dt, xg),
                               param_for(params["wu"], dt, xg),
                               param_for(params["wd"], dt, xg),
                               ep=_ep_hook(cfg))

    # Switch-style aux losses, each mean over every group
    me = replicated(probs.mean(dim=(0, 1)))                   # router prob
    ce = replicated(_one_hot(torch.argmax(probs, dim=-1), E)
                    .mean(dim=(0, 1)))
    aux = {"lb_loss": E * torch.sum(me * ce),
           "z_loss": replicated(torch.mean(
               torch.logsumexp(logits, dim=-1) ** 2)),
           "router_entropy": replicated(-torch.mean(torch.sum(
               probs * torch.log(probs + 1e-9), dim=-1)))}
    return out.reshape(B, S, d), aux
