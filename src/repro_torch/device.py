"""Device choice for the port's entry points.

Entry points run on the card (``cuda``) unless the caller asks for the
CPU.  A missing GPU without an explicit ``cpu`` is an error, never a
silent CPU run.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU")
    return dev


def on_mesh_of(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (made inside the model: positions, tables, masks) as a
    replicated DTensor on ``like``'s mesh when ``like`` is a DTensor (the
    sharded path, ``launch/sharding.py``); ``t`` itself otherwise (a
    DTensor ``t`` too)."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def param_for(p: torch.Tensor, dtype: torch.dtype,
              x: torch.Tensor) -> torch.Tensor:
    """A parameter cast to ``dtype`` for a product with the activations
    ``x`` (batch first).  On the sharded path it is gathered over the mesh
    dims that split x's batch (the data-centric read: an all-gather of
    each partition, whose backward is the write's reduce-scatter), so
    the activations keep their batch split and the products run on local
    shards; under ``bsp`` those dims already replicate it."""
    w = p.to(dtype)
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return w
    pl = [Replicate() if isinstance(q, Shard) and xp == Shard(0) else q
          for q, xp in zip(w.placements, x.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor (a loss, a metric, a mean over split rows: often partial
    sums) replicated on its mesh; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, [Replicate()] * mesh.ndim)
