"""Device choice for the port's entry points.

Entry points run on the card (``cuda``) unless the caller asks for the
CPU.  A missing GPU without an explicit ``cpu`` is an error, never a
silent CPU run.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU")
    return dev
