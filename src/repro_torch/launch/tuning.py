"""Platform tuning, applied in one place (port of ``repro.launch.tuning``).

The CLIs call :func:`apply_tuning` first thing, as JAX's do, so every run
starts from the same tuned baseline.  The settings are PyTorch's own and
none changes a bit of any result:

  * ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` (GPU) -- the
    caching allocator grows its segments in place instead of keeping
    blocks of fixed sizes, so a long run's peak is not inflated by
    fragmentation (the MoE training phase of ``chip_smoke.py`` ran out of
    memory without it).  It changes where tensors live, not what is
    computed.

JAX's knobs without a counterpart: its XLA flags (async collectives, the
latency-hiding scheduler, Triton fusions) tune a compiler the port does
not have; ``host_device_count`` forces XLA's CPU device count, where the
port's dry run sets its fake process group's world size itself
(``dryrun.py``); ``enable_x64`` has no switch, PyTorch's dtypes being
explicit.  Both arguments are accepted and change nothing.

The allocator reads its settings at the first CUDA allocation, so tuning
must run before it; settings already in the environment are left as they
are (idempotent), and ``REPRO_TUNE=0`` disables everything (the untuned
baseline).
"""
from __future__ import annotations

import os

import torch

GPU_SETTINGS = (
    ("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True"),
)


def apply_tuning(platform: str | None = None,
                 host_device_count: int | None = None,
                 enable_x64: bool = False) -> list[str]:
    """Set the platform's settings that are not set yet; returns them as
    ``NAME=value`` strings.

    platform: "cpu" | "gpu" | None (autodetect: "gpu" when CUDA is
    available).  Safe to call repeatedly.  No-op when REPRO_TUNE=0.
    """
    if os.environ.get("REPRO_TUNE", "1") == "0":
        return []
    platform = platform or ("gpu" if torch.cuda.is_available() else "cpu")
    added: list[str] = []
    if platform == "gpu":
        for name, value in GPU_SETTINGS:
            if name not in os.environ:
                os.environ[name] = value
                added.append(f"{name}={value}")
    return added
