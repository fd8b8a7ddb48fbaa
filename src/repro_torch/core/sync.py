"""Synchronization configuration of the training engine (own copy of
``repro.core.sync_jax.SyncConfig``).

``mode`` names the paper's regime (``bsp``, ``datacentric``, ``ssp``); on
one device it selects no layout yet (the mesh rules that map it onto
sharded parameters come with the multi-device slice of the port).
``delta`` is the admissible staleness of Sec 7 (0 = exact, bit-identical
to synchronous training) and ``group_delays`` the Sec-7.1 per-chunk
delays, matched by longest prefix on a parameter's ``/``-joined path.
"""
from __future__ import annotations

import dataclasses

BSP = "bsp"
DATACENTRIC = "datacentric"
SSP = "ssp"


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How parameter reads/writes are synchronized during training."""
    mode: str = DATACENTRIC          # "bsp" | "datacentric" | "ssp"
    delta: int = 0                   # admissible staleness (Sec 7); 0 = exact
    compression: str = "none"        # "none" | "int8" gradient compression
    remat: str = "full"              # "none" | "full" | "dots"
    # per-partition-group delays (Sec 7.1 per-chunk version arrays):
    group_delays: tuple[tuple[str, int], ...] = ()
    # ring-buffer layout: True/False force the packed (grouped, one gather
    # per group) or the per-leaf tree layout; None follows the parameters'
    # device (packed on the card, tree on the CPU; pdb/torch_backend.py)
    packed_ring: bool | None = None

    def __post_init__(self):
        if self.mode not in (BSP, DATACENTRIC, SSP):
            raise ValueError(f"unknown sync mode {self.mode!r}")
        if self.delta < 0:
            raise ValueError("delta must be >= 0")

    def delay_for(self, path: tuple[str, ...]) -> int:
        """Resolve a parameter path (a tuple of dict keys) to its group
        delay (longest-prefix match on the ``/``-joined path); defaults to
        the uniform delta."""
        s = "/".join(path)
        best = self.delta
        best_len = -1
        for prefix, d in self.group_delays:
            if s.startswith(prefix) and len(prefix) > best_len:
                best, best_len = d, len(prefix)
        return best
