"""Synchronization configuration of the training engine (own copy of
``repro.core.sync_jax.SyncConfig``).

``mode`` names the paper's regime and selects the parameters' layout on a
mesh (``param_rules``: logical axis -> mesh-axis preference lists, which
:mod:`repro_torch.launch.sharding` resolves against a concrete mesh):

  * ``bsp`` -- parameters replicated over the data-parallel axes, sharded
    over ``model`` only; the train step's gradient all-reduce over
    ``data`` is the read barrier of Algorithm 2a.
  * ``datacentric`` (and ``ssp``, which shards the database the same
    way) -- the parameter database sharded over ``data`` too (the
    ``embed`` dims, ZeRO-3 partitions): reads are per-partition
    all-gathers, writes per-partition reduce-scatters.

``delta`` is the admissible staleness of Sec 7 (0 = exact, bit-identical
to synchronous training) and ``group_delays`` the Sec-7.1 per-chunk
delays, matched by longest prefix on a parameter's ``/``-joined path.
"""
from __future__ import annotations

import dataclasses

BSP = "bsp"
DATACENTRIC = "datacentric"
SSP = "ssp"

# Logical parameter axes used by the model zoo:
#   vocab     — embedding / lm-head vocabulary dim
#   embed     — d_model dims of weight matrices (the FSDP shard dim)
#   ffn       — feed-forward hidden dim
#   heads     — flattened (n_heads * head_dim) projection dim
#   kv_heads  — flattened (n_kv_heads * head_dim) projection dim
#   experts   — MoE expert dim
#   layers    — stacked layer dim (never sharded)
#   batch/seq/kv_seq — activation & cache dims

_TP_RULES = {
    "vocab": ("model",),
    "ffn": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "layers": (),
}

RULES = {
    # data-centric: parameter database sharded over `data` (ZeRO-3 partitions)
    DATACENTRIC: {**_TP_RULES, "embed": ("data",)},
    # bsp: parameters replicated over `data`; only tensor-parallel sharding
    BSP: {**_TP_RULES, "embed": ()},
    # ssp: bounded-staleness baseline; shards the database like data-centric
    SSP: {**_TP_RULES, "embed": ("data",)},
}

ACTIVATION_RULES = {
    "batch": (("pod", "data"), ("data",)),   # first spec that divides wins
    "seq": (),
    "kv_seq": ("model",),                    # SP fallback for long caches
    "act_embed": (),
    "act_vocab": ("model",),
}


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

    @property
    def param_rules(self) -> dict:
        return RULES[self.mode]

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

    def to_policy(self, n_workers: int, n_chunks: int | None = None):
        """The ParameterDB consistency policy equivalent of this sync mode
        (host-side backends: threads, in-process replay, simulator)."""
        from ..pdb.policies import make_policy
        name = {BSP: "bsp", DATACENTRIC: "dc", SSP: "ssp"}[self.mode]
        return make_policy(name, n_workers, self.delta, n_chunks)
