"""Deterministic synthetic data of the port (own copy of ``repro.data``'s
LM token streams)."""
from .synthetic import LMBatchSpec, make_lm_batch  # noqa: F401
