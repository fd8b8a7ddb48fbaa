"""Synthetic token streams for the LM zoo (port of
``repro.data.synthetic``'s LM part; the frontends' media stub comes with
the slice that ports them).

Determinism contract, as in the JAX package: batch t of a stream depends
only on (seed, t) — any restart regenerates identical data, which is what
makes checkpoint-resume exactly reproducible.  The draws come from a CPU
``torch.Generator`` seeded from (seed, t), so a batch is the same on every
device; its bits differ from ``jax.random``'s, and tests that compare the
two packages hand both the same numpy batch instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class LMBatchSpec:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0


def _generator(seed: int, step: int) -> torch.Generator:
    """One stream per (seed, step).  The CPU generator keeps 32 bits of its
    seed, so the pair is hashed into 32 bits by numpy's SeedSequence."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(mixed))


def make_lm_batch(spec: LMBatchSpec, step: int,
                  device: str | torch.device | None = None) -> dict:
    """Markov-ish synthetic tokens: enough structure for loss to drop.
    Even positions repeat the previous token, so next-token prediction at
    odd positions reduces to "repeat the current token"."""
    dev = resolve_device(device)
    g = _generator(spec.seed, step)
    B, S = spec.batch, spec.seq_len
    base = torch.randint(0, spec.vocab_size, (B, S), generator=g,
                         dtype=torch.int32)
    shifted = torch.roll(base, 1, dims=1)
    even = (torch.arange(S) % 2 == 0)[None, :]
    tokens = torch.where(even, shifted, base)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((B, S), dtype=torch.float32)
    mask[:, -1] = 0.0
    batch = {"tokens": tokens, "labels": labels, "mask": mask}
    return {k: v.to(dev) for k, v in batch.items()}
