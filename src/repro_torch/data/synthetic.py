"""Synthetic data (port of ``repro.data.synthetic``): token streams for the
LM zoo (with the vision frontend's media stub), dense and sparse
regression sets for the paper's Sec-6 experiments.

Determinism contract, as in the JAX package: batch t of a stream depends
only on (seed, t) — any restart regenerates identical data, which is what
makes checkpoint-resume exactly reproducible.  The draws come from a CPU
``torch.Generator`` seeded from (seed, t), so a batch is the same on every
device; its bits differ from ``jax.random``'s, and tests that compare the
two packages hand both the same numpy batch instead.

The regression sets draw from ``np.random.default_rng(seed)`` in the JAX
package's order, so their coordinates and values are its bits; the
tensors (f64) are built on the requested device, the sparse set's dense
matrix scattered there from the drawn coordinates (at the real-dataset
shape it is 19.35 GB, never built on the host).
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
    media_tokens: int = 0           # vision frontend stub
    media_dim: int = 0
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
    odd positions reduces to "repeat the current token".  With
    ``media_tokens`` the batch also holds ``media`` (B, media_tokens,
    media_dim) f32, a normal draw times 0.02 from the same generator."""
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
    if spec.media_tokens:
        batch["media"] = torch.randn(
            (B, spec.media_tokens, spec.media_dim), generator=g) * 0.02
    return {k: v.to(dev) for k, v in batch.items()}


def regression_dataset(n_examples: int, n_features: int, seed: int = 0,
                       noise: float = 0.01,
                       device: str | torch.device | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense f64 ``(X, y)``: X ~ N(0, 1/n_features), y = X w + noise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(n_examples, n_features))
                         / np.sqrt(n_features)).to(dev)
    w = torch.from_numpy(rng.normal(size=n_features)).to(dev)
    e = torch.from_numpy(rng.normal(size=n_examples)).to(dev)
    return X, X @ w + noise * e


def sparse_regression_coords(n_examples: int, n_features: int,
                             density: float = 0.003, seed: int = 0
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray]:
    """The draws of :func:`sparse_regression_dataset` on the host:
    ``(cols, vals, w, noise)``, ``cols`` and ``vals`` of shape
    (n_examples, nnz) — row i's non-zero columns and values."""
    rng = np.random.default_rng(seed)
    nnz = max(int(n_features * density), 1)
    w = rng.normal(size=n_features)
    cols = np.empty((n_examples, nnz), np.int64)
    vals = np.empty((n_examples, nnz))
    for i in range(n_examples):
        cols[i] = rng.choice(n_features, size=nnz, replace=False)
        vals[i] = rng.normal(size=nnz)
    return cols, vals, w, rng.normal(size=n_examples)


def sparse_regression_dataset(n_examples: int, n_features: int,
                              density: float = 0.003, seed: int = 0,
                              device: str | torch.device | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shape-proxy for the Kogan et al. real dataset (150,360 features,
    16,087 examples, highly sparse), dense f64 on ``device``; ``density``
    sets the non-zeros a row."""
    dev = resolve_device(device)
    cols, vals, w, e = sparse_regression_coords(n_examples, n_features,
                                                density, seed)
    X = torch.zeros((n_examples, n_features), dtype=torch.float64,
                    device=dev)
    rows = torch.arange(n_examples, device=dev)[:, None]
    X[rows, torch.from_numpy(cols).to(dev)] = torch.from_numpy(vals).to(dev)
    y = X @ torch.from_numpy(w).to(dev) + 0.01 * torch.from_numpy(e).to(dev)
    return X, y
