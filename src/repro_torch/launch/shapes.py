"""Assigned input-shape cells and their abstract input specs (port of
``repro.launch.shapes``).

Every (arch x shape) cell runs one of three step kinds:

  train_4k     -> train_step   (seq 4096,   global batch 256)
  prefill_32k  -> prefill_step (seq 32768,  global batch 32)
  decode_32k   -> decode_step  (KV len 32768, global batch 128)
  long_500k    -> decode_step  (KV len 524288, global batch 1;
                                sub-quadratic archs only)

``input_specs`` returns ``meta`` tensors (shapes and dtypes, no storage)
plus the logical-axes tree used by the sharding engine.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.transformer import cache_axes, init_cache


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.runs_long_context:
        out.append("long_500k")
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_of(shape: str | ShapeCell) -> ShapeCell:
    """A cell by name, or the cell itself (a smaller one of a test or of
    the one-card run)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg: ModelConfig, shape_name: str | ShapeCell
                ) -> tuple[dict, dict]:
    """Returns (abstract inputs as ``meta`` tensors, logical axes) of the
    step function's batch argument."""
    cell = cell_of(shape_name)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        specs = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32),
                 "mask": _meta((B, S), torch.float32)}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                "mask": ("batch", "seq")}
    elif cell.kind == "prefill":
        specs = {"tokens": _meta((B, S), torch.int32)}
        axes = {"tokens": ("batch", "seq")}
    else:  # decode: one new token against a KV/recurrent cache of length S
        specs = {"tokens": _meta((B, 1), torch.int32),
                 "pos": _meta((), torch.int32)}
        axes = {"tokens": ("batch", None), "pos": ()}
    if cfg.frontend == "vision":
        specs["media"] = _meta((B, cfg.n_frontend_tokens, cfg.d_frontend),
                               torch.float32)
        axes["media"] = ("batch", None, None)
    return specs, axes


def decode_cache_specs(cfg: ModelConfig, shape_name: str | ShapeCell
                       ) -> tuple[dict, dict]:
    """(``init_cache`` on the ``meta`` device, ``cache_axes``) of a
    cell's global batch and length."""
    cell = cell_of(shape_name)
    cache = init_cache(cfg, cell.global_batch, cell.seq_len, device="meta")
    return cache, cache_axes(cfg)
