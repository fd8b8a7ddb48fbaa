"""Weights bridge: the JAX package's parameter trees into the port.

Two ways in, both keyed by the same ``/``-joined paths as
``repro.checkpoint`` (``groups/g0/s0/mix/wq``, stacked ``(n, ...)``
leading axes kept):

* ``params_from_numpy(tree, device)`` — a nested dict of numpy arrays, as
  ``repro.models.paramlib.init_tree`` makes it after ``np.asarray``;
* ``load_checkpoint(ckpt_dir, step, device)`` — the on-disk format of
  ``repro.checkpoint`` read without jax: ``step_<N>/manifest.json`` plus
  ``<id>.s<k>.npy`` shards split along axis 0, with bf16 leaves stored as
  a uint16 view and restored from the manifest's dtype.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .device import resolve_device

# numpy-native dtypes by manifest name; bf16 is special-cased below
_NUMPY_DTYPES = ("float64", "float32", "float16", "int64", "int32",
                 "int16", "int8", "uint8", "bool")


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    # np.require keeps 0-d leaves 0-d (np.ascontiguousarray makes them 1-d);
    # "W" copies a read-only view such as one of a jax array
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":          # ml_dtypes array from JAX
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree: dict, device: str | torch.device | None = None
                      ) -> dict:
    """Nested dict of array-likes -> the same nesting of torch tensors."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(np.asarray(node), dev)

    return walk(tree)


def _restore(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype not in _NUMPY_DTYPES:
        raise NotImplementedError(f"checkpoint leaf dtype {dtype!r}")
    return torch.from_numpy(arr.view(np.dtype(dtype)))


def load_checkpoint(ckpt_dir: str, step: int,
                    device: str | torch.device | None = None) -> dict:
    """Read ``ckpt_dir/step_<step>`` into a nested dict keyed by path."""
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out: dict[str, Any] = {}
    for m in manifest["leaves"]:
        parts = [np.load(os.path.join(d, f"{m['id']}.s{k}.npy"))
                 for k in range(m["n_shards"])]
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        if list(arr.shape) != list(m["shape"]):
            raise ValueError(f"shape mismatch for {m['path']}: shards "
                             f"{arr.shape} vs manifest {m['shape']}")
        node = out
        *head, leaf = m["path"].split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[leaf] = _restore(np.require(arr, requirements=["C"]),
                              m["dtype"]).to(dev)
    return out
