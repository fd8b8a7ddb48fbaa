"""Checkpoints in the JAX package's on-disk format, and the weights bridge.

``save_checkpoint`` / ``latest_step`` / ``load_state`` are the port's
counterparts of ``repro.checkpoint``'s: a checkpoint is a directory
``step_<N>/`` holding ``manifest.json`` (leaf ids, ``/``-joined paths,
dtypes, shapes, shard counts) and ``<id>.s<k>.npy`` shards split along
axis 0 when a leaf passes 64 MiB, written to ``step_<N>.tmp`` and renamed
(atomic).  Leaf ids and path strings are those the JAX package gives the
same training state: sorted dict keys, and a
:class:`repro_torch.pdb.torch_backend.DelayedState` keyed by field
position (``0/...`` params, ``1/...`` ring, ``2`` ptr, ``3/...`` optimizer
state, ``4`` step).  So a JAX checkpoint resumes in the port and the
reverse.

Two ways in for plain parameter trees, both keyed by the same paths
(``groups/g0/s0/mix/wq``, stacked ``(n, ...)`` leading axes kept):

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
import shutil
from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .tree import leaves_with_path, unflatten

_SHARD_BYTES = 64 * 1024 * 1024   # split leaves larger than this

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


# ---------------------------------------------------------------------------
# Training-state checkpoints
# ---------------------------------------------------------------------------

def _as_tree(state: Any) -> Any:
    """A DelayedState (anything with ``as_tree``) as its path-keyed dict."""
    return state.as_tree() if hasattr(state, "as_tree") else state


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """Host copy and logical dtype name; bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> str:
    """Atomically write ``state`` (a nested dict of tensors or a
    DelayedState) under ``ckpt_dir/step_<step>``."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: dict[str, Any] = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(leaves_with_path(_as_tree(state))):
        arr, dtype = _to_numpy(leaf)
        n_shards = max(1, -(-arr.nbytes // _SHARD_BYTES))
        n_shards = min(n_shards, max(arr.shape[0], 1)) if arr.ndim else 1
        manifest["leaves"].append({
            "id": i, "path": "/".join(path), "dtype": dtype,
            "shape": list(arr.shape), "n_shards": int(n_shards)})
        parts = [arr] if n_shards == 1 else np.array_split(arr, n_shards,
                                                           axis=0)
        for k, part in enumerate(parts):
            np.save(os.path.join(tmp, f"{i}.s{k}.npy"), part)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_state(ckpt_dir: str, step: int, like: Any) -> Any:
    """Load ``ckpt_dir/step_<step>`` into the structure of ``like`` (a
    nested dict of tensors or a DelayedState), each leaf on the device and
    in the dtype of its counterpart in ``like``; raises on a missing path
    or a shape mismatch."""
    got = leaves_with_path(load_checkpoint(ckpt_dir, step, device="cpu"))
    by_path = dict(got)
    paths, out = [], []
    for path, ref in leaves_with_path(_as_tree(like)):
        if path not in by_path:
            raise KeyError(f"checkpoint step {step} has no leaf "
                           f"{'/'.join(path)!r}")
        t = by_path[path]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {'/'.join(path)}: ckpt "
                             f"{tuple(t.shape)} vs expected "
                             f"{tuple(ref.shape)}")
        paths.append(path)
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    tree = unflatten(paths, out)
    return type(like).from_tree(tree) if hasattr(like, "as_tree") else tree
