"""The benchmark's inputs, all made from ``--seed`` on the device: the
initial weights over the leaf shapes the program declares, and one batch
of tokens per step.

Every draw has a stream of its own, keyed by (seed, what, index) through
a hash, so a leaf or a batch can be made again alone, bit for bit, on the
same device: the reference and the checks remake them instead of keeping
copies.
"""
from __future__ import annotations

import hashlib
import math

import torch


def stream(seed: int, what: str, index: int | str,
           device: torch.device) -> torch.Generator:
    digest = hashlib.blake2b(f"{seed}:{what}:{index}".encode(),
                             digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest, "little") >> 1)


def leaf_items(tree: dict, prefix: str = ""):
    """(path, leaf) of every leaf of a nested dict, keys sorted, paths
    joined by ``/``: tensors, or the specs of the program's
    ``paramlib.P`` (``shape``, ``init``, ``scale``, ``fan_in_dim``)."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaf_items(v, path)
        else:
            yield path, v


def make_leaf(path: str, spec, seed: int, device: torch.device
              ) -> torch.Tensor:
    """One float32 leaf: ones or zeros where the spec says so, else a
    normal draw times the spec's scale, or 1/sqrt(fan-in) without one."""
    if spec.init == "ones":
        return torch.ones(spec.shape, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=device)
    std = spec.scale if spec.scale is not None else \
        1.0 / math.sqrt(max(spec.shape[spec.fan_in_dim], 1))
    x = torch.randn(spec.shape, generator=stream(seed, "w", path, device),
                    device=device)
    return x.mul_(std)


def make_params(specs: dict, seed: int, device: torch.device) -> dict:
    """The initial parameters, a nested dict with the spec tree's keys
    (empty subtrees kept)."""
    def walk(node, prefix):
        out = {}
        for k in sorted(node):
            path = f"{prefix}/{k}" if prefix else k
            v = node[k]
            out[k] = walk(v, path) if isinstance(v, dict) \
                else make_leaf(path, v, seed, device)
        return out
    return walk(specs, "")


def make_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
               device: torch.device) -> dict:
    """Step ``step``'s batch: (batch, seq + 1) uniform token ids, the
    tokens its first ``seq`` columns and the labels its last ``seq``."""
    ids = torch.randint(0, vocab, (batch, seq + 1),
                        generator=stream(seed, "batch", step, device),
                        device=device, dtype=torch.int32)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
