"""Controls and faults planted in the program, to show that the
comparison fails them (``calibrate.py`` on the card, the tests on the
CPU).  The benchmark's own runs plant none (``variant`` None).

* ``int8``: the control, the program's own lower-precision path: its
  int8 gradient compression with error feedback switched on;
* ``unchanged``: each step returns the state it was given;
* ``half_batch``: the program gets the first half of each batch's rows,
  so its loss is the mean over them;
* ``grad_leaf_zeroed``: the backward's gradient of the embedding (the
  tied output head's with it) is left out where it is produced.

The reference put in the program's place at float8 precision, the other
control, is ``reference_readings(..., numerics="fp8")``.
"""
from __future__ import annotations

VARIANTS = ("int8", "unchanged", "half_batch", "grad_leaf_zeroed")


def _check(variant: str | None) -> None:
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: {VARIANTS}")


def opt_overrides(variant: str | None) -> dict:
    _check(variant)
    return {"compression": "int8"} if variant == "int8" else {}


def grad_fn(variant: str | None, fn):
    _check(variant)
    if variant != "grad_leaf_zeroed":
        return fn

    def zeroed(params, batch):
        loss, grads = fn(params, batch)
        grads = dict(grads)
        grads["embedding"] = grads["embedding"] * 0
        return loss, grads
    return zeroed


def step_fn(variant: str | None, fn):
    _check(variant)
    if variant != "unchanged":
        return fn

    def unchanged(state, batch):
        _, metrics = fn(state, batch)
        return state, metrics
    return unchanged


def batch(variant: str | None, b: dict) -> dict:
    _check(variant)
    if variant != "half_batch":
        return b
    half = b["tokens"].shape[0] // 2
    return {k: v[:half] for k, v in b.items()}
