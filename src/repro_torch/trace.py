"""Named spans of the program's work, for ``torch.profiler``.

``span(name)`` marks a region of the host's work.  While a profiler
records, it opens a ``torch.profiler.record_function`` range, so the region
lands in the profiler's trace on the same clock as the device operations
launched inside it.  Otherwise it returns one shared no-op context after a
single check.  No setting switches the spans: a recording profiler is the
switch.

The names say what a span covers: ``pdb.*`` the ParameterDB engine
(``pdb.step``, ``pdb.commit_ring``, ``pdb.read_stale``), ``model.*`` the
model (``model.grad``, ``model.layer``, ``model.attn``, ``model.mlp``,
``model.norm``, ``model.head``, and RWKV-6's ``model.time_mix`` with the
WKV recurrence's ``model.wkv`` inside it) and ``opt.*`` the optimizer
(``opt.update``).  Only the forward runs inside a model span: autograd
launches the backward later, from its own thread, and a reader of the
trace finds each backward node's forward operation by its sequence number.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context over the named region: a profiler range while a profiler
    records, a shared no-op otherwise."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)
