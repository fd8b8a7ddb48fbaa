"""PyTorch/CUDA port of :mod:`repro`, module for module.

The JAX package ``repro`` stays the reference; this package imports
``torch`` and never ``jax`` or ``repro``.  Module names mirror ``repro``'s
so each counterpart is found under the same relative path.  Kernels that
``repro`` wrote in Pallas for the TPU are hand-written CUDA for Hopper
(``repro_torch.kernels``), built from the sources in this checkout at
first use.

Ported so far, on the dense GQA configs: serving
(``python -m repro_torch.launch.serve``: whole-prompt prefill, continuous
batching, greedy decoding, static parameters) and training
(``python -m repro_torch.launch.train``: the ParameterDB train engine,
synchronous or delta-stale on a ring of parameter versions, with
checkpoints and restart drills).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
