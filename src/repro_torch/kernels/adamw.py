"""AdamW's update of one parameter leaf in one CUDA pass
(``csrc/adamw.cu``), and its plain version.

No TPU kernel stands behind it: the JAX package's AdamW is plain array
operations.  The plain version, :func:`adamw_plain`, runs the same
arithmetic as ~15 PyTorch passes over leaf-sized f32 temporaries; the
kernel reads p, g, m and v once and writes new p, m and v once (28 bytes
an f32 parameter), rounding each element as the plain passes do.

The update is functional: it returns fresh tensors and leaves its inputs
as they were, so a caller that rejects or retries a step still holds the
prior state.  :func:`adamw` routes by the leaf's device: a CUDA leaf
launches the kernel (a DTensor's through its local shard: the update is
elementwise, so a shard gets the bits of the whole leaf), any other leaf
(CPU, ``meta``) takes the plain version.  A CUDA leaf the kernel does not
take raises; nothing falls back.

``counts`` holds the kernel's launches and the parameters it updated.  It
is not one of ``_build.launches``, whose keys are the model's kernels.
"""
from __future__ import annotations

import ctypes
import threading

import torch
from torch.distributed.tensor import DTensor

from . import _build

NAME = "adamw"
_P = ctypes.c_void_p
_F = ctypes.c_float
SIGNATURES = {"adamw_fwd": [_P] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, _P, _P, _P]
              + [_F] * 7 + [_P]}
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


class Counts:
    """Kernel launches and the elements they updated (thread-safe: the
    parameter server's workers update at once)."""

    def __init__(self) -> None:
        self.launches = 0
        self.elements = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self.launches += 1
            self.elements += n

    def reset(self) -> None:
        with self._lock:
            self.launches = self.elements = 0


counts = Counts()


def adamw_plain(g, m, v, p, scale, bc1, bc2, *, lr, b1, b2, eps,
                weight_decay):
    """The update of one leaf in PyTorch passes: (new p, new m, new v).

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g;
    p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p), with g clipped by
    ``scale`` (a 0-d tensor, or None) in its own dtype first.  Each product
    and sum rounds as written, in place on fresh temporaries: at most four
    leaf-sized f32 tensors are alive besides the old state."""
    gf = (g if scale is None else g * scale.to(g.dtype)).float()
    m = torch.mul(m, b1).add_(torch.mul(gf, 1 - b1))
    v = torch.mul(v, b2).add_(torch.mul(gf, 1 - b2).mul_(gf))
    del gf
    step = torch.div(m, bc1)
    step.div_(torch.div(v, bc2).sqrt_().add_(eps))
    pf = p.float()
    step.add_(torch.mul(pf, weight_decay)).mul_(lr)
    return torch.sub(pf, step).to(p.dtype), m, v


def adamw(g, m, v, p, scale, bc1, bc2, **hyper):
    """One leaf's update, (new p, new m, new v), on the leaf's route;
    ``hyper``: lr, b1, b2, eps, weight_decay."""
    if p.device.type != "cuda":
        return adamw_plain(g, m, v, p, scale, bc1, bc2, **hyper)
    if isinstance(p, DTensor):
        return on_local_shards(adamw_kernel, g, m, v, p, scale, bc1, bc2,
                               **hyper)
    return adamw_kernel(g, m, v, p, scale, bc1, bc2, **hyper)


def on_local_shards(update, g, m, v, p, scale, bc1, bc2, **hyper):
    """``update`` of DTensor leaves on their local shards, each output a
    DTensor of p's layout.  g, m and v must share p's mesh and placements;
    the 0-d scalars are taken whole (replicated)."""
    mesh, placements = p.device_mesh, p.placements
    for x in (g, m, v):
        if (not isinstance(x, DTensor) or x.device_mesh != mesh
                or x.placements != placements):
            raise ValueError(f"{NAME}: a DTensor leaf needs g, m and v on "
                             f"its mesh and placements {placements}")
    outs = update(g.to_local(), m.to_local(), v.to_local(), p.to_local(),
                  *map(_whole, (scale, bc1, bc2)), **hyper)
    return tuple(DTensor.from_local(o, mesh, placements, run_check=False,
                                    shape=p.shape, stride=p.stride())
                 for o in outs)


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def adamw_kernel(g, m, v, p, scale, bc1, bc2, *, lr, b1, b2, eps,
                 weight_decay):
    """The kernel on contiguous CUDA tensors of one shape on one device: p
    and g f32 or bf16, m and v f32; scale (or None), bc1 and bc2 0-d f32
    on that device.  Returns fresh (new p, new m, new v)."""
    dev = p.device
    for what, x in (("g", g), ("m", m), ("v", v)):
        if x.device != dev or x.shape != p.shape:
            raise ValueError(f"{NAME}: {what} is {tuple(x.shape)} on "
                             f"{x.device}, p {tuple(p.shape)} on {dev}")
    for what, x in (("p", p), ("g", g), ("m", m), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{NAME}: {what} must be contiguous")
    if p.dtype not in _TYPES or g.dtype not in _TYPES:
        raise ValueError(f"{NAME}: p and g f32 or bf16, got {p.dtype} / "
                         f"{g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"{NAME}: m and v must be f32")
    for what, x in (("scale", scale), ("bc1", bc1), ("bc2", bc2)):
        if x is not None and (x.device != dev or x.ndim != 0
                              or x.dtype != torch.float32):
            raise ValueError(f"{NAME}: {what} must be a 0-d f32 tensor on "
                             f"{dev}")
    p_out = torch.empty_like(p)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    n = p.numel()
    if n == 0:
        return p_out, m_out, v_out
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.adamw_fwd(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(), n,
            _TYPES[p.dtype], _TYPES[g.dtype],
            None if scale is None else scale.data_ptr(), bc1.data_ptr(),
            bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, lr, weight_decay,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, NAME)
    counts.add(n)
    return p_out, m_out, v_out
