"""What each part of a model computes and launches, one file a part, found
by name in this package: ``mix_<kind>.py`` for the mixer of each layer
kind, ``ffn_<name>.py`` for each feed-forward, ``head.py`` for the output
head.  The plain reference of each part lies beside it in
``perfbench/reference/``, under the same name, with ``norm_<norm>.py``
for each norm.  So a configuration of a new kind enters the benchmark as
new files; ``missing`` names those it still needs.

A block of kind ``kind`` is its norm, its mixer, its norm and its
feed-forward: the one its mixer's description names as ``FFN``, else
``experts`` where the configuration has experts, else the
configuration's ``mlp``.

A part's description gives, for one layer (or the head), at a
configuration ``cfg`` and traffic ``tr``:

* ``weights(cfg)``: the weights of the products a token passes through;
* ``flops(cfg, seq)``: a token's training FLOPs beyond 6 x those weights
  (attention's scores), forward and backward, no recomputation;
* ``launches(cfg, tr)``: {kernel: launches a step} of the program's
  counted kernels (``_build.launches``), in the forward, the backward and
  remat's second forward;
* ``SOURCES``: the kernel sources the program builds before a run;
* ``kernels(cfg, tr)``: {kernel: ``Launch``}, one launch's work at the
  cell's shapes, for its share of the roofline (``metrics/_roofline.py``).
"""
from __future__ import annotations

import importlib
import importlib.util
from typing import NamedTuple

from perfbench.counts import layer_kinds

REFERENCE = "perfbench.reference"


class Launch(NamedTuple):
    """One launch of a kernel: a part of its device name, and the bytes
    and operations its inputs need (``counts.py``)."""
    device_name: str
    nbytes: float
    flops: float
    dtype: str = "bfloat16"


def _found(package: str, module: str) -> bool:
    return importlib.util.find_spec(f"{package}.{module}") is not None


def _file(package: str, module: str) -> str:
    """Where ``module`` of ``package`` goes, from the checkout's root."""
    return f"{package.replace('.', '/')}/{module}.py"


def find(module: str, package: str = __name__):
    """The part ``module`` of ``package``, a description (this package) or
    a reference (``perfbench.reference``), or a ValueError naming the file
    to add."""
    if not _found(package, module):
        raise ValueError(f"perfbench: {module} is not described: add "
                         f"{_file(package, module)}")
    return importlib.import_module(f"{package}.{module}")


def ffn_name(cfg: dict, kind: str) -> str:
    """The feed-forward of a block of ``kind``: its mixer's ``FFN``, else
    ``experts`` where the configuration has experts, else its ``mlp``."""
    own = getattr(find(f"mix_{kind}"), "FFN", None) \
        if _found(__name__, f"mix_{kind}") else None
    return own or ("experts" if cfg["n_experts"] else cfg["mlp"])


def parts(cfg: dict) -> list:
    """The description of each part a token passes through, in order:
    each layer's mixer and feed-forward, then the head."""
    out = []
    for kind in layer_kinds(cfg):
        out += [find(f"mix_{kind}"), find(f"ffn_{ffn_name(cfg, kind)}")]
    return out + [find("head")]


def missing(cfg: dict) -> list[str]:
    """The files a configuration still needs: the description and the
    reference of each of its mixers and feed-forwards, and the reference
    of its norm, where they are not there."""
    need = [(REFERENCE, f"norm_{cfg['norm']}")]
    for kind in dict.fromkeys(layer_kinds(cfg)):
        for module in (f"mix_{kind}", f"ffn_{ffn_name(cfg, kind)}"):
            need += [(__name__, module), (REFERENCE, module)]
    return [_file(p, m) for p, m in dict.fromkeys(need) if not _found(p, m)]
