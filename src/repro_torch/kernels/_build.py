"""Build and load the port's CUDA kernels from the sources in this checkout.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``
(route (b): no PyTorch headers, so a build takes seconds).  Libraries go
to ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``) under a name carrying a hash of the source, every
``csrc/*.cuh`` header and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.
Nothing is built at import: the first launch builds what it needs, and
``build_all`` builds every source at once, one ``nvcc`` per source, all
started together.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.  ``launches`` counts kernel launches
per kernel (``KERNELS``: the flash-attention, the WKV and the RG-LRU
sources hold two each, the forward and the backward); each wrapper adds one right after
its launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("flash_attention", "page_gather", "decode_attention",
           "ring_gather", "prefill_page_attention", "moe_grouped_ffn",
           "rwkv6_scan", "rglru_scan")
KERNELS = ("flash_attention", "flash_attention_bwd", "page_gather",
           "decode_attention", "ring_gather", "prefill_page_attention",
           "moe_grouped_ffn", "rwkv6_scan", "rwkv6_scan_bwd", "rglru_scan",
           "rglru_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

launches: dict[str, int] = dict.fromkeys(KERNELS, 0)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    # every header, since a source may include any of them
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes at once.  Returns the seconds each build took (0.0 when
    the library was already there); the compiler's output, with
    ``-Xptxas -v``'s register and shared-memory report, is kept beside
    each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    secs = dict.fromkeys(names, 0.0)
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = so.with_name(so.name + ".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")], stdout=fh,
                stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, so, log, time.perf_counter()))
    try:
        for name, proc, tmp, so, log, t0 in jobs:
            rc = proc.wait(timeout=NVCC_TIMEOUT_S)
            secs[name] = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"nvcc failed for {name} (rc {rc}):\n"
                                   + log.read_text()[-4000:])
            os.replace(tmp, so)
    finally:
        for _, proc, tmp, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return secs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), with
    ``argtypes`` set from ``signatures`` ({function: [ctypes types]}) and
    every function returning a C int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
