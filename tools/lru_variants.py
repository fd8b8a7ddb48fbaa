#!/usr/bin/env python3
"""Variants of this checkout's RG-LRU source (``csrc/rglru_scan.cu``) on
one card: each variant is the source with its constants replaced (the
chunk length CK and the backward's piece SUB), built with ``nvcc`` under
the ignored ``build/lru_variants/``, checked against the plain version
and timed beside the source as it is, in turns (this, variants..., this),
at recurrentgemma-2b's training shape (B4 T512 D2560 bf16, the decay
from the model's map): the forward with its checkpoints and the backward,
with ptxas' registers and spills and the blocks resident on an SM.

    python3 tools/lru_variants.py

Needs one CUDA card.  Exits non-zero if a variant does not build or
disagrees with the plain version (bf16 rtol/atol 2e-2, the backward a
normalized 2e-2).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

SHAPE = (4, 512, 2560)
# name: {constant: value}; the chunk length must be a multiple of SUB
VARIANTS = {"chunk32": {"CK": 32, "SUB": 4}, "chunk64": {"CK": 64, "SUB": 4},
            "chunk16_sub8": {"CK": 16, "SUB": 8}}


def build(name: str, consts: dict, nvcc: str, flags) -> tuple[Path, str]:
    """The variant's library and ptxas' report."""
    out = ROOT / "build" / "lru_variants"
    out.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "rglru_scan.cu").read_text()
    for k, v in consts.items():
        old = next(line for line in src.splitlines()
                   if line.startswith(f"constexpr int {k} = "))
        src = src.replace(old, f"constexpr int {k} = {v};")
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    (out / f"{name}.cu").write_text(src)
    so = out / f"{name}.so"
    res = subprocess.run([nvcc, *flags, "-o", str(so), str(out / f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    return so, res.stdout + res.stderr


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rglru_scan as lru
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.smi(), flush=True)
    _build.build_all((lru.NAME,))
    log = _build.library_path(lru.NAME)
    cs.print_ptxas("this", log.with_name(log.name + ".log").read_text())
    libs = {"this": lru._lib()}
    for name, consts in VARIANTS.items():
        so, report = build(name, consts, _build._nvcc(), _build.NVCC_FLAGS)
        cs.print_ptxas(name, report)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in lru.SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    B, T, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, a = cs.lru_inputs(torch, gen, B, T, D, torch.bfloat16)
    dy = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    leaves = [t.float().requires_grad_() for t in (x, a)]
    want_y = ref.rglru(*leaves)[0]
    want = torch.autograd.grad(want_y, leaves, dy.float())
    sets = cs.rotation((x, a, dy))
    n = len(sets)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def calls(lib):
        ck_len = lib.rglru_scan_ck()

        def fwd(x, a):
            y = torch.empty_like(x)
            ck = torch.empty((B, -(-T // ck_len), D), device="cuda")
            st = lru._strides(x, a)
            rc = lib.rglru_scan_fwd(
                x.data_ptr(), a.data_ptr(), y.data_ptr(), ck.data_ptr(),
                lru.ELEM[x.dtype], B, T, D, ck_len, ctypes.addressof(st),
                stream())
            if rc:
                raise RuntimeError(f"rglru_scan_fwd: CUDA error {rc}")
            return y, ck

        def bwd(x, a, ck, dy):
            dx, da = torch.empty_like(x), torch.empty_like(x)
            st = lru._strides(x, a, dy)
            rc = lib.rglru_scan_bwd(
                x.data_ptr(), a.data_ptr(), ck.data_ptr(), dy.data_ptr(),
                dx.data_ptr(), da.data_ptr(), lru.ELEM[x.dtype], B, T, D,
                ck_len, ctypes.addressof(st), stream())
            if rc:
                raise RuntimeError(f"rglru_scan_bwd: CUDA error {rc}")
            return dx, da
        return fwd, bwd

    bad = 0
    for name in [*libs, "this"]:
        lib = libs[name]
        fwd, bwd = calls(lib)
        y, ck = fwd(x, a)
        got = bwd(x, a, ck, dy)
        ok = torch.allclose(y.float(), want_y.float(), rtol=cs.BF16_TOL,
                            atol=cs.BF16_TOL) and all(
            ((g.float() - w).abs().max() / w.abs().max()).item()
            <= cs.BWD_BF16_NORM_TOL for g, w in zip(got, want))
        bad += not ok
        cks = [fwd(*s[:2])[1] for s in sets]
        row = dict(
            name=name, chunk=lib.rglru_scan_ck(), ok=ok,
            fwd_ms=cs.time_ms(lambda i: fwd(*sets[i % n][:2]), 50)[0],
            bwd_ms=cs.time_ms(lambda i: bwd(*sets[i % n][:2], cks[i % n],
                                            sets[i % n][2]), 50)[0],
            resident=[lib.rglru_scan_tiles(d, 1, T, len(lru.TILE_KEYS))
                      for d in (0, 1)])
        print("variant", json.dumps(row), flush=True)
        del cks
    print(cs.smi())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
