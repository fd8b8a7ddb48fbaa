#!/usr/bin/env python3
"""This checkout's WKV kernels (``csrc/rwkv6_scan.cu``) on one card, alone
or against another version of that source: ptxas' registers and spills,
then at rwkv6-1.6b's training shape (B4 T512 H32 hd64, bf16 r/k/v and dy,
f32 w and u), with the decay from N(0, 1) and near 0 (N(2, 1)), the device
times of the forward (with its checkpoints, as training calls it) and of
the backward, taken in turns (other, this, this, other) so that both sides
see the same card, beside the bounds ``chip_smoke.py`` computes; and the
largest difference of each output (y, dr, dk, dv, dw, du) between the two
versions, in bf16 and in f32 on the same inputs.

    mkdir -p build/other
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/other
    python3 tools/wkv_compare.py build/other      # or with no argument

The other version is built with ``nvcc`` from that directory (into it:
keep it under the ignored ``build/``) and called through PR 19's C
interface: a sequential walk per (b, h) that checkpoints every
``rwkv6_scan_ck()`` steps and takes f64 du partials of (B, H, hd).  Needs
one CUDA card.  Exits non-zero if an output of the two versions differs by
more than the kernels' own tolerances (f32 rtol/atol 1e-4, bf16 a
normalized 2e-2).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

SHAPE = (4, 512, 32, 64)
_P, _I = ctypes.c_void_p, ctypes.c_int


def load_other(src: Path, nvcc: str, flags) -> ctypes.CDLL:
    """The other version's library, built from ``src`` with ``flags``."""
    so = src / "libwkv_other.so"
    subprocess.run([nvcc, *flags, "-o", str(so), str(src / "rwkv6_scan.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.rwkv6_scan_ck.argtypes, lib.rwkv6_scan_ck.restype = [], ctypes.c_int
    return lib


def other_calls(lib: ctypes.CDLL, wkv):
    """(forward with checkpoints, backward) through the other library's C
    interface (PR 19's: a sequential walk per (b, h))."""
    lib.rwkv6_scan_fwd.argtypes = [_P] * 7 + [_I] * 5 + [_P, _P]
    lib.rwkv6_scan_bwd.argtypes = [_P] * 13 + [_I] * 5 + [_P, _P]
    ck = lib.rwkv6_scan_ck()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def fwd(r, k, v, w, u):
        B, T, H, hd = r.shape
        y = torch.empty_like(r)
        ckpt = torch.empty((B, H, -(-T // ck), hd, hd), device="cuda")
        st = wkv._strides(r, k, v, w, y)
        rc = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), ckpt.data_ptr(), wkv.ELEM[r.dtype],
            B, T, H, hd, ctypes.addressof(st), stream())
        if rc:
            raise RuntimeError(f"other rwkv6_scan_fwd: CUDA error {rc}")
        return y, ckpt

    def bwd(r, k, v, w, u, ckpt, dy):
        B, T, H, hd = r.shape
        grads = [torch.empty_like(r) for _ in range(3)]
        dw = torch.empty_like(w)
        du = torch.empty((H, hd), device="cuda")
        du_part = torch.empty((B, H, hd), dtype=torch.float64, device="cuda")
        st = wkv._strides(r, k, v, w, dy, *grads, dw)
        rc = lib.rwkv6_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
            *(g.data_ptr() for g in grads), dw.data_ptr(),
            du_part.data_ptr(), du.data_ptr(), wkv.ELEM[r.dtype], B, T, H,
            hd, ctypes.addressof(st), stream())
        if rc:
            raise RuntimeError(f"other rwkv6_scan_bwd: CUDA error {rc}")
        return (*grads, dw, du)
    return fwd, bwd


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as wkv
    if not torch.cuda.is_available() or len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi(), flush=True)
    t0 = time.perf_counter()
    print("build", _build.build_all((wkv.NAME,)),
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.library_path(wkv.NAME)
    cs.print_ptxas(wkv.NAME, log.with_name(log.name + ".log").read_text())
    other = None
    if len(sys.argv) == 2:
        other = other_calls(load_other(Path(sys.argv[1]), _build._nvcc(),
                                       _build.NVCC_FLAGS), wkv)
    this = (lambda *a: wkv.rwkv6_scan(*a, with_state=True),
            wkv.rwkv6_scan_bwd)
    B, T, H, hd = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for mean in (0.0, 2.0):
        ins32 = cs.wkv_inputs(torch, gen, B, T, H, hd, torch.float32, mean)
        dy32 = torch.randn(SHAPE, generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            ins = [x.to(dt) for x in ins32[:3]] + list(ins32[3:])
            dy = dy32.to(dt)
            y, ckpt = this[0](*ins)
            outs = (y, *this[1](*ins, ckpt, dy))
            row = dict(dtype=str(dt)[6:], decay_mean=mean, chunk=wkv.chunk(),
                       checkpoint_bytes=cs.nbytes(ckpt))
            if other is not None:
                yo, cko = other[0](*ins)
                outs_o = (yo, *other[1](*ins, cko, dy))
                diff, norm = {}, {}
                for name, a, b in zip(("y", "dr", "dk", "dv", "dw", "du"),
                                      outs, outs_o):
                    d = (a.float() - b.float()).abs().max().item()
                    diff[name] = d
                    norm[name] = d / max(b.float().abs().max().item(), 1e-30)
                ok = (all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                          for a, b in zip(outs, outs_o))
                      if dt == torch.float32
                      else max(norm.values()) <= cs.BF16_TOL)
                bad += not ok
                row.update(other_checkpoint_bytes=cs.nbytes(cko),
                           max_abs_diff=diff, normalized_diff=norm, ok=ok)
                del yo, cko, outs_o
            if dt == torch.bfloat16:
                # the bounds of chip_smoke.py's rows: the function's own
                # bytes, 5 (forward) and 14 (backward) hd^2 f32 FLOPs a step
                f_ms, f_by = cs.bound(cs.nbytes(*ins, y),
                                      5.0 * hd * hd * B * T * H, "float32")
                b_ms, b_by = cs.bound(cs.nbytes(*ins, dy, *outs[1:]),
                                      14.0 * hd * hd * B * T * H, "float32")
                sets = cs.rotation((*ins, dy))
                n = len(sets)
                turns = [("this", this), ("this_2", this)]
                if other is not None:
                    turns = [("other", other)] + turns + [("other_2", other)]
                fwd_ms, bwd_ms = {}, {}
                for tag, (fwd, bwd) in turns:
                    fwd_ms[tag] = cs.time_ms(
                        lambda i: fwd(*sets[i % n][:5]), 20)[0]
                    cks = [fwd(*s[:5])[1] for s in sets]
                    bwd_ms[tag] = cs.time_ms(lambda i: bwd(
                        *sets[i % n][:5], cks[i % n], sets[i % n][5]),
                        10)[0]
                    del cks
                row.update(fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_bound_ms=f_ms,
                           fwd_bound_by=f_by, bwd_bound_ms=b_ms,
                           bwd_bound_by=b_by)
                del sets
            print("wkv", json.dumps(row), flush=True)
            del outs, y, ckpt
            torch.cuda.empty_cache()
    print(cs.smi())
    print(f"cases whose outputs differ past the tolerance: {bad}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
