#!/usr/bin/env python3
"""This checkout's RG-LRU kernels (``csrc/rglru_scan.cu``) on one card,
alone or against another version of that source: ptxas' registers and
spills, then at recurrentgemma-2b's training shape (B4 T512 D2560, bf16
x, a and dy), with the decay from the model's map and near 1, the device
times of the forward (with the state it keeps for the backward, as
training calls it) and of the backward, taken in turns (other, this,
this, other) so that both sides see the same card, beside the bounds
``chip_smoke.py`` computes; and the largest difference of each output
(y, dx, da) between the two versions, in bf16 and in f32 on the same
inputs.

    mkdir -p build/other
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/other
    python3 tools/lru_compare.py build/other      # or with no argument

The other version is built with ``nvcc`` from that directory (into it:
keep it under the ignored ``build/``) and called through the sequential
kernels' C interface: one thread per (b, channel) chain that writes every
f32 state h_t (B, T, D), which its backward reads.  Needs one CUDA card.
Exits non-zero if an output of the two versions differs, as a share of
its largest magnitude, by more than 1e-5 in f32 (the two sum in different
orders, and with a near 1 over 512 steps da reaches thousands, where
their f32 roundings differ by a few 1e-3) or 2e-2 in bf16.
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

SHAPE = (4, 512, 2560)
DRAWS = ("model", "near1")
F32_NORM_TOL = 1e-5
_P, _I = ctypes.c_void_p, ctypes.c_int


def load_other(src: Path, nvcc: str, flags) -> ctypes.CDLL:
    """The other version's library, built from ``src`` with ``flags``."""
    so = src / "liblru_other.so"
    subprocess.run([nvcc, *flags, "-o", str(so), str(src / "rglru_scan.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def other_calls(lib: ctypes.CDLL, lru):
    """(forward with its states, backward) through the other library's C
    interface (the sequential walk's: every f32 state h_t)."""
    lib.rglru_scan_fwd.argtypes = [_P] * 4 + [_I] * 4 + [_P, _P]
    lib.rglru_scan_bwd.argtypes = [_P] * 6 + [_I] * 4 + [_P, _P]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def fwd(x, a):
        B, T, D = x.shape
        y = torch.empty_like(x)
        hs = torch.empty((B, T, D), device="cuda")
        st = lru._strides(x, a)
        rc = lib.rglru_scan_fwd(x.data_ptr(), a.data_ptr(), y.data_ptr(),
                                hs.data_ptr(), lru.ELEM[x.dtype], B, T, D,
                                ctypes.addressof(st), stream())
        if rc:
            raise RuntimeError(f"other rglru_scan_fwd: CUDA error {rc}")
        return y, hs

    def bwd(x, a, hs, dy):
        B, T, D = x.shape
        dx, da = torch.empty_like(x), torch.empty_like(x)
        st = lru._strides(x, a, dy)
        rc = lib.rglru_scan_bwd(x.data_ptr(), a.data_ptr(), hs.data_ptr(),
                                dy.data_ptr(), dx.data_ptr(), da.data_ptr(),
                                lru.ELEM[x.dtype], B, T, D,
                                ctypes.addressof(st), stream())
        if rc:
            raise RuntimeError(f"other rglru_scan_bwd: CUDA error {rc}")
        return dx, da
    return fwd, bwd


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as lru
    if not torch.cuda.is_available() or len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.smi(), flush=True)
    t0 = time.perf_counter()
    print("build", _build.build_all((lru.NAME,)),
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.library_path(lru.NAME)
    cs.print_ptxas(lru.NAME, log.with_name(log.name + ".log").read_text())
    other = None
    if len(sys.argv) == 2:
        other = other_calls(load_other(Path(sys.argv[1]), _build._nvcc(),
                                       _build.NVCC_FLAGS), lru)
    this = (lambda x, a: lru.rglru_scan(x, a, with_state=True),
            lru.rglru_scan_bwd)
    B, T, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for draw in DRAWS:
        x32, a32 = cs.lru_inputs(torch, gen, B, T, D, torch.float32, draw)
        dy32 = torch.randn(SHAPE, generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x, a, dy = x32.to(dt), a32.to(dt), dy32.to(dt)
            y, ck = this[0](x, a)
            outs = (y, *this[1](x, a, ck, dy))
            row = dict(dtype=str(dt)[6:], draw=draw, chunk=lru.chunk(),
                       checkpoint_bytes=cs.nbytes(ck),
                       saturated_share=(a == 1.0).float().mean().item())
            if other is not None:
                yo, hs = other[0](x, a)
                outs_o = (yo, *other[1](x, a, hs, dy))
                diff, norm = {}, {}
                for name, p, q in zip(("y", "dx", "da"), outs, outs_o):
                    d = (p.float() - q.float()).abs().max().item()
                    diff[name] = d
                    norm[name] = d / max(q.float().abs().max().item(), 1e-30)
                ok = max(norm.values()) <= (F32_NORM_TOL
                                            if dt == torch.float32
                                            else cs.BF16_TOL)
                bad += not ok
                row.update(other_state_bytes=cs.nbytes(hs),
                           max_abs_diff=diff, normalized_diff=norm, ok=ok)
                del yo, hs, outs_o
            if dt == torch.bfloat16:
                # the bounds of chip_smoke.py's rows: the function's own
                # bytes, 6 (forward) and 10 (backward) f32 FLOPs a step
                f_ms, f_by = cs.bound(cs.nbytes(x, a, y),
                                      cs.LRU_FWD_FLOPS * B * T * D, "float32")
                b_ms, b_by = cs.bound(cs.nbytes(x, a, dy, *outs[1:]),
                                      cs.LRU_BWD_FLOPS * B * T * D, "float32")
                sets = cs.rotation((x, a, dy))
                n = len(sets)
                turns = [("this", this), ("this_2", this)]
                if other is not None:
                    turns = [("other", other)] + turns + [("other_2", other)]
                fwd_ms, bwd_ms = {}, {}
                for tag, (fwd, bwd) in turns:
                    fwd_ms[tag] = cs.time_ms(
                        lambda i: fwd(*sets[i % n][:2]), 20)[0]
                    states = [fwd(*s[:2])[1] for s in sets]
                    bwd_ms[tag] = cs.time_ms(lambda i: bwd(
                        *sets[i % n][:2], states[i % n], sets[i % n][2]),
                        20)[0]
                    del states
                row.update(fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_bound_ms=f_ms,
                           fwd_bound_by=f_by, bwd_bound_ms=b_ms,
                           bwd_bound_by=b_by)
                del sets
            print("lru", json.dumps(row), flush=True)
            del outs, y, ck
            torch.cuda.empty_cache()
    print(cs.smi())
    print(f"cases whose outputs differ past the tolerance: {bad}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
