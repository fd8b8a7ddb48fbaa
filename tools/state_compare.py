#!/usr/bin/env python3
"""The training path of this checkout's recurrence forwards (the WKV of
``csrc/rwkv6_scan.cu`` and the RG-LRU of ``csrc/rglru_scan.cu``, called
with no start state and with their checkpoints, as training calls them)
against another version of those sources that takes no start state: the
outputs and every checkpoint compared bit for bit, in f32 and bf16, at
rwkv6-1.6b's and recurrentgemma-2b's training shapes (B4 T512 H32 hd64;
B4 T512 D2560), and the device times taken in turns (other, this, this,
other) so that both sides see the same card.

    mkdir -p build/other
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/other
    python3 tools/state_compare.py build/other

The other version is built with ``nvcc`` from that directory (into it:
keep it under the ignored ``build/``) and called through its C interface
without the state arguments.  Needs one CUDA card.  Exits non-zero if any
output or checkpoint of the two versions differs in a bit.
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

_P, _I = ctypes.c_void_p, ctypes.c_int


def load_other(src: Path, name: str, nvcc: str, flags) -> ctypes.CDLL:
    """The other version's library of ``name``, built from ``src``."""
    so = src / f"lib{name}_other.so"
    subprocess.run([nvcc, *flags, "-o", str(so), str(src / f"{name}.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def other_wkv(lib: ctypes.CDLL, wkv):
    """The other WKV forward with its checkpoints: (y, ckpt)."""
    lib.rwkv6_scan_fwd.argtypes = [_P] * 8 + [_I] * 6 + [_P, _P]

    def fwd(r, k, v, w, u):
        B, T, H, hd = r.shape
        y = torch.empty_like(r)
        ckpt = torch.empty((B, H, wkv.n_checkpoints(T), hd, hd),
                           device="cuda")
        p = wkv.plan(B, T, H, hd)
        summ = wkv._scratch(p, r.device)
        st = wkv._strides(r, k, v, w, y)
        rc = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), ckpt.data_ptr(),
            None if summ is None else summ.data_ptr(), wkv.ELEM[r.dtype], B,
            T, H, hd, p["chunk"], ctypes.addressof(st),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"other rwkv6_scan_fwd: CUDA error {rc}")
        return y, ckpt
    return fwd


def other_lru(lib: ctypes.CDLL, lru):
    """The other RG-LRU forward with its checkpoints: (y, ck)."""
    lib.rglru_scan_fwd.argtypes = [_P] * 4 + [_I] * 5 + [_P, _P]

    def fwd(x, a):
        B, T, D = x.shape
        y = torch.empty_like(x)
        ck = torch.empty((B, lru.n_checkpoints(T), D), device="cuda")
        st = lru._strides(x, a)
        rc = lib.rglru_scan_fwd(x.data_ptr(), a.data_ptr(), y.data_ptr(),
                                ck.data_ptr(), lru.ELEM[x.dtype], B, T, D,
                                lru.CHUNK, ctypes.addressof(st),
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"other rglru_scan_fwd: CUDA error {rc}")
        return y, ck
    return fwd


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as lru
    from repro_torch.kernels import rwkv6_scan as wkv
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.smi(), flush=True)
    print("build", _build.build_all((wkv.NAME, lru.NAME)), flush=True)
    src = Path(sys.argv[1])
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    cases = {
        "rwkv6_scan": (other_wkv(load_other(src, wkv.NAME, nvcc, flags),
                                 wkv),
                       lambda *t: wkv.rwkv6_scan(*t, with_state=True),
                       lambda g, dt: cs.wkv_inputs(torch, g, *cs.WKV_MAIN,
                                                   dt)),
        "rglru_scan": (other_lru(load_other(src, lru.NAME, nvcc, flags),
                                 lru),
                       lambda *t: lru.rglru_scan(*t, with_state=True),
                       lambda g, dt: cs.lru_inputs(torch, g, *cs.LRU_MAIN,
                                                   dt))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for name, (other, this, inputs) in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            ins = inputs(gen, dt)
            got, want = this(*ins), other(*ins)
            torch.cuda.synchronize()
            same = {part: torch.equal(p, q)
                    for part, p, q in zip(("y", "checkpoints"), got, want)}
            bad += not all(same.values())
            row = dict(kernel=name, dtype=str(dt)[6:],
                       shape=list(ins[0].shape), bit_identical=same)
            if dt == torch.bfloat16:
                sets = cs.rotation(ins)
                n = len(sets)
                row["ms"] = {tag: cs.time_ms(lambda i: fn(*sets[i % n]),
                                             20)[0]
                             for tag, fn in (("other", other), ("this", this),
                                             ("this_2", this),
                                             ("other_2", other))}
                del sets
            print("state_compare", json.dumps(row), flush=True)
            del ins, got, want
            torch.cuda.empty_cache()
    print(cs.smi())
    print(f"cases whose bits differ: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
