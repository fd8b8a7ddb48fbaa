#!/usr/bin/env python3
"""This checkout's flash-attention kernels against another version of
``csrc/flash_attention.cu`` on one card: f32 results bit for bit, and bf16
device times at every shape ``chip_smoke.py`` times, taken in turns
(other, this, this, other) so that both sides see the same card.

    mkdir -p build/other
    git archive <rev> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/other
    python3 tools/flash_compare.py build/other

The other version is built with ``nvcc`` from that directory (into it:
keep it under the ignored ``build/``) and called through the earlier C
interface, whose ``flash_attention_bwd`` takes no partial-sum scratch.
Needs one CUDA card.  Prints the card, one JSON line per shape, and exits
non-zero if an f32 result differs in any bit."""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# f32 parity shapes (B, S, H, KV, hd, causal, window): head dims below 64
# (padded inside the kernels), ragged tails, GQA groups 1-10, windows
PARITY = [(2, 64, 4, 4, 32, True, 0), (2, 130, 6, 2, 16, True, 24),
          (2, 96, 4, 2, 64, False, 0), (2, 77, 8, 1, 128, True, 0),
          (2, 100, 10, 1, 256, True, 24), (2, 200, 15, 5, 20, True, 0)]


def load_other(src: Path, nvcc: str, flags) -> ctypes.CDLL:
    """The other version's library, built from ``src`` with ``flags``."""
    so = src / "libflash_other.so"
    subprocess.run([nvcc, *flags, "-o", str(so),
                    str(src / "flash_attention.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [P] * 5 + [I] * 6 + [P, F, I, I, P]
    lib.flash_attention_bwd.argtypes = [P] * 10 + [I] * 6 + [P, F, I, I, P]
    return lib


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    other = load_other(Path(sys.argv[1]), _build._nvcc(), _build.NVCC_FLAGS)

    def other_fwd(q, k, v, causal=True, window=0, with_lse=False):
        B, S, H, hd = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32,
                          device="cuda") if with_lse else None
        st = fa._strides(q, k, v, o)
        rc = other.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), fa.ELEM[q.dtype], B, S,
            H, k.shape[2], hd, ctypes.addressof(st), hd ** -0.5,
            int(causal), int(window),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return (o, lse) if with_lse else o

    def other_bwd(q, k, v, o, do, lse, causal=True, window=0):
        B, S, H, hd = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        D = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        st = fa._strides(q, k, v, o, do, dq, dk, dv)
        rc = other.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), fa.ELEM[q.dtype], B, S, H,
            k.shape[2], hd, ctypes.addressof(st), hd ** -0.5, int(causal),
            int(window), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return dq, dk, dv

    print(cs.smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def mk(B, S, n, hd, dtype=torch.float32):
        return torch.randn((B, S, n, hd), generator=gen,
                           device="cuda").to(dtype)

    differ = 0
    for B, S, H, KV, hd, causal, w in PARITY:
        q, k, v, do = mk(B, S, H, hd), mk(B, S, KV, hd), mk(B, S, KV, hd), \
            mk(B, S, H, hd)
        o1, l1 = other_fwd(q, k, v, causal, w, True)
        o2, l2 = fa.flash_attention(q, k, v, causal=causal, window=w,
                                    with_lse=True)
        g1 = other_bwd(q, k, v, o1, do, l1, causal, w)
        g2 = fa.flash_attention_bwd(q, k, v, o2, do, l2, causal=causal,
                                    window=w)
        same = [torch.equal(a, b) for a, b in zip((o1, l1, *g1),
                                                  (o2, l2, *g2))]
        differ += not all(same)
        print("f32 bits", json.dumps(dict(
            shape=[B, S, H, KV, hd], causal=causal, window=w,
            o_lse_dq_dk_dv_equal=same)), flush=True)

    bf = torch.bfloat16
    for B, S, H, KV, hd, w in cs.FLASH_CASES:
        sets = cs.rotation((mk(B, S, H, hd, bf), mk(B, S, KV, hd, bf),
                            mk(B, S, KV, hd, bf)))
        n = len(sets)
        ms = {}
        for tag, f in (("other", other_fwd), ("this", fa.flash_attention),
                       ("this_2", fa.flash_attention),
                       ("other_2", other_fwd)):
            ms[tag] = cs.time_ms(
                lambda i: f(*sets[i % n], True, w), 20)[0]
        print("bf16 forward ms", json.dumps(dict(
            shape=[B, S, H, KV, hd], window=w, **ms)), flush=True)
        del sets
    for B, S, H, KV, hd, causal, w in cs.FLASH_BWD_CASES:
        q, k, v, do = mk(B, S, H, hd, bf), mk(B, S, KV, hd, bf), \
            mk(B, S, KV, hd, bf), mk(B, S, H, hd, bf)
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=w,
                                    with_lse=True)
        sets = cs.rotation((q, k, v, o, do, lse))
        n = len(sets)
        ms = {}
        for tag, f in (("other", other_bwd), ("this", fa.flash_attention_bwd),
                       ("this_2", fa.flash_attention_bwd),
                       ("other_2", other_bwd)):
            ms[tag] = cs.time_ms(
                lambda i: f(*sets[i % n], causal, w), 10)[0]
        print("bf16 backward ms", json.dumps(dict(
            shape=[B, S, H, KV, hd], causal=causal, window=w, **ms)),
            flush=True)
        del sets
    torch.cuda.synchronize()
    print(f"f32 shapes differing: {differ} of {len(PARITY)}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
