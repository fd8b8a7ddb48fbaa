#!/usr/bin/env python3
"""Variants of this checkout's grouped MoE backward (``moe_bwd_tc_kernel``
in ``csrc/moe_grouped_ffn.cu``) on one card: each variant is the source
with some of its lines replaced, built with ``nvcc`` under the ignored
``build/moe_variants/`` and timed beside the source as it is, in turns
(this, variants..., this), at mixtral-8x7b's training shape (G 2, g 1024,
E 8, C 320, d 4096, f 14336, bf16, top-2): the whole backward from one
forward's saved tensors, and each of its launches from a profiler trace,
with ptxas' registers and spills.  A variant marked exact is held to the
source's gradients (a normalized 2e-2); the others take work out of the
kernel (the producer's loads, the consumers' products, the row lists'
reads) to show which part sets its time, and compute nothing usable.

    python3 tools/moe_bwd_variants.py [name ...]     # default: all

Needs one CUDA card.  Exits non-zero if a variant does not build or an
exact one disagrees.
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

SHAPE = (2, 1024, 8, 320, 4096, 14336)
# name: (exact, [(line of the source, its replacement)])
VARIANTS = {
    # the producer fills no stage: the consumers' products and stores
    "no_loads": (False, [
        ("        tc_load<MODE>(p, T, kt, As, As + TB_A, full, tid);\n", ""),
        ("mbar_expect_tx(full, TB_A + TB_B);", "mbar_expect_tx(full, 0);")]),
    # the consumers multiply nothing: the producer's ring and the stores
    "no_products": (False, [(
        "        wgmma_ss_n256<TRANS>(acc, da, db);\n", "")]),
    # no tile is stored: the ring and the products
    "no_stores": (False, [("    tc_epilogue<MODE>(p, T, cw, acc, out);\n",
                            "")]),
    # a ring of three stages
    "stages3": (True, [("constexpr int TB_STAGES = 4;",
                        "constexpr int TB_STAGES = 3;")]),
    # dh's SwiGLU gradient through the approximate exp and reciprocal
    "fast_swiglu": (True, [(
        "const float s0 = 1.f / (1.f + expf(-a.x)), "
        "s1 = 1.f / (1.f + expf(-a.y));",
        "const float s0 = __fdividef(1.f, 1.f + __expf(-a.x)), "
        "s1 = __fdividef(1.f, 1.f + __expf(-a.y));")]),
    # the second consumer warpgroup starts 4 us late, so that the two
    # store their tiles at different times
    "skew": (True, [(
        "  const int cw = role - 1;  // rows 64 cw.. of each tile\n",
        "  const int cw = role - 1;  // rows 64 cw.. of each tile\n"
        "  if (cw == 1) __nanosleep(4000);\n")]),
    # the weight gradients' epilogue in parts: without its proxy fence,
    # its TMA stores, or its writes of the tile to shared memory
    "wg_no_fence": (False, [(
        "  fence_proxy_async();\n  named_barrier(1 + cw, 128);\n",
        "  named_barrier(1 + cw, 128);\n")]),
    "wg_no_tma_store": (False, [(
        "      tma_store_3d(map, out + blk * (64 * 128), col, m, T.z);\n",
        "")]),
    "wg_no_smem": (False, [(
        '      asm volatile("st.shared.b32 [%0], %1;\\n" ::"r"(\n'
        "                       out + swz<64>(r, col)),\n"
        '                   "r"(*reinterpret_cast<const uint32_t*>(&v)));\n',
        "      (void)v;\n")]),
}


def build(name: str, edits, nvcc: str, flags) -> tuple[Path, str]:
    """The variant's library and ptxas' report."""
    out = ROOT / "build" / "moe_variants"
    out.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "moe_grouped_ffn.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} is not in the source")
        src = src.replace(old, new)
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
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_matmul as mm
    names = sys.argv[1:] or list(VARIANTS)
    if not torch.cuda.is_available() or any(n not in VARIANTS
                                            for n in names):
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.smi(), flush=True)
    nvcc = _build._nvcc()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        this = pool.submit(_build.build_all, (mm.NAME,))
        built = {n: pool.submit(build, n, VARIANTS[n][1], nvcc,
                                _build.NVCC_FLAGS) for n in names}
        this.result()
        log = _build.library_path(mm.NAME)
        cs.print_ptxas("this", log.with_name(log.name + ".log").read_text())
        libs = {"this": _build.load(mm.NAME, mm.SIGNATURES)}
        for n in names:
            so, report = built[n].result()
            cs.print_ptxas(n, "\n".join(
                line for line in report.splitlines() if "bwd_tc" in line
                or "Compiling entry" in line or "spill" in line))
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in mm.SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            libs[n] = lib

    G, g, E, C, d, f = SHAPE
    bf = torch.bfloat16
    cfg = get_config("mixtral-8x7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ws = tuple((torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5)
               .to(bf) for s in ((E, d, f), (E, d, f), (E, f, d)))
    dispatch, combine = cs.moe_route(torch, gen, cfg, g, G)
    x = torch.randn((G, g, d), generator=gen, device="cuda").to(bf)
    dout = torch.randn((G, g, d), generator=gen, device="cuda").to(bf)
    _, sv = mm.launch_forward((dispatch, combine, x, *ws), save=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dev = dict(device="cuda")

    def backward(lib):
        def fn(i=0):
            grads = (torch.empty_like(x), torch.empty(dispatch.shape, **dev),
                     *(torch.empty_like(w) for w in ws))
            scratch = (torch.empty((E, G * C, d), dtype=bf, **dev),
                       torch.empty((E, G * C, f), dtype=bf, **dev),
                       torch.empty((E, G * C, f), dtype=bf, **dev),
                       torch.empty((G, E, C, d), **dev),
                       torch.empty(E * G * C + E + G * E * C,
                                   dtype=torch.int32, **dev))
            rc = lib.moe_grouped_ffn_bwd(
                *(t.data_ptr() for t in (dispatch, combine, dout, *ws)),
                *(sv[k].data_ptr() for k in ("xin", "h", "a", "b", "y",
                                             "live")),
                *(t.data_ptr() for t in grads + scratch), mm.ELEM[bf], G, g,
                E, C, d, f, sv["ks"], n_sm,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"moe_grouped_ffn_bwd: CUDA error {rc}")
            return grads
        return fn

    want = backward(libs["this"])()
    bad = 0
    for name in ["this", *names, "this"]:
        fn = backward(libs[name])
        exact = name == "this" or VARIANTS[name][0]
        errs = None
        if exact:
            errs = cs._moe_bwd_errs(torch, fn(), want)
            bad += max(errs.values()) > cs.BWD_BF16_NORM_TOL
        row = dict(name=name, exact=exact, normalized_err_vs_this=errs,
                   ms=cs.time_ms(fn, 10)[0],
                   launches=cs.launch_breakdown(fn, cs.MOE_BWD_LAUNCHES))
        print("variant", json.dumps(row), flush=True)
    print(cs.smi())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
