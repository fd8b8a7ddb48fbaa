"""The grouped MoE FFN kernels' plan and bf16 rounding, on the CPU.

``moe_matmul.plan`` states the tiles, rings, grids and shared memory of
the CUDA kernels from the shapes alone (the card's tests and
``chip_smoke.py`` hold the built library to the same numbers); here it is
held to the H100's limits at mixtral-8x7b's serving shapes and at the
shapes of ``tests/test_torch_cuda.py``, to reading no data, and to
filling the card at decode.  The bf16 kernels round xin (a slot's token,
or the f32 sum of several) and H = silu(xin wg) * (xin wu), computed in
f32, once to bf16, and keep the down product's split partials, their sum
and the combine in f32.  An emulation of that rounding in plain torch,
written here and not in the package, is held to the JAX package's Pallas
kernel in interpret mode and to the same function in f64 at half of the
card's gate: a normalized max error (max |emu - ref| / max |ref|) of
1e-2, so the gate keeps a margin over what the rounding alone costs.
``moe_matmul.plan_bwd``, the backward's tiles, tile queues and grids, is
held to the same limits at mixtral's training shape, to reading no data,
and to the CUDA source's constants; ``moe_matmul.expert_rows``, the plain
version of the bf16 backward's row lists, to a numpy loop.
"""
import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_matmul import \
    moe_grouped_ffn as pallas_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import SMEM_LIMIT, SMS  # noqa
from repro_torch.kernels import moe_matmul as mm  # noqa: E402
from repro_torch.kernels.moe_matmul import (  # noqa: E402
    MAX_GRID, SLOT_TILES, plan, plan_bwd)
from repro_torch.models.moe import route  # noqa: E402

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
NORM_TOL = 1e-2          # half of chip_smoke.py's bf16 gate (2e-2)
MIXTRAL = get_config("mixtral-8x7b")


def _capacity(g: int, cfg=MIXTRAL) -> int:
    return max(math.ceil(g * cfg.top_k * cfg.capacity_factor
                         / cfg.n_experts), 1)


# (G, g, E, C, d, f): mixtral-8x7b's decode batch, 128-token chunk and
# 300- and 512-token prompts, then the shapes of test_torch_cuda.py's
# MoE tests
MIXTRAL_SHAPES = [(1, g, MIXTRAL.n_experts, _capacity(g), MIXTRAL.d_model,
                   MIXTRAL.d_ff) for g in (8, 128, 300, 512)]
TEST_SHAPES = [(1, 16, 4, 8, 32, 48), (2, 24, 4, 16, 16, 64),
               (1, 32, 8, 10, 64, 96), (1, 8, 8, 3, 256, 512),
               (1, 128, 8, 40, 128, 256), (1, 300, 8, 94, 64, 128),
               (1, 16, 4, 8, 64, 96), (1, 8, 8, 2, 256, 512),
               (1, 8, 8, 2, 64, 96)]


def test_mixtral_capacities():
    assert [s[3] for s in MIXTRAL_SHAPES] == [3, 40, 94, 160]


def _in_flight(p: dict, kind: str) -> int:
    """Weight bytes a bf16 SM has in flight: the stages each block keeps
    loading ahead of the one multiplied and the one whose wgmma group is
    still pending, 32 KB each."""
    return p[kind]["resident"] * (p[kind]["stages"] - 2) * 32 * 1024


@pytest.mark.parametrize("shape", MIXTRAL_SHAPES + TEST_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_shared_memory_and_the_grid(shape, dtype):
    G, g, E, C, d, f = shape
    p = plan(G, g, E, C, d, f, dtype, SMS)
    chunks = -(-f // p["depth"])
    assert p["ks"] * p["per"] >= chunks > (p["ks"] - 1) * p["per"]
    bf16 = dtype == torch.bfloat16
    slot_tiles = p["up"]["grid"][0 if bf16 else 1]
    assert slot_tiles * p["slots"] >= C > (slot_tiles - 1) * p["slots"]
    for kind in ("up", "down"):
        k = p[kind]
        if bf16:            # dynamic, plus the slots' static live flags
            assert 0 < k["smem"] + 4 * p["slots"] <= SMEM_LIMIT, (kind, k)
            assert _in_flight(p, kind) >= 32 * 1024, (kind, k)
        else:               # static only
            assert 0 < k["smem"] <= 48 * 1024, (kind, k)
        assert k["resident"] >= 1 and k["threads"] in (128, 256)
        x, y, z = k["grid"]
        assert 0 < x < 2 ** 31 and 0 < y <= MAX_GRID and 0 < z <= MAX_GRID
        cols = d if kind == "down" else f
        assert k["cols"] * (y if bf16 else x) >= cols
    assert p["down"]["grid"][2] == G * E * p["ks"]
    if bf16:
        assert p["tile"] in SLOT_TILES
        assert p["up"]["stages"] == p["down"]["stages"] >= 3


@pytest.mark.parametrize("C", [1, 2, 3, 8, 9, 40, 94, 160, 161, 400, 640])
def test_bf16_slot_tile(C):
    """The narrowest built width that holds C; past 160 slots, C is cut
    into even tiles of at most 160."""
    p = plan(1, 512, 8, C, 4096, 14336, torch.bfloat16, SMS)
    tiles = p["up"]["grid"][0]
    assert tiles == -(-C // p["tile"]) and tiles * p["tile"] >= C
    assert p["tile"] == min(t for t in SLOT_TILES if t >= -(-C // tiles))
    assert tiles == max(1, -(-C // SLOT_TILES[-1]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_reads_no_data(dtype):
    """The plan takes shapes, a dtype and the SM count, never a tensor:
    a token's bits cannot depend on where the other tokens went.  It is
    a pure function of them, and does not read the group's token count g
    at all."""
    assert list(inspect.signature(plan).parameters) == \
        ["G", "g", "E", "C", "d", "f", "dtype", "n_sm"]
    for G, g, E, C, d, f in MIXTRAL_SHAPES + TEST_SHAPES:
        p = plan(G, g, E, C, d, f, dtype, SMS)
        assert p == plan(G, g, E, C, d, f, dtype, SMS)
        assert p == plan(G, 10 * g + 1, E, C, d, f, dtype, SMS)


def test_plan_fills_the_card_at_decode():
    """A mixtral decode batch (C = 3, 6 of 8 experts with a token): the
    live experts' blocks give each product at least two blocks for every
    SM (the down product through its split of f), and each SM keeps at
    least 64 KB of weights in flight (one block an SM, a ring of six
    stages: a block streams deeper than two blocks of three stages
    could)."""
    G, g, E, C, d, f = MIXTRAL_SHAPES[0]
    p = plan(G, g, E, C, d, f, torch.bfloat16, SMS)
    assert p["tile"] == 8 and p["ks"] > 1
    live_experts = 6
    for kind in ("up", "down"):
        x, y, z = p[kind]["grid"]
        assert p[kind]["resident"] >= 1, p[kind]
        assert x * y * z * live_experts // E >= 2 * SMS, (kind, p[kind])
        assert _in_flight(p, kind) >= 64 * 1024, (kind, p[kind])


# ---------------------------------------------------------------------------
# the bf16 kernels' rounding, emulated
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate(dispatch, combine, x, wg, wu, wd, ks, per, depth):
    """The bf16 route's arithmetic in f32: xin = bf16(sum of the slot's
    tokens), H = bf16(silu(xin wg) * (xin wu)), the down product summed
    in f32 over each of ks parts of f (``per`` chunks of ``depth``), the
    parts added in order, the combine in f32, the output rounded once."""
    disp = dispatch.float()
    xin = _bf16(torch.einsum("GgEC,Ggd->GECd", disp, x))
    gate = torch.einsum("GECd,Edf->GECf", xin, wg)
    up = torch.einsum("GECd,Edf->GECf", xin, wu)
    h = _bf16(torch.nn.functional.silu(gate) * up)
    y = 0
    for s in range(ks):
        lo, hi = s * per * depth, (s + 1) * per * depth
        y = y + torch.einsum("GECf,Efd->GECd", h[..., lo:hi], wd[:, lo:hi])
    return _bf16(torch.einsum("GgEC,GECd->Ggd", combine, y))


def _f64(dispatch, combine, x, wg, wu, wd):
    xin = torch.einsum("GgEC,Ggd->GECd", dispatch.double(), x)
    h = torch.nn.functional.silu(torch.einsum("GECd,Edf->GECf", xin, wg)) \
        * torch.einsum("GECd,Edf->GECf", xin, wu)
    return torch.einsum("GgEC,GECd->Ggd", combine.double(),
                        torch.einsum("GECf,Efd->GECd", h, wd))


def _inputs(G, g, E, C, d, f, seed, two_in_one_slot):
    """bf16 values (held as f32) from numpy: top-2 routing through the
    port's ``route``, or a random dispatch with tokens 0 and 1 in one
    slot and a random combine."""
    rng = np.random.default_rng(seed)
    if two_in_one_slot:
        dispatch = torch.from_numpy(rng.random((G, g, E, C)) < 0.15)
        dispatch[0, 0, 1, 3] = dispatch[0, 1, 1, 3] = True
        combine = torch.from_numpy(rng.random((G, g, E, C)).astype(
            np.float32))
    else:
        logits = torch.from_numpy(rng.standard_normal((G, g, E)).astype(
            np.float32))
        dispatch, combine = route(torch.softmax(logits, -1), 2, C)
    x = _bf16(torch.from_numpy(rng.standard_normal((G, g, d)).astype(
        np.float32)))
    ws = [_bf16(torch.from_numpy((rng.standard_normal(s) * s[1] ** -0.5)
                                 .astype(np.float32)))
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    return dispatch, combine, x, *ws


@pytest.mark.parametrize("G,g,E,C,d,f,two", [
    (1, 16, 4, 8, 32, 48, False),
    (2, 24, 4, 16, 16, 64, False),
    (1, 32, 8, 10, 64, 96, False),       # capacity drops
    (1, 8, 8, 3, 256, 512, False),       # a decode batch: C 3, f split
    (1, 16, 4, 8, 64, 96, True),         # two tokens in one slot
])
def test_bf16_rounding_within_half_the_gate(G, g, E, C, d, f, two):
    ins = _inputs(G, g, E, C, d, f, seed=19, two_in_one_slot=two)
    p = plan(G, g, E, C, d, f, torch.bfloat16, SMS)
    emu = _emulate(*ins, p["ks"], p["per"], p["depth"])
    assert emu.shape == (G, g, d)
    want64 = _f64(*(t.double() if t.is_floating_point() else t
                    for t in ins))
    jin = [jnp.asarray(t.numpy()) for t in ins[:2]] + \
        [jnp.asarray(t.numpy()).astype(jnp.bfloat16) for t in ins[2:]]
    pallas = torch.from_numpy(np.asarray(
        pallas_moe(*jin, interpret=True), np.float32))
    for ref in (want64, pallas.double()):
        err = (emu.double() - ref).abs().max() / ref.abs().max()
        assert err <= NORM_TOL, float(err)
    if two:                              # the shared slot's xin was rounded
        assert ins[0][0, :, 1, 3].sum() >= 2
    if C == 3:                           # the decode shape splits f
        assert p["ks"] > 1



# ---------------------------------------------------------------------------
# the backward's plan
# ---------------------------------------------------------------------------

# (G, g, E, C, d, f): mixtral-8x7b's training shape (batch 4 x 512 in
# groups of 1024: C 320), llama4-scout's smoke-like width, the CUDA tests'
BWD_SHAPES = [(2, 1024, 8, 320, 4096, 14336), (1, 16, 4, 8, 32, 48),
              (2, 24, 4, 16, 16, 64), (2, 300, 8, 94, 64, 128),
              (1, 512, 8, 160, 256, 384), (4, 64, 16, 10, 5120, 8192)]


def test_mixtral_training_capacity():
    assert _capacity(1024) == 320


@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_bwd_fits_shared_memory_and_the_grid(shape, dtype):
    G, g, E, C, d, f = shape
    p = plan_bwd(G, g, E, C, d, f, dtype, SMS)
    t = p["tile"]
    assert t["route"] == ("wgmma" if dtype == torch.bfloat16 else "simt")
    limit = SMEM_LIMIT if t["route"] == "wgmma" else 48 * 1024
    assert 0 < t["smem"] <= limit
    assert t.get("wg_smem", 0) <= SMEM_LIMIT
    assert t["threads"] == (384 if t["route"] == "wgmma" else 256)
    assert p["sw"]["smem"] <= 48 * 1024
    names = ("dy", "dh", "dxin", "dwd", "dwg_dwu", "dx", "dcombine")
    for name in names + (("rows",) if t["route"] == "wgmma" else ()):
        grid = p[name]["grid"]
        assert 0 < grid[0] < 2 ** 31, name
        assert all(0 < v <= MAX_GRID for v in grid[1:]), name
        assert p[name]["smem"] <= SMEM_LIMIT
    bm, bn = t["bm"], t["bn"]
    if t["route"] == "wgmma":
        # a consumer warpgroup's registers hold its 64 x bn f32 sums, and
        # setmaxnreg shares out no more than the block launched with (168
        # a thread at 384 threads)
        assert bn // 2 < t["consumer_regs"] <= 255
        launched = 65536 // t["threads"] // 8 * 8 * t["threads"]
        assert 128 * t["producer_regs"] + 256 * t["consumer_regs"] \
            <= launched
        # every output element has a tile: the listed rows (at most G C an
        # expert) x f or d, f x d, d x (f of dwg and of dwu), tokens x E C
        q = {k: p[k]["queue"] for k in mm.TC_PRODUCTS}
        assert q["dh"][0] == q["dxin"][0] == q["dwd"][0] == E
        assert q["dh"][1] * bn >= f and q["dxin"][1] * bn >= d
        assert q["dh"][2] * bm >= G * C and q["dxin"][2] * bm >= G * C
        assert q["dwd"][1] * bm >= f and q["dwd"][2] * bn >= d
        assert q["dwg_dwu"][1] * bm >= d and q["dwg_dwu"][2] * bn // 2 >= f
        assert q["dcombine"] == (G, -(-(E * C) // bn), -(-g // bm))
        for k in q:     # persistent: one block an SM, no more than tiles
            assert p[k]["tiles"] == math.prod(q[k])
            assert p[k]["grid"] == (min(p[k]["tiles"], SMS), 1, 1)
        assert p["rows"]["grid"] == (E, 1, 1)
        assert p["launches"] == 8
    else:
        # every output element has a block: slots x f, slots x d, f x d,
        # d x f
        assert p["dh"]["grid"][0] * bn >= f and p["dh"]["grid"][1] * bm >= C
        assert p["dxin"]["grid"][0] * bn >= d and \
            p["dh"]["grid"][2] == G * E
        assert p["dwd"]["grid"][:2] == (-(-d // bn), -(-f // bm))
        assert p["dwg_dwu"]["grid"][:2] == (-(-f // bn), -(-d // bm))
        assert p["dwd"]["grid"][2] == p["dwg_dwu"]["grid"][2] == E
        assert p["dcombine"]["grid"] == (-(-(E * C) // p["sw"]["bn"]),
                                         -(-g // p["sw"]["bm"]), G)
        assert p["launches"] == 9


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_bwd_reads_no_data(dtype):
    assert list(inspect.signature(plan_bwd).parameters) == \
        ["G", "g", "E", "C", "d", "f", "dtype", "n_sm"]
    for shape in BWD_SHAPES:
        assert plan_bwd(*shape, dtype, SMS) == plan_bwd(*shape, dtype, SMS)
    # the grid follows the card's SMs, never the data
    assert plan_bwd(2, 1024, 8, 320, 4096, 14336, torch.bfloat16, 8)[
        "dh"]["grid"] == (8, 1, 1)


def test_plan_bwd_states_the_source():
    """The wrapper's constants are the CUDA source's (the card's tests
    hold the built library's ``moe_grouped_ffn_bwd_tiles`` and
    ``moe_grouped_ffn_bwd_queue`` to them too)."""
    src = (Path(mm.__file__).with_name("csrc")
           / "moe_grouped_ffn.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int ((?:TB|SW|ROWS)_[A-Z_]+) = (\d+);", src)}
    assert consts == dict(
        TB_BM=mm.TB_BM, TB_BN=mm.TB_BN, TB_BK=mm.TB_BK,
        TB_STAGES=mm.TB_STAGES, TB_WG_STAGES=mm.TB_WG_STAGES,
        TB_THREADS=mm.TB_THREADS,
        TB_PRODUCER_REGS=mm.TB_PRODUCER_REGS,
        TB_CONSUMER_REGS=mm.TB_CONSUMER_REGS, ROWS_THREADS=mm.ROWS_THREADS,
        SW_BM=mm.SW_BM, SW_BN=mm.SW_BN, SW_BK=mm.SW_BK,
        SW_THREADS=mm.SW_THREADS)
    assert "TB_A = TB_BM * TB_BK * 2;" in src
    assert "TB_B = TB_BN * TB_BK * 2;" in src
    assert "TB_SMEM = 1024 + TB_STAGES * (TB_A + TB_B);" in src
    assert "TB_OUT = TB_BM * TB_BN * 2;" in src
    assert "TB_WG_SMEM = 1024 + TB_WG_STAGES * (TB_A + TB_B) + TB_OUT;" \
        in src
    assert "SW_SMEM = 2 * SW_BK * (SW_BM + 4) * 4;" in src
    assert mm.TB_SMEM == 1024 + mm.TB_STAGES * (mm.TB_BM + mm.TB_BN) \
        * mm.TB_BK * 2
    assert mm.TB_WG_SMEM == 1024 + mm.TB_WG_STAGES * (
        mm.TB_BM + mm.TB_BN) * mm.TB_BK * 2 + mm.TB_BM * mm.TB_BN * 2
    assert mm.SW_SMEM == 2 * mm.SW_BK * (mm.SW_BM + 4) * 4
    p = plan_bwd(2, 1024, 8, 320, 4096, 14336, torch.bfloat16, SMS)
    assert (p["tile"]["bm"], p["tile"]["bk"], p["tile"]["smem"]) == \
        (mm.TB_BM, mm.TB_BK, mm.TB_SMEM)
    # the products' modes are numbered in the wrapper's order
    assert "constexpr int MODE_DH = 0, MODE_DXIN = 1, MODE_DWD = 2, " \
        "MODE_DWGU = 3,\n              MODE_DCOMB = 4;" in src
    assert mm.TC_PRODUCTS == ("dh", "dxin", "dwd", "dwg_dwu", "dcombine")


# ---------------------------------------------------------------------------
# the bf16 backward's row lists
# ---------------------------------------------------------------------------

def _rows_numpy(live: np.ndarray) -> np.ndarray:
    """The row lists as a loop over (expert, group, slot): expert e's
    slots (group E + e) C + c in (group, slot) order, the live ones first,
    then the E live counts, then each slot's place in its list."""
    G, E, C = live.shape
    GC = G * C
    lists, counts = [], []
    place = np.zeros(G * E * C, dtype=np.int32)
    for e in range(E):
        mine = [[], []]
        for grp in range(G):
            for c in range(C):
                mine[not live[grp, e, c]].append((grp * E + e) * C + c)
        for i, slot in enumerate(mine[0] + mine[1]):
            place[slot] = i
        lists += mine[0] + mine[1]
        counts.append(len(mine[0]))
    return np.concatenate([np.array(lists + counts, dtype=np.int32), place])


def _live(dispatch: torch.Tensor) -> torch.Tensor:
    return dispatch.any(1).to(torch.int32)


def _routed(G, g, E, C, seed):
    rng = np.random.default_rng(seed)
    probs = torch.softmax(torch.from_numpy(
        rng.standard_normal((G, g, E)).astype(np.float32)), -1)
    return route(probs, 2, C)[0]


@pytest.mark.parametrize("case", ["prefix", "empty_expert", "one_group",
                                  "random", "two_in_one_slot", "none"])
def test_expert_rows_plain_equals_numpy(case):
    """``moe_matmul.expert_rows`` (the plain version of the backward's
    first kernel) lists the slots, live ones first, and places each slot
    as a loop does: top-2 routing
    (slots filled in prefix order), an expert with no token, one live in
    one group only, a random dispatch with gaps, two tokens in one slot,
    and no token at all."""
    G, g, E, C = 2, 48, 4, 20
    rng = np.random.default_rng(3)
    if case == "prefix":
        disp = _routed(G, g, E, C, 0)
    elif case == "empty_expert":
        disp = _routed(G, g, E, C, 1)
        disp[..., 2, :] = False
    elif case == "one_group":
        disp = _routed(G, g, E, C, 2)
        disp[1, :, 0] = False
    elif case == "random":
        disp = torch.from_numpy(rng.random((G, g, E, C)) < 0.02)
    elif case == "two_in_one_slot":
        disp = torch.from_numpy(rng.random((G, g, E, C)) < 0.02)
        disp[0, 0, 1, 3] = disp[0, 1, 1, 3] = True
    else:
        disp = torch.zeros((G, g, E, C), dtype=torch.bool)
    live = _live(disp)
    got = mm.expert_rows(live)
    assert got.dtype == torch.int32 and got.shape == (2 * E * G * C + E,)
    assert np.array_equal(got.numpy(), _rows_numpy(live.numpy()))
    counts = got[E * G * C:E * G * C + E]
    assert counts.tolist() == live.sum((0, 2)).tolist()
    if case == "prefix":    # top-2 fills each group's slots from 0 on
        assert all(bool((live[grp, e, :int(live[grp, e].sum())] == 1).all())
                   for grp in range(G) for e in range(E))


def test_expert_rows_walk_only_live_rows_at_mixtral_training_shape():
    """At mixtral's training shape (G 2, g 1024, E 8, C 320, top-2) the
    lists hold every live slot once, none dead, and the dh / dxin tiles a
    list needs (128 rows each) are far fewer than the G C / 128 a fixed
    per-group grid would run."""
    G, g, E, C = 2, 1024, 8, 320
    live = _live(_routed(G, g, E, C, 4))
    rows = mm.expert_rows(live)
    counts = rows[E * G * C:E * G * C + E]
    flat = live.flatten()
    listed = torch.cat([rows[e * G * C:e * G * C + int(counts[e])]
                        for e in range(E)]).long()
    assert sorted(listed.tolist()) == torch.nonzero(flat).flatten().tolist()
    live_tiles = sum(-(-int(n) // mm.TB_BM) for n in counts)
    per_group = G * E * -(-C // mm.TB_BM)
    assert int(counts.sum()) == int(flat.sum()) <= G * g * 2
    assert live_tiles < per_group
