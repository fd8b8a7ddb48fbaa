"""A model's parts found by name: the reference's norms, mixers and
feed-forwards (``reference/``) and the descriptions of their work
(``kinds/``).  The split changed no number: the reference reads as it read
when it was one file, and the olmo cells' counts, launches and builds are
what they were.  A kind with no files is refused when its cell loads; a
kind whose files lie outside ``perfbench/`` on the lookup path is taken by
the reference, the counts, the launch check and the roofline."""
import json
import sys
import textwrap

import pytest
import torch

import tiny
from perfbench import cells, counts, feed, harness, kinds
from perfbench import reference as ref_pkg
from perfbench.cells import HERE, ROOT, load_cell
from perfbench.metrics import _roofline, flash_roofline
from perfbench.reference import model as ref_model
from perfbench.tests.test_perfbench_counts import Run, _config, hand_trace

SEED = 2 ** 31 + 11
RECORDED = json.loads((HERE / "tests" / "reference_readings.json")
                      .read_text())
CONFIGS = {
    "dense": tiny.DENSE,
    "windowed": dict(tiny.DENSE, name="tiny-windowed",
                     groups=[{"pattern": ["attn", "local"], "n": 1}],
                     window=8, norm="rmsnorm", tie_embeddings=False),
}


def _hex_norms(grads: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(g)).hex()
            for k, g in grads.items()}


@pytest.fixture
def one_thread():
    """The recorded readings were taken with one thread: the sums'
    order, and so their last bits, are the same at every core count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("numerics", ["f32", "fp8"])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_reference_reads_as_recorded(case, numerics, one_thread):
    """Loss and every leaf's gradient norm of one batch, and the five
    delta-2 AdamW steps' readings, bit for bit as recorded from the
    reference before its parts were split into files."""
    from repro_torch.models.transformer import model_specs
    conf, cpu = CONFIGS[case], torch.device("cpu")
    want = RECORDED[case]
    params = feed.make_params(model_specs(harness.program_config(conf)),
                              SEED, cpu)
    b = feed.make_batch(SEED, 0, 3, 32, conf["vocab_size"], cpu)
    loss, grads = ref_model.loss_and_grads(
        params, b["tokens"], b["labels"], conf, ref_model.Numerics(numerics))
    assert {"loss": float(loss).hex(), "grad_norms": _hex_norms(grads)} \
        == want[f"loss_and_grads.{numerics}"]
    r = harness.reference_readings(tiny.cell(conf), SEED, cpu, numerics)
    assert {"losses": [x.hex() for x in r.losses],
            "first_grad_norms": {k: v.hex()
                                 for k, v in r.first_grad_norms.items()},
            "change_norms": {k: v.hex() for k, v in r.change_norms.items()}
            } == want[f"follow.{numerics}"]


# what counts.model_flops_per_token, harness.expected_launches (37 steps,
# one ring group) and harness.kernel_sources gave before the parts had
# descriptions of their own
OLMO = {"olmo1b-train-d2": (7463436288.0, {
            "flash_attention": 592, "flash_attention_bwd": 592,
            "ring_gather": 37}),
        "olmo1b-train-d2-b8-remat": (7463436288.0, {
            "flash_attention": 1184, "flash_attention_bwd": 592,
            "ring_gather": 37})}


@pytest.mark.parametrize("name", sorted(OLMO))
def test_olmo_cells_count_as_before(name):
    cell = load_cell(name)
    flops, launches = OLMO[name]
    assert counts.model_flops_per_token(cell.config,
                                        cell.traffic["seq"]) == flops
    assert harness.expected_launches(cell, 37, 1) == launches
    assert list(harness.expected_launches(cell, 37, 1)) == list(launches)
    assert harness.kernel_sources(cell) == ("flash_attention", "ring_gather")


def test_windowed_kinds_count_as_before():
    olmo = _config("olmo-1b")
    mixed = dict(olmo, groups=[{"pattern": ["attn", "local", "swa"],
                                "n": 2}], window=512)
    assert counts.model_flops_per_token(mixed, 2048) == 3128463360.0
    assert counts.model_flops_per_token(olmo, 4096) == 7866089472.0
    cell = tiny.cell(mixed, remat="full")
    assert harness.expected_launches(cell, 3, 2) == {
        "flash_attention": 36, "flash_attention_bwd": 18, "ring_gather": 6}


def _manifest(tmp_path, config: dict):
    (tmp_path / "config.json").write_text(json.dumps(config))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"][0]["file"] = str(tmp_path / "config.json")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def test_an_undescribed_kind_is_refused_at_load(tmp_path):
    conf = dict(_config("olmo-1b"),
                groups=[{"pattern": ["attn", "undescribed"], "n": 8}])
    with pytest.raises(SystemExit) as e:
        load_cell("olmo1b-train-d2", _manifest(tmp_path, conf))
    msg = str(e.value)
    for f in ("perfbench/kinds/mix_undescribed.py",
              "perfbench/reference/mix_undescribed.py"):
        assert f in msg
    assert "mix_attn" not in msg and "swiglu" not in msg
    for fn in (lambda: counts.model_flops_per_token(conf, 2048),
               lambda: harness.kernel_sources(tiny.cell(conf))):
        with pytest.raises(ValueError, match="kinds/mix_undescribed.py"):
            fn()


def test_experts_and_an_unknown_norm_name_their_files():
    conf = dict(_config("olmo-1b"), n_experts=8, norm="layernorm")
    assert kinds.missing(conf) == [
        "perfbench/reference/norm_layernorm.py",
        "perfbench/kinds/ffn_experts.py",
        "perfbench/reference/ffn_experts.py"]
    assert kinds.missing(_config("olmo-1b")) == []


TOY_DESCRIPTION = '''
    """A throwaway kind: one product, and a feed-forward of its own."""
    from perfbench.kinds import Launch

    FFN = "toy"
    SOURCES = ("toy_src",)


    def weights(cfg):
        return cfg["d_model"] ** 2


    def flops(cfg, seq):
        return 5.0


    def launches(cfg, tr):
        return {"toy_kernel": 1 if tr["remat"] == "none" else 2,
                "toy_kernel_bwd": 1}


    def kernels(cfg, tr):
        return {"toy_kernel": Launch("toy_fwd", 3.35e6, 0.0)}
'''
TOY_FFN_DESCRIPTION = '''
    SOURCES = ()


    def weights(cfg):
        return 2 * cfg["d_model"] ** 2


    def flops(cfg, seq):
        return 0.0


    def launches(cfg, tr):
        return {}


    def kernels(cfg, tr):
        return {}
'''
TOY_MIX = '''
    def apply(p, x, cfg, kind, nm):
        return nm.mm(x, p["w"])
'''
TOY_FFN = '''
    def apply(p, x, cfg, nm):
        return 0.5 * nm.mm(x, p["w"])
'''


@pytest.fixture
def toy_kind(tmp_path, monkeypatch):
    """The toy kind's description and reference, written only to
    ``tmp_path`` and put on both packages' lookup paths."""
    files = {"kinds": {"mix_toy": TOY_DESCRIPTION,
                       "ffn_toy": TOY_FFN_DESCRIPTION},
             "reference": {"mix_toy": TOY_MIX, "ffn_toy": TOY_FFN}}
    for pkg, mods in files.items():
        (tmp_path / pkg).mkdir()
        for mod, src in mods.items():
            (tmp_path / pkg / f"{mod}.py").write_text(textwrap.dedent(src))
    conf = dict(tiny.DENSE, groups=[{"pattern": ["attn", "toy"], "n": 1}])
    before = kinds.missing(conf)
    monkeypatch.setattr(kinds, "__path__",
                        [*kinds.__path__, str(tmp_path / "kinds")])
    monkeypatch.setattr(ref_pkg, "__path__",
                        [*ref_pkg.__path__, str(tmp_path / "reference")])
    yield conf, before
    for pkg in ("perfbench.kinds", "perfbench.reference"):
        for mod in ("mix_toy", "ffn_toy"):
            sys.modules.pop(f"{pkg}.{mod}", None)


def test_a_kind_enters_as_files_alone(toy_kind):
    conf, before = toy_kind
    assert before == ["perfbench/kinds/mix_toy.py",
                      "perfbench/reference/mix_toy.py"]
    assert kinds.missing(conf) == []
    d, f, V = conf["d_model"], conf["d_ff"], conf["vocab_size"]
    H, KV, hd = conf["n_heads"], conf["n_kv_heads"], conf["head_dim"]
    attn = d * hd * (2 * H + 2 * KV) + 3 * d * f
    assert counts.model_flops_per_token(conf, 32) == \
        6.0 * (d * V + attn + 3 * d * d) + \
        12.0 * H * hd * counts.live_pairs(32, True, 0) / 32 + 5.0
    cell = tiny.cell(conf, remat="full")
    assert harness.expected_launches(cell, 3, 1) == {
        "flash_attention": 6, "flash_attention_bwd": 3, "toy_kernel": 6,
        "toy_kernel_bwd": 3, "ring_gather": 3}
    assert harness.kernel_sources(cell) == ("flash_attention", "toy_src",
                                            "ring_gather")


def test_the_reference_takes_a_kind_from_files_alone(toy_kind):
    conf, _ = toy_kind
    g = torch.Generator().manual_seed(7)
    d, f, V = conf["d_model"], conf["d_ff"], conf["vocab_size"]
    H, KV, hd = conf["n_heads"], conf["n_kv_heads"], conf["head_dim"]

    def w(*shape):
        return 0.1 * torch.randn(1, *shape, generator=g)
    params = {"embedding": torch.randn(V, d, generator=g), "final_norm": {},
              "groups": {"g0": {
                  "s0": {"ln1": {}, "ln2": {},
                         "mix": {"wq": w(d, H * hd), "wk": w(d, KV * hd),
                                 "wv": w(d, KV * hd), "wo": w(H * hd, d)},
                         "ffn": {"wg": w(d, f), "wu": w(d, f),
                                 "wd": w(f, d)}},
                  "s1": {"ln1": {}, "ln2": {}, "mix": {"w": w(d, d)},
                         "ffn": {"w": w(d, d)}}}}}
    tokens = torch.randint(0, V, (2, 16), generator=g)
    labels = torch.randint(0, V, (2, 16), generator=g)
    nm = ref_model.Numerics()
    got = ref_model.loss_sum(params, tokens, labels, conf, nm)

    from perfbench.reference import ffn_swiglu, mix_attn, norm_layernorm_np

    def ln(x):
        return norm_layernorm_np.apply({}, x, conf)
    s0, s1 = params["groups"]["g0"]["s0"], params["groups"]["g0"]["s1"]
    one = {k: v[0] for k, v in s0["mix"].items()}
    x = params["embedding"][tokens]
    x = x + mix_attn.apply(one, ln(x), conf, "attn", nm)
    x = x + ffn_swiglu.apply({k: v[0] for k, v in s0["ffn"].items()}, ln(x),
                             conf, nm)
    x = x + ln(x) @ s1["mix"]["w"][0]
    x = x + 0.5 * (ln(x) @ s1["ffn"]["w"][0])
    logits = ln(x) @ params["embedding"].T
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, V), labels.reshape(-1), reduction="sum")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _, grads = ref_model.loss_and_grads(params, tokens, labels, conf, nm)
    assert float(grads["groups/g0/s1/mix/w"].norm()) > 0
    assert float(grads["groups/g0/s1/ffn/w"].norm()) > 0


def test_the_roofline_helper(toy_kind, tmp_path):
    run = Run(hand_trace(tmp_path))
    assert _roofline.share(run, ("flash_attention", "flash_attention_bwd")) \
        == pytest.approx(flash_roofline.read(run), rel=1e-12)
    assert _roofline.share(run, ("toy_kernel",)) is None
    conf, _ = toy_kind
    run.cfg, run.launches = conf, {"toy_kernel": 2}
    run.trace.ops[-1].name = "void toy_fwd<2>"        # 5 us
    assert _roofline.share(run, ("toy_kernel",)) == pytest.approx(
        100 * 2 * 1e-6 / 5e-6)


def test_cells_load_with_their_parts_described():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert kinds.missing(cell.config) == []
