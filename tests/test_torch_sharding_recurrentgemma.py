"""recurrentgemma-2b's sharded route (``ops.rglru`` and
``ops.rglru_stateful`` on DTensors, ``models/rglru.py``, local attention)
against the JAX package: the smoke config on 4 CPU ranks over gloo (a
(2, 2) ``data, model`` mesh; ``tests/torch_mesh_harness.py``) at f32,
batch 4 x 16: the sharded train step in ``datacentric`` and ``bsp``
against JAX's (AdamW at lr 3e-4: losses rtol 1e-5, parameters, m and v
at the AdamW guide's bounds), and prefill and decode logits (atol 1e-5)
with the cache laid out by ``cache_axes``: the states' rows over
``data``, the local ring's slots also over ``model``, so its decode goes
through ``ops._decode_partial`` and the parts' combine.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_harness as H  # noqa: E402

ARCHS = ["recurrentgemma-2b"]
S, L = 16, 32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, want = {}, {}
    for arch in ARCHS:
        jobs[arch], want[arch] = H.make_job(arch, S=S, L=L)
    got = H.run_ranks(tmp_path_factory.mktemp("rg_mesh"), jobs)
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["datacentric", "bsp"])
def test_sharded_recurrent_train_step_matches_jax(runs, arch, mode):
    want, got = runs
    H.check_train(want[arch], got[arch], mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_recurrent_prefill_and_decode_match_jax(runs, arch):
    want, got = runs
    pl = got[arch]["cache_placements"]
    # the recurrent rows over data; a ring also over model
    assert all(v.startswith("(Shard(dim=1),") for v in pl.values()), pl
    if arch == "recurrentgemma-2b":
        assert any(v == "(Shard(dim=1), Shard(dim=2))" for p, v in
                   pl.items() if p[-1] in ("k", "v")), pl
    H.check_serve(want[arch], got[arch])
