"""The MoE configs' sharded route (``ops._moe_sharded``, ``models/moe.py``
on DTensors) against the JAX package, on 4 CPU ranks over gloo (a (2, 2)
``data, model`` mesh; ``tests/torch_mesh_harness.py``) at f32: the
mixtral smoke config (4 experts: split over ``model``) and a variant with
3 experts (3 does not divide 2, as mixtral's 8 do not divide 16: the ffn
dim is split instead), batch 4 x 64 (one 64-token group a row, so the
groups keep the batch split):

* the sharded train step in ``datacentric`` and ``bsp`` against JAX's
  (AdamW at lr 3e-4: losses rtol 1e-5, the router metrics atol 2e-5,
  parameters, m and v at the AdamW guide's bounds);
* prefill and decode logits (atol 1e-5, the ring laid out by
  ``cache_axes``);
* the router's lb_loss, z_loss and router_entropy of one ``moe_ffn``
  against JAX's (atol 2e-5: means over every group before any product).

The expert-parallel hook is ``test_torch_sharding_moe_ep.py``'s and
``test_torch_dryrun_ep.py``'s, the dry run's cells
``test_torch_dryrun_zoo_moe.py``'s.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_harness as H  # noqa: E402

S, L = 64, 80


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs = {"experts": dict(arch="mixtral-8x7b", aux=True),
             "ffn": dict(arch="mixtral-8x7b", aux=True, n_experts=3)}
    jobs, want = {}, {}
    for name, kw in specs.items():
        jobs[name], want[name] = H.make_job(S=S, L=L, **kw)
    got = H.run_ranks(tmp_path_factory.mktemp("moe_mesh"), jobs)
    return want, got


@pytest.mark.parametrize("layout", ["experts", "ffn"])
@pytest.mark.parametrize("mode", ["datacentric", "bsp"])
def test_sharded_moe_train_step_matches_jax(runs, layout, mode):
    want, got = runs
    H.check_train(want[layout], got[layout], mode)


@pytest.mark.parametrize("layout", ["experts", "ffn"])
def test_sharded_moe_prefill_and_decode_match_jax(runs, layout):
    want, got = runs
    assert set(got[layout]["cache_placements"].values()) == {
        "(Shard(dim=1), Shard(dim=2))"}, got[layout]["cache_placements"]
    H.check_serve(want[layout], got[layout])


@pytest.mark.parametrize("layout", ["experts", "ffn"])
def test_sharded_router_losses_match_jax(runs, layout):
    want, got = runs
    w, g = want[layout]["aux"], got[layout]["aux"]
    assert set(g) == set(w) == {"lb_loss", "z_loss", "router_entropy"}
    for k in w:
        assert abs(float(g[k]) - w[k]) <= 2e-5, (k, float(g[k]), w[k])
