"""The vision config's sharded route (the projected media, self- and
cross-attention under ``ops._attention_sharded``) against the JAX package.

* llama-3.2-vision-11b's smoke config on 4 CPU ranks over gloo (a (2, 2)
  ``data, model`` mesh; ``tests/torch_mesh_harness.py``) at f32, batch 4
  x 16 with media 4 x 8 x 24 split as the batch and the xattn gates drawn
  non-zero in both trees (they init to 0, and tanh(0) would hide the
  layer): the sharded train step in ``datacentric`` and ``bsp`` against
  JAX's (AdamW at lr 3e-4: losses rtol 1e-5, parameters, m and v at the
  AdamW guide's bounds, ``frontend_proj`` and the gates included), and
  prefill and decode logits with the media (atol 1e-5), the cache laid
  out by ``cache_axes``.
* The cross-attention's sharded layout never splits the media's keys:
  ``_attention_sharded`` at Sq != Sk keeps dim 1 whole.

The dry run's cells are ``test_torch_dryrun_zoo_vision.py``'s.
"""
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_harness as H  # noqa: E402

ARCH = "llama-3.2-vision-11b"
S, L = 16, 32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job, want = H.make_job(ARCH, S=S, L=L)
    got = H.run_ranks(tmp_path_factory.mktemp("vision_mesh"),
                      {ARCH: job})[ARCH]
    return want, got


@pytest.mark.parametrize("mode", ["datacentric", "bsp"])
def test_sharded_vision_train_step_matches_jax(runs, mode):
    want, got = runs
    H.check_train(want, got, mode)
    assert any("frontend_proj" in k for k in want["params"])
    assert any(k.endswith("gate") for k in want["params"])


def test_sharded_vision_prefill_and_decode_match_jax(runs):
    want, got = runs
    assert set(got["cache_placements"].values()) == {
        "(Shard(dim=1), Shard(dim=2))"}, got["cache_placements"]
    H.check_serve(want, got)


XATTN_SNIPPET = """
import json
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

dryrun.fake_world(4)
mesh = make_test_mesh((2, 2))
seen = []
local = ops._attention_local


def spy(q, k, v, causal, window):
    seen.append([list(q.shape), list(k.shape)])
    return local(q, k, v, causal, window)


ops._attention_local = spy


def meta(shape, pl):
    loc = torch.empty(shape, device="meta")
    return DTensor.from_local(loc, mesh, pl, run_check=False)

# q split over batch and heads, the media's keys split over model on dim 1
q = meta((2, 5, 4, 16), [Shard(0), Shard(2)])
k = meta((2, 3, 2, 16), [Shard(0), Shard(1)])
out = ops.attention(q, k, k, causal=False)
print(json.dumps({"seen": seen, "out": [repr(p) for p in out.placements]}))
"""


def test_xattn_layout_keeps_the_keys_whole():
    """q (4, 5, 8, 16) split over data (batch) and model (heads); keys
    (4, 6, 2, 16) of 6 media tokens handed in split over model on dim 1:
    each rank's shard holds every key (2 of 4 rows, 4 of 8 heads, 1 of 2
    kv heads)."""
    out = H.run_python(XATTN_SNIPPET)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["seen"] == [[[2, 5, 4, 16], [2, 6, 1, 16]]], r
    assert r["out"] == ["Shard(dim=0)", "Shard(dim=2)"]
