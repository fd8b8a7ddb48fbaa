"""Serve-while-train through the port's ``LiveParamDB``
(``repro_torch.serve.live_db``) against the JAX package's.

* On the llama smoke config at f32, a trainer publishing every 3 decode
  steps into both packages' ``LiveParamDB`` gives the same read log, the
  same Op history, the same staleness summary and the same greedy tokens.
* ``tests/test_serve_engine.py::TestServeWhileTrain`` on the port: every
  serve-side read within its group's delay (some stale, both delays
  seen), the history sequentially correct, out-of-order publishes
  refused, delay-0 groups following the head.
* ``publish`` snapshots: a tree changed in place after its publish (as a
  trainer's ring is) leaves what a stale ``get()`` serves unchanged.
* The engine's constructor records no read (it takes the handle's
  ``device``), and a ``LiveParamDB`` that never gets a publish serves the
  tokens of ``StaticParams``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core.sync_jax import SyncConfig as JSyncConfig  # noqa: E402
from repro.models import paramlib as jparamlib  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core.history import is_sequentially_correct  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

ARCH = "llama3.2-1b"
SCFG = dict(batch_size=3, page_size=8, cache_len=32, clock="steps")
GROUPS = (("groups", 4), ("embed", 1))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               dtype=torch.float32)
    jp = jparamlib.init_tree(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _requests(pkg, cfg, rate=0.5, n=10, seed=3):
    return pkg.open_loop_requests(n, rate, cfg.vocab_size,
                                  prompt_lens=(8, 16), gen_lens=(2, 4, 8),
                                  seed=seed)


def _serve_while_train(tcfg, tp):
    db = tserve.LiveParamDB(tp, SyncConfig(delta=4, group_delays=GROUPS),
                            cfg=tcfg)
    eng = tserve.ServeEngine(tcfg, db, tserve.ServeConfig(**SCFG))
    itr = [0]

    def trainer(step):
        if step % 3 == 0:
            itr[0] += 1
            # a real weight change, so stale reads serve old values
            db.publish(tree_map(lambda x: x * 0.999, tp), itr[0])

    return db, eng.run(_requests(tserve, tcfg), step_hook=trainer), itr[0]


def test_read_log_and_history_equal_jax(model):
    jcfg, tcfg, jp, tp = model
    db, rep, n_pub = _serve_while_train(tcfg, tp)
    jdb = jserve.LiveParamDB(jp, JSyncConfig(delta=4, group_delays=GROUPS))
    jeng = jserve.ServeEngine(jcfg, jdb, jserve.ServeConfig(**SCFG))
    jitr = [0]

    def jtrainer(step):
        if step % 3 == 0:
            jitr[0] += 1
            jdb.publish(jax.tree.map(lambda x: x * 0.999, jp), jitr[0])

    jrep = jeng.run(_requests(jserve, jcfg), step_hook=jtrainer)
    assert n_pub == jitr[0] > 2
    assert db.n_chunks == jdb.n_chunks == 2
    assert [dataclasses.astuple(r) for r in db.read_log] == \
        [dataclasses.astuple(r) for r in jdb.read_log]
    assert [repr(o) for o in db.telemetry.history] == \
        [repr(o) for o in jdb.telemetry.history]
    assert db.telemetry.summary() == jdb.telemetry.summary()
    assert rep.outputs == jrep.outputs
    assert rep.decode_steps == jrep.decode_steps


class TestServeWhileTrain:
    def test_delay_bounds_on_every_read(self, model):
        _, tcfg, _, tp = model
        db, rep, n_pub = _serve_while_train(tcfg, tp)
        assert rep.n_requests == 10 and n_pub > 2
        assert len(db.read_log) > 0
        for r in db.read_log:
            assert 0 <= r.staleness <= r.delay
        assert any(r.staleness > 0 for r in db.read_log)
        assert {r.delay for r in db.read_log} == {1, 4}
        assert is_sequentially_correct(db.telemetry.history, db.n_chunks)
        stats = db.telemetry.summary()
        assert stats["stale_reads"] > 0
        assert stats["max_staleness"] <= 4

    def test_publish_out_of_order_rejected(self, model):
        _, tcfg, _, tp = model
        db = tserve.LiveParamDB(tp, SyncConfig(delta=2), cfg=tcfg)
        db.publish(tp, 1)
        with pytest.raises(ValueError, match="out of order"):
            db.publish(tp, 3)
        assert db.version == 1

    def test_fresh_groups_follow_the_head(self, model):
        _, tcfg, _, tp = model
        db = tserve.LiveParamDB(tp, SyncConfig(delta=0), cfg=tcfg)
        for i in range(1, 4):
            new = tree_map(lambda x: x * (1.0 - 0.1 * i), tp)
            db.publish(new, i)
            assert torch.equal(leaves(db.get())[0], leaves(new)[0])
        assert all(r.staleness == 0 for r in db.read_log)
        assert is_sequentially_correct(db.telemetry.history, db.n_chunks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-clones", "bf16-casts"])
def test_publish_snapshots_the_tree(model, dtype):
    """Change a tree in place after its publish (and the initial tree
    after construction): what a stale get() serves does not change.  At
    f32 every leaf is the caller's own (cloned); at bf16 the weight
    matrices are cast and the norm scales cloned."""
    _, tcfg, _, tp = model
    cfg = dataclasses.replace(tcfg, dtype=dtype)

    def want(p):
        return [x.clone() for x in leaves(tserve.serving_params(p, cfg))]

    p0 = tree_map(lambda x: x.clone(), tp)
    db = tserve.LiveParamDB(p0, SyncConfig(delta=1), cfg=cfg)
    want0 = want(p0)
    for x in leaves(p0):
        x.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(db.get()), want0))

    p1, p2, p3 = (tree_map(lambda x: x * s, tp) for s in (0.5, 0.25, 2.0))
    db.publish(p1, 1)
    db.publish(p2, 2)
    assert db.get() is not None                 # refreshed to version 2
    want2 = want(p2)
    db.publish(p3, 3)
    for x in leaves(p2):
        x.mul_(-3.0)                            # the trainer's ring moves on
    got = db.get()                              # stale by 1: version 2
    assert db.read_log[-1].version == 2 and db.read_log[-1].staleness == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), want2))


def test_engine_constructor_records_no_read(model):
    _, tcfg, _, tp = model
    db = tserve.LiveParamDB(tp, SyncConfig(delta=2), cfg=tcfg)
    eng = tserve.ServeEngine(tcfg, db, tserve.ServeConfig(**SCFG))
    assert eng.device == db.device == torch.device("cpu")
    assert db.read_log == [] and db.telemetry.history == []
    assert db.telemetry.summary()["reads"] == 0
    static = tserve.StaticParams(tp)
    assert static.device == torch.device("cpu")
    with pytest.raises(TypeError, match="device"):
        class GetOnly:
            def get(self):
                return tp
        tserve.ServeEngine(tcfg, GetOnly(), tserve.ServeConfig(**SCFG))


def test_unpublished_live_db_serves_static_tokens(model):
    """bf16 serving copies: the live handle's snapshot is the engine's own
    serving copy, bit for bit, so the tokens are StaticParams'."""
    _, _, _, tp = model
    cfg = tconfigs.get_smoke_config(ARCH)           # bf16 compute
    reqs = _requests(tserve, cfg, rate=100.0)
    db = tserve.LiveParamDB(tp, SyncConfig(delta=4, group_delays=GROUPS),
                            cfg=cfg)
    live = tserve.ServeEngine(cfg, db, tserve.ServeConfig(**SCFG)).run(reqs)
    static = tserve.ServeEngine(cfg, tp, tserve.ServeConfig(**SCFG)).run(reqs)
    assert live.outputs == static.outputs
    served = db.get()
    assert served["embedding"].dtype == torch.bfloat16
    assert served["final_norm"]["scale"].dtype == torch.float32
    assert served["final_norm"]["scale"] is not tp["final_norm"]["scale"]
    assert all(r.staleness == 0 for r in db.read_log)
