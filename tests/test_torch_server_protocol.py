"""The port's parameter-server wire and fault layers
(``repro_torch.pdb.server.protocol``, ``shard``'s state, ``client``'s
receive loop, ``runtime.fault``'s backoff and shard-death plan, and the
Lamport stamps of ``pdb.telemetry``) against the JAX package's, on the CPU
and without shard processes.

* Frames written by the port and by JAX are byte for byte equal, the
  ``pack_arrays`` manifests and payloads too (mixed dtypes, 0-d and empty
  arrays), and each side decodes the other's; ``shard_of`` and
  ``owned_chunks`` agree over a grid; oversized frames are refused;
  bfloat16 cannot cross the wire and says so.
* ``tests/test_pdb_server.py``'s protocol, shard-state, backoff and
  telemetry tests on the port.
"""
import pickle
import socket
import socketserver
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.pdb.server import protocol as JP  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro_torch.core import history as H  # noqa: E402
from repro_torch.pdb import Telemetry, WaitTimeout  # noqa: E402
from repro_torch.pdb.server import owned_chunks, shard_of  # noqa: E402
from repro_torch.pdb.server import protocol as P  # noqa: E402
from repro_torch.pdb.server.client import ClientParameterDB, _Conn  # noqa
from repro_torch.pdb.server.shard import (ShardConfig, ShardServer,  # noqa
                                          ShardState)
from repro_torch.runtime.fault import (Backoff, ShardDeathPlan,  # noqa: E402
                                       retry_with_backoff)


def _mixed():
    return {1: np.arange(6, dtype=np.float16).reshape(2, 3),
            3: np.array(2.5, dtype=np.float32),           # 0-d
            4: np.array([], dtype=np.int64),              # empty
            7: np.ones((3, 2), dtype=np.float64),
            9: np.arange(4, dtype=np.int64),
            11: np.array([True, False])}


def _wire(send, header, payload) -> bytes:
    """The bytes ``send`` puts on a socket for one frame."""
    a, b = socket.socketpair()
    try:
        out = []
        reader = threading.Thread(target=lambda: out.append(
            _read_all(b)), daemon=True)
        reader.start()
        send(a, header, payload)
        a.shutdown(socket.SHUT_WR)
        reader.join(timeout=30)
        assert not reader.is_alive()
        return out[0]
    finally:
        a.close()
        b.close()


def _read_all(sock) -> bytes:
    chunks = []
    while True:
        part = sock.recv(1 << 20)
        if not part:
            return b"".join(chunks)
        chunks.append(part)


# ---------------------------------------------------------------------------
# the wire against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 12, 40_000])   # empty, one write, two
def test_frames_are_byte_for_byte_jax(n):
    arr = np.random.default_rng(n).normal(size=n)
    meta, payload = P.encode_array(torch.from_numpy(arr))
    jmeta, jpayload = JP.encode_array(arr)
    assert meta == jmeta and payload == jpayload
    header = {"op": "write", "worker": 1, "chunk": 3, "itr": 2, "ts": 7,
              "clocks": {"commit": [1, 0], "frontier": [2, 1]}, "id": 5,
              "cum": 0.25, **meta}
    assert _wire(P.send_msg, header, payload) \
        == _wire(JP.send_msg, header, jpayload)


def test_pack_arrays_equals_jax_both_ways():
    arrays = _mixed()
    jm, jp = JP.pack_arrays(arrays)
    for given in (arrays, {c: torch.from_numpy(v) for c, v in
                           arrays.items()}):
        m, p = P.pack_arrays(given)
        assert m == jm and p == jp
    for payload in (jp, bytearray(jp)):        # JAX's bytes, decoded here
        got = P.unpack_arrays(jm, payload)
        assert set(got) == set(arrays)
        for c, v in arrays.items():
            assert isinstance(got[c], torch.Tensor)
            assert got[c].numpy().dtype == v.dtype
            assert tuple(got[c].shape) == v.shape
            np.testing.assert_array_equal(got[c].numpy(), v)
    back = JP.unpack_arrays(*P.pack_arrays(arrays))   # ours, decoded there
    for c, v in arrays.items():
        assert back[c].dtype == v.dtype and back[c].shape == v.shape
        np.testing.assert_array_equal(back[c], v)


def test_pack_manifest_offsets_are_contiguous_and_exact():
    manifest, payload = P.pack_arrays(_mixed())
    off = 0
    for cid, dtype, shape, o, nbytes in manifest:
        assert o == off
        assert nbytes == np.dtype(dtype).itemsize * int(np.prod(shape))
        off += nbytes
    assert off == len(payload)
    assert [row[0] for row in manifest] == sorted(_mixed())


def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        t = torch.arange(12, dtype=torch.float64).reshape(3, 4)
        meta, payload = P.encode_array(t)
        P.send_msg(a, {"op": "write", "worker": 1, **meta}, payload)
        header, got = P.recv_msg(b)
        assert header["op"] == "write" and header["worker"] == 1
        assert torch.equal(P.decode_array(header, got), t)
        P.send_msg(b, {"ok": True})
        header, got = P.recv_msg(a)
        assert header == {"ok": True} and got == b""
    finally:
        a.close()
        b.close()


def test_decoded_chunks_are_writable_cpu_tensors():
    """A decoded chunk is a CPU tensor that owns or shares a writable
    buffer (JAX's read-only ``bytes`` are copied)."""
    m, p = JP.pack_arrays({0: np.arange(3.0)})
    for payload in (p, bytearray(p)):
        t = P.unpack_arrays(m, payload)[0]
        assert t.device.type == "cpu"
        t += 1                              # no read-only warning or error
        assert t.tolist() == [1.0, 2.0, 3.0]


def test_bf16_cannot_cross_the_wire():
    with pytest.raises(TypeError, match="bfloat16"):
        P.pack_arrays({0: torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16"):
        P.encode_array(torch.zeros(2, dtype=torch.bfloat16))


def test_big_endian_arrays_decode_natively():
    arr = np.array([1.5, -2.0, 3.25], dtype=">f8")
    got = P.decode_array({"dtype": arr.dtype.str, "shape": [3]},
                         arr.tobytes())
    assert got.tolist() == [1.5, -2.0, 3.25]


def test_recv_raises_on_peer_close():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(ConnectionError):
        P.recv_msg(b)
    b.close()


def test_recv_rejects_oversized_frames():
    assert P.MAX_FRAME == JP.MAX_FRAME == 1 << 30
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", P.MAX_FRAME + 1))
        with pytest.raises(ConnectionError, match="oversized header"):
            P.recv_msg(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        hb = b'{"op":"x"}'
        a.sendall(struct.pack("!I", len(hb)) + hb
                  + struct.pack("!I", P.MAX_FRAME + 1))
        with pytest.raises(ConnectionError, match="oversized payload"):
            P.recv_msg(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8, 13])
def test_shard_placement_equals_jax(n_shards):
    for c in range(200):
        assert shard_of(c, n_shards) == JP.shard_of(c, n_shards)
    seen = []
    for s in range(n_shards):
        owned = owned_chunks(s, 64, n_shards)
        assert owned == JP.owned_chunks(s, 64, n_shards)
        seen += owned
    assert sorted(seen) == list(range(64))     # a partition, no overlap


def test_full_width_layout_fits_max_frame():
    """The card's layout for llama3.2-1b (64 chunks over 8 shards): every
    shard owns 8 chunks, so a read_batch response stays under MAX_FRAME;
    2 shards of 4 chunks (the CLI's defaults) would not."""
    n = 1_235_814_400
    bounds = np.linspace(0, n, 65).astype(int)
    for s in range(8):
        owned = owned_chunks(s, 64, 8)
        assert len(owned) == 8
        assert sum(4 * int(bounds[c + 1] - bounds[c]) for c in owned) \
            == 617_907_200 < P.MAX_FRAME
    b4 = np.linspace(0, n, 5).astype(int)
    assert max(4 * sum(int(b4[c + 1] - b4[c]) for c in owned_chunks(s, 4, 2))
               for s in range(2)) > P.MAX_FRAME


# ---------------------------------------------------------------------------
# protocol v2 on the port's client and shard
# ---------------------------------------------------------------------------

def test_recv_matched_drains_out_of_order_acks():
    client = ClientParameterDB(0, [("127.0.0.1", 9)], n_workers=2,
                               n_chunks=2)
    a, b = socket.socketpair()
    try:
        conn = _Conn(sock=a, pending={1, 2})
        client._conns[0] = conn
        P.send_msg(b, {"ok": True, "id": 2, "ts": 5})   # acks, out of order
        P.send_msg(b, {"ok": True, "id": 1, "ts": 6})
        P.send_msg(b, {"ok": True, "id": 3, "ts": 7, "answer": 42})
        resp, rp = client._recv_matched(conn, 3)
        assert resp["answer"] == 42 and rp == b""
        assert conn.pending == set()
        assert client.lamport >= 7
        P.send_msg(b, {"ok": True, "id": 99})
        with pytest.raises(ConnectionResetError, match="protocol error"):
            client._recv_matched(conn, 4)
    finally:
        a.close()
        b.close()


def test_noreply_broadcast_sends_no_frame_and_ping_barriers():
    server = ShardServer(("127.0.0.1", 0))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    sock = None
    try:
        sock = P.connect(server.server_address, timeout=5.0)
        manifest, payload = P.pack_arrays({0: torch.zeros(2)})
        P.send_msg(sock, {"op": "init", "config": {
            "shard_id": 0, "n_shards": 1, "n_workers": 2, "n_chunks": 1,
            "policy": "bsp", "delta": 0, "vbound": None, "timeout": 0.2,
            "record": True}, "manifest": manifest}, payload)
        resp, _ = P.recv_msg(sock)
        assert resp["ok"]
        for w in (0, 1):                      # one-way: no response frames
            P.send_msg(sock, {"op": "frontier", "worker": w, "itr": 1,
                              "id": 100 + w, "noreply": True})
        P.send_msg(sock, {"op": "ping", "id": 7})
        resp, _ = P.recv_msg(sock)
        assert resp["id"] == 7 and resp["ok"]
        P.send_msg(sock, {"op": "can", "kind": "w", "worker": 0,
                          "chunk": 0, "itr": 1, "id": 8})
        resp, _ = P.recv_msg(sock)
        assert resp["id"] == 8 and resp["admissible"]
    finally:
        if sock is not None:
            sock.close()
        server.shutdown()
        server.server_close()


def test_connect_phase_timeout_surfaces_as_waittimeout(monkeypatch):
    def hang(addr, timeout):
        raise TimeoutError("connect timed out")

    monkeypatch.setattr(P, "connect", hang)
    db = ClientParameterDB(0, [("127.0.0.1", 1)], n_workers=1, n_chunks=1,
                           timeout=0.1, backoff=Backoff(max_retries=0))
    with pytest.raises(WaitTimeout) as ei:
        db.read(0, 0, 1)
    msg = str(ei.value)
    assert "timed out" in msg and "shard0" in msg and "rpc" in msg


def test_can_merges_clock_gossip_and_ticks():
    cfg = ShardConfig(shard_id=0, n_shards=1, n_workers=2, n_chunks=1,
                      policy="bsp", timeout=0.2)
    st = ShardState(cfg, {0: np.zeros(2)})
    resp, _ = st.can({"op": "can", "kind": "w", "worker": 0, "chunk": 0,
                      "itr": 1, "ts": 41,
                      "clocks": {"commit": [0, 0], "frontier": [1, 1]}})
    assert resp["admissible"]
    assert resp["ts"] > 41


def test_blocked_read_is_stamped_after_admitting_write():
    cfg = ShardConfig(shard_id=0, n_shards=1, n_workers=2, n_chunks=1,
                      policy="dc", timeout=5.0)
    st = ShardState(cfg, {0: torch.zeros(2, dtype=torch.float64)})
    for w in (0, 1):
        st.read({"op": "read", "worker": w, "chunk": 0, "itr": 1})
    done = []

    def blocked():
        resp, _ = st.read({"op": "read", "worker": 1, "chunk": 0, "itr": 2})
        done.append(resp)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.1)
    meta, payload = P.encode_array(torch.ones(2, dtype=torch.float64))
    st.write({"op": "write", "worker": 0, "chunk": 0, "itr": 1, **meta},
             payload)
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert done and done[0]["ok"]
    stamps = {(op.kind, op.worker, op.itr): ts
              for ts, op in st.telemetry.timed_history()}
    assert stamps[("r", 1, 2)] > stamps[("w", 0, 1)]


@pytest.mark.parametrize("batched", [False, True], ids=["per-op", "batched"])
def test_resent_read_gets_the_version_it_was_first_served(batched):
    """A read the shard recorded but whose response was lost (the shard
    killed between its snapshot and its reply) is resent after its
    recording let the chunk's owner write: the resent read gets the value
    it was first served, version 0, not the write's (JAX's shard serves
    the current version there: one write too new for delta 0)."""
    from repro.pdb.server.shard import ShardConfig as JShardConfig
    from repro.pdb.server.shard import ShardState as JShardState
    cfg = dict(shard_id=0, n_shards=1, n_workers=2, n_chunks=1,
               policy="dc", timeout=1.0)

    def read(st, w):
        if batched:
            resp, payload = st.read_batch({"op": "read_batch", "worker": w,
                                           "itr": 1, "ops": [[0, 1]]})
            (c, version, modified, cum), = resp["results"]
            value = JP.unpack_arrays(resp["manifest"], bytes(payload))[0]
        else:
            resp, payload = st.read({"op": "read", "worker": w, "chunk": 0,
                                     "itr": 1})
            version = resp["version"]
            value = JP.decode_array(resp, bytes(payload))
        return version, np.asarray(value)

    served = {}
    for name, state_cls, cfg_cls in (("port", ShardState, ShardConfig),
                                     ("jax", JShardState, JShardConfig)):
        st = state_cls(cfg_cls(**cfg), {0: np.zeros(2)})
        read(st, 0)
        read(st, 1)                   # recorded; say its reply was lost
        meta, payload = JP.encode_array(np.ones(2))
        st.write({"op": "write", "worker": 0, "chunk": 0, "itr": 1, **meta},
                 payload)             # admitted by that recording
        served[name] = read(st, 1)    # the resend
        assert st.telemetry.stats.reads == 2      # not recorded again
    assert served["port"][0] == 0 and served["port"][1].tolist() == [0, 0]
    assert served["jax"][0] == 1 and served["jax"][1].tolist() == [1, 1]


def test_shard_drift_ledger_is_numpys_linf():
    """``cum_change`` adds the L-inf norm of each write's change, exact as
    JAX's shard computes it in numpy (f32 and f64)."""
    from repro.pdb.server.shard import ShardState as JShardState
    rng = np.random.default_rng(0)
    for dt in (np.float32, np.float64):
        vals = [rng.normal(size=257).astype(dt) for _ in range(4)]
        cfg = dict(shard_id=0, n_shards=1, n_workers=1, n_chunks=1,
                   policy="hogwild")
        ours = ShardState(ShardConfig(**cfg), {0: vals[0]})
        from repro.pdb.server.shard import ShardConfig as JShardConfig
        theirs = JShardState(JShardConfig(**cfg), {0: vals[0]})
        for itr, v in enumerate(vals[1:], start=1):
            with ours.cond:
                ours._apply_write(0, 0, itr, torch.from_numpy(v))
            with theirs.cond:
                theirs._apply_write(0, 0, itr, v)
        assert ours.cum_change[0] == theirs.cum_change[0] > 0
        assert np.array_equal(ours.chunks[0].numpy(), theirs.chunks[0])


def test_shard_state_snapshot_restores(tmp_path):
    """The atomic pickle snapshot round-trips chunks, versions, dedup set,
    the replies kept for resends, Lamport clock and the Lamport-stamped
    telemetry."""
    path = str(tmp_path / "s.pkl")
    cfg = ShardConfig(shard_id=0, n_shards=1, n_workers=1, n_chunks=1,
                      policy="dc", snapshot_path=path)
    st = ShardState(cfg, {0: np.zeros(3)})
    st.read({"op": "read", "worker": 0, "chunk": 0, "itr": 1, "ts": 3})
    meta, payload = P.encode_array(torch.tensor([1.0, 2.0, 3.0],
                                                dtype=torch.float64))
    st.write({"op": "write", "worker": 0, "chunk": 0, "itr": 1, **meta},
             payload)
    back = ShardState.restore(path)
    assert torch.equal(back.chunks[0], st.chunks[0])
    assert back.version == {0: 1} and back.seen == st.seen
    (itr, version, modified, value, cum), = back.replies.values()
    assert list(back.replies) == list(st.replies) == [(0, 0)]
    assert (itr, version, modified, cum) == (1, 0, True, 0.0)
    assert torch.equal(value, torch.zeros(3, dtype=torch.float64))
    assert back.lamport == st.lamport
    assert back.telemetry.timed_history() == st.telemetry.timed_history()
    assert back.cum_change == st.cum_change == {0: 3.0}


# ---------------------------------------------------------------------------
# backoff, retries, shard death, telemetry
# ---------------------------------------------------------------------------

def test_backoff_schedule_is_exponential_and_capped():
    b = Backoff(max_retries=5, base_delay=0.1, multiplier=2.0, max_delay=0.5)
    assert [b.delay(i) for i in range(1, 6)] == [0.1, 0.2, 0.4, 0.5, 0.5]
    jb = jfault.Backoff()
    assert [Backoff().delay(i) for i in range(1, 13)] \
        == [jb.delay(i) for i in range(1, 13)]


def test_retry_with_backoff_retries_then_succeeds():
    calls, hooks = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("boom")
        return "ok"

    tele = Telemetry()
    got = retry_with_backoff(flaky, Backoff(max_retries=5, base_delay=0.001),
                             telemetry=tele, on_retry=hooks.append,
                             describe="flaky op")
    assert got == "ok" and len(calls) == 3
    assert tele.stats.retried_steps == 2
    assert hooks == [1, 2]


def test_retry_with_backoff_exhausts_budget():
    def always():
        raise ConnectionResetError("down")

    with pytest.raises(ConnectionResetError):
        retry_with_backoff(always, Backoff(max_retries=2, base_delay=0.001))
    with pytest.raises(ValueError):           # not connection-shaped
        retry_with_backoff(lambda: int("x"), Backoff(base_delay=0.001))


def test_shard_death_plan_fires_once():
    class FakeCluster:
        def __init__(self):
            self.killed, self.restarted = [], []

        def kill_shard(self, s):
            self.killed.append(s)

        def restart_shard(self, s):
            self.restarted.append(s)

    plan = ShardDeathPlan(kill_at_step=3, shard=1)
    fc = FakeCluster()
    assert not plan.maybe_kill(2, fc)
    assert plan.maybe_kill(3, fc)
    assert not plan.maybe_kill(3, fc)
    assert fc.killed == [1] and fc.restarted == [1]
    quiet = ShardDeathPlan(kill_at_step=1, shard=0, restart=False)
    fc = FakeCluster()
    assert quiet.maybe_kill(1, fc) and fc.restarted == []


def test_telemetry_pickles_with_its_lamport_stamps():
    tele = Telemetry(record_history=True)
    tele.on_read(0, 1, 2, version=1, lamport=5)
    tele.on_write(0, 1, 2, lamport=9)
    tele.on_read(1, 0, 1)                     # unstamped: arrival index
    back = pickle.loads(pickle.dumps(tele))
    assert back.timed_history() == tele.timed_history() == [
        (5, H.r(0, 1, 2)), (9, H.w(0, 1, 2)), (2, H.r(1, 0, 1))]
    assert back.summary() == tele.summary()
    back.on_retry(1)                          # its lock was rebuilt
    assert back.stats.retried_steps == 1
    assert Telemetry().timed_history() == []


@pytest.mark.parametrize("batched", [False, True], ids=["read", "batch"])
def test_resent_read_at_delta_2_gets_the_version_its_telemetry_records(
        batched):
    """Delay 2, two workers each owning one chunk of a one-shard store:
    worker 1's read of chunk 0 at iteration 1 is recorded but its reply
    lost, and the owner writes chunk 0 twice (iterations 1 and 2) before
    the resend.  The resend gets version 0 and its value, the version the
    shard's telemetry recorded at the first serve (JAX's shard serves
    version 2); every read's returned version is the recorded one (the
    telemetry's staleness sum), and the completed history passes
    ``core.history``'s checks at delay 2."""
    from repro.pdb.server.shard import ShardConfig as JShardConfig
    from repro.pdb.server.shard import ShardState as JShardState
    cfg = dict(shard_id=0, n_shards=1, n_workers=2, n_chunks=2,
               policy="dc", delta=2, timeout=1.0)

    def read(st, w, c, a):
        if batched:
            resp, payload = st.read_batch({"op": "read_batch", "worker": w,
                                           "itr": a, "ops": [[c, a]]})
            (_, version, _, _), = resp["results"]
            value = JP.unpack_arrays(resp["manifest"], bytes(payload))[c]
        else:
            resp, payload = st.read({"op": "read", "worker": w, "chunk": c,
                                     "itr": a})
            version = resp["version"]
            value = JP.decode_array(resp, bytes(payload))
        return version, np.asarray(value).tolist()

    def write(st, w, a):
        meta, payload = JP.encode_array(np.full(2, float(a)))
        resp, _ = st.write({"op": "write", "worker": w, "chunk": w,
                            "itr": a, **meta}, payload)
        assert resp["ok"], resp

    resent = {}
    for name, state_cls, cfg_cls in (("port", ShardState, ShardConfig),
                                     ("jax", JShardState, JShardConfig)):
        st = state_cls(cfg_cls(**cfg), {0: np.zeros(2), 1: np.zeros(2)})
        staleness = []

        def rd(w, c, a):
            version, value = read(st, w, c, a)
            staleness.append((a - 1) - version)
            return version, value

        for c in (0, 1):
            rd(0, c, 1)
        rd(1, 0, 1)                 # recorded; say its reply was lost
        staleness.pop()             # ... so the worker never saw it
        rd(1, 1, 1)
        write(st, 0, 1)
        for c in (0, 1):
            rd(0, c, 2)
        write(st, 0, 2)             # two writes since the lost reply
        resent[name] = rd(1, 0, 1)  # the resend
        assert st.telemetry.stats.reads == 6      # not recorded again
        write(st, 1, 1)
        for a in (2, 3):
            for w in ((1,) if a == 2 else (0, 1)):
                for c in (0, 1):
                    rd(w, c, a)
                write(st, w, a)
        if name == "port":
            assert sum(staleness) == st.telemetry.stats.sum_staleness
            h = st.telemetry.history
            assert H.is_complete(h, 2, 3)
            assert H.satisfies_rcwc(h, 2, delta=2)
            merged = [op for _, op in sorted(st.telemetry.timed_history(),
                                             key=lambda t: t[0])]
            assert merged == h
    assert resent["port"] == (0, [0.0, 0.0])
    assert resent["jax"] == (2, [2.0, 2.0])


# ---------------------------------------------------------------------------
# every resend after a severed connection counts as a retry
# ---------------------------------------------------------------------------

class _SeveringHandler(socketserver.BaseRequestHandler):
    """The shard's connection handler, except that the first request whose
    op is in ``server.sever`` is read and then the connection is closed
    unanswered and unprocessed: the shard's side of the socket dies between
    the client's send and its receive."""

    def handle(self):
        sock = self.request
        while True:
            try:
                h, payload = P.recv_msg(sock)
            except (ConnectionError, OSError):
                return
            if h.get("op") in self.server.sever:
                self.server.sever.discard(h["op"])
                self.server.severed.append(h["op"])
                return
            resp, rp = self.server.dispatch(h, payload)
            if h.get("noreply"):
                continue
            resp["id"] = h["id"]
            P.send_msg(sock, resp, rp)


@pytest.fixture
def severing_shard():
    """One in-process shard of one chunk (two f64 zeros) for one worker at
    delta 0, whose handler severs the ops listed in ``server.sever``."""
    server = ShardServer(("127.0.0.1", 0))
    server.RequestHandlerClass = _SeveringHandler
    server.sever, server.severed = set(), []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    manifest, payload = P.pack_arrays({0: torch.zeros(2,
                                                      dtype=torch.float64)})
    with P.connect(server.server_address, timeout=5.0) as sock:
        P.send_msg(sock, {"op": "init", "id": 1, "config": {
            "shard_id": 0, "n_shards": 1, "n_workers": 1, "n_chunks": 1,
            "policy": "dc", "delta": 0, "vbound": None, "timeout": 5.0,
            "record": True}, "manifest": manifest}, payload)
        assert P.recv_msg(sock)[0]["ok"]
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("path", ["rpc", "pipelined", "settle",
                                  "write-send", "post"])
def test_resend_after_a_severed_connection_counts_a_retry(severing_shard,
                                                          path):
    """Each client path that can meet a dead shard connection counts its
    resend as one retry: a synchronous ``_rpc`` (inside its backoff loop),
    a pipelined ``read_batch`` and a deferred ``write_batch``'s settle
    (both resent through ``_rpc`` on a new connection), a ``write_batch``
    whose send fails, and a one-way broadcast whose send fails (the next
    request's new connection).  The shard's side is closed between the
    send and its receive, or before the send; the resent request is
    served exactly once and delta 0's values are the sequential ones."""
    server = severing_shard
    db = ClientParameterDB(0, [server.server_address], n_workers=1,
                           n_chunks=1, timeout=5.0,
                           backoff=Backoff(max_retries=3, base_delay=0.001),
                           batched=path != "rpc")
    one = torch.ones(2, dtype=torch.float64)

    def dead_conn() -> _Conn:
        a, b = socket.socketpair()
        b.close()                 # the shard's side is gone before the send
        return _Conn(sock=a)

    try:
        if path == "rpc":
            server.sever.add("read")
            got = db.read(0, 0, 1)
        elif path == "pipelined":
            server.sever.add("read_batch")
            got, = db.read_all(0, 1)
        else:
            got, = db.read_all(0, 1)
            assert db.telemetry.stats.retried_steps == 0
            if path == "settle":
                server.sever.add("write_batch")
            elif path == "write-send":
                db._conns[0].sock.close()
                db._conns[0] = dead_conn()
            db.write(0, 0, 1, one)
            if path == "post":
                db.settle()
                db._conns[0].sock.close()
                db._conns[0] = dead_conn()
                db._post(0, {"op": "frontier", "worker": 0, "itr": 1})
                assert 0 not in db._conns
            got, = db.read_all(0, 2)
        assert db.telemetry.stats.retried_steps == 1
        assert server.severed == ({"rpc": ["read"],
                                   "pipelined": ["read_batch"],
                                   "settle": ["write_batch"]}.get(path, []))
        want = torch.zeros(2, dtype=torch.float64) \
            if path in ("rpc", "pipelined") else one
        assert torch.equal(got, want)
        db.flush()
        stats = server.state.telemetry.stats
        assert stats.reads == 1 + (path not in ("rpc", "pipelined"))
        assert stats.writes == (path not in ("rpc", "pipelined"))
    finally:
        db.close()
