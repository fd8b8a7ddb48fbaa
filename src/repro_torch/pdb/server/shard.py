"""One shard of the distributed ParameterDB (own copy of
``repro.pdb.server.shard``): a TCP server process owning a hash-assigned
subset of the chunks.

A shard is the blocking-threaded store of :mod:`repro_torch.pdb.db` pushed
across a process boundary: each client connection gets a handler thread,
admission blocks on one shared condition variable, and every completed op
is recorded through the same :class:`repro_torch.pdb.telemetry.Telemetry`
— stamped with the shard's Lamport clock so per-shard histories merge into
one global history (``telemetry.merge_timed_histories``).

The chunks are torch **CPU** tensors: a shard is storage, and never
initialises CUDA (a context would cost each shard process memory on the
card).  Chunk-local policy state (bit vectors, versions, last-read arrays)
lives here authoritatively; cross-shard admission state arrives as
per-worker clock broadcasts (``commit`` / ``frontier`` messages) that the
policy merges via ``observe_commit`` / ``observe_frontier``.  All admission
predicates are monotone in that state, so a shard can never admit an op
the global truth would reject — it can only wait longer.

Retries are safe: every state-mutating message is keyed by
``(kind, worker, chunk, itr)`` and deduplicated, so a client that resends
after a connection reset (shard death drill, ``runtime.fault.Backoff``)
gets at-least-once delivery with exactly-once recording.  A resent read
gets the reply it was given the first time, the version its telemetry
records: its recording may have let other workers write the chunk since
(the first response lost with a killed shard; up to delta + 1 writes at
delay delta), so the shard keeps, per worker and chunk, the reply to the
worker's last read of it (version, value, drift) and answers a resend
with that.  A worker resends only its last read of a chunk, so one reply
per (worker, chunk) is enough at any delay; a kept value is a reference
to the tensor a later write replaced, never a copy.  (The JAX shard
serves the current version there, up to delta + 1 writes too new.)  With
``--snapshot`` the shard persists its state (chunks, policy, dedup set,
telemetry, Lamport clock) after each mutation and restores it on boot —
a killed-and-restarted shard resumes where it died.

Run standalone:  ``python -m repro_torch.pdb.server.shard --port 7070``
(then initialize it with an ``init`` message — see ``cluster.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import socketserver
import threading

import torch

from ..db import stall_diagnostic
from ..policies import make_policy
from ..telemetry import Telemetry
from . import protocol as P

# how often serve_forever looks for a shutdown request (socketserver's
# default is 0.5 s, the longest a cluster's shutdown then waits a shard)
SHUTDOWN_POLL_S = 0.05


@dataclasses.dataclass
class ShardConfig:
    shard_id: int
    n_shards: int
    n_workers: int
    n_chunks: int
    policy: str = "dc"
    delta: float | list = 0
    vbound: float | None = None
    timeout: float = 60.0
    record: bool = True
    snapshot_path: str | None = None

    def to_header(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("snapshot_path")
        return d


def _own(value) -> torch.Tensor:
    """A CPU tensor of ``value`` that shares memory with nothing else (a
    received chunk is a view into its frame)."""
    return torch.as_tensor(value, device="cpu").clone()


class ShardState:
    """Storage + policy + telemetry for the chunks this shard owns."""

    def __init__(self, cfg: ShardConfig, chunks: dict):
        self.cfg = cfg
        self.chunks = {int(c): _own(v) for c, v in chunks.items()}
        self.policy = make_policy(cfg.policy, cfg.n_workers, cfg.delta,
                                  n_chunks=cfg.n_chunks, vbound=cfg.vbound)
        self.telemetry = Telemetry(record_history=cfg.record)
        self.version = {c: 0 for c in self.chunks}
        self.cum_change = {c: 0.0 for c in self.chunks}   # vap ledger (L-inf)
        self.seen: set[tuple] = set()
        # (worker, chunk) -> (itr, version, modified, value, cum): the
        # reply to the worker's last read of the chunk, for its resend
        self.replies: dict[tuple, tuple] = {}
        self.lamport = 0
        self.cond = threading.Condition()

    # -- persistence (shard-death survival) ---------------------------------
    def snapshot(self) -> None:
        """Atomically persist state; called under the condition lock after
        every mutation when a snapshot path is configured."""
        path = self.cfg.snapshot_path
        if not path:
            return
        blob = pickle.dumps({
            "cfg": self.cfg, "chunks": self.chunks, "policy": self.policy,
            "version": self.version, "cum_change": self.cum_change,
            "seen": self.seen, "replies": self.replies,
            "lamport": self.lamport, "telemetry": self.telemetry})
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    @classmethod
    def restore(cls, path: str) -> "ShardState":
        # the file is this shard's own snapshot (see ``snapshot``)
        with open(path, "rb") as f:
            d = pickle.load(f)
        self = cls.__new__(cls)
        self.cfg = d["cfg"]
        self.chunks, self.policy = d["chunks"], d["policy"]
        self.version, self.cum_change = d["version"], d["cum_change"]
        self.seen, self.lamport = d["seen"], d["lamport"]
        self.replies = d["replies"]
        self.telemetry = d["telemetry"]
        self.cond = threading.Condition()
        return self

    # -- helpers (call under self.cond) -------------------------------------
    def _tick(self, ts) -> int:
        self.lamport = max(self.lamport, int(ts or 0)) + 1
        return self.lamport

    def _merge_clocks(self, h: dict) -> None:
        clocks = h.get("clocks")
        if clocks:
            self.policy.clocks.merge(clocks["commit"], clocks["frontier"])
            # merged clocks can satisfy a blocked admission predicate (BSP
            # frontier, SSP slack) even when this message records no op —
            # wake waiters so piggybacked gossip alone makes progress
            self.cond.notify_all()

    def _base_resp(self, chunk: int | None = None) -> dict:
        resp = {"ok": True, "clocks": self.policy.clocks.as_dict(),
                "ts": self.lamport}
        if chunk is not None:
            resp["cum"] = self.cum_change[chunk]
        return resp

    def _stall(self, kind: str, w: int, c: int, a: int) -> tuple[dict, bytes]:
        return ({"ok": False, "stall": True,
                 "error": stall_diagnostic(
                     kind, w, c, a, self.cfg.timeout, self.policy,
                     where=f"shard{self.cfg.shard_id}")}, b"")

    # -- op bodies (call under self.cond) ------------------------------------
    def _admit(self, kind: str, w: int, c: int, a: int) -> bool:
        """Block until the op is admissible (or already recorded — a crash
        retry).  The Lamport stamp of the op is taken *after* this returns:
        an op that waited must be stamped later than the op that admitted
        it, or the merged global history misorders them."""
        key = (kind, w, c, a)
        pred = (self.policy.can_read if kind == "r" else self.policy.can_write)
        return self.cond.wait_for(
            lambda: key in self.seen or pred(w, c, a),
            timeout=self.cfg.timeout)

    def _record_notify(self, w: int, c: int, a: int, ver) -> bool:
        """Record a client-cache-served read (bits, last-read arrays,
        history, staleness at the *observed* version).  Returns True if the
        op was new (False: duplicate delivery)."""
        key = ("r", w, c, a)
        if key in self.seen:
            return False
        self.policy.did_read(w, c, a)
        self.telemetry.on_read(w, c, a, version=ver, lamport=self._tick(None))
        self.seen.add(key)
        self.cond.notify_all()
        return True

    def _serve_read(self, w: int, c: int, a: int, cached_ver,
                    cached_cum) -> tuple[int, bool, torch.Tensor, float]:
        """Admitted-read body: conditional serving + recording.  Returns
        (served_version, modified, value, cum); ``modified=False`` means the
        client's cached copy is still valid (current, or within the value
        bound) and no payload travels."""
        key = ("r", w, c, a)
        ver, cum = self.version[c], self.cum_change[c]
        if key in self.seen:              # crash retry: the first reply
            itr, *reply = self.replies.get((w, c), (None,))
            if itr == a:
                return tuple(reply)
            return ver, True, self.chunks[c], cum   # recorded by a notify
        vb = self.cfg.vbound
        if cached_ver is not None and cached_ver == ver:
            served, modified = ver, False             # cache validated
        elif (cached_ver is not None and vb is not None
              and cached_cum is not None and cum - cached_cum <= vb):
            served, modified = cached_ver, False      # within value bound
        else:
            served, modified = ver, True
        self.policy.did_read(w, c, a)
        self.telemetry.on_read(w, c, a, version=served,
                               lamport=self._tick(None))
        self.seen.add(key)
        self.replies[w, c] = (a, served, modified, self.chunks[c], cum)
        self.cond.notify_all()
        return served, modified, self.chunks[c], cum

    def _apply_write(self, w: int, c: int, a: int,
                     arr: torch.Tensor) -> None:
        """Admitted-write body: value + drift ledger + recording (idempotent
        under duplicate delivery).  The drift is the L-inf norm of the
        change, exact as in numpy."""
        key = ("w", w, c, a)
        if key in self.seen:
            return
        old = self.chunks[c]
        if old.shape == arr.shape:
            self.cum_change[c] += (float((arr - old).abs().max())
                                   if arr.numel() else 0.0)
        self.chunks[c] = _own(arr)
        self.version[c] = max(self.version[c], a)
        self.policy.did_write(w, c, a)
        self.telemetry.on_write(w, c, a, lamport=self._tick(None))
        self.seen.add(key)
        self.cond.notify_all()

    # -- message handlers ----------------------------------------------------
    def read(self, h: dict) -> tuple[dict, bytes]:
        w, c, a = h["worker"], h["chunk"], h["itr"]
        with self.cond:
            self._merge_clocks(h)
            self._tick(h.get("ts"))       # receipt event (sender causality)
            if not self._admit("r", w, c, a):
                return self._stall("r", w, c, a)
            served, modified, value, cum = self._serve_read(
                w, c, a, h.get("cached_version"), h.get("cached_cum"))
            self.snapshot()
            resp = self._base_resp(c)
            resp.update(version=served, modified=modified, cum=cum)
            if modified:
                meta, payload = P.encode_array(value)
                resp.update(meta)
                return resp, payload
            return resp, b""

    def notify_read(self, h: dict) -> tuple[dict, bytes]:
        """A read the client served from its local cache."""
        w, c, a = h["worker"], h["chunk"], h["itr"]
        with self.cond:
            self._merge_clocks(h)
            self._tick(h.get("ts"))
            if self._record_notify(w, c, a, h.get("version")):
                self.snapshot()
            return self._base_resp(c), b""

    def write(self, h: dict, payload) -> tuple[dict, bytes]:
        w, c, a = h["worker"], h["chunk"], h["itr"]
        with self.cond:
            self._merge_clocks(h)
            self._tick(h.get("ts"))
            if not self._admit("w", w, c, a):
                return self._stall("w", w, c, a)
            self._apply_write(w, c, a, P.decode_array(h, payload))
            self.snapshot()
            resp = self._base_resp(c)
            resp["version"] = self.version[c]
            return resp, b""

    def read_batch(self, h: dict) -> tuple[dict, bytes]:
        """Protocol-v2 multi-chunk read: one frame carries every read this
        worker needs from this shard at this iteration, plus piggybacked
        ``notify`` entries for the reads its cache already served.

        Sub-ops are admitted in order under a single condition-lock pass
        (``wait_for`` releases the lock while blocked, so other handler
        threads make progress).  Each sub-op gets its own post-admission
        Lamport stamp; ``snapshot()`` runs once per batch.  A stalled
        sub-op fails the whole batch (already-recorded sub-ops are kept:
        the client's retry is deduplicated per sub-op)."""
        w = h["worker"]
        with self.cond:
            self._merge_clocks(h)
            self._tick(h.get("ts"))
            recorded = False
            for c, a, ver in h.get("notify") or []:
                recorded |= self._record_notify(w, int(c), int(a), ver)
            results, send = [], {}
            for op in h.get("ops") or []:
                c, a = int(op[0]), int(op[1])
                cached_ver = op[2] if len(op) > 2 else None
                cached_cum = op[3] if len(op) > 3 else None
                if not self._admit("r", w, c, a):
                    if recorded:
                        self.snapshot()
                    return self._stall("r", w, c, a)
                served, modified, value, cum = self._serve_read(
                    w, c, a, cached_ver, cached_cum)
                recorded = True
                if modified:
                    send[c] = value
                results.append([c, served, int(modified), cum])
            if recorded:
                self.snapshot()
            resp = self._base_resp()
            manifest, payload = P.pack_arrays(send)
            resp.update(results=results, manifest=manifest)
            return resp, payload

    def write_batch(self, h: dict, payload) -> tuple[dict, bytes]:
        """Protocol-v2 multi-chunk write: ``ops`` rows are ``[chunk, itr]``
        with the values packed into one payload via the ``pack_arrays``
        manifest.  Same single-lock-pass admission, per-sub-op Lamport
        stamps and once-per-batch snapshot as :meth:`read_batch`."""
        w = h["worker"]
        arrays = P.unpack_arrays(h.get("manifest") or [], payload)
        with self.cond:
            self._merge_clocks(h)
            self._tick(h.get("ts"))
            results, recorded = [], False
            for c, a in h.get("ops") or []:
                c, a = int(c), int(a)
                if not self._admit("w", w, c, a):
                    if recorded:
                        self.snapshot()
                    return self._stall("w", w, c, a)
                self._apply_write(w, c, a, arrays[c])
                recorded = True
                results.append([c, self.version[c], self.cum_change[c]])
            if recorded:
                self.snapshot()
            resp = self._base_resp()
            resp["results"] = results
            return resp, b""

    def observe(self, h: dict) -> tuple[dict, bytes]:
        """commit / frontier clock broadcasts."""
        with self.cond:
            self._merge_clocks(h)
            self._tick(h.get("ts"))
            if h["op"] == "commit":
                self.policy.observe_commit(h["worker"], h["itr"])
            else:
                self.policy.observe_frontier(h["worker"], h["itr"])
            self.snapshot()
            self.cond.notify_all()
            return self._base_resp(), b""

    def can(self, h: dict) -> tuple[dict, bytes]:
        w, c, a = h["worker"], h["chunk"], h["itr"]
        with self.cond:
            # merge + tick like every other handler: clock gossip rides
            # ``can`` requests too, and the response must carry a fresh ts
            self._merge_clocks(h)
            self._tick(h.get("ts"))
            pred = (self.policy.can_read if h["kind"] == "r"
                    else self.policy.can_write)
            resp = self._base_resp()
            resp["admissible"] = bool(pred(w, c, a))
            return resp, b""

    def pull(self, h: dict) -> tuple[dict, bytes]:
        """Final-state collection: values + Lamport-stamped history + stats."""
        with self.cond:
            self._tick(h.get("ts"))
            manifest, payload = P.pack_arrays(self.chunks)
            resp = self._base_resp()
            resp.update(
                manifest=manifest,
                history=[[t, op.kind, op.worker, op.chunk, op.itr]
                         for t, op in self.telemetry.timed_history()],
                stats=dataclasses.asdict(self.telemetry.stats),
                versions={str(c): v for c, v in self.version.items()},
                cums={str(c): v for c, v in self.cum_change.items()})
            return resp, payload


class ShardServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr: tuple[str, int],
                 snapshot_path: str | None = None):
        super().__init__(addr, _Handler)
        self.snapshot_path = snapshot_path
        self.state: ShardState | None = None
        if snapshot_path and os.path.exists(snapshot_path):
            self.state = ShardState.restore(snapshot_path)
            self.state.cfg.snapshot_path = snapshot_path

    def dispatch(self, h: dict, payload) -> tuple[dict, bytes]:
        op = h.get("op")
        if op == "ping":
            return {"ok": True, "initialized": self.state is not None}, b""
        if op == "init":
            if self.state is None:
                cfg = ShardConfig(snapshot_path=self.snapshot_path,
                                  **h["config"])
                chunks = P.unpack_arrays(h["manifest"], payload)
                self.state = ShardState(cfg, chunks)
                self.state.snapshot()
            return {"ok": True, "chunks": sorted(self.state.chunks)}, b""
        if op == "shutdown":
            return {"ok": True}, b""
        if self.state is None:
            # mid-restart window: the client treats this as a transient
            # connection-level failure and retries with backoff
            return {"ok": False, "retryable": True,
                    "error": "shard not initialized"}, b""
        if op == "read":
            return self.state.read(h)
        if op == "read_batch":
            return self.state.read_batch(h)
        if op == "notify_read":
            return self.state.notify_read(h)
        if op == "write":
            return self.state.write(h, payload)
        if op == "write_batch":
            return self.state.write_batch(h, payload)
        if op in ("commit", "frontier"):
            return self.state.observe(h)
        if op == "can":
            return self.state.can(h)
        if op == "pull":
            return self.state.pull(h)
        return {"ok": False, "error": f"unknown op {op!r}"}, b""


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        # pipelining puts back-to-back small writes (broadcast ack, then a
        # batch response) on one socket: without NODELAY, Nagle holds the
        # second write for the peer's delayed ACK (~40ms per batch)
        self.request.setsockopt(P.socket.IPPROTO_TCP, P.socket.TCP_NODELAY, 1)

    def handle(self):
        sock = self.request
        while True:
            try:
                h, payload = P.recv_msg(sock)
            except (ConnectionError, OSError):
                return
            try:
                resp, rp = self.server.dispatch(h, payload)
            except Exception as e:     # never kill the connection silently
                resp, rp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}, b""
            if h.get("noreply"):       # one-way message (clock broadcast):
                continue               # no response frame at all
            if "id" in h:              # protocol v2: responses echo the
                resp["id"] = h["id"]   # request id (pipelined matching)
            try:
                P.send_msg(sock, resp, rp)
            except (ConnectionError, OSError):
                return
            if h.get("op") == "shutdown":
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return


def _spawn_entry(conn, snapshot_path: str | None = None,
                 port: int = 0) -> None:
    """multiprocessing spawn target: bind ``port`` (0 = ephemeral), report
    the bound port through ``conn``, serve until shutdown.  Restarts pass
    the original port so clients can reconnect to a fixed address."""
    server = ShardServer(("127.0.0.1", port), snapshot_path=snapshot_path)
    conn.send(server.server_address[1])
    conn.close()
    server.serve_forever(poll_interval=SHUTDOWN_POLL_S)
    server.server_close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one ParameterDB shard")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--snapshot", default=None,
                    help="state file for crash-restart survival")
    args = ap.parse_args(argv)
    server = ShardServer((args.host, args.port), snapshot_path=args.snapshot)
    print(f"shard listening on {server.server_address[0]}:"
          f"{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
