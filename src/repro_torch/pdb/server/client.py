"""Worker-side client of the sharded ParameterDB (own copy of
``repro.pdb.server.client``).

:class:`ClientParameterDB` exposes the interface of the in-process stores
— ``read / write / can_read / can_write / read_all`` plus ``history``-style
telemetry — so the Sec-6 worker loop, the conformance suite and the
training CLI run unchanged across process boundaries.  Values come back as
torch CPU tensors; a worker moves them to its device itself.

What the client adds over a dumb RPC stub:

  * a **versioned local cache**: a read is served locally when the cached
    version is admissible under the policy bound
    (``policy.cache_admissible``, a monotone predicate evaluated against
    the client's lower-bound clock knowledge — provably conservative).
    Cache-served reads still notify the owner shard (``notify_read``) so
    chunk-local admission state, the Op history and staleness telemetry
    stay authoritative at the shard; what a hit saves is the blocking
    admission wait and the value payload.  Inadmissible cached versions
    are *fetched-and-validated*: the shard answers not-modified (no
    payload) when the cached version is still current — or, under the
    value-bounded policy, when its accumulated drift is within ``vbound``.
  * **batched + pipelined RPC** (protocol v2, the default): ``read_all``
    groups the iteration's read set by owner shard and issues one
    ``read_batch`` frame per shard *concurrently* (all sends first, then
    all receives) — cache hits ride the same frame as piggybacked
    ``notify`` entries.  ``write_many`` frames are **write-behind** — sent
    immediately, their responses collected (``_settle_writes``) at the
    start of the next exchange, so the write round-trip overlaps the
    client's compute.  The commit clock, cache entries and commit
    broadcast are only published at settle time, after the owner shard
    acknowledged the batch: a commit observation that outran its write
    would let a clock-gated read (BSP / SSP) be admitted elsewhere against
    the not-yet-applied value.  Commit and read-frontier broadcasts are
    **one-way** (``noreply``) messages pipelined on the data sockets;
    dropping one is safe, since its content rides the ``clocks`` header of
    every later request.  ``flush`` turns per-connection FIFO into a
    delivery barrier (one ``ping``).  ``batched=False`` restores the
    per-chunk v1 path.
  * **vector-clock gossip**: every response carries the shard's per-worker
    clock vectors, merged into the client's mirror policy; every request
    carries the client's, merged into the shard.  Commit and read-frontier
    events are additionally broadcast to every shard that did not already
    observe the event first-hand, which is what makes clock-gated
    policies (BSP barriers, SSP slack) exact across shards.
  * **shard-death survival**: every synchronous RPC runs under
    :func:`repro_torch.runtime.fault.retry_with_backoff`; connection
    resets reconnect with exponential backoff and resend (shards
    deduplicate by per-sub-op key, so a replayed batch is exactly-once per
    sub-op), and each retry is reported into the client's Telemetry.  A
    connection failure met outside that loop (a pipelined batch, a
    deferred write's settle, a one-way broadcast) marks the shard
    *severed*; the connection that replaces it counts one retry when it
    is opened, so every resend after a shard's death shows in
    ``retried_steps`` whichever path met the failure first.
    Connection *establishment* runs inside the same guarded region: a
    connect-phase timeout against a hung shard surfaces as the standard
    :class:`WaitTimeout` diagnostic.
"""
from __future__ import annotations

import dataclasses
import socket

import torch

from ...runtime.fault import Backoff, retry_with_backoff
from ..db import WaitTimeout
from ..policies import make_policy
from ..telemetry import Telemetry
from . import protocol as P


@dataclasses.dataclass
class CacheEntry:
    value: torch.Tensor
    version: int
    cum: float = 0.0        # shard's cumulative-change ledger at fetch time


@dataclasses.dataclass
class _Conn:
    """One shard's data socket + pipelining state: ids of acked
    fire-and-forget messages still awaiting their acknowledgement, and
    whether any one-way (``noreply``) message has been sent since the last
    synchronous exchange (it needs a ping barrier before teardown)."""
    sock: socket.socket
    pending: set[int] = dataclasses.field(default_factory=set)
    unflushed: bool = False


class ClientParameterDB:
    """One worker's window onto the sharded ParameterDB."""

    def __init__(self, worker: int, addrs: list[tuple[str, int]],
                 n_workers: int, n_chunks: int,
                 policy: str = "dc", delta: float | list = 0,
                 vbound: float | None = None,
                 timeout: float = 60.0,
                 backoff: Backoff | None = None,
                 batched: bool = True):
        self.worker = worker
        self.addrs = list(addrs)
        self.p, self.m = n_workers, n_chunks
        self.n_shards = len(addrs)
        # mirror policy: local clock vector + cache-admissibility bounds
        # (admission itself is decided authoritatively at the shards)
        self.policy = make_policy(policy, n_workers, delta,
                                  n_chunks=n_chunks, vbound=vbound)
        self.timeout = timeout
        self.backoff = backoff or Backoff()
        self.batched = batched
        self.telemetry = Telemetry()            # rpc retries -> retried_steps
        self.cache: dict[int, CacheEntry] = {}
        self.stats = {"cache_hits": 0, "cache_misses": 0,
                      "cache_validated": 0, "bytes_saved": 0,
                      "batch_rpcs": 0, "async_posts": 0}
        self.lamport = 0
        self._next_id = 0
        self._conns: dict[int, _Conn] = {}
        # shards whose connection failed outside retry_with_backoff: the
        # next connection to one is a resend, counted as a retry
        self._severed: set[int] = set()
        self._read_sets: dict[int, set[int]] = {}
        # write-behind: per shard, one deferred write_batch whose response
        # has not been read yet -> (rid, header, payload, writes)
        self._wb_pending: dict[int, tuple[int, dict, bytes, list]] = {}

    # -- connection management ----------------------------------------------
    def _conn(self, shard: int) -> _Conn:
        conn = self._conns.get(shard)
        if conn is None:
            conn = _Conn(P.connect(self.addrs[shard],
                                   timeout=self.timeout + 10.0))
            self._conns[shard] = conn
            if shard in self._severed:
                self._severed.discard(shard)
                self.telemetry.on_retry(0)
        return conn

    def _drop(self, shard: int, severed: bool = True) -> None:
        """Close ``shard``'s connection.  ``severed``: it failed (or was
        left mid-stream), so the next connection to the shard is a resend
        and counts as a retry; retry_with_backoff's own attempts pass False,
        since the loop counts them itself."""
        if severed:
            self._severed.add(shard)
        conn = self._conns.pop(shard, None)
        if conn is not None:
            try:
                conn.sock.close()
            except OSError:
                pass

    def close(self) -> None:
        for s in list(self._conns):
            self.flush(s)
            self._drop(s, severed=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the RPC core --------------------------------------------------------
    def _send(self, conn: _Conn, header: dict, payload: bytes = b"") -> int:
        """Stamp (id, ts, clocks) onto ``header`` and put one frame on the
        wire.  Returns the request id."""
        self._next_id += 1
        self.lamport += 1
        header["id"] = self._next_id
        header["ts"] = self.lamport
        header["clocks"] = self.policy.clocks.as_dict()
        P.send_msg(conn.sock, header, payload)
        return self._next_id

    def _fold(self, resp: dict) -> None:
        """Merge a response's clock gossip + Lamport stamp (acks included)."""
        clocks = resp.get("clocks")
        if clocks:
            self.policy.clocks.merge(clocks["commit"], clocks["frontier"])
        self.lamport = max(self.lamport, int(resp.get("ts", 0)))

    def _recv_matched(self, conn: _Conn, rid: int) -> tuple[dict, bytes]:
        """Receive until the response with id ``rid`` arrives, draining
        acknowledgements of earlier fire-and-forget messages pipelined on
        the same socket (they may complete in any order relative to each
        other).  Responses for ids this client never issued are a protocol
        violation."""
        while True:
            resp, rp = P.recv_msg(conn.sock)
            got = resp.get("id")
            self._fold(resp)
            if got == rid or got is None:   # None: pre-id (v1) peer
                return resp, rp
            if got in conn.pending:
                # an async broadcast's ack; a non-ok ack needs no replay —
                # the broadcast's clock content piggybacks on every
                # subsequent request header (gossip self-repairs)
                conn.pending.discard(got)
                continue
            raise ConnectionResetError(
                f"protocol error: response id {got} matches no outstanding "
                f"request (expected {rid})")

    def _check(self, resp: dict, header: dict, shard: int) -> None:
        if resp.get("ok"):
            return
        if resp.get("stall"):
            raise WaitTimeout(
                header.get("op", "?")[:1], header.get("worker", -1),
                header.get("chunk", -1), header.get("itr", -1),
                self.timeout, self.policy, message=resp.get("error"))
        if resp.get("retryable"):
            raise ConnectionResetError(resp.get("error", "retryable"))
        raise RuntimeError(f"shard{shard}: {resp.get('error')}")

    def _timeout_error(self, header: dict, shard: int,
                       phase: str) -> WaitTimeout:
        # the shard itself answers admission stalls; a silent socket
        # timeout means a hung/unreachable shard — same diagnostic as the
        # threaded backend's condition-variable timeout
        return WaitTimeout(
            header.get("op", "?")[:1], header.get("worker", -1),
            header.get("chunk", -1), header.get("itr", -1),
            self.timeout, self.policy, where=f"shard{shard} ({phase})")

    def _rpc(self, shard: int, header: dict,
             payload: bytes = b"") -> tuple[dict, bytes]:
        """One synchronous request/response, retried with backoff across
        connection failures (including the connect phase: a hung shard's
        connect timeout is a WaitTimeout, not a raw socket error)."""
        def attempt() -> tuple[dict, bytes]:
            try:
                conn = self._conn(shard)
                rid = self._send(conn, header, payload)
                resp, rp = self._recv_matched(conn, rid)
            except TimeoutError:
                self._drop(shard)
                raise self._timeout_error(header, shard, "rpc")
            except OSError:
                self._drop(shard, severed=False)
                raise
            self._check(resp, header, shard)
            return resp, rp

        return retry_with_backoff(
            attempt, self.backoff, retry_on=(ConnectionError,),
            telemetry=self.telemetry,
            on_retry=lambda attempt_no: self._drop(shard, severed=False),
            describe=f"rpc {header.get('op')} -> shard{shard}")

    def _rpc_pipelined(self, requests: dict[int, tuple[dict, bytes]]
                       ) -> dict[int, tuple[dict, bytes]]:
        """Issue one request per shard *concurrently*: all frames go on the
        wire first, then the responses are collected — total latency is the
        slowest shard's, not the sum.  A shard whose send/receive fails
        falls back to the synchronous retry-with-backoff path (sub-op dedup
        at the shard makes the replay exactly-once)."""
        sent: dict[int, int] = {}
        failed: list[int] = []
        out: dict[int, tuple[dict, bytes]] = {}
        fatal: Exception | None = None
        for s in sorted(requests):
            header, payload = requests[s]
            try:
                sent[s] = self._send(self._conn(s), header, payload)
            except (TimeoutError, OSError):
                self._drop(s)
                failed.append(s)
        for s, rid in sent.items():
            header, payload = requests[s]
            try:
                resp, rp = self._recv_matched(self._conns[s], rid)
                self._check(resp, header, s)
            except WaitTimeout as e:
                # a stalled batch is fatal, but keep draining the other
                # shards' responses first so no socket is left mid-stream
                fatal = fatal or e
                continue
            except TimeoutError:
                self._drop(s)
                fatal = fatal or self._timeout_error(header, s, "rpc")
                continue
            except OSError:
                self._drop(s)
                failed.append(s)
                continue
            out[s] = (resp, rp)
        if fatal is not None:
            raise fatal
        for s in failed:
            header, payload = requests[s]
            out[s] = self._rpc(s, header, payload)
        self.stats["batch_rpcs"] += len(requests)
        return out

    def _post(self, shard: int, header: dict) -> None:
        """Fire-and-forget: pipeline a one-way broadcast on the data socket.
        ``noreply`` tells the shard to send no acknowledgement frame at all
        — the message costs one send and zero receives.  Failures are
        swallowed: the message's clock content rides the header of every
        later request, so a lost broadcast costs latency, never safety."""
        header["noreply"] = True
        try:
            conn = self._conn(shard)
            self._send(conn, header)
            conn.unflushed = True
            self.stats["async_posts"] += 1
        except (TimeoutError, OSError):
            self._drop(shard)

    def flush(self, shard: int | None = None) -> None:
        """Settle deferred writes and barrier outstanding one-way
        broadcasts: a synchronous ``ping`` on each dirty socket proves (by
        per-connection FIFO) that the shard processed everything sent
        before it — used before final-state collection; not needed for
        correctness mid-run."""
        self._settle_writes()
        shards = [shard] if shard is not None else list(self._conns)
        for s in shards:
            conn = self._conns.get(s)
            if conn is None or not conn.unflushed:
                continue
            try:
                rid = self._send(conn, {"op": "ping"})
                resp, _ = self._recv_matched(conn, rid)
                conn.unflushed = False
            except (TimeoutError, OSError):
                self._drop(s)

    def _shard(self, chunk: int) -> int:
        return P.shard_of(chunk, self.n_shards)

    # -- write-behind --------------------------------------------------------
    def _apply_write_results(self, resp: dict, writes: list) -> None:
        cums = {int(c): (int(ver), float(cum))
                for c, ver, cum in resp["results"]}
        for c, a, v in writes:
            ver, cum = cums[c]
            self.policy.did_write(self.worker, c, a)
            self.cache[c] = CacheEntry(v.clone(), ver, cum)

    def _settle_writes(self) -> None:
        """Collect the responses of deferred ``write_batch`` frames, then
        perform every observable effect of the write: the local commit-clock
        bump (``did_write``), the cache entries, and the commit broadcast.
        All of it waits for the owner shard's acknowledgement because **a
        commit observation must never outrun the write it describes**: if
        ``commit[w]=itr`` gossiped to other shards while the write frame was
        still in flight, a clock-gated read (BSP/SSP) could be admitted
        elsewhere against the not-yet-applied value.

        Settle runs before any other exchange on the data sockets, so the
        response is normally already buffered (the shard processed the
        write while the client moved on) — the write's round-trip latency
        is overlapped, not skipped.  A connection failure replays the
        stored frame through the synchronous retry path (shard-side dedup
        makes the replay exactly-once per sub-op); a stall surfaces as the
        standard WaitTimeout, one exchange later than the sequential client
        would have seen it."""
        if not self._wb_pending:
            return
        pending, self._wb_pending = self._wb_pending, {}
        fatal: Exception | None = None
        owners, itr_max = set(), 0
        for s, (rid, header, payload, writes) in pending.items():
            conn = self._conns.get(s)
            try:
                if conn is None:
                    raise ConnectionResetError("connection dropped")
                resp, _ = self._recv_matched(conn, rid)
                self._check(resp, header, s)
            except WaitTimeout as e:
                fatal = fatal or e
                continue
            except TimeoutError:
                self._drop(s)
                fatal = fatal or self._timeout_error(header, s, "settle")
                continue
            except (ConnectionError, OSError):
                self._drop(s)
                resp, _ = self._rpc(s, header, payload)
            self._apply_write_results(resp, writes)
            owners.add(s)
            itr_max = max(itr_max, max(a for _, a, _ in writes))
        if fatal is not None:
            raise fatal
        for s in range(self.n_shards):
            if s not in owners:
                self._post(s, {"op": "commit", "worker": self.worker,
                               "itr": itr_max})

    def settle(self) -> None:
        """Collect the deferred write responses now rather than at the start
        of the next exchange (``_settle_writes``), so a caller can time the
        settle apart from its next read."""
        self._settle_writes()

    def _broadcast(self, op: str, itr: int,
                   exclude: int | None = None) -> None:
        for s in range(self.n_shards):
            if s == exclude:
                continue
            header = {"op": op, "worker": self.worker, "itr": itr}
            if self.batched:
                self._post(s, header)
            else:
                self._rpc(s, header)

    # -- the ParameterDB interface ------------------------------------------
    def read(self, worker: int, chunk: int, itr: int) -> torch.Tensor:
        self._settle_writes()
        entry = self.cache.get(chunk)
        if entry is not None and self.policy.cache_admissible(
                chunk, entry.version, itr):
            self.stats["cache_hits"] += 1
            self.stats["bytes_saved"] += entry.value.nbytes
            self._rpc(self._shard(chunk),
                      {"op": "notify_read", "worker": worker, "chunk": chunk,
                       "itr": itr, "version": entry.version})
            value = entry.value
        else:
            req = {"op": "read", "worker": worker, "chunk": chunk, "itr": itr}
            if entry is not None:
                req["cached_version"] = entry.version
                req["cached_cum"] = entry.cum
            resp, rp = self._rpc(self._shard(chunk), req)
            if resp["modified"]:
                value = P.decode_array(resp, rp)
                self.cache[chunk] = CacheEntry(value, resp["version"],
                                               resp.get("cum", 0.0))
                self.stats["cache_misses"] += 1
            else:
                value = entry.value       # validated: current, or in vbound
                self.stats["cache_validated"] += 1
                self.stats["bytes_saved"] += value.nbytes
        self.policy.did_read(worker, chunk, itr)
        self._note_read(worker, chunk, itr)
        return value.clone()

    def _note_read(self, worker: int, chunk: int, itr: int) -> None:
        s = self._read_sets.setdefault(itr, set())
        s.add(chunk)
        if len(s) == self.m:      # full Def-3 read set done at this itr
            del self._read_sets[itr]
            self.policy.observe_frontier(worker, itr)
            # the shard serving the completing read learns the frontier from
            # the next message's clock header; everyone else is broadcast to
            self._broadcast("frontier", itr, exclude=self._shard(chunk))

    def read_all(self, worker: int, itr: int) -> list[torch.Tensor]:
        """The iteration's full Def-3 read set.  Batched mode: group by
        owner shard, one pipelined ``read_batch`` per shard; cache hits
        become piggybacked ``notify`` entries on the same frames."""
        if not self.batched:
            return [self.read(worker, j, itr) for j in range(self.m)]
        self._settle_writes()
        values: dict[int, torch.Tensor] = {}
        groups: dict[int, dict] = {}
        for c in range(self.m):
            g = groups.setdefault(self._shard(c), {"ops": [], "notify": []})
            entry = self.cache.get(c)
            if entry is not None and self.policy.cache_admissible(
                    c, entry.version, itr):
                self.stats["cache_hits"] += 1
                self.stats["bytes_saved"] += entry.value.nbytes
                g["notify"].append([c, itr, entry.version])
                values[c] = entry.value
            else:
                op = [c, itr]
                if entry is not None:
                    op += [entry.version, entry.cum]
                g["ops"].append(op)
        requests = {
            s: ({"op": "read_batch", "worker": worker, "itr": itr,
                 "ops": g["ops"], "notify": g["notify"]}, b"")
            for s, g in groups.items()}
        for s, (resp, rp) in self._rpc_pipelined(requests).items():
            got = P.unpack_arrays(resp.get("manifest") or [], rp)
            for c, served, modified, cum in resp["results"]:
                c = int(c)
                if modified:
                    values[c] = got[c]
                    self.cache[c] = CacheEntry(got[c], int(served),
                                               float(cum))
                    self.stats["cache_misses"] += 1
                else:
                    values[c] = self.cache[c].value
                    self.stats["cache_validated"] += 1
                    self.stats["bytes_saved"] += values[c].nbytes
        for c in range(self.m):
            self.policy.did_read(worker, c, itr)
            self._note_read(worker, c, itr)
        return [values[c].clone() for c in range(self.m)]

    def write(self, worker: int, chunk: int, itr: int,
              value: torch.Tensor) -> None:
        self.write_many(worker, [(chunk, itr, value)])

    def write_many(self, worker: int,
                   writes: list[tuple[int, int, torch.Tensor]]) -> None:
        """Commit several chunk writes — grouped by owner shard into one
        pipelined ``write_batch`` per shard (batched mode) or sequential
        per-chunk ``write`` RPCs (v1 mode).  The commit-clock broadcast
        goes to the shards that received no write (a written shard observes
        the commit first-hand in ``did_write``)."""
        writes = [(int(c), int(a), torch.as_tensor(v, device="cpu"))
                  for c, a, v in writes]
        owners = {self._shard(c) for c, _, _ in writes}
        if self.batched:
            self._settle_writes()      # at most one deferred write per shard
            groups: dict[int, dict] = {}
            for c, a, v in writes:
                g = groups.setdefault(self._shard(c),
                                      {"ops": [], "arr": {}, "writes": []})
                g["ops"].append([c, a])
                g["arr"][c] = v
                g["writes"].append((c, a, v))
            for s, g in groups.items():
                manifest, payload = P.pack_arrays(g["arr"])
                header = {"op": "write_batch", "worker": worker,
                          "ops": g["ops"], "manifest": manifest}
                try:
                    rid = self._send(self._conn(s), header, payload)
                    self._wb_pending[s] = (rid, header, payload, g["writes"])
                except (TimeoutError, OSError):
                    self._drop(s)      # send failed: sync replay w/ backoff
                    resp, _ = self._rpc(s, header, payload)
                    self._apply_write_results(resp, g["writes"])
            # did_write / cache entries / commit broadcast all happen at
            # settle time, once the owner shard has acknowledged the batch
            # (a commit observation must never outrun its write)
            return
        for c, a, v in writes:
            meta, payload = P.encode_array(v)
            resp, _ = self._rpc(self._shard(c),
                                {"op": "write", "worker": worker,
                                 "chunk": c, "itr": a, **meta}, payload)
            self.policy.did_write(worker, c, a)
            self.cache[c] = CacheEntry(v.clone(), resp["version"],
                                       resp.get("cum", 0.0))
        itr = max(a for _, a, _ in writes)
        for s in range(self.n_shards):
            if s not in owners:
                self._rpc(s, {"op": "commit", "worker": self.worker,
                              "itr": itr})

    def can_read(self, worker: int, chunk: int, itr: int) -> bool:
        self._settle_writes()
        resp, _ = self._rpc(self._shard(chunk),
                            {"op": "can", "kind": "r", "worker": worker,
                             "chunk": chunk, "itr": itr})
        return bool(resp["admissible"])

    def can_write(self, worker: int, chunk: int, itr: int) -> bool:
        self._settle_writes()
        resp, _ = self._rpc(self._shard(chunk),
                            {"op": "can", "kind": "w", "worker": worker,
                             "chunk": chunk, "itr": itr})
        return bool(resp["admissible"])
