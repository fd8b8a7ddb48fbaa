"""Wire protocol of the sharded parameter server (own copy of
``repro.pdb.server.protocol``): length-prefixed frames, byte for byte the
JAX package's, so a port peer and a JAX peer talk to each other.

Every message (request or response) is one frame:

    u32_be header_len | header (UTF-8 JSON) | u32_be payload_len | payload

The JSON header (compact separators) carries the op type, coordinates,
clock vectors and array metadata; the payload carries raw array bytes
(C-order) when chunk values travel, else is empty.  Frames whose header or
payload length exceeds ``MAX_FRAME`` are rejected at receive time
(``ConnectionError``).  Arrays are described by numpy dtype strings
(``'<f4'``, ``'<f8'``, ...): a torch dtype with no numpy counterpart
(bfloat16) cannot cross the wire and raises ``TypeError``.  Received arrays
are torch CPU tensors that share memory with the received frame.

See the JAX module for the ops and their header fields (protocol v2:
request ids, batched and pipelined ``read_batch`` / ``write_batch``,
one-way ``noreply`` broadcasts, ``ping`` as a per-connection delivery
barrier).  Multi-chunk payloads use ``pack_arrays``/``unpack_arrays``: the
manifest rows are ``[chunk_id, dtype, shape, offset, nbytes]`` into one
concatenated byte string.

Chunk placement is by hash: ``shard_of(chunk, S)`` mixes the chunk id with
a Knuth multiplicative hash before reducing mod S, so consecutive chunks
spread across shards.
"""
from __future__ import annotations

import json
import socket
import struct

import numpy as np
import torch

_LEN = struct.Struct("!I")
MAX_FRAME = 1 << 30          # sanity bound: refuse absurd frames
_COALESCE = 1 << 16          # payloads up to this go out in one write

# A multiplicative hash (Knuth's 2^32 / phi) rather than `chunk % S`, so
# chunk->shard placement is scattered and independent of chunk ordering.
_KNUTH = 2654435761


def shard_of(chunk: int, n_shards: int) -> int:
    return ((chunk * _KNUTH) & 0xFFFFFFFF) % n_shards


def owned_chunks(shard: int, n_chunks: int, n_shards: int) -> list[int]:
    return [c for c in range(n_chunks) if shard_of(c, n_shards) == shard]


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        part = sock.recv_into(view[got:], n - got)
        if not part:
            raise ConnectionResetError("peer closed mid-frame")
        got += part
    return buf


def send_msg(sock: socket.socket, header: dict, payload=b"") -> None:
    hb = json.dumps(header, separators=(",", ":")).encode()
    head = _LEN.pack(len(hb)) + hb + _LEN.pack(len(payload))
    if len(payload) <= _COALESCE:
        sock.sendall(head + payload)
    else:                       # the same bytes, without a copy of payload
        sock.sendall(head)
        sock.sendall(payload)


def recv_msg(sock: socket.socket) -> tuple[dict, bytes | bytearray]:
    (hlen,) = _LEN.unpack(_recv_exact(sock, 4))
    if hlen > MAX_FRAME:
        raise ConnectionError(f"oversized header ({hlen} bytes)")
    header = json.loads(_recv_exact(sock, hlen).decode())
    (plen,) = _LEN.unpack(_recv_exact(sock, 4))
    if plen > MAX_FRAME:
        raise ConnectionError(f"oversized payload ({plen} bytes)")
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


def _as_numpy(arr) -> np.ndarray:
    """The C-ordered numpy view of a tensor (copied to the CPU first when
    it lies on a device) or array; its dtype names it on the wire."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach()
        if arr.device.type != "cpu":
            arr = arr.cpu()
        try:
            arr = arr.numpy()
        except TypeError as e:
            raise TypeError(
                f"{arr.dtype} cannot cross the parameter server's wire: "
                "frames name numpy dtypes, and numpy has none for it "
                "(cast the chunk to float32 first)") from e
    # order="C" (not ascontiguousarray, whose contract is ndim >= 1 and
    # would silently promote 0-d arrays to shape (1,))
    return np.asarray(arr, order="C")


def _bytes_of(a: np.ndarray) -> np.ndarray:
    """A uint8 view of C-ordered ``a`` (no copy)."""
    return a.reshape(-1).view(np.uint8)


def _tensor(dtype: str, shape, buf, offset: int, nbytes: int
            ) -> torch.Tensor:
    dt = np.dtype(dtype)
    a = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize,
                      offset=offset).reshape(shape)
    if not dt.isnative:
        a = a.astype(dt.newbyteorder("="))
    elif not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def encode_array(arr) -> tuple[dict, bytes]:
    a = _as_numpy(arr)
    return ({"dtype": a.dtype.str, "shape": list(a.shape)},
            _bytes_of(a).tobytes())


def decode_array(meta: dict, payload) -> torch.Tensor:
    return _tensor(meta["dtype"], meta["shape"], payload, 0, len(payload))


def pack_arrays(arrays: dict) -> tuple[list, bytes]:
    """Pack several chunk arrays into one payload: returns (manifest, bytes)
    where manifest rows are [chunk_id, dtype, shape, offset, nbytes]."""
    manifest, parts, off = [], [], 0
    for cid in sorted(arrays):
        a = _as_numpy(arrays[cid])
        manifest.append([cid, a.dtype.str, list(a.shape), off, a.nbytes])
        parts.append(_bytes_of(a))
        off += a.nbytes
    return manifest, b"".join(parts)


def unpack_arrays(manifest: list, payload) -> dict[int, torch.Tensor]:
    return {int(cid): _tensor(dtype, shape, payload, off, nbytes)
            for cid, dtype, shape, off, nbytes in manifest}


def connect(addr: tuple[str, int], timeout: float | None) -> socket.socket:
    sock = socket.create_connection(addr, timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
