"""Cross-host map exchange over TCP.

Port of `orbslam3_tpu/distributed/host_exchange.py`. Ships `map_blocks`
keyframe blocks between SLAM hosts, so a stored map can be welded into
another host's Atlas (`fetch_remote_map` -> `Atlas.weld`).

Framing, byte for byte the JAX package's: every message is [u32
big-endian length][payload]; a map is one `map` header (JSON: kind,
n_blocks, map_id) followed by that many serialized blocks; a dict of arrays
(e.g. a BA problem for a joint solve) is one `arrays` header (JSON: kind,
name) followed by one npz payload. Synchronous by design: the caller owns
threads.

Every socket this module makes has a timeout, `recv_msg` refuses a socket
without one, `connect` retries only until its deadline, and `serve_once`
closes its listener on every path.
"""

from __future__ import annotations

import io
import json
import socket
import struct
import time

import numpy as np

from orbslam3_tpu_torch.distributed.map_blocks import (fetch_remote_map, map_to_blocks,
                                                       serialize_block)
from orbslam3_tpu_torch.slam_map.map_state import MapConfig, MapState

_LEN = struct.Struct(">I")
MAX_MSG = 256 * 1024 * 1024  # one block is <= a few MB; guards corrupt frames


def send_msg(sock: socket.socket, payload: bytes):
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket) -> bytes:
    if sock.gettimeout() is None:
        raise ValueError("recv_msg needs a socket with a timeout")
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_MSG:
        raise ValueError(f"oversized frame: {n} bytes")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


# ------------------------------------------------------------------ map send
def send_map(sock: socket.socket, m: MapState, block_kfs: int = 64):
    """Stream a map as blocks over an open socket."""
    blocks = map_to_blocks(m, block_kfs=block_kfs)
    head = json.dumps({"kind": "map", "n_blocks": len(blocks),
                       "map_id": int(m.map_id)}).encode()
    send_msg(sock, head)
    for blk in blocks:
        send_msg(sock, serialize_block(blk))


def recv_map(sock: socket.socket, cfg: MapConfig, map_id: int = 0,
             device=None) -> MapState:
    """Receive one map; returns a reassembled MapState whose covisibility
    product runs on `device` (the card unless ``device="cpu"``)."""
    head = json.loads(recv_msg(sock).decode())
    if head.get("kind") != "map":
        raise ValueError(f"expected map header, got {head}")
    raw = [recv_msg(sock) for _ in range(int(head["n_blocks"]))]
    return fetch_remote_map(raw, cfg, map_id=map_id, device=device)


# ------------------------------------------------------- array dict exchange
def send_arrays(sock: socket.socket, name: str, arrays: dict):
    """Ship a dict of numpy arrays (e.g. a BA problem) to the peer."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    send_msg(sock, json.dumps({"kind": "arrays", "name": name}).encode())
    send_msg(sock, buf.getvalue())


def recv_arrays(sock: socket.socket) -> tuple[str, dict]:
    head = json.loads(recv_msg(sock).decode())
    if head.get("kind") != "arrays":
        raise ValueError(f"expected arrays header, got {head}")
    with np.load(io.BytesIO(recv_msg(sock)), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return head["name"], arrays


# ----------------------------------------------------------------- listeners
def serve_once(port: int, timeout: float = 120.0, host: str = "127.0.0.1") -> socket.socket:
    """Accept exactly one peer on host:port within `timeout` seconds; the
    connection keeps that timeout for every later wait."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        srv.settimeout(timeout)
        conn, _ = srv.accept()
    finally:
        srv.close()
    conn.settimeout(timeout)
    return conn


def connect(port: int, host: str = "127.0.0.1", timeout: float = 120.0,
            delay: float = 0.2) -> socket.socket:
    """Connect to a peer, retrying while it boots, for at most `timeout`
    seconds; the socket keeps that timeout for every later wait."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection(
                (host, port), timeout=max(0.1, deadline - time.monotonic()))
            sock.settimeout(timeout)
            return sock
        except OSError as e:
            if time.monotonic() + delay >= deadline:
                raise ConnectionError(f"cannot reach {host}:{port} within {timeout} s: {e}") \
                    from e
            time.sleep(delay)
