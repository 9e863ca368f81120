"""The gang coordinator's wire protocol (ref
``paddle_tpu/distributed/coordinator.py:108-162``).

Length-prefixed JSON frames: a 4-byte big-endian unsigned length, then that
many bytes of UTF-8 JSON with sorted keys (one object a frame, 16 MiB cap).
The serving fleet (``serving/fleet.py``) speaks it between the router and
each replica, so a port router can drive reference replicas and back.

Not ported yet: ``GangCoordinator`` and ``GangClient`` (heartbeats, the
commit manifest, step barriers, standby promotion and epoch fencing), with
the launcher that hosts them (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any

__all__ = ["MAX_FRAME_BYTES", "send_frame", "recv_frame"]

#: one JSON frame may not exceed this
MAX_FRAME_BYTES = 16 << 20


def send_frame(sock: socket.socket, obj: Any) -> None:
    """Serialize ``obj`` as one length-prefixed JSON frame (raises
    ``ValueError`` over the cap, before anything is sent)."""
    body = json.dumps(obj, sort_keys=True).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError(
            f"gang frame of {len(body)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap")
    sock.sendall(struct.pack(">I", len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("gang peer closed the connection")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Any:
    """Read one frame (``ConnectionError`` on a closed peer, ``ValueError``
    on an oversized or malformed frame)."""
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if n > MAX_FRAME_BYTES:
        raise ValueError(
            f"gang frame announces {n} bytes, over the "
            f"{MAX_FRAME_BYTES}-byte cap (corrupt stream?)")
    return json.loads(_recv_exact(sock, n).decode("utf-8"))
