"""Shared length-prefixed TCP framing for the coordination planes.

Counterpart of `cake_tpu/utils/wire.py`, copied as it is: the same
4-byte big-endian length prefix, the same bounded hello read, so a
frame one package writes is a frame the other reads. The telemetry
federation plane (obs/federation.py) and the disaggregated page channel
(kv/transfer.py) speak it, and so does the control channel of
multi-process serving (serve/control.py).

Deliberately NOT shared: each consumer's streaming read loop. The page
channel's persistent partial-frame buffer (timeout-resume semantics)
and the collector's per-connection buffer genuinely differ, and forcing
them through one abstraction would couple timeout behaviors that must
stay independent.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Optional

LEN = struct.Struct("!I")


def send_msg(sock: socket.socket, payload: bytes) -> None:
    """One length-prefixed message, written atomically enough for a
    stream socket (sendall)."""
    sock.sendall(LEN.pack(len(payload)) + payload)


def recv_bounded_msg(conn: socket.socket, max_len: int,
                     deadline: float) -> Optional[bytes]:
    """Read ONE length-prefixed message under an ABSOLUTE monotonic
    deadline and a payload-size cap; None on timeout, EOF, socket
    error, or a length outside (0, max_len].

    This is the hello-read discipline both planes use on their accept
    paths: the size cap stops an attacker-controlled multi-GiB length
    from allocating, and the absolute deadline stops byte-trickling
    from holding an accept/handler thread hostage (per-recv timeouts
    would multiply under trickling)."""
    buf = b""

    def fill(n: int) -> bool:
        nonlocal buf
        while len(buf) < n:
            rem = deadline - time.monotonic()
            if rem <= 0:
                return False
            conn.settimeout(rem)
            try:
                part = conn.recv(n - len(buf))
            except OSError:
                return False
            if not part:
                return False
            buf += part
        return True

    if not fill(LEN.size):
        return None
    (n,) = LEN.unpack(buf[:LEN.size])
    if not 0 < n <= max_len:
        return None
    if not fill(LEN.size + n):
        return None
    return buf[LEN.size:]
