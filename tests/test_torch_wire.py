"""The port's length-prefixed framing (`cake_tpu_torch/utils/wire.py`)
against the JAX package's (`cake_tpu/utils/wire.py`).

  * `send_msg` writes the bytes JAX's writes, and each package's
    `recv_bounded_msg` reads the other's messages;
  * the bounded read gives None, as JAX's does, on a length of 0, a
    length past the cap, an EOF mid-message and a deadline that passes
    while bytes trickle in (the deadline is absolute: waited on with a
    deadline, never a fixed sleep).
"""

import socket
import time

import pytest

from cake_tpu_torch.utils import wire


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _read_all(sock, n):
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        assert part
        buf += part
    return buf


@pytest.mark.parametrize("payload", [b"x", b"hello" * 100, bytes(range(256))])
def test_send_msg_writes_jax_bytes_and_each_reads_the_other(payload):
    from cake_tpu.utils import wire as jwire

    assert wire.LEN.format == jwire.LEN.format
    for send, recv in ((wire.send_msg, jwire.recv_bounded_msg),
                       (jwire.send_msg, wire.recv_bounded_msg)):
        a, b = _pair()
        try:
            send(a, payload)
            got = recv(b, 1 << 20, time.monotonic() + 5.0)
            assert got == payload
        finally:
            a.close()
            b.close()
    a, b = _pair()
    c, d = _pair()
    try:
        wire.send_msg(a, payload)
        jwire.send_msg(c, payload)
        n = wire.LEN.size + len(payload)
        assert _read_all(b, n) == _read_all(d, n)
    finally:
        for s in (a, b, c, d):
            s.close()


@pytest.mark.parametrize("case", ["zero", "over_cap", "eof", "trickle"])
def test_bounded_read_refuses_like_jax(case):
    from cake_tpu.utils import wire as jwire

    results = []
    for recv in (wire.recv_bounded_msg, jwire.recv_bounded_msg):
        a, b = _pair()
        try:
            if case == "zero":
                a.sendall(wire.LEN.pack(0))
            elif case == "over_cap":
                a.sendall(wire.LEN.pack(17) + b"x" * 17)
            elif case == "eof":
                a.sendall(wire.LEN.pack(8) + b"abc")
                a.shutdown(socket.SHUT_WR)
            else:
                # two bytes of a 4-byte prefix, then nothing: the
                # absolute deadline ends the read
                a.sendall(wire.LEN.pack(8)[:2])
            t0 = time.monotonic()
            results.append(recv(b, 16, t0 + 0.3))
            assert time.monotonic() - t0 < 5.0
        finally:
            a.close()
            b.close()
    assert results == [None, None]
