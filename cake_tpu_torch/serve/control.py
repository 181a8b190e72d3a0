"""Multi-process serving control channel.

Counterpart of `cake_tpu/serve/control.py`, with its frames, token
hello, `MAX_OP_BYTES`, desync check and wire metrics (the same family
names), so a frame one package's server writes is a frame the other's
client reads.

Why it exists in the port: every process of a mesh that spans
processes runs the positions it owns, and a stage's hidden state
crosses to the next process inside the step (a `torch.distributed`
send/recv, parallel/pipeline.py). A step dispatched by the coordinator
alone would block in its first hop, so the coordinator's engine
publishes one tiny op record (slot and token metadata, never tensors)
before each device step, and every follower replays the same step in
the same order (serve/engine.run_follower_loop).

Transport: length-prefixed JSON over TCP (utils/wire.py). The payloads
are ints, floats and lists only, no pickle, so a hostile peer on the
serving network cannot execute code through this channel. The
coordinator's address reaches the followers through a one-time
broadcast over the process group that `parallel/distributed.initialize`
formed (a length-prefixed uint8 tensor, `broadcast_control_address`),
so no extra address flag is needed.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from typing import Dict, List, Optional

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.utils import wire as _wire

log = logging.getLogger(__name__)

# the shared length-prefix framing (utils/wire.py — ONE copy
# for the control and telemetry planes); module aliases kept so the
# rest of this file (and its tests) read unchanged
_LEN = _wire.LEN
MAX_OP_BYTES = 16 << 20  # sanity bound; a real op is < max_seq_len ints
# the address payload's bound: three 253-char DNS-name ":65535" fields
# (control, heartbeat, telemetry collector) and the 32-hex token fit
MAX_ADDR_BYTES = 1024

# -- wire metrics ------------------------------------------------------------
# The control/heartbeat plane carries ALL cross-host coordination, yet
# until these it emitted nothing — a slow or flapping op stream was
# invisible. Both sides increment the same family names in their OWN
# process registry; follower-side samples reach the coordinator's
# /metrics with a host label via telemetry federation
# (obs/federation.py).
_CONTROL_OPS = _m.counter(
    "cake_control_ops_total",
    "Control-channel ops by op type (coordinator: published; follower: "
    "received/replayed — each side counts in its own process registry)",
    labelnames=("op",))
_CONTROL_BYTES = _m.counter(
    "cake_control_bytes_total",
    "Control-channel wire bytes incl. the length prefix, by direction "
    "(tx = coordinator publish fan-out across followers, rx = follower "
    "frame receive)",
    labelnames=("dir",))
_CONTROL_PUBLISH = _m.histogram(
    "cake_control_publish_seconds",
    "Wall seconds per ControlServer.publish (serialize + fan the op out "
    "to every follower socket) — the engine thread pays this before "
    "each replayed device step",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0))
_FOLLOWER_LAG = _m.gauge(
    "cake_control_follower_lag_ops",
    "Published-op seq minus the follower's last-applied seq (reported "
    "in its telemetry frames) — a growing lag means a follower is "
    "falling behind the SPMD dispatch stream",
    labelnames=("follower",))


class ControlDesyncError(RuntimeError):
    """A follower observed a GAP in the published op seq stream: one or
    more ops were never received, so its mirrored engine state has
    diverged from the coordinator's. Replaying further ops would
    silently desync the SPMD dispatch — the only safe move is to fail
    loudly and disconnect (the coordinator's next publish then raises
    instead of wedging a collective)."""


def broadcast_control_address(addr: Optional[str]) -> str:
    """Share the coordinator's control address with every process.

    The coordinator passes its payload ("host:port|token|..."); the
    followers pass None. Two broadcasts over the default process group,
    from rank 0: the payload's length as one int64, then its bytes as a
    uint8 tensor (never `broadcast_object_list`: the channel stays free
    of pickle). On gloo the tensors live on the CPU; on nccl on this
    process's card. Must be called at the same program point on every
    process (it is a collective)."""
    import torch
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    raw = addr.encode() if addr else b""
    if len(raw) > MAX_ADDR_BYTES:
        raise ValueError(f"control address too long: {addr!r}")
    n = torch.tensor([len(raw)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=0)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if addr:
        buf.copy_(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    if buf.numel():
        dist.broadcast(buf, src=0)
    return bytes(buf.cpu().numpy().tobytes()).decode()


_send_msg = _wire.send_msg


class ControlServer:
    """Coordinator side: accepts one connection per follower, then
    `publish()`es each op to all of them in dispatch order (TCP keeps
    per-follower ordering; every follower sees the same sequence).

    token: shared secret (distributed through the process group's
    broadcast, which only cluster members receive). A connection that
    does not present it within 10s is dropped without ever occupying a
    follower slot or receiving an op — so a rogue peer on the serving
    network can neither exhaust the slots nor observe prompt token ids."""

    # cakelint guards discipline: every dotted use of the injector must
    # be `is not None`-guarded (disabled plane = one attribute test)
    OPTIONAL_PLANES = ("faults",)

    def __init__(self, n_followers: int, host: str = "",
                 port: int = 0, accept_timeout: float = 120.0,
                 token: Optional[str] = None):
        self.n_followers = n_followers
        self.token = token
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
            self._sock.listen(max(n_followers, 1))
        except OSError:
            # callers retry with a different host on bind failure; the
            # half-constructed socket must not leak its fd
            self._sock.close()
            raise
        self._accept_timeout = accept_timeout
        self._conns: List[socket.socket] = []
        # parallel to _conns: per-follower wire bookkeeping — peer
        # address + the last op seq actually written to that socket.
        # With follower_acks (last-applied seqs reported back through
        # telemetry frames) a disconnect is diagnosable post-mortem:
        # the log line says exactly how far the dead follower got.
        self._peers: List[Dict] = []
        # follower name (telemetry host id) -> last-acked applied seq
        self.follower_acks: Dict[str, int] = {}
        self._seq = 0                # monotonic published-op counter
        self._lock = threading.Lock()
        # deterministic fault injection (faults/): the engine's
        # attach_control points this at its injector so a --fault-plan
        # can fail the op publish exactly like a dead follower would
        self.faults = None

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def accept_followers(self) -> None:
        import hmac
        import time as _time

        deadline = _time.monotonic() + self._accept_timeout
        while len(self._conns) < self.n_followers:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"only {len(self._conns)}/{self.n_followers} followers"
                    f" connected within {self._accept_timeout}s")
            self._sock.settimeout(remaining)
            try:
                conn, peer = self._sock.accept()
            except socket.timeout:
                continue
            if self.token is not None:
                # bounded hello (utils/wire.py): the length
                # is size-capped (a token is tens of bytes — an
                # attacker-controlled multi-GiB length must not
                # allocate) and the whole read wall-time-capped with
                # an ABSOLUTE deadline (per-recv timeouts would
                # multiply under byte-trickling and hold the accept
                # loop hostage)
                from cake_tpu_torch.utils.wire import recv_bounded_msg
                hd = _time.monotonic() + min(
                    10.0, max(deadline - _time.monotonic(), 0.1))
                hello = recv_bounded_msg(conn, 256, hd)
                if hello is None or not hmac.compare_digest(
                        hello, self.token.encode()):
                    log.warning("control: rejected peer %s (bad token)",
                                peer)
                    conn.close()
                    continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            self._peers.append({"peer": "%s:%s" % peer[:2],
                                "last_sent_seq": 0})
            log.info("control: follower connected from %s", peer)

    def publish(self, op: dict) -> None:
        """Send one op to every follower, stamped with a monotonically
        increasing ``seq``. Called from the engine thread immediately
        before it dispatches the corresponding device step. Followers
        verify the seq stream is gapless (ControlClient.recv raises
        ControlDesyncError on a gap) and report their last-applied seq
        back through telemetry frames (note_ack)."""
        if self.faults is not None:
            self.faults.check("control.publish")
        t0 = time.perf_counter()
        nbytes = 0
        with self._lock:
            self._seq += 1
            seq = self._seq
            payload = json.dumps({**op, "seq": seq}).encode()
            for conn, meta in zip(self._conns, self._peers):
                try:
                    _send_msg(conn, payload)
                except OSError:
                    # a dead follower cannot be skipped silently — the
                    # step it was part of would block on its hop; surface it
                    # WITH the wire state (how far this follower got,
                    # and what every follower last acked) so the
                    # desync is diagnosable post-mortem
                    log.error(
                        "control: follower %s connection lost at "
                        "publish seq %d (last_sent_seq=%d, "
                        "follower_acks=%s)", meta["peer"], seq,
                        meta["last_sent_seq"], dict(self.follower_acks))
                    raise RuntimeError(
                        "control: follower connection lost; the SPMD "
                        f"mesh is no longer fully driven (follower "
                        f"{meta['peer']} last_sent_seq="
                        f"{meta['last_sent_seq']}, publishing seq "
                        f"{seq}, acks {dict(self.follower_acks)})")
                meta["last_sent_seq"] = seq
                nbytes += _LEN.size + len(payload)
        _CONTROL_OPS.labels(op=str(op.get("op", "?"))).inc()
        if nbytes:
            _CONTROL_BYTES.labels(dir="tx").inc(nbytes)
        _CONTROL_PUBLISH.observe(time.perf_counter() - t0)

    @property
    def published_seq(self) -> int:
        """Seq of the newest published op (0 = nothing published) —
        the minuend of every follower's lag."""
        with self._lock:
            return self._seq

    def note_ack(self, follower: str, applied_seq: int) -> None:
        """Record a follower's last-APPLIED op seq (reported in its
        telemetry frame, obs/federation.py) and refresh its lag gauge.
        Keyed by the follower's telemetry host id (proc1, ...)."""
        with self._lock:
            self.follower_acks[str(follower)] = int(applied_seq)
            lag = max(0, self._seq - int(applied_seq))
        _FOLLOWER_LAG.labels(follower=str(follower)).set(lag)

    def wire_state(self) -> Dict:
        """Control-plane wire introspection for recovery_state() /
        post-mortems: the published seq, each connection's last-sent
        seq, and the last-acked applied seqs by follower name."""
        with self._lock:
            return {
                "published_seq": self._seq,
                "followers": [dict(meta) for meta in self._peers],
                "acks": dict(self.follower_acks),
            }

    def wait_closed(self, timeout: float = 30.0) -> None:
        """Block until every follower closes its end (EOF). Called during
        coordinator teardown so the process group's store, which the
        coordinator hosts, stays up until every follower has finished
        with the channel and entered its own process-group shutdown."""
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.settimeout(timeout)
                while conn.recv(4096):
                    pass  # followers send nothing; drain until EOF
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            for conn in self._conns:
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
        self._sock.close()


class ControlClient:
    """Follower side: connect (with retries — the coordinator may still
    be binding), present the shared token, and iterate ops until the
    stream closes."""

    # cakelint guards discipline, same as ControlServer
    OPTIONAL_PLANES = ("faults",)

    def __init__(self, address: str, connect_timeout: float = 120.0,
                 token: Optional[str] = None):
        host, port = address.rsplit(":", 1)
        deadline = connect_timeout
        # last op seq seen on this channel: recv() enforces a gapless
        # stream (a GAP = missed ops = diverged mirror state) with a
        # typed ControlDesyncError instead of silently replaying on
        self._last_seq = 0
        t0 = time.monotonic()
        last: Optional[Exception] = None
        while time.monotonic() - t0 < deadline:
            try:
                self._sock = socket.create_connection(
                    (host, int(port)), timeout=10.0)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                if token is not None:
                    _send_msg(self._sock, token.encode())
                self._sock.settimeout(None)  # ops may be minutes apart
                return
            except OSError as e:
                last = e
                time.sleep(0.2)
        raise ConnectionError(
            f"could not reach control server at {address}: {last}")

    # follower-side fault injection point (faults/): cli wires
    # the follower's --fault-plan here so a chaos run can fail an op
    # receive exactly like a truncated stream would
    faults = None
    # partial-frame carry-over: bytes consumed before a recv() timeout
    # are KEPT here and resumed by the next call — the liveness retry
    # loop must never re-enter mid-frame and desync the op stream, and
    # a coordinator that dies WITHOUT a FIN mid-frame must still hit
    # the timeout (no unbounded blocking read anywhere)
    _rbuf = b""

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Next op, or None when the coordinator closed the channel.
        With a timeout, raises socket.timeout when the wait for more
        frame bytes exceeds it — whether the frame has started or not
        (a mid-frame peer death with no FIN must not hang the
        follower); partially-read bytes persist in _rbuf, so a retry
        resumes the SAME frame instead of desyncing the stream."""
        if self.faults is not None:
            self.faults.check("control.recv")

        def fill(n: int) -> bool:
            """Grow _rbuf to n bytes; False = clean close. Timeouts
            propagate with everything read so far preserved."""
            while len(self._rbuf) < n:
                part = self._sock.recv(n - len(self._rbuf))
                if not part:
                    return False
                self._rbuf += part
            return True

        self._sock.settimeout(timeout)
        try:
            if not fill(_LEN.size):
                return None
            (n,) = _LEN.unpack(self._rbuf[:_LEN.size])
            if n > MAX_OP_BYTES:
                raise ValueError(f"oversized control op: {n} bytes")
            if not fill(_LEN.size + n):
                return None
        finally:
            self._sock.settimeout(None)
        payload = self._rbuf[_LEN.size:]
        self._rbuf = b""
        op = json.loads(payload)
        _CONTROL_BYTES.labels(dir="rx").inc(_LEN.size + len(payload))
        seq = op.get("seq") if isinstance(op, dict) else None
        if isinstance(seq, int):
            if self._last_seq and seq != self._last_seq + 1:
                raise ControlDesyncError(
                    f"control op seq gap: expected "
                    f"{self._last_seq + 1}, got {seq} — this follower "
                    f"missed {seq - self._last_seq - 1} op(s); its "
                    "mirrored state has diverged and replaying further "
                    "ops would silently desync the SPMD dispatch")
            self._last_seq = seq
        if isinstance(op, dict):
            _CONTROL_OPS.labels(op=str(op.get("op", "?"))).inc()
        return op

    def close(self) -> None:
        self._sock.close()
