"""HTTP/SSE proxying between the front door and one replica.

The router forwards the client's body and control headers
(`x-cake-priority`, `x-cake-idempotency-key`, `Last-Event-ID`) to the
chosen replica and relays the response:

  * non-200: status, body, `Retry-After` and `x-cake-replica` headers
    relay VERBATIM — a replica's computed backpressure is the honest
    one, the router never rewrites it;
  * 200 JSON: body relays as-is;
  * 200 SSE: the event stream passes through line-by-line with `id:`
    fields preserved (absolute token positions — `Last-Event-ID`
    reconnects keep working through the router, across replicas);
  * a replica dying MID-STREAM surfaces as a terminal SSE error event
    (typed `ReplicaDownError`, retryable) — never a silent close the
    client cannot tell from success.

Outcomes are returned as ProxyOutcome values so the server's failover
loop can decide: retry elsewhere (nothing reached the client yet) or
stop (bytes are already on the wire / the response was relayed).
"""

from __future__ import annotations

import http.client
import json
import logging
import time
from typing import Callable, Optional

from cake_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

# headers the router forwards to the replica; everything else is
# hop-local (Content-Length is recomputed, Host rewritten by httplib).
# Trace context (x-cake-trace / x-cake-hop) is NOT in this list: the
# router owns it — the server passes the minted/propagated values via
# extra_headers so a client cannot smuggle a conflicting hop count past
# the front door.
FORWARD_HEADERS = ("x-cake-priority", "x-cake-idempotency-key",
                   "Last-Event-ID")
# response headers relayed verbatim on a non-200 (the honest
# backpressure surface: the replica computed them, the router must
# not; x-cake-trace rides along so a refused request still hands the
# client its trace id)
RELAY_HEADERS = ("Retry-After", "x-cake-replica", "x-cake-trace")

_TTFT = obs_metrics.histogram(
    "cake_router_ttft_seconds",
    "Router-observed time from forwarding a streaming request to its "
    "first SSE data event")


class ProxyOutcome:
    """What happened to one forward attempt.

    kind:
      * "ok"        — 200 relayed to completion (stream or JSON)
      * "relayed"   — non-200 relayed verbatim (status carries it)
      * "retryable" — nothing reached the client; the server may fail
                      over to another replica (connect failure, or a
                      refusal `should_failover` classified as roamable:
                      draining 429, switch 409, retryable 503)
      * "midstream" — the stream broke after bytes reached the client;
                      a terminal SSE error event was written
    """

    __slots__ = ("kind", "status", "retry_after_s", "error", "draining",
                 "hard")

    def __init__(self, kind: str, status: int = 0,
                 retry_after_s: Optional[float] = None,
                 error: str = "", draining: bool = False,
                 hard: bool = False):
        self.kind = kind
        self.status = status
        self.retry_after_s = retry_after_s
        self.error = error
        self.draining = draining
        # hard: CONNECT-level failure — nothing listens there, strong
        # evidence the replica is gone (the server hard-ejects it).
        # Post-connect breaks (header timeout, body/stream cut) stay
        # soft: a busy replica queueing admissions is not a corpse.
        self.hard = hard


def classify_refusal(status: int, body: bytes) -> str:
    """Split replica refusals into roamable vs terminal.

    Roamable (another replica may well admit this request): a DRAIN
    429 (this replica is leaving the fleet), a 409 (config switch in
    flight) and a retryable 503 (transient engine reset). Terminal
    (relay verbatim): shed/queue-full 429 — the replica measured its
    own saturation and computed an honest Retry-After; 4xx client
    errors; non-retryable 500s (poison)."""
    if status == 409:
        return "switch"
    try:
        doc = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        doc = {}
    if status == 429 and "draining" in str(doc.get("error", "")):
        return "draining"
    if status == 503 and doc.get("retryable") is True:
        return "reset"
    return ""


class ReplicaProxy:
    """One forward attempt per call; connections are per-request (the
    replica's keep-alive is its own business — the router's fan-out is
    bounded by client concurrency, not a pool)."""

    def __init__(self, connect_timeout_s: float = 2.0,
                 stream_idle_timeout_s: float = 600.0,
                 header_timeout_s: float = 300.0):
        self.connect_timeout_s = connect_timeout_s
        self.stream_idle_timeout_s = stream_idle_timeout_s
        # bound on the wait for the replica's response STATUS LINE: a
        # replica whose accept loop died with its listen socket still
        # open (mid-drain shutdown, wedged process) would otherwise
        # blackhole requests for the full idle timeout instead of
        # roaming. Streaming responses send headers at ADMISSION, so
        # this costs them nothing; non-stream responses arrive only
        # when generation completes — keep the bound above the longest
        # expected non-stream generation (or use streaming behind a
        # router).
        self.header_timeout_s = header_timeout_s

    def forward_chat(self, replica: str, path: str, body_bytes: bytes,
                     headers: dict, stream: bool,
                     send_status: Callable[[int, dict, bytes], None],
                     send_line: Callable[[bytes], None],
                     send_terminal_error: Callable[[str], None],
                     on_admitted: Optional[Callable[..., None]] = None,
                     extra_headers: Optional[dict] = None,
                     on_hop: Optional[Callable[..., None]] = None,
                     ) -> ProxyOutcome:
        """Forward one chat request.

        send_status(code, relay_headers, body) — relay a complete
        non-stream response. send_line(raw) — relay one SSE line
        (already includes the newline). send_terminal_error(msg) —
        write the typed terminal SSE error event (only called after
        send_line delivered bytes). on_admitted(rid=...) fires as soon
        as the replica answers 200 — i.e. the request holds a slot
        THERE — so idempotency-sticky state exists before the stream
        finishes (a mid-stream reconnect must find its home); rid is
        the replica's echoed x-cake-rid (None when absent).
        extra_headers are router-owned forwards (the trace context)
        merged OVER the client's. on_hop(name, **fields) records hop
        spans live ("connect", "first_byte") for the router's tracer —
        live, because a streaming relay returns only when the stream
        ends, long after both happened."""
        fwd = {"Content-Type": "application/json"}
        for h in FORWARD_HEADERS:
            v = headers.get(h)
            if v is not None:
                fwd[h] = v
        if extra_headers:
            fwd.update(extra_headers)
        # the SHORT timeout covers only the TCP connect (a dead replica
        # must fail over in milliseconds); the response itself may
        # legitimately take a long generation (non-stream requests
        # answer only when done), so the socket relaxes to the idle
        # timeout once connected
        conn = http.client.HTTPConnection(
            replica, timeout=self.connect_timeout_s)
        t0 = time.perf_counter()
        try:
            conn.connect()
        except OSError as e:
            conn.close()
            return ProxyOutcome("retryable", hard=True,
                                error=f"connect failed: {e}")
        if on_hop is not None:
            on_hop("connect")
        try:
            conn.sock.settimeout(self.header_timeout_s)
            conn.request("POST", path, body=body_bytes, headers=fwd)
            resp = conn.getresponse()
            conn.sock.settimeout(self.stream_idle_timeout_s)
        except OSError as e:
            # post-connect: the replica is there but slow/broken —
            # roam, but do NOT treat it as a corpse
            conn.close()
            return ProxyOutcome("retryable",
                                error=f"request/header failed: {e}")

        try:
            if resp.status != 200:
                try:
                    data = resp.read()
                except (OSError, http.client.HTTPException) as e:
                    # body cut mid-read; nothing reached the client
                    return ProxyOutcome(
                        "retryable", error=f"refusal body cut: {e}")
                roam = classify_refusal(resp.status, data)
                relay = {h: resp.getheader(h) for h in RELAY_HEADERS
                         if resp.getheader(h) is not None}
                ra = resp.getheader("Retry-After")
                if roam:
                    return ProxyOutcome(
                        "retryable", status=resp.status,
                        retry_after_s=float(ra) if ra else None,
                        error=roam, draining=(roam == "draining"))
                send_status(resp.status, relay, data)
                return ProxyOutcome(
                    "relayed", status=resp.status,
                    retry_after_s=float(ra) if ra else None)

            if on_admitted is not None:
                rid_h = resp.getheader("x-cake-rid")
                try:
                    rid_v = int(rid_h) if rid_h is not None else None
                except ValueError:
                    rid_v = None
                on_admitted(rid=rid_v)
            ctype = resp.getheader("Content-Type", "")
            if not stream or "text/event-stream" not in ctype:
                try:
                    data = resp.read()
                except (OSError, http.client.HTTPException) as e:
                    # the replica died mid-body: nothing reached the
                    # client yet, so this request can still roam (the
                    # keyed case re-homes; a completed-but-cut
                    # transcript re-serves via the idempotent attach)
                    return ProxyOutcome(
                        "retryable", error=f"response body cut: {e}")
                if on_hop is not None:
                    # non-stream: the whole body IS the first byte the
                    # client sees (generation answers only when done)
                    on_hop("first_byte",
                           ttft_s=round(time.perf_counter() - t0, 6))
                relay = {h: resp.getheader(h) for h in RELAY_HEADERS
                         if resp.getheader(h) is not None}
                send_status(200, relay, data)
                return ProxyOutcome("ok", status=200)

            # SSE pass-through. The replica sent its headers only after
            # admission (api/server.py on_start), so a 200 here means
            # the request holds a slot — from now on a break is
            # mid-stream, not a failover.
            first = True
            sent_any = False
            saw_terminal = False
            while True:
                try:
                    line = resp.readline()
                except (OSError, http.client.HTTPException) as e:
                    if not sent_any:
                        # admitted but nothing reached the client yet:
                        # safe to roam to another replica
                        return ProxyOutcome(
                            "retryable",
                            error=f"stream broke before first event: "
                                  f"{e}")
                    log.warning("replica %s died mid-stream: %s",
                                replica, e)
                    send_terminal_error(
                        f"replica {replica} went away mid-stream "
                        f"({type(e).__name__}); reconnect with your "
                        "idempotency key and Last-Event-ID to resume")
                    return ProxyOutcome("midstream", error=str(e))
                if not line:
                    if not sent_any:
                        # admitted but died before the first event:
                        # nothing reached the client — roam
                        return ProxyOutcome(
                            "retryable",
                            error="stream closed before first event")
                    if not saw_terminal:
                        # EOF without [DONE] or an error event: the
                        # replica's socket closed under the stream —
                        # surface it, never a silent close
                        send_terminal_error(
                            f"replica {replica} closed the stream "
                            "without finishing; reconnect with your "
                            "idempotency key and Last-Event-ID to "
                            "resume")
                        return ProxyOutcome(
                            "midstream", error="eof without terminal")
                    return ProxyOutcome("ok", status=200)
                if first and line.startswith((b"data:", b"id:")):
                    ttft = time.perf_counter() - t0
                    _TTFT.observe(ttft)
                    if on_hop is not None:
                        on_hop("first_byte", ttft_s=round(ttft, 6))
                    first = False
                # terminal markers: the exact [DONE] sentinel line or
                # the typed error event ({"error": {...}} — a delta
                # containing the literal text would JSON-escape its
                # quotes)
                if line.strip() == b"data: [DONE]" or (
                        line.startswith(b'data: {"error":')):
                    saw_terminal = True
                try:
                    send_line(line)
                    sent_any = True
                except OSError:
                    # the CLIENT went away; nothing more to relay (the
                    # replica stream is abandoned with this connection
                    # close — a keyed request keeps decoding replica-
                    # side for the reconnect)
                    return ProxyOutcome("ok", status=200,
                                        error="client disconnected")
        finally:
            conn.close()
