"""Fleet-scope telemetry federation: cross-host metric/event shipping.

Counterpart of `cake_tpu/obs/federation.py`, copied as it is: the same
frames (JSON over the utils/wire.py framing, a token-gated hello), the
same per-host views, clock correction and read surfaces, and the same
metric families, so a port exporter's frames are ingested by the JAX
package's collector and the other way round. The collector feeds the
API server's ``GET /api/v1/fleet``, ``?host=`` events, the
host-labelled families appended to ``/metrics`` and the fleet merge of
a request's timeline. Multi-process serving (cli._serve_multihost)
wires them as JAX does: the coordinator's collector with ``control=``
(its ControlServer, whose published seq is the lag reference) and each
follower's exporter with its applied op seq and a heartbeat health
snapshot.

Every serving subsystem measures ONE process. Under multi-host
serving the coordinator runs the API and publishes the op stream, but
the follower hosts — which dispatch every SPMD step, hold their own
slice of HBM, and can fail independently — were observability black
holes: no metrics, no events, no answer to "what was host B doing when
this request stalled". This module closes the process boundary:

  * **TelemetryExporter** (one per non-coordinator process): every
    ``interval_s`` it batches the process's LOCAL telemetry — the full
    obs/metrics registry (structured family export, histograms as
    cumulative buckets), the typed event-bus events published since the
    last frame (cursor-tracked, resent on a failed send), the step
    flight-recorder summary, the follower's last-APPLIED control-op
    seq, and a health snapshot — into one length-prefixed JSON frame
    and ships it over TCP to the coordinator. Same wire discipline as
    JAX's control channel (its serve/control.py): ints/floats/strings only,
    no pickle, and a token-gated hello so a rogue peer on the serving
    network can neither pose as a host nor read another host's frames.

  * **TelemetryCollector** (coordinator side): accepts exporter
    connections, validates the shared token within a bounded window,
    and ingests frames into per-host namespaced views. Every frame
    carries a ``(t_mono, t_wall)`` clock sample from the exporter; the
    collector keeps ``min(rx_wall - t_wall)`` over frames as the
    per-host clock offset (skew + the smallest observed transit time),
    uses the mono sample to DETECT remote wall-clock steps (the
    exporter's ``t_wall - t_mono`` is constant unless NTP stepped its
    clock — a step resets the stale min-offset), and adjusts remote
    event timestamps by the offset on read — so a merged request
    timeline (obs/timeline.py) stays wall-clock-ordered across hosts
    whose clocks disagree. The adjustment is bounded by the tightest
    frame's transit time: sub-transit orderings between hosts are not
    resolvable from this channel (README documents the caveat).

  * The collector feeds three consumer surfaces: ``GET /api/v1/fleet``
    (per-host liveness, last-export age, applied seq + lag vs the
    control server's published seq, device HBM gauges, health state),
    ``GET /api/v1/events?host=`` (a remote host's event stream), and
    ``render_federated()`` — remote metric families appended to the
    coordinator's /metrics exposition with a ``host`` label (families
    the coordinator also owns reuse its HELP/TYPE block; remote-only
    families bring their own).

Cost discipline: the exporter is one daemon thread with a bounded
frame cadence; a dead collector degrades to counted send errors and
reconnects — telemetry must never fail serving. The collector caps the
number of hosts at topology scale (``max_hosts``) so a misbehaving
peer cannot grow per-host state without bound.
"""

from __future__ import annotations

import hmac
import json
import logging
import math
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.obs.metrics import _escape_label_value, _format_value
from cake_tpu_torch.utils import wire as _wire

log = logging.getLogger(__name__)

# shared length-prefix framing (utils/wire.py): ONE copy of
# the wire discipline for the control AND telemetry planes
_LEN = _wire.LEN
_send_frame = _wire.send_msg
FRAME_VERSION = 1
MAX_FRAME_BYTES = 32 << 20   # a full registry dump is ~100s of KB
MAX_HELLO_BYTES = 4096

# -- wire-plane metrics (exporter side) --------------------------------------
_EXPORTED_FRAMES = _m.counter(
    "cake_telemetry_exported_frames_total",
    "Telemetry frames this process shipped to the fleet collector "
    "(obs/federation.py TelemetryExporter)")
_EXPORT_ERRORS = _m.counter(
    "cake_telemetry_export_errors_total",
    "Telemetry frames that failed to ship (collector unreachable or "
    "send error) — the exporter reconnects and resends undelivered "
    "events on the next frame")
_TEL_BYTES = _m.counter(
    "cake_telemetry_bytes_total",
    "Telemetry federation wire bytes incl. the length prefix, by "
    "direction (tx = exporter frames out, rx = collector frames in)",
    labelnames=("dir",))
# -- wire-plane metrics (collector side) -------------------------------------
_INGESTED_FRAMES = _m.counter(
    "cake_telemetry_frames_total",
    "Telemetry frames ingested by the fleet collector, by origin host",
    labelnames=("host",))
_INGEST_LAG = _m.histogram(
    "cake_telemetry_ingest_lag_seconds",
    "Per-frame ingest lag: collector receipt time minus the frame's "
    "clock-offset-corrected build time (transit + queueing on the "
    "telemetry channel)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0))
_FLEET_UP = _m.gauge(
    "cake_fleet_host_up",
    "1 when the host's last telemetry export is within the staleness "
    "window, 0 when it has gone quiet (GET /api/v1/fleet liveness)",
    labelnames=("host",))
_FLEET_AGE = _m.gauge(
    "cake_fleet_last_export_age_seconds",
    "Seconds since the host's last ingested telemetry frame",
    labelnames=("host",))
_FLEET_APPLIED = _m.gauge(
    "cake_fleet_applied_seq",
    "Last control-op seq the host reported as APPLIED in its telemetry "
    "frame (pair with cake_control_follower_lag_ops for the lag)",
    labelnames=("host",))
_FLEET_OFFSET = _m.gauge(
    "cake_fleet_clock_offset_seconds",
    "Estimated per-host wall-clock offset (min over frames of receipt "
    "time minus frame build time: skew + smallest observed transit) — "
    "the correction applied to remote event timestamps before merging "
    "timelines",
    labelnames=("host",))


def dump_registry(registry: Optional[_m.Registry] = None,
                  prefixes: Optional[Tuple[str, ...]] = None
                  ) -> List[Dict]:
    """Structured snapshot of every family in `registry` (default: the
    process-global REGISTRY) — the ``metrics`` section of a telemetry
    frame. `prefixes` optionally restricts to matching family names."""
    reg = registry if registry is not None else _m.REGISTRY
    out: List[Dict] = []
    for fam in reg.families():
        if prefixes and not fam.name.startswith(tuple(prefixes)):
            continue
        try:
            out.append(fam.export())
        except Exception:  # noqa: BLE001 — telemetry must never raise
            log.debug("family export failed: %s", fam.name,
                      exc_info=True)
    return out


class TelemetryExporter:
    """Non-coordinator side: ship this process's telemetry to the
    coordinator's TelemetryCollector as periodic JSON frames.

    address: "host:port" of the collector. host: this process's fleet
    id (proc1, ...). token: the shared control-channel secret (the
    collector rejects hellos without it). All content callables are
    best-effort — a raising supplier drops its section from the frame,
    never the frame. ``clock``/``mono`` are injectable for tests that
    simulate clock skew; the clock MUST be the same source the event
    bus stamps its events with, or the collector's offset correction
    would corrupt remote event ordering instead of fixing it."""

    # the event bus is optional (an engine-less follower exports
    # metrics/health only)
    OPTIONAL_PLANES = ("_events",)

    def __init__(self, address: str, host: str,
                 token: Optional[str] = None,
                 interval_s: float = 2.0, *,
                 registry: Optional[_m.Registry] = None,
                 metric_prefixes: Optional[Tuple[str, ...]] = None,
                 events=None, flight=None,
                 applied_seq: Optional[Callable[[], int]] = None,
                 health_snapshot: Optional[Callable[[], Dict]] = None,
                 clock: Callable[[], float] = time.time,
                 mono: Callable[[], float] = time.monotonic,
                 connect_timeout_s: float = 30.0,
                 start: bool = True):
        peer_host, port = address.rsplit(":", 1)
        self._addr = (peer_host, int(port))
        self.host = str(host)
        self._token = token
        self._interval = max(0.01, float(interval_s))
        self._registry = registry
        self._prefixes = tuple(metric_prefixes) if metric_prefixes \
            else None
        self._events = events
        self._events_cursor = 0
        self._flight = flight
        self._applied = applied_seq
        self._health = health_snapshot
        self._clock = clock
        self._mono = mono
        self._connect_timeout = connect_timeout_s
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._frame = 0
        self.frames_sent = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> "TelemetryExporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"cake-telemetry-{self.host}")
            self._thread.start()
        return self

    # -- wire ---------------------------------------------------------------

    def _connect(self, timeout_s: Optional[float] = None,
                 ignore_stop: bool = False) -> bool:
        budget = (self._connect_timeout if timeout_s is None
                  else timeout_s)
        t0 = time.monotonic()
        last: Optional[Exception] = None
        while (time.monotonic() - t0 < budget
               and (ignore_stop or not self._stop.is_set())):
            try:
                s = socket.create_connection(self._addr, timeout=10.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hello = json.dumps({
                    "v": FRAME_VERSION, "host": self.host,
                    "token": self._token or "",
                }).encode()
                _send_frame(s, hello)
                self._sock = s
                return True
            except OSError as e:
                last = e
                self._stop.wait(0.2)
        log.warning("telemetry exporter %s: collector unreachable at "
                    "%s:%s (%s)", self.host, *self._addr, last)
        return False

    def _call(self, fn):
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — drop the section, not the frame
            log.debug("telemetry supplier failed", exc_info=True)
            return None

    def _build_frame(self) -> Tuple[Dict, int]:
        """(frame, post-send events cursor). The cursor only advances
        after a SUCCESSFUL send, so events are resent, not dropped,
        across a collector blip."""
        evs: List[Dict] = []
        cursor = self._events_cursor
        if self._events is not None:
            try:
                evs, cursor = self._events.snapshot(
                    since=self._events_cursor)
            except Exception:  # noqa: BLE001
                log.debug("event snapshot failed", exc_info=True)
        try:
            # scrape-fresh device HBM gauges ride the registry dump, so
            # the coordinator's fleet view shows real follower memory
            from cake_tpu_torch.obs.steps import refresh_device_gauges
            refresh_device_gauges()
        except Exception:  # noqa: BLE001
            pass
        frame = {
            "v": FRAME_VERSION,
            "host": self.host,
            "frame": self._frame + 1,
            "t_mono": self._mono(),
            "t_wall": self._clock(),
            "applied_seq": self._call(self._applied),
            "events": evs,
            "metrics": dump_registry(self._registry, self._prefixes),
            "steps": (self._flight.summary()
                      if self._flight is not None else None),
            "health": self._call(self._health),
        }
        return frame, cursor

    def flush(self, connect_timeout_s: Optional[float] = None,
              _ignore_stop: bool = False) -> bool:
        """Build and ship one frame NOW (synchronous; also the body of
        the periodic thread). False = the frame did not go out (the
        events cursor is kept, so nothing is lost)."""
        with self._send_lock:
            if self._sock is None and not self._connect(
                    connect_timeout_s, ignore_stop=_ignore_stop):
                _EXPORT_ERRORS.inc()
                return False
            frame, cursor = self._build_frame()
            payload = json.dumps(frame).encode()
            try:
                _send_frame(self._sock, payload)
            except OSError:
                _EXPORT_ERRORS.inc()
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                return False
            self._frame += 1
            self.frames_sent += 1
            self._events_cursor = cursor
            _EXPORTED_FRAMES.inc()
            _TEL_BYTES.labels(dir="tx").inc(_LEN.size + len(payload))
            return True

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("telemetry flush failed")

    def close(self, flush: bool = True) -> None:
        """Stop the export thread; by default ship one final frame so
        the collector sees the terminal applied seq (lag drains to 0
        on a clean shutdown). _stop is set FIRST: an in-flight
        periodic flush stuck in its connect-retry loop exits within
        one retry step instead of holding _send_lock for the full
        connect budget, and the terminal flush itself runs under a
        short bounded budget — teardown of a follower whose
        coordinator is already gone must not stall for a minute."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if flush:
            try:
                self.flush(connect_timeout_s=2.0, _ignore_stop=True)
            except Exception:  # noqa: BLE001
                pass
        with self._send_lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


class _HostView:
    """One exporter host's namespaced state on the collector."""

    __slots__ = ("host", "frames", "last_rx_mono", "last_rx_wall",
                 "offset", "wall_minus_mono", "applied_seq", "metrics",
                 "steps", "health", "events", "lags", "peer")

    def __init__(self, host: str, event_ring: int, peer: str):
        self.host = host
        self.frames = 0
        self.last_rx_mono = 0.0
        self.last_rx_wall = 0.0
        self.offset: Optional[float] = None
        # exporter-side (t_wall - t_mono): constant for a given remote
        # process unless its WALL clock steps (NTP) — the step detector
        # that invalidates a stale min-offset
        self.wall_minus_mono: Optional[float] = None
        self.applied_seq: Optional[int] = None
        self.metrics: List[Dict] = []
        self.steps: Optional[Dict] = None
        self.health: Optional[Dict] = None
        self.events: deque = deque(maxlen=max(1, int(event_ring)))
        self.lags: deque = deque(maxlen=512)
        self.peer = peer


class TelemetryCollector:
    """Coordinator side: accept exporter connections (token-gated, the
    ControlServer hello discipline: bounded hello size AND wall time),
    ingest frames into per-host views, and serve them to the fleet API
    + federated /metrics + cross-host timelines.

    control: an attached serve.control.ControlServer — applied seqs
    from telemetry frames feed its note_ack (the per-follower lag
    gauge + post-mortem acks), and its published_seq is the lag
    reference in fleet()."""

    def __init__(self, host: str = "", port: int = 0,
                 token: Optional[str] = None, *,
                 control=None, local_host: str = "proc0",
                 stale_after_s: float = 10.0, event_ring: int = 2048,
                 max_hosts: int = 64, hello_timeout_s: float = 10.0):
        self.token = token
        self._control = control
        self.local_host = local_host
        self._stale_after = float(stale_after_s)
        self._event_ring = int(event_ring)
        self._max_hosts = int(max_hosts)
        self._hello_timeout = float(hello_timeout_s)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
            self._sock.listen(8)
        except OSError:
            self._sock.close()
            raise
        self._sock.settimeout(0.5)
        self._lock = threading.Lock()
        self._views: Dict[str, _HostView] = {}
        self._conns: List[socket.socket] = []
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._serve, daemon=True,
            name="cake-telemetry-collector")
        self._accept_thread.start()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    # -- accept/ingest ------------------------------------------------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return   # closed
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._handle_conn, args=(conn, peer),
                daemon=True, name="cake-telemetry-conn").start()

    def _handle_conn(self, conn: socket.socket, peer) -> None:
        """_handle plus guaranteed cleanup: whatever path the handler
        exits through (rejected hello, EOF, oversized frame), the
        socket is closed AND removed from _conns — a flaky exporter
        reconnecting every few seconds must not grow the list for the
        life of the process."""
        try:
            self._handle(conn, peer)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _recv_hello(self, conn: socket.socket) -> Optional[Dict]:
        """Bounded hello read (utils/wire.py: size-capped —
        an attacker-controlled multi-GiB length must not allocate —
        and deadline-capped — byte trickling must not hold a handler
        thread hostage)."""
        payload = _wire.recv_bounded_msg(
            conn, MAX_HELLO_BYTES,
            time.monotonic() + self._hello_timeout)
        if payload is None:
            return None
        try:
            hello = json.loads(payload)
        except ValueError:
            return None
        return hello if isinstance(hello, dict) else None

    def _handle(self, conn: socket.socket, peer) -> None:
        peer_s = "%s:%s" % peer[:2]
        hello = self._recv_hello(conn)
        host = str(hello.get("host") or "") if hello else ""
        if hello is None or not host or (
                self.token is not None and not hmac.compare_digest(
                    str(hello.get("token", "")).encode(),
                    self.token.encode())):
            log.warning("telemetry: rejected exporter %s (bad hello/"
                        "token)", peer_s)
            conn.close()
            return
        with self._lock:
            if host not in self._views:
                if len(self._views) >= self._max_hosts:
                    # topology-sized cap: per-host state (views, host-
                    # labeled series) must not grow unboundedly from a
                    # misbehaving peer inventing host names
                    log.warning(
                        "telemetry: rejecting host %r from %s — "
                        "max_hosts=%d reached", host, peer_s,
                        self._max_hosts)
                    conn.close()
                    return
                self._views[host] = _HostView(host, self._event_ring,
                                              peer_s)
            else:
                self._views[host].peer = peer_s
        log.info("telemetry: exporter %r connected from %s", host,
                 peer_s)
        conn.settimeout(1.0)
        rbuf = b""
        while not self._stop.is_set():
            try:
                part = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not part:
                break
            rbuf += part
            while len(rbuf) >= _LEN.size:
                (n,) = _LEN.unpack(rbuf[:_LEN.size])
                if n > MAX_FRAME_BYTES:
                    log.error("telemetry: oversized frame (%d bytes) "
                              "from %r; disconnecting", n, host)
                    conn.close()
                    return
                if len(rbuf) < _LEN.size + n:
                    break
                payload = rbuf[_LEN.size:_LEN.size + n]
                rbuf = rbuf[_LEN.size + n:]
                try:
                    self._ingest(host, payload)
                except Exception:  # noqa: BLE001 — one bad frame must
                    log.exception("telemetry ingest failed")  # not kill
        conn.close()
        log.info("telemetry: exporter %r disconnected", host)

    def _ingest(self, host: str, payload: bytes) -> None:
        rx_wall = time.time()
        rx_mono = time.monotonic()
        try:
            frame = json.loads(payload)
        except ValueError:
            log.warning("telemetry: unparseable frame from %r", host)
            return
        if not isinstance(frame, dict):
            return
        t_wall = frame.get("t_wall")
        applied = frame.get("applied_seq")
        with self._lock:
            view = self._views[host]
            view.frames += 1
            view.last_rx_mono = rx_mono
            view.last_rx_wall = rx_wall
            t_mono = frame.get("t_mono")
            if isinstance(t_wall, (int, float)):
                if isinstance(t_mono, (int, float)):
                    # (t_wall - t_mono) is constant for the remote
                    # process unless its wall clock STEPPED (NTP): on
                    # a >1s step, discard the stale min-offset so the
                    # estimate re-converges on the new epoch instead
                    # of pinning every future event to the old one
                    wmm = float(t_wall) - float(t_mono)
                    if (view.wall_minus_mono is not None
                            and abs(wmm - view.wall_minus_mono) > 1.0):
                        log.warning(
                            "telemetry: host %r wall clock stepped by "
                            "%.1fs; resetting its clock offset", host,
                            wmm - view.wall_minus_mono)
                        view.offset = None
                    view.wall_minus_mono = wmm
                delta = rx_wall - float(t_wall)
                # min over frames = skew + the smallest observed
                # transit: the tightest offset bound this channel can
                # produce (see the module docstring's caveat)
                view.offset = (delta if view.offset is None
                               else min(view.offset, delta))
            if isinstance(applied, int):
                view.applied_seq = applied
            if isinstance(frame.get("metrics"), list):
                view.metrics = frame["metrics"]
            if isinstance(frame.get("steps"), dict):
                view.steps = frame["steps"]
            if isinstance(frame.get("health"), dict):
                view.health = frame["health"]
            for ev in frame.get("events") or ():
                if isinstance(ev, dict):
                    view.events.append(dict(ev))
            offset = view.offset or 0.0
        _INGESTED_FRAMES.labels(host=host).inc()
        _TEL_BYTES.labels(dir="rx").inc(_LEN.size + len(payload))
        if isinstance(t_wall, (int, float)):
            lag = max(0.0, rx_wall - (float(t_wall) + offset))
            _INGEST_LAG.observe(lag)
            view.lags.append(lag)
            _FLEET_OFFSET.labels(host=host).set(round(offset, 6))
        if isinstance(applied, int):
            _FLEET_APPLIED.labels(host=host).set(applied)
            if self._control is not None:
                try:
                    self._control.note_ack(host, applied)
                except Exception:  # noqa: BLE001
                    log.debug("note_ack failed", exc_info=True)

    # -- read surfaces ------------------------------------------------------

    def hosts(self) -> List[str]:
        with self._lock:
            return sorted(self._views)

    def ingest_lags(self, host: str) -> List[float]:
        """Recent per-frame ingest lags (seconds) for one host — the
        bench tier's p50/p99 source."""
        with self._lock:
            view = self._views.get(host)
            return list(view.lags) if view is not None else []

    def events_for(self, rid: Optional[int] = None,
                   host: Optional[str] = None,
                   type: Optional[str] = None,
                   since: Optional[int] = None,
                   limit: Optional[int] = None) -> List[Dict]:
        """Collector-held remote events, each tagged with its origin
        ``host`` and its ``ts`` corrected by that host's clock offset,
        merged in corrected wall-clock order. Filters: rid/type exact,
        host exact, since = strictly-greater per-host seq."""
        with self._lock:
            views = ([self._views[host]] if host in self._views
                     else [] if host is not None
                     else list(self._views.values()))
            items = [(v.host, v.offset or 0.0, list(v.events))
                     for v in views]
        out: List[Dict] = []
        for hname, off, evs in items:
            for ev in evs:
                if rid is not None and ev.get("rid") != rid:
                    continue
                if type is not None and ev.get("type") != type:
                    continue
                if since is not None and (ev.get("seq") or 0) <= since:
                    continue
                e = dict(ev)
                e["host"] = hname
                if isinstance(e.get("ts"), (int, float)):
                    e["ts"] = round(float(e["ts"]) + off, 6)
                out.append(e)
        out.sort(key=lambda e: (e.get("ts") or 0.0, e.get("seq") or 0))
        if limit is not None:
            out = out[:max(0, int(limit))]
        return out

    def events_page(self, host: str, rid: Optional[int] = None,
                    type: Optional[str] = None,
                    since: Optional[int] = None,
                    limit: Optional[int] = None):
        """(events, cursor) for ONE host's stream under the local
        EventBus.snapshot contract (obs/events.py): limit keeps the
        FIRST n matches — the page right after `since` — and a
        truncated page's cursor is the last RETURNED seq, so a
        ?since=cursor poll resumes where the page ended instead of
        skipping the truncated remainder forever; an un-truncated
        page's cursor is the host's newest held seq. The cursor-
        pagination invariant lives HERE, next to the data, not in the
        API layer."""
        evs = self.events_for(rid=rid, type=type, host=host,
                              since=since)
        truncated = limit is not None and len(evs) > max(0, int(limit))
        if limit is not None:
            evs = evs[:max(0, int(limit))]
        if not truncated:
            cursor = self.host_cursor(host)
        elif evs:
            cursor = max(e.get("seq") or 0 for e in evs)
        else:                      # limit=0: no progress was made
            cursor = since if since is not None else 0
        return evs, cursor

    def host_cursor(self, host: str) -> int:
        """Newest event seq held for `host` (0 = none) — the ?host=
        events endpoint's response cursor."""
        with self._lock:
            view = self._views.get(host)
            if view is None or not view.events:
                return 0
            return max((ev.get("seq") or 0) for ev in view.events)

    def published_seq(self) -> Optional[int]:
        if self._control is None:
            return None
        try:
            return self._control.published_seq
        except Exception:  # noqa: BLE001
            return None

    @staticmethod
    def _hbm_from_metrics(metrics: List[Dict]) -> Dict[str, Dict]:
        """Per-device HBM gauge values lifted out of a host's shipped
        metric dump — the fleet view's memory column."""
        fields = {
            "cake_device_hbm_bytes_in_use": "bytes_in_use",
            "cake_device_hbm_peak_bytes": "peak_bytes",
            "cake_device_hbm_bytes_limit": "bytes_limit",
        }
        out: Dict[str, Dict] = {}
        for fam in metrics:
            key = fields.get(fam.get("name"))
            if key is None:
                continue
            try:
                idx = list(fam.get("labels") or ()).index("device")
            except ValueError:
                continue
            for values, v in fam.get("samples") or ():
                dev = str(values[idx])
                out.setdefault(dev, {})[key] = v
        return out

    def refresh_gauges(self) -> None:
        """Scrape-time refresh of the per-host liveness/age gauges
        (api/server.py calls this before rendering /metrics)."""
        now = time.monotonic()
        with self._lock:
            views = list(self._views.values())
        for v in views:
            age = now - v.last_rx_mono if v.frames else float("inf")
            _FLEET_UP.labels(host=v.host).set(
                1 if age < self._stale_after else 0)
            if math.isfinite(age):
                _FLEET_AGE.labels(host=v.host).set(round(age, 3))

    def fleet(self) -> Dict:
        """The GET /api/v1/fleet body's remote half: per-host liveness,
        export age, applied seq + lag, clock offset, ingest lag, HBM
        gauges, health and step summaries."""
        self.refresh_gauges()
        now = time.monotonic()
        pub = self.published_seq()
        hosts: Dict[str, Dict] = {}
        with self._lock:
            views = list(self._views.values())
        for v in views:
            age = now - v.last_rx_mono if v.frames else None
            lag = None
            if pub is not None and isinstance(v.applied_seq, int):
                lag = max(0, pub - v.applied_seq)
            lags = sorted(v.lags)
            entry = {
                "role": "exporter",
                "peer": v.peer,
                "live": (age is not None
                         and age < self._stale_after),
                "frames": v.frames,
                "last_export_age_s": (round(age, 3)
                                      if age is not None else None),
                "applied_seq": v.applied_seq,
                "lag_ops": lag,
                "clock_offset_s": (round(v.offset, 6)
                                   if v.offset is not None else None),
                "events_held": len(v.events),
                "hbm": self._hbm_from_metrics(v.metrics),
            }
            if lags:
                entry["ingest_lag_p50_ms"] = round(
                    lags[len(lags) // 2] * 1e3, 3)
                entry["ingest_lag_p99_ms"] = round(
                    lags[min(len(lags) - 1,
                             int(len(lags) * 0.99))] * 1e3, 3)
            if v.health is not None:
                entry["health"] = v.health
            if v.steps is not None:
                entry["steps"] = {
                    k: v.steps.get(k)
                    for k in ("recorded_steps", "impl", "mfu",
                              "hbm_util") if k in v.steps}
            hosts[v.host] = entry
        return {"published_seq": pub,
                "stale_after_s": self._stale_after,
                "hosts": hosts}

    # -- federated /metrics --------------------------------------------------

    def render_federated(self, local_families=()) -> str:
        """Remote hosts' metric families as exposition text with a
        ``host`` label on every sample, appended after the local
        render. Families the coordinator also exposes locally reuse
        the local HELP/TYPE block (emitting a second one would be a
        duplicate-family violation); remote-only families bring their
        own. Returns "" when nothing is held."""
        local = set(local_families)
        # family name -> (type, help, [(host, fam_dict)]) — grouped so
        # a family exported by several hosts gets ONE HELP/TYPE block
        fams: Dict[str, List] = {}
        with self._lock:
            views = sorted(self._views.values(), key=lambda v: v.host)
            per_host = [(v.host, list(v.metrics)) for v in views]
        for hname, metrics in per_host:
            for fam in metrics:
                name = fam.get("name")
                typ = fam.get("type")
                if (not isinstance(name, str)
                        or not _m._NAME_RE.match(name)
                        or typ not in ("counter", "gauge", "histogram",
                                       "untyped")):
                    continue
                fams.setdefault(name, [typ, str(fam.get("help") or
                                                name), []])
                if fams[name][0] != typ:
                    # two hosts disagreeing on a family's type cannot
                    # be rendered under one TYPE line; keep the first
                    continue
                fams[name][2].append((hname, fam))
        lines: List[str] = []
        for name in sorted(fams):
            typ, help_, rows = fams[name]
            if name not in local:
                lines.append("# HELP %s %s"
                             % (name, help_.replace("\n", " ")))
                lines.append(f"# TYPE {name} {typ}")
            for hname, fam in rows:
                labels = [str(x) for x in (fam.get("labels") or ())]
                if typ == "histogram":
                    for child in fam.get("hist") or ():
                        self._render_hist(lines, name, labels, hname,
                                          child)
                else:
                    for values, v in fam.get("samples") or ():
                        suffix = self._suffix(labels, values, hname)
                        if isinstance(v, (int, float)):
                            lines.append(
                                f"{name}{suffix} {_format_value(v)}")
        return "\n".join(lines) + "\n" if lines else ""

    @staticmethod
    def _suffix(labels: List[str], values, host: str,
                extra: Tuple = ()) -> str:
        pairs = list(zip(labels, [str(v) for v in values]))
        pairs.append(("host", host))
        pairs.extend(extra)
        body = ",".join('%s="%s"' % (k, _escape_label_value(v))
                        for k, v in pairs)
        return "{" + body + "}"

    @classmethod
    def _render_hist(cls, lines: List[str], name: str,
                     labels: List[str], host: str,
                     child: Dict) -> None:
        """One histogram child as bucket/sum/count lines. A child with
        any malformed piece is dropped WHOLE — a partial bucket series
        (no +Inf, no _sum) would fail the exposition lint."""
        values = child.get("values") or ()
        buckets = child.get("buckets") or ()
        s, n = child.get("sum"), child.get("count")
        if not buckets or not (isinstance(s, (int, float))
                               and isinstance(n, (int, float))):
            return
        out: List[str] = []
        for pair in buckets:
            try:
                le, cum = pair
            except (TypeError, ValueError):
                return
            if not isinstance(cum, (int, float)):
                return
            suffix = cls._suffix(
                labels, values, host,
                extra=(("le", _format_value(
                    float(le) if le is not None else math.inf)),))
            out.append(f"{name}_bucket{suffix} {_format_value(cum)}")
        base = cls._suffix(labels, values, host)
        out.append(f"{name}_sum{base} {_format_value(s)}")
        out.append(f"{name}_count{base} {_format_value(n)}")
        lines.extend(out)

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5.0)
