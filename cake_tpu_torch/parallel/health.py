"""Failure detection: device probes, heartbeats, progress watchdog.

Counterpart of `cake_tpu/parallel/health.py`, copied with its wire
format (a heartbeat is `name\\n`, acked with one byte), its metric
families and its failure reasons, so a dashboard or an operator reads
the same words from both packages:

  * `probe_devices(timeout_s)` runs a tiny computation on every local
    card (or the CPU) from a watchdog thread; a hung device, which
    blocks rather than raises, is reported wedged instead of hanging
    the caller.
  * `HeartbeatMonitor` / `HeartbeatSender`: the coordinator's liveness
    tracking of the follower processes over plain TCP (a stale
    heartbeat fails serving before the next cross-process hop blocks
    on the dead process).
  * `Watchdog`: polls a counter (`engine.stats.tokens_generated`) and
    fires a callback when it stops advancing with requests active.
  * `ServingHealth` composes them around a live engine: the API's 503
    gate, `cake_serving_healthy`, the reason in `/api/v1/health` and
    the fleet's local `live` read it. `api/server.start` always arms one
    over an engine; multi-process serving adds the heartbeat monitor.

Everything runs in daemon threads and needs no card; the tests drive it
on localhost and the CPU.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from cake_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

# stall detections are rare and load-bearing (each one failed every
# in-flight request): a counter so dashboards see them without log
# spelunking
_WATCHDOG_STALLS = obs_metrics.counter(
    "cake_watchdog_stalls_total",
    "Progress-watchdog stall detections (engine stopped advancing "
    "with active requests)")

# reconnect storms are the classic monitor-restart failure mode; the
# counter makes a flapping heartbeat channel visible per worker
_HEARTBEAT_RECONNECTS = obs_metrics.counter(
    "cake_heartbeat_reconnects_total",
    "Heartbeat-sender reconnection attempts after a lost or refused "
    "monitor connection, by worker",
    labelnames=("worker",))

# wire latency of the liveness plane itself: the monitor acks each
# beat with one byte, and the sender times send->ack. A rising RTT is
# the early signal of a congested/flaky coordinator link — before the
# staleness gauge trips anything
_HEARTBEAT_RTT = obs_metrics.histogram(
    "cake_heartbeat_rtt_seconds",
    "Heartbeat round-trip time (send 'name\\n' -> monitor ack byte), "
    "by worker — wire latency of the coordinator liveness channel",
    labelnames=("worker",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5))


# -- device probe ------------------------------------------------------------

@dataclass
class DeviceProbe:
    device: str
    ok: bool
    latency_s: float
    error: Optional[str] = None


def probe_devices(timeout_s: float = 30.0, devices=None) -> List[DeviceProbe]:
    """Health-check local devices with a wall-clock timeout each.

    A tiny computation is dispatched from a worker thread and read back
    (which waits for the device); if it neither completes nor raises
    within timeout_s the device is reported wedged (ok=False,
    error='timeout') and the caller does not hang on it. devices: torch
    devices or their names (default every visible card, else the
    CPU)."""
    import torch

    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    out: List[DeviceProbe] = []
    for dev in devices:
        dev = torch.device(dev)
        result: Dict = {}

        def work(dev=dev, result=result):
            try:
                t0 = time.perf_counter()
                x = torch.arange(8, dtype=torch.float32, device=dev)
                float((x * 2).sum())  # waits until the device answers
                result["latency"] = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 — report, don't raise
                result["error"] = f"{type(e).__name__}: {e}"

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            out.append(DeviceProbe(str(dev), False, timeout_s,
                                   error="timeout"))
        elif "error" in result:
            out.append(DeviceProbe(str(dev), False, 0.0, result["error"]))
        else:
            out.append(DeviceProbe(str(dev), True, result["latency"]))
    return out


# -- heartbeats --------------------------------------------------------------

class HeartbeatMonitor:
    """Coordinator-side liveness tracker.

    Workers connect over TCP and send `name\\n` lines periodically; the
    monitor records last-seen times. `stale(threshold_s)` lists workers
    whose heartbeat lapsed; `on_failure`, if set, fires once per worker
    when it first goes stale (checked by a background sweeper).
    """

    def __init__(self, address: str = "127.0.0.1:0",
                 on_failure: Optional[Callable[[str], None]] = None,
                 stale_after_s: float = 10.0, sweep_interval_s: float = 1.0,
                 expected: Optional[List[str]] = None):
        host, port = address.rsplit(":", 1)
        self.last_seen: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._failed: set = set()
        self._on_failure = on_failure
        self._stale_after = stale_after_s
        monitor = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    name = line.decode("utf-8", "replace").strip()
                    if name:
                        monitor.beat(name)
                        try:
                            # one-byte ack: the sender times send->ack
                            # into cake_heartbeat_rtt_seconds; a peer
                            # that never reads it just buffers a byte
                            self.wfile.write(b"\x06")
                            self.wfile.flush()
                        except OSError:
                            return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, int(port)), Handler)
        self.address = "%s:%d" % self._server.server_address[:2]
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="cake-heartbeat-server")
        self._serve_thread.start()
        self._stop = threading.Event()
        self._sweeper = threading.Thread(
            target=self._sweep, args=(sweep_interval_s,), daemon=True,
            name="cake-heartbeat-sweeper")
        self._sweeper.start()

        if expected:
            self.expect(*expected)

    def expect(self, *names: str) -> None:
        """Register workers that MUST beat. Registration starts the stale
        clock, so a worker that dies before its first heartbeat is reported
        after stale_after_s instead of staying invisible (a monitor that
        only tracks seen workers cannot detect a never-started one —
        precisely the failure the subsystem exists for)."""
        now = time.monotonic()
        with self._lock:
            for name in names:
                self.last_seen.setdefault(name, now)

    def beat(self, name: str) -> None:
        with self._lock:
            self.last_seen[name] = time.monotonic()
            self._failed.discard(name)

    def stale(self, threshold_s: Optional[float] = None) -> List[str]:
        thr = threshold_s if threshold_s is not None else self._stale_after
        now = time.monotonic()
        with self._lock:
            return [n for n, t in self.last_seen.items() if now - t > thr]

    def staleness(self) -> Dict[str, float]:
        """Seconds since each tracked worker's last heartbeat (the
        /metrics staleness gauge's source)."""
        now = time.monotonic()
        with self._lock:
            return {n: now - t for n, t in self.last_seen.items()}

    def _sweep(self, interval: float) -> None:
        while not self._stop.wait(interval):
            for name in self.stale():
                with self._lock:
                    first = name not in self._failed
                    self._failed.add(name)
                if first:
                    log.warning("heartbeat lost: %s", name)
                    if self._on_failure is not None:
                        try:
                            self._on_failure(name)
                        except Exception:  # noqa: BLE001
                            log.exception("on_failure callback failed")

    def close(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()


class HeartbeatSender:
    """Worker-side pinger: connects to the monitor and sends `name\\n`
    every interval_s from a daemon thread until close().

    CONNECT_TIMEOUT_S bounds each (re)dial; worst_case_gap_s budgets
    it, so raising one without the other cannot silently shrink the
    follower liveness window below the sender's real quiet gap.

    Reconnects back off exponentially (capped, with seeded per-worker
    jitter): a restarted monitor on a large fleet used to get every
    sender re-dialing in interval_s lockstep — a thundering herd right
    when the coordinator is busiest coming back. The jitter stream is
    seeded from the worker name, so a chaos run's reconnect schedule
    is reproducible."""

    CONNECT_TIMEOUT_S = 5.0

    def __init__(self, address: str, name: str, interval_s: float = 2.0,
                 max_backoff_s: float = 30.0):
        import random as _random

        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._name = name
        self._interval = interval_s
        self._max_backoff = max_backoff_s
        self._failures = 0        # consecutive connect/send failures
        self.reconnects = 0       # lifetime reconnect attempts
        # deterministic per-worker jitter: same worker name -> same
        # desynchronization offsets, run after run
        self._rng = _random.Random(
            int.from_bytes(name.encode()[:8].ljust(8, b"\0"), "big"))
        # monotonic time of the last SUCCESSFUL send — the follower
        # liveness probe (engine.run_follower_loop) reads it: the
        # monitor lives in the coordinator process, so a recent
        # successful send proves the peer is up
        self._last_ok: float = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"cake-heartbeat-{name}")
        self._thread.start()

    def alive_within(self, threshold_s: float) -> bool:
        """True when a heartbeat send succeeded within threshold_s —
        evidence the monitor (and so the coordinator process hosting
        it) is alive."""
        return (self._last_ok > 0
                and time.monotonic() - self._last_ok < threshold_s)

    @property
    def worst_case_gap_s(self) -> float:
        """Upper bound on the quiet gap between SUCCESSFUL sends while
        the monitor stays reachable: one send interval, plus a full
        backoff sleep at the cap with its 1.5x jitter, plus one
        connect timeout. A liveness threshold below this misreads a
        sender mid-backoff (monitor blipped, already back) as a dead
        coordinator."""
        return (self._interval + 1.5 * self._max_backoff
                + self.CONNECT_TIMEOUT_S)

    def _run(self) -> None:
        sock = None
        while not self._stop.is_set():
            try:
                if sock is None:
                    if self._failures:
                        self.reconnects += 1
                        _HEARTBEAT_RECONNECTS.labels(
                            worker=self._name).inc()
                    sock = socket.create_connection(
                        self._addr, timeout=self.CONNECT_TIMEOUT_S)
                t_beat = time.perf_counter()
                sock.sendall(f"{self._name}\n".encode())
                try:
                    # read the monitor's one-byte ack and observe the
                    # RTT. A timeout (busy monitor, or one predating
                    # the ack) is NOT a failure — the send succeeded,
                    # we only lose this sample. A late ack read by the
                    # NEXT beat shortens that sample; acceptable noise
                    # for a wire-latency trend signal.
                    sock.settimeout(min(2.0, self._interval))
                    ack = sock.recv(64)
                    if not ack:
                        raise OSError("heartbeat monitor closed")
                    _HEARTBEAT_RTT.labels(worker=self._name).observe(
                        time.perf_counter() - t_beat)
                except socket.timeout:
                    pass
                finally:
                    sock.settimeout(self.CONNECT_TIMEOUT_S)
                self._failures = 0
                self._last_ok = time.monotonic()
                self._stop.wait(self._interval)
            except OSError:
                if sock is not None:
                    sock.close()
                    sock = None
                self._failures += 1
                # capped exponential backoff + jitter: spread the
                # fleet's re-dials instead of stampeding the monitor
                delay = min(self._max_backoff,
                            self._interval * (2.0 ** (self._failures - 1)))
                delay *= 0.5 + self._rng.random()   # 0.5x..1.5x
                self._stop.wait(delay)
        if sock is not None:
            sock.close()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


# -- serving glue ------------------------------------------------------------

class ServingHealth:
    """Failure detection wired into the serving path.

    Composes the detectors around a live engine so a failure actually
    does something: the API flips /api/v1/health to "failed", new chat
    requests get 503s (api/server.py gates on `failed`), and every
    in-flight request is failed immediately instead of hanging its
    client until timeout.

      * a Watchdog on tokens_generated fires when the engine stops
        making progress with active requests (wedged device, dead host
        blocking a collective);
      * `expect_workers()` (multi-host serving) starts a
        HeartbeatMonitor over the follower hosts — a lapsed heartbeat
        fails serving before the next collective deadlocks on the dead
        host (cli._serve_multihost wires the followers' senders).
    """

    def __init__(self, engine, stall_after_s: float = 600.0):
        self.engine = engine
        self.reason: Optional[str] = None
        self._lock = threading.Lock()
        self._recoverable = False
        self._failed_at_tokens = 0
        self.monitor: Optional[HeartbeatMonitor] = None
        # device/page gauge refresh rides the watchdog's poll (the
        # "existing heartbeat"), rate-limited so memory_stats isn't
        # called every 0.5s
        self._gauges_at = 0.0
        self._gauge_interval_s = 5.0
        # tokens_generated advances on prefill first-tokens too, so a
        # long prefill is not a false stall; stall_after_s must exceed
        # worst-case first-request capture time (configurable via
        # --stall-timeout; a too-small value + a long capture would
        # false-fail, which is why stall failures self-recover below)
        self._watchdog = Watchdog(
            self._progress_counter,
            stall_after_s,
            on_stall=self._on_stall,
            active=lambda: engine.active > 0,
        )
        self._stall_after = stall_after_s

    def _on_stall(self) -> None:
        _WATCHDOG_STALLS.inc()
        self.fail(
            f"engine made no progress for {self._stall_after:.0f}s "
            "with active requests", recoverable=True)

    def observe_metrics(self) -> None:
        """Sync health state into the metrics registry — called by
        ApiServer.metrics() at scrape time, so the staleness gauge
        reflects the instant of the scrape (not the last sweep)."""
        if self.monitor is not None:
            g = obs_metrics.gauge(
                "cake_heartbeat_staleness_seconds",
                "Seconds since each worker's last heartbeat",
                labelnames=("worker",))
            for name, age in self.monitor.staleness().items():
                g.labels(worker=name).set(round(age, 3))
        self._refresh_gauges(force=True)

    def _refresh_gauges(self, force: bool = False) -> None:
        """Per-device HBM gauges (obs/steps.py; no-op on CPU) and
        page-pool occupancy, refreshed on the watchdog heartbeat so
        dashboards fed only by --step-log / pushed expositions stay
        current without scrapes. force=True (scrape time) bypasses the
        rate limit."""
        now = time.monotonic()
        if not force and now - self._gauges_at < self._gauge_interval_s:
            return
        self._gauges_at = now
        try:
            from cake_tpu_torch.obs import steps as obs_steps
            obs_steps.refresh_device_gauges()
            obs_steps.refresh_page_gauges(self.engine)
        except Exception:  # noqa: BLE001 — telemetry must never fail health
            log.debug("device gauge refresh failed", exc_info=True)

    def _progress_counter(self) -> int:
        """Watchdog counter; doubles as the recovery probe: a stall
        failure (recoverable) clears itself the moment tokens flow again
        — e.g. a false positive from a long first capture must not
        brick an otherwise healthy server. Heartbeat failures (a dead
        host) never self-clear."""
        self._refresh_gauges()
        v = self.engine.stats.tokens_generated
        with self._lock:
            if (self.reason is not None and self._recoverable
                    and v != self._failed_at_tokens):
                log.warning("serving health: RECOVERED (progress resumed "
                            "after: %s)", self.reason)
                self.reason = None
        return v

    @property
    def failed(self) -> bool:
        return self.reason is not None

    def expect_workers(self, names: List[str], bind_host: str = "",
                       stale_after_s: float = 15.0) -> str:
        """Start heartbeat monitoring for worker hosts that MUST stay
        alive. Returns the monitor's bound address for distribution to
        the workers (cli broadcasts it on the control handshake)."""
        self.monitor = HeartbeatMonitor(
            address=f"{bind_host}:0",
            on_failure=lambda n: self.fail(f"worker {n} heartbeat lost"),
            stale_after_s=stale_after_s,
            expected=list(names),
        )
        return self.monitor.address

    def fail(self, reason: str, recoverable: bool = False) -> None:
        """Idempotent: first failure wins; later detections are logged
        only. Fails every in-flight engine request so clients see an
        error now, not a timeout. (The engine thread may be wedged in a
        collective — _fail_all from this thread releases the waiters;
        request teardown races are benign because _emit re-checks
        _slot_req identity.) recoverable: the condition can clear itself
        when progress resumes (watchdog stalls); non-recoverable
        failures (dead hosts) latch until restart."""
        with self._lock:
            if self.reason is not None:
                log.warning("serving health (already failed): %s", reason)
                return
            self.reason = reason
            self._recoverable = recoverable
            self._failed_at_tokens = self.engine.stats.tokens_generated
        log.error("serving health: FAILED — %s", reason)
        try:
            # non-recoverable failures (dead host) are fatal: snapshot
            # the in-flight requests for restart-and-resume before
            # failing them. Recoverable stalls may clear — no snapshot.
            self.engine._fail_all(
                RuntimeError(f"serving failed: {reason}"),
                snapshot=not recoverable)
        except Exception:  # noqa: BLE001
            log.exception("failing in-flight requests failed")

    def close(self) -> None:
        self._watchdog.close()
        if self.monitor is not None:
            self.monitor.close()
        # the watchdog's thread has ended; dropping it breaks the
        # health <-> watchdog cycle, so a stopped server's engine is
        # freed by its refcount
        self._watchdog = _ClosedWatchdog()


# -- progress watchdog -------------------------------------------------------

class _ClosedWatchdog:
    """What a closed ServingHealth holds in place of its watchdog."""

    def close(self) -> None:
        pass


class Watchdog:
    """Fires on_stall when a monotonically-advancing counter stops moving.

    counter: zero-arg callable (e.g. `lambda: engine.stats.steps`).
    A stall is `active()` holding true for stall_after_s with no counter
    advance — including before the counter's FIRST advance, so a request
    that hangs before producing any token (a wedged capture, a dead peer)
    still fires. While `active()` is false the deadline keeps refreshing:
    an idle engine with an empty queue is never a stall, and a later
    request always gets the full window.
    """

    def __init__(self, counter: Callable[[], int], stall_after_s: float,
                 on_stall: Callable[[], None],
                 active: Optional[Callable[[], bool]] = None,
                 poll_interval_s: float = 0.5):
        self._counter = counter
        self._active = active or (lambda: True)
        self._stall_after = stall_after_s
        self._on_stall = on_stall
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(poll_interval_s,), daemon=True,
            name="cake-watchdog")
        self._thread.start()

    def _run(self, poll: float) -> None:
        last_value = self._counter()
        last_change = time.monotonic()
        fired = False
        while not self._stop.wait(poll):
            cur = self._counter()
            now = time.monotonic()
            if cur != last_value:
                last_value, last_change, fired = cur, now, False
                continue
            if not self._active():
                # an idle interval ends the stall episode: refresh the
                # deadline AND clear the fired latch so the next request
                # gets both the full window and a fresh detection (the
                # latch only suppresses re-firing within one episode)
                last_change = now
                fired = False
                continue
            if not fired and now - last_change > self._stall_after:
                fired = True
                log.warning("watchdog: no progress for %.1fs",
                            now - last_change)
                try:
                    self._on_stall()
                except Exception:  # noqa: BLE001
                    log.exception("on_stall callback failed")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
