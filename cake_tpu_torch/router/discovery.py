"""Fleet discovery at the front door: replica auto-registration,
push-based telemetry to the router, and the observability-fed half of
placement.

Before this module the router fronted a *static* ``--replicas`` list
that it *polled* — scaling the fleet meant restarting the front door,
and placement saw only what lite health carries. This module inverts
the direction with the machinery already built for the SPMD
coordinator (obs/federation.py over the utils/wire.py length-prefixed,
token-gated framing):

  * **ReplicaAnnouncer** (replica side) — a thin configuration of
    ``TelemetryExporter`` pointed at the router instead of the
    coordinator. Every ``interval_s`` it ships one frame whose
    ``health`` section is a lite-health SUPERSET (queue depths by
    class, config epoch + switch_in_flight, draining + drain ETA, SLO
    attainment) extended with KV-pool headroom lifted from the
    existing page gauges and the replica's active sentinel anomalies;
    a bounded slice of the local metrics registry rides along for the
    router's replica-labeled federated /metrics. ``depart()`` ships an
    explicit departure notice (``departing: true``) so shutdown is an
    announcement, not an inference from silence.

  * **AnnounceListener** (router side) — a ``TelemetryCollector``
    subclass: same token-gated hello, bounded frames, per-origin
    views, min-over-frames clock offsets and federated render; it
    overrides the ingest hook to drive fleet membership and the
    exposition label so federated families carry ``replica=`` (the
    front door's dimension) instead of ``host=``.

  * **FleetDiscovery** — the glue onto the router's existing organs.
    A replica's FIRST frame registers it (tracker + deterministic ring
    position — a rejoin lands on exactly its old vnodes, so a
    depart+rejoin cycle moves ~1/N of keys once, not twice). Every
    frame refreshes liveness through ``tracker.note_ok(push=True)``,
    which suppresses the redundant poll while frames are fresh and
    FALLS BACK to the existing poll path the moment they stop — no
    mode switch anywhere. Frames also feed placement: pool-headroom
    and worst-class-attainment become multiplicative ``RoutingPolicy``
    factors (0.05 floor, per-factor provenance — the anomaly-
    weight audit discipline). A departure notice starts
    drain-then-forget: the replica stops admitting NEW work instantly
    (``ReplicaState.departing``), keeps serving sticky attaches, and
    is forgotten — tracker, ring, weights, view — once its reported
    load reaches zero (or a grace deadline, for a replica that died
    mid-drain). Membership churn publishes typed
    ``replica_joined`` / ``replica_departed`` / ``replica_stale``
    events on the router's event ring, so discovery shows up in the
    same timelines as everything else.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.obs.federation import (_HostView, TelemetryCollector,
                                     TelemetryExporter)
from cake_tpu_torch.obs.metrics import _escape_label_value

log = logging.getLogger(__name__)

# the bounded slice of a replica's registry that rides each announce
# frame — exactly the families placement and the fleet view read, not
# the whole registry (the router federates these replica-labeled; a
# full dump would grow the router's /metrics with every family every
# replica owns)
ANNOUNCE_METRIC_PREFIXES: Tuple[str, ...] = (
    "cake_engine_kv_pages",      # pool headroom (total/free)
    "cake_device_hbm_",          # device memory, the fleet view's column
    "cake_kv_pool_",             # pool byte gauges where present
    "cake_slo_attainment",       # per-class attainment windows
)

_ANNOUNCE_FRAMES = _m.counter(
    "cake_router_announce_frames_total",
    "Announce/telemetry frames the router ingested from each replica "
    "(router/discovery.py; the push path that supersedes polling while "
    "fresh)", labelnames=("replica",))
_ANNOUNCE_DEPARTURES = _m.counter(
    "cake_router_announce_departures_total",
    "Explicit departure notices received, by replica — each starts the "
    "drain-then-forget sequence", labelnames=("replica",))
_FLEET_REPLICAS = _m.gauge(
    "cake_router_fleet_replicas",
    "Replicas currently tracked by the router, by how they entered the "
    "fleet (static = --replicas seed, announced = self-registered)",
    labelnames=("source",))
_FLEET_WEIGHT = _m.gauge(
    "cake_router_fleet_weight",
    "Composed placement weight per replica (product of anomaly/"
    "headroom/attainment factors, 0.05 floor; 1 = unweighted — see "
    "GET /api/v1/fleet for per-factor provenance)",
    labelnames=("replica",))
_FLEET_STALE = _m.counter(
    "cake_router_fleet_stale_total",
    "Announce streams that went quiet past the staleness window, by "
    "replica — each transition falls placement back to the poll path",
    labelnames=("replica",))


def _gauge_value(name: str) -> Optional[float]:
    """First sample of a local registry gauge, or None. The announcer
    reads the page gauges BACK from the registry instead of touching
    engine internals — the gauge refresh already holds the engine's
    locking discipline (non-blocking switch-lock acquire)."""
    fam = _m.REGISTRY.get(name)
    if fam is None:
        return None
    return next(iter(fam.samples().values()), None)


class ReplicaAnnouncer:
    """Replica-side announce stream: a TelemetryExporter pointed at the
    router's AnnounceListener.

    ``replica`` is the replica's OWN serving address ("host:port") —
    it is both the fleet identity and the address the router proxies
    to, so it must be reachable from the router. ``health`` supplies
    the lite health doc (api/server.py ``health(lite=True)``);
    ``engine`` is optional and adds pool headroom + active sentinel
    anomalies to each frame. Everything is best-effort: a raising
    supplier drops its enrichment, never the frame, and a dead router
    degrades to counted send errors + reconnects (telemetry must never
    fail serving)."""

    # cakelint guards discipline: the engine (and its sentinel) and
    # the health supplier are optional planes — an engine-less replica
    # still announces liveness
    OPTIONAL_PLANES = ("_engine", "_sentinel", "_health")

    def __init__(self, router_address: str, replica: str,
                 token: Optional[str] = None,
                 interval_s: float = 2.0, *,
                 health=None, engine=None,
                 registry: Optional[_m.Registry] = None,
                 metric_prefixes: Tuple[str, ...]
                 = ANNOUNCE_METRIC_PREFIXES,
                 connect_timeout_s: float = 10.0,
                 start: bool = True):
        self.replica = str(replica)
        self._health = health
        self._engine = engine
        self._sentinel = (getattr(engine, "sentinel", None)
                          if engine is not None else None)
        self._registry = registry
        self._prefixes = tuple(metric_prefixes)
        self._departing = False
        self._exporter = TelemetryExporter(
            router_address, host=self.replica, token=token,
            interval_s=interval_s, registry=registry,
            metric_prefixes=self._prefixes, events=None,
            health_snapshot=self._announce_doc,
            connect_timeout_s=connect_timeout_s, start=start)

    @property
    def frames_sent(self) -> int:
        return self._exporter.frames_sent

    @property
    def interval_s(self) -> float:
        return self._exporter._interval

    def start(self) -> "ReplicaAnnouncer":
        self._exporter.start()
        return self

    # -- frame content ----------------------------------------------------

    def _announce_doc(self) -> Dict:
        """The frame's ``health`` section: the lite health doc extended
        with pool headroom, active sentinel anomalies, and the
        departure flag."""
        doc: Dict = {}
        if self._health is not None:
            try:
                doc = dict(self._health() or {})
            except Exception:  # noqa: BLE001 — a raising supplier drops
                log.debug("announce health supplier failed",  # its section
                          exc_info=True)
                doc = {}
        doc.setdefault("status", "ok")
        doc.setdefault("replica", self.replica)
        doc.setdefault("now", time.time())
        if self._engine is not None:
            try:
                from cake_tpu_torch.obs.steps import refresh_page_gauges
                refresh_page_gauges(self._engine)
                total = _gauge_value("cake_engine_kv_pages_total")
                free = _gauge_value("cake_engine_kv_pages_free")
                if total:
                    doc["pool"] = {"pages_total": int(total),
                                   "pages_free": int(free or 0)}
            except Exception:  # noqa: BLE001
                log.debug("announce pool enrichment failed",
                          exc_info=True)
        if self._sentinel is not None:
            try:
                active = self._sentinel.state(limit=0).get("active", ())
                doc["anomalies"] = sorted(
                    {a.get("kind") for a in active if a.get("kind")})
            except Exception:  # noqa: BLE001
                log.debug("announce sentinel enrichment failed",
                          exc_info=True)
        if self._departing:
            doc["departing"] = True
        return doc

    # -- lifecycle --------------------------------------------------------

    def flush(self, connect_timeout_s: Optional[float] = None) -> bool:
        return self._exporter.flush(connect_timeout_s)

    def depart(self, timeout_s: float = 2.0) -> bool:
        """Ship the departure notice NOW (synchronous, bounded budget).
        Called at the TOP of shutdown — before the drain begins — so
        the router stops admitting new work here while in-flight
        streams finish. False = the notice did not go out (the router
        will infer departure from staleness instead)."""
        self._departing = True
        try:
            return self._exporter.flush(connect_timeout_s=timeout_s,
                                        _ignore_stop=True)
        except Exception:  # noqa: BLE001 — shutdown must proceed
            return False

    def close(self, depart: bool = True) -> None:
        """Stop announcing; by default the terminal frame (the exporter
        close-flush) carries the departure notice."""
        if depart:
            self._departing = True
        self._exporter.close(flush=True)


class AnnounceListener(TelemetryCollector):
    """Router-side announce endpoint: the TelemetryCollector accept/
    hello/ingest machinery with (a) the ingest hook driving fleet
    membership through the owning FleetDiscovery and (b) the federated
    exposition label renamed ``host`` -> ``replica`` — the front
    door's dimension, matching every other cake_router_* family."""

    def __init__(self, discovery: "FleetDiscovery", host: str = "",
                 port: int = 0, token: Optional[str] = None, *,
                 stale_after_s: float = 10.0, max_replicas: int = 64):
        # set BEFORE super().__init__: the accept thread starts inside
        # it, and a fast replica's first frame must find the hook
        self._discovery = discovery
        super().__init__(host=host, port=port, token=token,
                         local_host="router",
                         stale_after_s=stale_after_s,
                         max_hosts=max_replicas)

    def _ingest(self, host: str, payload: bytes) -> None:
        with self._lock:
            if host not in self._views:
                # the view was popped by forget() while this replica's
                # connection stayed open (frames raced the departure,
                # or it cancelled its shutdown): recreate it — the
                # connection already passed the token gate at hello
                if len(self._views) >= self._max_hosts:
                    return
                self._views[host] = _HostView(
                    host, self._event_ring, "(reannounced)")
        super()._ingest(host, payload)
        with self._lock:
            view = self._views.get(host)
            doc = (dict(view.health)
                   if view is not None and isinstance(view.health, dict)
                   else {})
            offset = view.offset if view is not None else None
        self._discovery.on_frame(host, doc, offset)

    def forget(self, replica: str) -> None:
        """Drop a forgotten replica's view so its federated families
        stop rendering and a rejoin starts from a clean slate."""
        with self._lock:
            self._views.pop(replica, None)

    def hbm_for(self, replica: str) -> Dict[str, Dict]:
        """Per-device HBM gauges lifted from the replica's shipped
        metric dump — the fleet view's memory column."""
        with self._lock:
            view = self._views.get(replica)
            metrics = list(view.metrics) if view is not None else []
        return self._hbm_from_metrics(metrics)

    @staticmethod
    def _suffix(labels: List[str], values, host: str,
                extra: Tuple = ()) -> str:
        pairs = list(zip(labels, [str(v) for v in values]))
        pairs.append(("replica", host))
        pairs.extend(extra)
        body = ",".join('%s="%s"' % (k, _escape_label_value(v))
                        for k, v in pairs)
        return "{" + body + "}"


class FleetDiscovery:
    """The router's discovery plane: owns the AnnounceListener, maps
    frames onto tracker/ring/policy, and runs the maintenance loop
    (stale transitions, drain-then-forget, fleet gauges).

    Placement factors (the observability-fed half of routing): each
    frame recomputes two multiplicative RoutingPolicy factors with
    provenance —

      headroom    free/total KV pool pages; 1.0 above
                  ``HEADROOM_LOW_FRAC`` free, then linear down (a
                  nearly-full pool reads as nearly-saturated)
      attainment  worst per-class attainment_1m; 1.0 at or above
                  ``ATTAINMENT_LOW``, then linear down (a replica
                  missing its SLOs stops attracting new load before
                  it starts shedding)

    both floored at 0.05 by the policy — de-weighting never becomes a
    de-facto ejection. switch_in_flight routing is NOT a factor: the
    policy routes around the flag directly (router/policy.py
    ``_eligible``) and restores the replica the moment a doc shows the
    epoch landed."""

    # cakelint guards discipline: the maintenance thread exists only
    # between start() and close(); the router's event ring is optional
    # (--event-ring 0)
    OPTIONAL_PLANES = ("_thread",)

    HEADROOM_LOW_FRAC = 0.25
    ATTAINMENT_LOW = 0.9

    def __init__(self, router, address: str = "127.0.0.1:0",
                 token: Optional[str] = None, *,
                 announce_interval_s: float = 2.0,
                 stale_after_s: Optional[float] = None,
                 forget_grace_s: float = 30.0,
                 max_replicas: int = 64, start: bool = False):
        if announce_interval_s <= 0:
            raise ValueError(
                f"announce_interval_s {announce_interval_s} must be > 0")
        host, _, port = str(address).rpartition(":")
        self.router = router
        self.announce_interval_s = float(announce_interval_s)
        # quiet = three missed announce intervals (never tighter than
        # the tracker's own poll-staleness window)
        self.stale_after_s = (
            float(stale_after_s) if stale_after_s is not None
            else max(3.0 * self.announce_interval_s,
                     router.tracker.stale_after_s))
        self.forget_grace_s = float(forget_grace_s)
        self._mu = threading.Lock()   # serializes membership changes
        self._stale: set = set()      # replicas currently fallen to poll
        self._depart_deadline: Dict[str, float] = {}
        self.listener = AnnounceListener(
            self, host=host or "", port=int(port or 0), token=token,
            stale_after_s=self.stale_after_s,
            max_replicas=max_replicas)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    @property
    def port(self) -> int:
        return self.listener.port

    # -- frame ingestion (listener threads) --------------------------------

    def on_frame(self, replica: str, doc: Dict,
                 offset: Optional[float]) -> None:
        """One announce frame arrived. Registration, departure, rejoin
        and liveness all flow through here; membership changes are
        serialized under _mu (one listener thread per replica)."""
        if not doc:
            return   # liveness-only frame with no health yet: ignore
        tracker = self.router.tracker
        departing = bool(doc.get("departing"))
        now = time.monotonic()
        with self._mu:
            st = tracker.get(replica)
            if st is None:
                if departing:
                    return   # a goodbye from a replica we never knew
                if ":" not in replica:
                    # the announced name IS the proxy target — an
                    # unroutable name would poison the ring
                    log.warning("discovery: ignoring announce from "
                                "unroutable replica id %r", replica)
                    return
                tracker.add(replica, source="announced")
                self.router.ring.add(replica)
                self._publish("replica_joined", replica=replica,
                              source="announced")
                log.info("discovery: replica %s joined via announce",
                         replica)
            elif departing and not st.departing:
                st.departing = True
                self._depart_deadline[replica] = (
                    now + self.forget_grace_s)
                _ANNOUNCE_DEPARTURES.labels(replica=replica).inc()
                self._publish("replica_departed", replica=replica,
                              source=st.source, load=st.load)
                log.info("discovery: replica %s departing (load=%d) — "
                         "draining then forgetting", replica, st.load)
            elif not departing and st.departing:
                # it came back before being forgotten (a cancelled
                # shutdown / flap): same tracker entry, same ring
                # vnodes — never a double-register
                st.departing = False
                self._depart_deadline.pop(replica, None)
                self._publish("replica_joined", replica=replica,
                              source=st.source, rejoined=True)
            # a fresh frame ends any stale episode
            self._stale.discard(replica)
        tracker.note_ok(replica, doc, push=True)
        _ANNOUNCE_FRAMES.labels(replica=replica).inc()
        self._apply_factors(replica, doc)

    def _apply_factors(self, replica: str, doc: Dict) -> None:
        policy = self.router.policy
        pool = doc.get("pool") or {}
        total, free = pool.get("pages_total"), pool.get("pages_free")
        w, cause = 1.0, None
        if (isinstance(total, (int, float)) and total > 0
                and isinstance(free, (int, float))):
            frac = max(0.0, float(free) / float(total))
            if frac < self.HEADROOM_LOW_FRAC:
                w = frac / self.HEADROOM_LOW_FRAC
                cause = (f"pool free fraction {frac:.3f} < "
                         f"{self.HEADROOM_LOW_FRAC}")
        policy.set_factor(replica, "headroom", w, cause=cause)
        att = (doc.get("slo") or {}).get("attainment_1m") or {}
        w, cause = 1.0, None
        vals = [v for v in att.values() if isinstance(v, (int, float))]
        if vals:
            worst = min(vals)
            if worst < self.ATTAINMENT_LOW:
                w = max(0.0, float(worst)) / self.ATTAINMENT_LOW
                cause = (f"worst-class attainment_1m {worst:.3f} < "
                         f"{self.ATTAINMENT_LOW}")
        policy.set_factor(replica, "attainment", w, cause=cause)
        _FLEET_WEIGHT.labels(replica=replica).set(
            round(policy.weight(replica), 4))

    def _publish(self, type: str, **fields) -> None:
        if self.router.events is not None:
            try:
                self.router.events.publish(type, **fields)
            except Exception:  # noqa: BLE001 — telemetry never takes
                log.debug("discovery event publish failed",  # us down
                          exc_info=True)

    # -- maintenance (stale transitions + drain-then-forget) ---------------

    def maintain(self, now: Optional[float] = None) -> None:
        """One maintenance pass (the synchronous seam; start() runs it
        on a daemon thread). Detects announce streams gone quiet
        (publish replica_stale once per transition — polling has
        already resumed automatically via the aged-out push stamp),
        forgets drained departures, and reaps announced replicas that
        died without a goodbye (ejected + quiet past the grace
        window)."""
        now = time.monotonic() if now is None else now
        tracker = self.router.tracker
        with self._mu:
            for st in tracker.states():
                if st.last_push is None:
                    continue   # poll-only replica: nothing pushed yet
                quiet_s = now - st.last_push
                if quiet_s > self.stale_after_s:
                    if st.name not in self._stale and not st.departing:
                        self._stale.add(st.name)
                        _FLEET_STALE.labels(replica=st.name).inc()
                        self._publish("replica_stale", replica=st.name,
                                      age_s=round(quiet_s, 3))
                        log.warning(
                            "discovery: replica %s announce stream "
                            "quiet for %.1fs — falling back to polling",
                            st.name, quiet_s)
                else:
                    self._stale.discard(st.name)
                if st.departing:
                    deadline = self._depart_deadline.get(
                        st.name, now + self.forget_grace_s)
                    if st.load <= 0 or now >= deadline:
                        self._forget(st.name)
                elif (st.source == "announced" and st.ejected
                      and quiet_s > self.stale_after_s
                      + self.forget_grace_s):
                    # died without a goodbye: ejected by the poll
                    # fallback AND quiet past the grace window
                    self._publish("replica_departed", replica=st.name,
                                  source=st.source, inferred=True)
                    self._forget(st.name)
        self._refresh_gauges()

    def _forget(self, name: str) -> None:
        """The drain-then-forget terminal step (callers hold _mu)."""
        self.router.ring.remove(name)
        self.router.tracker.remove(name)
        self.router.policy.clear_factors(name)
        self.listener.forget(name)
        self._depart_deadline.pop(name, None)
        self._stale.discard(name)
        _FLEET_WEIGHT.labels(replica=name).set(1.0)

    def _refresh_gauges(self) -> None:
        counts: Dict[str, int] = {"static": 0, "announced": 0}
        for st in self.router.tracker.states():
            counts[st.source] = counts.get(st.source, 0) + 1
        for source, n in counts.items():
            _FLEET_REPLICAS.labels(source=source).set(n)

    # -- read surfaces ------------------------------------------------------

    def warmup_retry_after(self) -> Optional[float]:
        """Retry-After for a fleet-wide NoReplicaError during the
        discovery WARM-UP window: no replica has ever reported, so the
        announce interval is the honest bound on when one could — the
        one documented exception to the router's never-invent-a-
        Retry-After contract (a formed fleet that refuses still
        propagates only replica-computed ETAs). None once any replica
        has reported."""
        for st in self.router.tracker.states():
            if st.polled:
                return None
        return max(1.0, self.announce_interval_s)

    def fleet(self) -> Dict:
        """The GET /api/v1/fleet body: per-replica liveness, announce
        age, clock offset, headroom, attainment, epoch, and the
        composed placement weight WITH per-factor provenance."""
        policy = self.router.policy
        fleet: Dict[str, Dict] = {}
        for st in self.router.tracker.states():
            snap = st.snapshot()
            doc = st.doc
            prov = policy.weight_provenance(st.name)
            fleet[st.name] = {
                "live": st.polled and not st.ejected,
                "source": st.source,
                "admitting": st.admitting,
                "draining": st.draining,
                "departing": st.departing,
                "last_announce_age_s": snap["push_age_s"],
                "last_seen_age_s": snap["age_s"],
                "clock_offset_s": snap["clock_offset_s"],
                "load": st.load,
                "config_epoch": st.config_epoch,
                "switch_in_flight": st.switch_in_flight,
                "queue_depth_by_class": doc.get("queue_depth_by_class"),
                "pool": doc.get("pool"),
                "attainment_1m": (doc.get("slo") or {}
                                  ).get("attainment_1m"),
                "anomalies": doc.get("anomalies"),
                "hbm": self.listener.hbm_for(st.name),
                "weight": prov["weight"],
                "weight_provenance": prov["factors"],
            }
        return {"role": "router",
                "announce_port": self.port,
                "announce_interval_s": self.announce_interval_s,
                "stale_after_s": self.stale_after_s,
                "replicas": fleet}

    def render_federated(self, local_families=()) -> str:
        """Replica-labeled federated families for the router's
        /metrics (the render_federated pattern, replica= label)."""
        return self.listener.render_federated(local_families)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetDiscovery":
        if self._thread is None:
            t = threading.Thread(target=self._run, daemon=True,
                                 name="cake-router-discovery")
            self._thread = t
            t.start()
        return self

    def _run(self) -> None:
        interval = min(1.0, max(0.05, self.announce_interval_s / 2.0))
        while not self._stop.wait(interval):
            try:
                self.maintain()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("discovery maintenance failed")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.listener.close()
