"""Per-replica state tracking for the front-door router.

Each replica is an independent `--api` engine server. The tracker polls
its cheap health variant (`GET /api/v1/health?lite=1` — api/server.py)
on a short cadence and keeps the last document plus liveness state:

  * a replica whose last successful poll is older than `stale_after_s`
    is EJECTED — no new work routes to it;
  * an ejected replica is re-probed on a jittered exponential backoff
    seeded from its name (the HeartbeatSender discipline: a fleet
    of routers restarting must not thundering-herd a recovering
    replica), and one successful probe reinstates it;
  * a hard connection failure observed by the PROXY (connect refused
    mid-request) ejects immediately via `note_failure(hard=True)` —
    the poller's staleness window is an upper bound, not a gate the
    data path must wait out.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

from cake_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

# replica-state gauge values (README metrics table): the router's view
# of each backend, refreshed on every poll outcome
STATE_UP = 2.0
STATE_DRAINING = 1.0
STATE_DOWN = 0.0

_REPLICA_STATE = obs_metrics.gauge(
    "cake_router_replica_state",
    "Router's view of each backend replica: 2 up, 1 draining, 0 "
    "ejected/unreachable", labelnames=("replica",))
_POLLS = obs_metrics.counter(
    "cake_router_polls_total",
    "Replica health polls by outcome", labelnames=("outcome",))


def _http_lite_health(name: str, timeout_s: float) -> dict:
    """Default fetch: the lite health doc over HTTP."""
    with urllib.request.urlopen(
            f"http://{name}/api/v1/health?lite=1",
            timeout=timeout_s) as resp:
        return json.loads(resp.read())


class ReplicaState:
    """One backend's last-known state. Reads are lock-free snapshots of
    immutable-once-assigned attributes; the tracker is the one writer."""

    def __init__(self, name: str, source: str = "static"):
        self.name = name
        self.doc: dict = {}
        self.last_ok: Optional[float] = None   # monotonic
        self.failures = 0
        self.ejected = False
        self.next_probe = 0.0                  # monotonic deadline
        # fleet discovery (router/discovery.py): how this replica
        # entered the fleet ("static" = --replicas seed, "announced" =
        # registered by its own announce frame), when its last PUSHED
        # telemetry frame arrived (monotonic; None = never — poll-only),
        # and whether it sent the departure notice (drains-then-forgets:
        # no new admissions, sticky attaches still land, forgotten once
        # its load hits zero)
        self.source = source
        self.last_push: Optional[float] = None
        self.departing = False
        # estimated wall-clock offset of THIS router vs the replica
        # (seconds): min over polls of receive-wall minus the
        # replica's health-reported wall ("now") — skew plus the
        # smallest observed transit, the federation rule. The
        # federated timeline corrects replica span timestamps by it.
        # None until a poll carries a clock sample; reset on
        # reinstatement (a restarted replica's clock is fresh news).
        self.clock_offset: Optional[float] = None

    # -- derived views (router policy reads these) -----------------------

    @property
    def polled(self) -> bool:
        return self.last_ok is not None

    @property
    def draining(self) -> bool:
        return bool(self.doc.get("draining"))

    @property
    def breaker_tripped(self) -> bool:
        return bool(self.doc.get("recovery", {})
                    .get("breaker", {}).get("tripped"))

    @property
    def admitting(self) -> bool:
        """New work may route here: polled, not ejected, not draining,
        not departing, breaker not tripped, replica itself reports
        ok."""
        return (self.polled and not self.ejected and not self.draining
                and not self.departing and not self.breaker_tripped
                and self.doc.get("status") == "ok")

    @property
    def switch_in_flight(self) -> bool:
        """The replica reports a live config hot-switch (the compile
        wall): the policy routes AROUND it while another eligible
        replica exists, and restores it automatically when a later
        doc shows the epoch landed."""
        return bool(self.doc.get("switch_in_flight"))

    @property
    def load(self) -> int:
        """Queue depth + active slots — the bounded-load watermark's
        input and the least-loaded tiebreak."""
        return (int(self.doc.get("queue_depth", 0))
                + int(self.doc.get("active_requests", 0)))

    @property
    def config_epoch(self) -> Optional[int]:
        return self.doc.get("config_epoch")

    @property
    def page_size(self) -> Optional[int]:
        return self.doc.get("page_size")

    @property
    def drain_eta_s(self) -> Optional[float]:
        eta = self.doc.get("drain", {}).get("eta_s")
        return float(eta) if eta is not None else None

    def snapshot(self) -> dict:
        """Introspection row for GET /api/v1/router."""
        return {
            "ejected": self.ejected,
            "draining": self.draining,
            "departing": self.departing,
            "source": self.source,
            "admitting": self.admitting,
            "failures": self.failures,
            "load": self.load,
            "config_epoch": self.config_epoch,
            "age_s": (round(time.monotonic() - self.last_ok, 3)
                      if self.last_ok is not None else None),
            "push_age_s": (round(time.monotonic() - self.last_push, 3)
                           if self.last_push is not None else None),
            "clock_offset_s": (round(self.clock_offset, 6)
                               if self.clock_offset is not None
                               else None),
            "replica_reported": self.doc.get("replica"),
        }


class ReplicaTracker:
    """Polls every replica's lite health on `poll_interval_s`.

    `fetch(name) -> dict` is injectable (tests and the bench drive
    in-process replicas without sockets); the default is the HTTP lite
    endpoint. `poll_once()` is the synchronous seam; `start()` runs it
    on a daemon thread.
    """

    # cakelint guards discipline: the poll thread exists only between
    # start() and close()
    OPTIONAL_PLANES = ("_thread",)

    BACKOFF_BASE_S = 0.5
    BACKOFF_MAX_S = 10.0

    def __init__(self, replicas: Sequence[str],
                 poll_interval_s: float = 0.25,
                 stale_after_s: float = 2.0,
                 fetch: Optional[Callable[[str], dict]] = None,
                 timeout_s: float = 1.0,
                 allow_empty: bool = False):
        # allow_empty: fleet discovery (router/discovery.py) grows the
        # fleet from announce frames, so the static seed MAY be empty
        # there; without discovery an empty list is a fleet that can
        # never serve — keep the loud error
        if not replicas and not allow_empty:
            raise ValueError("router needs at least one replica")
        if len(set(replicas)) != len(list(replicas)):
            raise ValueError(f"duplicate replica names in {replicas}")
        if poll_interval_s <= 0 or stale_after_s <= 0:
            raise ValueError("poll_interval_s and stale_after_s must "
                             "be > 0")
        self.poll_interval_s = poll_interval_s
        self.stale_after_s = stale_after_s
        self.timeout_s = timeout_s
        self._fetch = fetch or (
            lambda name: _http_lite_health(name, self.timeout_s))
        self._mu = threading.Lock()
        self._states: Dict[str, ReplicaState] = {
            name: ReplicaState(name) for name in replicas}
        # per-replica jitter rng seeded from the NAME: reproducible,
        # and de-correlated across replicas (the discipline)
        self._rng = {name: random.Random(f"cake-router:{name}")
                     for name in replicas}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- views (membership reads take _mu: discovery mutates the dict) ---

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._states)

    def states(self) -> List[ReplicaState]:
        with self._mu:
            return list(self._states.values())

    def get(self, name: str) -> Optional[ReplicaState]:
        with self._mu:
            return self._states.get(name)

    def admitting(self) -> List[ReplicaState]:
        return [s for s in self.states() if s.admitting]

    def snapshot(self) -> dict:
        with self._mu:
            items = sorted(self._states.items())
        return {name: st.snapshot() for name, st in items}

    # -- dynamic membership (fleet discovery, router/discovery.py) -------

    def add(self, name: str, source: str = "announced") -> bool:
        """Register a replica discovered at runtime. Idempotent: False
        when the name is already tracked (a re-announce refreshes state
        through note_ok, it never double-registers)."""
        with self._mu:
            if name in self._states:
                return False
            self._states[name] = ReplicaState(name, source=source)
            self._rng[name] = random.Random(f"cake-router:{name}")
        log.info("router: replica %s registered (%s)", name, source)
        return True

    def remove(self, name: str) -> bool:
        """Forget a replica (the drain-then-forget terminal step).
        Its state gauge drops to DOWN — the series stays, bounded by
        the names ever fronted."""
        with self._mu:
            st = self._states.pop(name, None)
            self._rng.pop(name, None)
        if st is None:
            return False
        _REPLICA_STATE.labels(replica=name).set(STATE_DOWN)
        log.info("router: replica %s forgotten", name)
        return True

    # -- state transitions (single-writer: poll thread or caller) --------

    def _set_gauge(self, st: ReplicaState) -> None:
        if st.ejected or not st.polled or st.breaker_tripped \
                or st.doc.get("status") != "ok":
            val = STATE_DOWN
        elif st.draining:
            val = STATE_DRAINING
        else:
            val = STATE_UP
        _REPLICA_STATE.labels(replica=st.name).set(val)

    def _backoff_s(self, st: ReplicaState) -> float:
        base = min(self.BACKOFF_MAX_S,
                   self.BACKOFF_BASE_S * (2 ** min(st.failures, 6)))
        rng = self._rng.get(st.name) \
            or random.Random(f"cake-router:{st.name}")
        return base * (0.5 + rng.random())

    def note_ok(self, name: str, doc: dict,
                push: bool = False) -> None:
        """A health document arrived for `name` — from the poll path
        (default) or PUSHED in an announce frame (push=True, fleet
        discovery). A fresh push also stamps last_push, which suppresses
        the redundant poll for one staleness window; when the announce
        stream goes quiet the stamp ages out and polling resumes — the
        fallback-to-poll semantics, no mode switch anywhere."""
        st = self.get(name)
        if st is None:
            return   # forgotten while the doc was in flight
        # clock sample: the health doc's build-time wall clock ("now",
        # api/server.py) against our receive wall. min over polls is
        # the tightest offset bound this channel can observe (the
        # obs/federation.py discipline); a poll without the field
        # (older replica, fake test fetches) just contributes nothing.
        sample = None
        t_wall = doc.get("now") if isinstance(doc, dict) else None
        if isinstance(t_wall, (int, float)):
            sample = time.time() - float(t_wall)
        with self._mu:
            reinstated = st.ejected
            st.doc = doc
            st.last_ok = time.monotonic()
            if push:
                st.last_push = st.last_ok
            st.failures = 0
            st.ejected = False
            st.next_probe = 0.0
            if sample is not None:
                if reinstated or st.clock_offset is None:
                    # a reinstated replica may be a RESTART — its old
                    # min-offset is stale evidence
                    st.clock_offset = sample
                else:
                    st.clock_offset = min(st.clock_offset, sample)
        if reinstated:
            log.info("router: replica %s reinstated", name)
        self._set_gauge(st)
        if not push:
            _POLLS.labels(outcome="ok").inc()

    def note_failure(self, name: str, hard: bool = False) -> None:
        """A poll (or, with hard=True, a data-path connect) failed.
        Ejection is staleness-based for soft failures — one dropped
        poll inside the window must not bounce a loaded replica — and
        immediate for hard ones."""
        st = self.get(name)
        if st is None:
            return   # forgotten while the failure was in flight
        now = time.monotonic()
        with self._mu:
            st.failures += 1
            stale = (st.last_ok is None
                     or now - st.last_ok > self.stale_after_s)
            if (hard or stale) and not st.ejected:
                st.ejected = True
                log.warning("router: ejecting replica %s (%s, %d "
                            "consecutive failures)", name,
                            "hard failure" if hard else "stale",
                            st.failures)
            if st.ejected:
                st.next_probe = now + self._backoff_s(st)
        self._set_gauge(st)
        _POLLS.labels(outcome="fail").inc()

    def poll_once(self, now: Optional[float] = None) -> None:
        """One pass over every replica: fetch lite health, update
        state. Ejected replicas are re-probed only past their jittered
        backoff deadline; replicas whose PUSHED announce frames are
        fresh (within the staleness window) are skipped — the push
        stream already carries liveness, so the poll would be a
        redundant round trip. When frames stop, the stamp ages out and
        this loop resumes polling automatically."""
        now = time.monotonic() if now is None else now
        with self._mu:
            items = list(self._states.items())
        for name, st in items:
            if st.ejected and now < st.next_probe:
                continue
            if (st.last_push is not None
                    and now - st.last_push <= self.stale_after_s):
                continue
            try:
                doc = self._fetch(name)
            except Exception:  # noqa: BLE001 — any failure is a miss
                self.note_failure(name)
            else:
                if not isinstance(doc, dict):
                    self.note_failure(name)
                else:
                    self.note_ok(name, doc)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ReplicaTracker":
        if self._thread is not None:
            return self
        t = threading.Thread(
            target=self._run, daemon=True, name="cake-router-poll")
        self._thread = t
        t.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_interval_s)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
