"""The router HTTP front door.

`cake-tpu --router --replicas host:port,host:port,...` runs THIS
process role — no model, no devices: a ThreadingHTTPServer that routes
each chat request to one of N engine replicas (policy.py), proxies the
response through (proxy.py), and serves its own introspection:

  * POST /api/v1/chat/completions (+ /v1 alias) — routed + proxied
  * GET  /api/v1/router — replica states, policy mode, sticky keys
  * GET  /api/v1/health — the ROUTER's own health (cheap; replicas'
    health is what the tracker polls)
  * GET  /api/v1/requests/{rid}/timeline — the FEDERATED per-request
    explain: router hop spans + the owning replica(s)' merged
    timelines (both after a failover), clock-offset-corrected into
    one wall-clock chronology
  * GET  /api/v1/events — the router-tier typed event ring
    (affinity_miss / spill_to_secondary / failover_resume /
    shed_by_router, keyed by trace id)
  * GET  /api/v1/anomalies — the --sentinel regression sentinel's
    active + recent anomalies (obs/sentinel.py)
  * GET  /metrics — the cake_router_* + cake_anomaly_* families

Every routed request carries trace context: the router propagates the
client's `x-cake-trace` (or continues a keyed request's recorded
trace, or mints one), forwards it with `x-cake-hop` to the replica —
which threads it through its tracer/event bus and echoes it on SSE
and error responses — and hands it back to the client on the SSE
response headers together with `x-cake-replica` / `x-cake-rid`.

Failover loop: a connect failure or a roamable refusal (draining 429,
switch 409, retryable 503) moves the request to the next pick until
every replica was tried; a shed/queue-full 429 relays VERBATIM with
the replica's computed Retry-After and x-cake-replica attribution. A
replica dying mid-stream surfaces as a terminal SSE error event; the
client's keyed reconnect (Last-Event-ID) re-routes — sticky to the
home replica while it lives, re-admitted elsewhere once it is ejected
(the engine-side fresh-admission Last-Event-ID suppression keeps the
resumed stream exact-suffix).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs.events import EventBus
from cake_tpu_torch.router.affinity import (
    HashRing, prefix_fingerprint, text_fingerprint,
)
# _FAILOVERS is single-sourced in policy.py (which increments it for
# sticky home_ejected re-homes); a second declaration here would have
# to keep its help string byte-identical forever
from cake_tpu_torch.router.policy import (
    _FAILOVERS, NoReplicaError, RoutingPolicy,
)
from cake_tpu_torch.router.proxy import ReplicaProxy
from cake_tpu_torch.router.replicas import ReplicaTracker
from cake_tpu_torch.router.tracing import HopTracer

log = logging.getLogger(__name__)

# rid-bearing paths count/route under their template, same rule as
# api/server.py — a per-rid route would be unbounded
_TIMELINE_RE = re.compile(r"^/api/v1/requests/(\d+)/timeline$")

_REQUESTS = obs_metrics.counter(
    "cake_router_requests_total",
    "Chat requests proxied, by backend replica and priority class",
    labelnames=("replica", "class"))
_SHEDS = obs_metrics.counter(
    "cake_router_sheds_total",
    "Requests the router could not place (no_replica) or relayed a "
    "replica refusal for (relay)", labelnames=("reason",))

DEFAULT_PAGE_SIZE = 128


class RouterServer:
    """Routing + proxy state shared by the handler threads."""

    # cakelint guards discipline: the tokenizer (page-aligned affinity
    # keys), the decision JSONL log, the hop tracer, the typed event
    # ring, the regression sentinel and the fleet-discovery plane are
    # all optional planes — every dereference is `is not None`-guarded,
    # machine-checked
    OPTIONAL_PLANES = ("tokenizer", "_log", "hops", "events",
                       "sentinel", "actions", "discovery")

    def __init__(self, replicas, tokenizer=None,
                 poll_interval_s: float = 0.25,
                 stale_after_s: float = 2.0,
                 load_watermark: int = 8,
                 policy_mode: str = "affinity",
                 fetch=None, decision_log: Optional[str] = None,
                 vnodes: int = 64,
                 trace_ring: int = 256,
                 trace_events: Optional[str] = None,
                 event_ring: int = 1024,
                 event_log: Optional[str] = None,
                 sentinel: bool = False,
                 sentinel_interval_s: float = 2.0,
                 anomaly_weighting: bool = False,
                 fetch_timeline=None,
                 timeline_timeout_s: float = 5.0,
                 announce: Optional[str] = None,
                 announce_interval_s: float = 2.0,
                 announce_token: Optional[str] = None,
                 forget_grace_s: float = 30.0):
        self.tokenizer = tokenizer
        # with fleet discovery armed the static --replicas seed MAY be
        # empty: the fleet forms from announce frames
        self.tracker = ReplicaTracker(
            replicas, poll_interval_s=poll_interval_s,
            stale_after_s=stale_after_s, fetch=fetch,
            allow_empty=announce is not None)
        self.ring = HashRing(self.tracker.names(), vnodes=vnodes)
        self.policy = RoutingPolicy(
            self.tracker, ring=self.ring,
            load_watermark=load_watermark, mode=policy_mode)
        self.proxy = ReplicaProxy()
        self._log = None
        if decision_log:
            from cake_tpu_torch.obs.jsonl import JsonlAppender
            self._log = JsonlAppender(decision_log)
        # distributed tracing (router/tracing.py): per-request hop
        # records keyed by the minted/propagated x-cake-trace id, the
        # front-door half of GET /api/v1/requests/{rid}/timeline.
        # trace_ring 0 disables the plane (every site is then one
        # attribute test — the --event-ring 0 discipline).
        self.hops = (HopTracer(trace_ring, events_path=trace_events)
                     if trace_ring > 0 else None)
        # router-tier typed event ring (obs/events.py vocabulary:
        # affinity_miss / spill_to_secondary / failover_resume /
        # shed_by_router, events carry trace= not rid=), served at
        # GET /api/v1/events with an optional --event-log JSONL sink
        self.events = (EventBus(capacity=event_ring,
                                log_path=event_log)
                       if event_ring > 0 else None)
        # online regression sentinel (--sentinel, obs/sentinel.py):
        # per-replica TTFT skew, affinity collapse, router shed storms
        self.sentinel = None
        if sentinel:
            from cake_tpu_torch.obs.sentinel import attach_router_sentinel
            self.sentinel = attach_router_sentinel(
                self, interval_s=sentinel_interval_s)
        # closed-loop anomaly weighting (--router-anomaly-weighting,
        # obs/actions.py): TTFT-skew / shed-storm / affinity-collapse
        # anomalies de-weight the offending replica's placement (and
        # re-weight on recovery), every action audited on the plane.
        # None without the flag — report-only stays byte-identical.
        self.actions = None
        if anomaly_weighting:
            if self.sentinel is None:
                raise ValueError(
                    "--router-anomaly-weighting requires --sentinel "
                    "with the hop tracer enabled (trace_ring > 0)")
            from cake_tpu_torch.obs.actions import (
                ActionPlane, RouterAnomalyActuator,
            )
            self.actions = ActionPlane(events=self.events)
            RouterAnomalyActuator(self, self.actions).attach(
                self.sentinel)
        # fleet discovery (--router-announce, router/discovery.py):
        # replicas self-register over the token-gated announce channel,
        # pushed frames supersede polling while fresh, departures
        # drain-then-forget, and pushed headroom/attainment become
        # placement weight factors. None without the flag — the static
        # polled fleet stays byte-identical.
        self.discovery = None
        if announce is not None:
            from cake_tpu_torch.router.discovery import FleetDiscovery
            self.discovery = FleetDiscovery(
                self, address=announce, token=announce_token,
                announce_interval_s=announce_interval_s,
                forget_grace_s=forget_grace_s)
        self._timeline_timeout_s = timeline_timeout_s
        # injectable replica-timeline fetch (tests / bench drive
        # in-process replicas); default is the HTTP GET
        self._fetch_timeline = fetch_timeline or self._http_timeline
        if tokenizer is None:
            log.warning(
                "router: no tokenizer — affinity keys fall back to "
                "system-prompt TEXT fingerprints (stable, but not "
                "page-aligned; pass the model's tokenizer for the "
                "register_prefix rounding rule)")

    # -- affinity keys ---------------------------------------------------

    def _page_size(self) -> int:
        """The fleet's kv page size, read from any polled replica's
        lite health (replicas of one deployment share a config);
        default when nothing has reported one yet."""
        for st in self.tracker.states():
            if st.page_size:
                return int(st.page_size)
        return DEFAULT_PAGE_SIZE

    def affinity_key(self, body: dict) -> Optional[str]:
        """The request's shareable-head fingerprint: the rendered
        system-message head (exactly what the engine's --auto-prefix
        registers), page-aligned through the tokenizer when one is
        available."""
        msgs = body.get("messages") or []
        if not msgs or not isinstance(msgs[0], dict):
            return None
        if str(msgs[0].get("role", "")).lower() != "system":
            return None
        from cake_tpu_torch.models.chat import BEGIN_OF_TEXT, History, Message
        try:
            head = BEGIN_OF_TEXT + History.encode_message(
                Message.from_json(msgs[0]))
        except (ValueError, AttributeError):
            return None
        if self.tokenizer is None:
            return text_fingerprint(head)
        from cake_tpu_torch.models.llama.generator import encode_text
        ids = encode_text(self.tokenizer, head)
        return prefix_fingerprint(ids, self._page_size())

    # -- introspection ---------------------------------------------------

    def state(self) -> dict:
        return {
            "role": "router",
            "policy": self.policy.mode,
            "load_watermark": self.policy.load_watermark,
            "replicas": self.tracker.snapshot(),
            "page_size": self._page_size(),
            "affinity": ("paged" if self.tokenizer is not None
                         else "text"),
            "tracing": self.hops is not None,
            "sentinel": self.sentinel is not None,
            "anomaly_weighting": self.actions is not None,
            "discovery": self.discovery is not None,
            "announce_port": (self.discovery.port
                              if self.discovery is not None else None),
            "weights": self.policy.weights(),
        }

    def health(self) -> dict:
        up = [s.name for s in self.tracker.admitting()]
        return {"status": "ok" if up else "degraded",
                "role": "router",
                "replicas_admitting": up,
                "replicas_total": len(self.tracker.names())}

    def note_decision(self, rec: dict) -> None:
        if self._log is not None:
            self._log.append(rec)

    def metrics(self) -> str:
        text = obs_metrics.REGISTRY.render()
        if self.discovery is not None:
            # replica-labeled federated families from announce frames
            # appended after the local render (the pattern):
            # families the router also owns reuse its HELP/TYPE block,
            # replica-only families bring their own
            try:
                text += self.discovery.render_federated(
                    {f.name for f in obs_metrics.REGISTRY.families()})
            except Exception:  # noqa: BLE001 — a scrape must not fail
                log.debug("federated render failed", exc_info=True)
        return text

    def fleet(self) -> dict:
        """GET /api/v1/fleet: per-replica liveness, announce age,
        clock offset, headroom, attainment, epoch and the composed
        placement weight with provenance. Without discovery the router
        still answers with the polled view (weights included) so the
        endpoint is one stop regardless of how the fleet formed."""
        if self.discovery is not None:
            return self.discovery.fleet()
        fleet = {}
        for st in self.tracker.states():
            snap = st.snapshot()
            prov = self.policy.weight_provenance(st.name)
            snap["live"] = st.polled and not st.ejected
            snap["weight"] = prov["weight"]
            snap["weight_provenance"] = prov["factors"]
            fleet[st.name] = snap
        return {"role": "router", "replicas": fleet,
                "note": "fleet discovery disabled (start the router "
                        "with --router-announce)"}

    # -- federated per-request explain ------------------------------------

    def _http_timeline(self, replica: str, rid: int) -> dict:
        """Default replica-timeline fetch: the replica's own merged
        explain document over HTTP."""
        with urllib.request.urlopen(
                f"http://{replica}/api/v1/requests/{rid}/timeline",
                timeout=self._timeline_timeout_s) as resp:
            return json.loads(resp.read())

    def request_timeline(self, rid: int) -> Optional[dict]:
        """GET /api/v1/requests/{rid}/timeline, ROUTER tier: resolve
        the rid to its hop record (the replica echoed x-cake-rid at
        admission), fetch the owning replica's merged timeline — BOTH
        replicas' after a failover resume — correct each by its polled
        clock offset, and merge with the router hop spans and router
        event-ring causes into one wall-clock-ordered view
        (obs/timeline.merge_router_timeline). None when the rid is
        unknown here (never admitted through this router, or fell out
        of the hop ring) — the handler's 404."""
        if self.hops is None:
            return None
        rec = self.hops.find_by_rid(rid)
        if rec is None:
            return None
        tid = rec["trace"]
        router_events = []
        if self.events is not None:
            router_events = [e for e in self.events.dump()
                             if e.get("trace") == tid]
        # one fetch per (replica, rid) admission, first-admission
        # order — the failover story reads home-then-survivor
        seen = set()
        replica_docs = []
        for att in rec.get("attempts", ()):
            arid = att.get("rid")
            name = att.get("replica")
            if arid is None or (name, arid) in seen:
                continue
            seen.add((name, arid))
            st = self.tracker.get(name)
            offset = (st.clock_offset if st is not None
                      and st.clock_offset is not None else 0.0)
            try:
                doc = self._fetch_timeline(name, arid)
                if not isinstance(doc, dict):
                    doc = None
            except Exception:  # noqa: BLE001 — a killed home cannot
                # answer; its attempt still reads from the router hops
                log.debug("timeline fetch from %s failed", name,
                          exc_info=True)
                doc = None
            replica_docs.append((name, offset, arid, doc))
        from cake_tpu_torch.obs.timeline import merge_router_timeline
        return merge_router_timeline(rec, router_events, replica_docs)

    def events_page(self, type: Optional[str] = None,
                    since: Optional[int] = None,
                    limit: Optional[int] = None,
                    trace: Optional[str] = None) -> dict:
        """GET /api/v1/events (router tier): the router event ring,
        cursor-paged exactly like the replica endpoint; ?trace=
        additionally selects one trace's events (the router's events
        carry trace ids, not rids)."""
        if self.events is None:
            return {"events": [], "cursor": 0,
                    "note": "router event ring disabled "
                            "(--event-ring 0)"}
        if trace is None:
            evs, cursor = self.events.snapshot(type=type, since=since,
                                               limit=limit)
            return {"events": evs, "cursor": cursor}
        # trace filter BEFORE limiting (limit-then-filter would
        # silently drop matching events while the cursor advanced
        # past them); the truncated-page cursor rule mirrors
        # EventBus.snapshot — the last RETURNED seq, so the next
        # ?since= resumes exactly after it
        evs, cursor = self.events.snapshot(type=type, since=since)
        evs = [e for e in evs if e.get("trace") == trace]
        truncated = limit is not None and len(evs) > max(0, int(limit))
        if limit is not None:
            evs = evs[:max(0, int(limit))]
        if truncated:
            cursor = evs[-1]["seq"] if evs else \
                (since if since is not None else 0)
        return {"events": evs, "cursor": cursor}

    def anomalies(self) -> dict:
        """GET /api/v1/anomalies (router tier), with the closed-loop
        action history and live placement weights when
        --router-anomaly-weighting is armed."""
        if self.sentinel is None:
            return {"active": [], "anomalies": [],
                    "note": "sentinel disabled (start the router with "
                            "--sentinel)"}
        out = self.sentinel.state()
        if self.actions is not None:
            out["actions"] = self.actions.history()
            out["action_rate_per_min"] = self.actions.max_per_min
            out["weights"] = self.policy.weights()
        return out

    def close(self) -> None:
        if self.discovery is not None:
            # stop ingesting announce frames BEFORE the tracker goes
            # down: a frame landing mid-teardown must not re-register
            self.discovery.close()
        if self.sentinel is not None:
            self.sentinel.close()
        self.tracker.close()
        if self.hops is not None:
            self.hops.close()
        if self.events is not None:
            self.events.close()
        if self._log is not None:
            self._log.close()


def make_router_handler(router: RouterServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("router http: " + fmt, *args)

        def _json(self, code: int, obj: dict,
                  headers: Optional[dict] = None):
            data = json.dumps(obj).encode()
            self.send_response(code)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _query(self) -> dict:
            if "?" not in self.path:
                return {}
            from urllib.parse import parse_qs
            return {k: v[0] for k, v in
                    parse_qs(self.path.split("?", 1)[1]).items() if v}

        def do_GET(self):
            route = self.path.split("?", 1)[0]
            if route == "/api/v1/router":
                return self._json(200, router.state())
            if route == "/api/v1/health":
                return self._json(200, router.health())
            m = _TIMELINE_RE.match(route)
            if m:
                tl = router.request_timeline(int(m.group(1)))
                if tl is None:
                    return self._json(404, {
                        "error": f"unknown rid {m.group(1)} at this "
                                 "router (not admitted through it, "
                                 "hop tracing disabled, or fell out "
                                 "of the hop ring)"})
                return self._json(200, tl)
            if route == "/api/v1/events":
                q = self._query()
                try:
                    t = q.get("type")
                    if t is not None:
                        from cake_tpu_torch.obs.events import EVENT_TYPES
                        if t not in EVENT_TYPES:
                            raise ValueError(
                                f"unknown event type {t!r} (choose "
                                f"one of {', '.join(EVENT_TYPES)})")
                    since = q.get("since")
                    limit = q.get("limit")
                    return self._json(200, router.events_page(
                        type=t,
                        since=int(since) if since is not None else None,
                        limit=int(limit) if limit is not None else None,
                        trace=q.get("trace")))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
            if route == "/api/v1/anomalies":
                return self._json(200, router.anomalies())
            if route == "/api/v1/fleet":
                return self._json(200, router.fleet())
            if route in ("/metrics", "/api/v1/metrics"):
                data = router.metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self._json(404, {"error": "not found (router process: "
                                      "chat + router introspection "
                                      "only)"})

        def do_POST(self):
            route = self.path.split("?", 1)[0]
            if route not in ("/api/v1/chat/completions",
                             "/v1/chat/completions"):
                return self._json(404, {
                    "error": "not found (the router fronts chat "
                             "completions; administrative endpoints "
                             "live on the replicas)"})
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            try:
                body = json.loads(raw)
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as e:
                return self._json(400, {"error": f"invalid JSON body: "
                                                 f"{e}"})
            try:
                self._route_chat(route, raw, body)
            except OSError as e:
                # the CLIENT went away while we wrote its response
                # (broken pipe out of a relay/shed write): nothing to
                # tell anyone — but the hop record must still reach a
                # terminal state, or it would sit in the tracer's
                # active set forever (finish() is a no-op when the
                # route already finished it)
                log.debug("client disconnected mid-response: %s", e)
                tid = getattr(self, "_trace_id", None)
                if tid is not None and router.hops is not None:
                    router.hops.finish(tid, "error",
                                       error="client disconnected")

        # -- routed chat -------------------------------------------------

        def _route_chat(self, route: str, raw: bytes,
                        body: dict) -> None:
            cls = body.get("priority") \
                or self.headers.get("x-cake-priority") or "standard"
            if not isinstance(cls, str):
                cls = "standard"
            idem = self.headers.get("x-cake-idempotency-key")
            stream = bool(body.get("stream"))
            try:
                key = router.affinity_key(body)
            except Exception:  # noqa: BLE001 — affinity is best-effort
                log.debug("affinity key failed", exc_info=True)
                key = None

            # trace context: propagate the client's x-cake-trace, else
            # CONTINUE a keyed request's original trace (the sticky map
            # remembers it — a failover resume is one story), else mint.
            # x-cake-hop counts front-door tiers: the router forwards
            # its own count + 1 so a multi-router chain stays legible.
            tid = self.headers.get("x-cake-trace") \
                or router.policy.sticky_trace(idem)
            if not tid:
                tid = uuid.uuid4().hex
            try:
                hop_n = int(self.headers.get("x-cake-hop", 0)) + 1
            except ValueError:
                hop_n = 1
            self._trace_id = tid
            self._sse_meta = None   # (replica, rid) once admitted
            resuming = self.headers.get("Last-Event-ID") is not None
            if router.hops is not None:
                router.hops.begin(tid, cls=cls, stream=stream,
                                  hop=hop_n)

            self._stream_started = False
            tried: set = set()
            last_refusal_ra = None
            while True:
                try:
                    decision = router.policy.route(
                        key=key, idem_key=idem, exclude=tried)
                except NoReplicaError as e:
                    _SHEDS.labels(reason="no_replica").inc()
                    router.note_decision({
                        "event": "shed", "class": cls, "trace": tid,
                        "tried": sorted(tried)})
                    if router.hops is not None:
                        router.hops.finish(tid, "shed",
                                           tried=sorted(tried))
                    if router.events is not None:
                        router.events.publish(
                            "shed_by_router", trace=tid, priority=cls,
                            tried=sorted(tried))
                    hdrs = {"x-cake-trace": tid}
                    # a REPLICA-computed Retry-After only: the drain
                    # ETA from a lite-health doc, or the one carried
                    # by the last roamable refusal this very request
                    # saw — the router never invents its own
                    ra = (e.retry_after_s if e.retry_after_s is not None
                          else last_refusal_ra)
                    if ra is None and router.discovery is not None:
                        # the documented exception: during the
                        # discovery WARM-UP window (no replica has ever
                        # reported) the announce interval is an honest
                        # bound on when one could — without it an empty
                        # forming fleet reads as unretryable
                        ra = router.discovery.warmup_retry_after()
                    if ra is not None:
                        hdrs["Retry-After"] = str(
                            max(1, int(-(-ra // 1))))
                    return self._json(503, {
                        "error": "no replica available",
                        "trace": tid,
                        "tried": sorted(tried),
                        "retryable": True}, headers=hdrs)

                name = decision.replica
                if router.hops is not None:
                    router.hops.attempt(tid, name, decision.outcome)
                    router.hops.span(tid, "pick", replica=name,
                                     outcome=decision.outcome,
                                     sticky=decision.sticky,
                                     spill_reason=decision.spill_reason)
                if router.events is not None and key is not None \
                        and decision.outcome == "spill":
                    # router-tier causes: the request did not land on
                    # its affinity home — and when the home was merely
                    # SATURATED, this was the bounded-load spill to a
                    # secondary ring node specifically
                    router.events.publish(
                        "affinity_miss", trace=tid, replica=name,
                        reason=decision.spill_reason)
                    if decision.spill_reason == "saturated":
                        router.events.publish(
                            "spill_to_secondary", trace=tid,
                            replica=name)
                if resuming and (tried or not decision.sticky):
                    # a keyed client resuming a broken stream somewhere
                    # OTHER than its live sticky home: the drain/kill
                    # failover-resume path (fresh admission +
                    # Last-Event-ID suppression on the new replica)
                    resuming = False   # one cause per request
                    if router.hops is not None:
                        router.hops.span(tid, "failover_resume",
                                         replica=name)
                    if router.events is not None:
                        router.events.publish(
                            "failover_resume", trace=tid, replica=name)

                def admitted(rid=None, name=name):
                    # as soon as the replica 200s: the request holds a
                    # slot there, so keyed reconnects must find this
                    # home even while the stream is still running; the
                    # echoed x-cake-rid joins this trace to the
                    # replica-local record for the federated timeline
                    _REQUESTS.labels(name, cls).inc()
                    router.policy.note_admitted(idem, name, trace=tid)
                    self._sse_meta = (name, rid)
                    if router.hops is not None:
                        router.hops.admitted(tid, name, rid)

                def hop(span_name, name=name, **fields):
                    if router.hops is not None:
                        router.hops.span(tid, span_name, replica=name,
                                         **fields)

                outcome = router.proxy.forward_chat(
                    name, route, raw, self.headers, stream,
                    send_status=self._relay_status,
                    send_line=self._relay_line,
                    send_terminal_error=(
                        lambda msg, name=name:
                        self._terminal_error(msg, replica=name)),
                    on_admitted=admitted,
                    on_hop=hop,
                    extra_headers={"x-cake-trace": tid,
                                   "x-cake-hop": str(hop_n)})
                router.note_decision({
                    "event": "route", "replica": name,
                    "outcome": decision.outcome, "class": cls,
                    "trace": tid,
                    "proxy": outcome.kind, "status": outcome.status})

                if outcome.kind == "retryable":
                    tried.add(name)
                    if router.hops is not None:
                        router.hops.span(tid, "roam", replica=name,
                                         error=outcome.error)
                    if outcome.retry_after_s is not None:
                        last_refusal_ra = outcome.retry_after_s
                    if outcome.hard:
                        # connect-level failure: strong evidence —
                        # eject now, probe later (the poller would
                        # take a staleness window to notice)
                        router.tracker.note_failure(name, hard=True)
                        _FAILOVERS.labels(reason="connect").inc()
                    else:
                        # post-connect: either a roamable REFUSAL
                        # (draining/switch/reset — a protocol answer
                        # from a live replica, no failure evidence) or
                        # a genuine break (header timeout, cut body —
                        # soft evidence: a busy replica is not a
                        # corpse). Labels stay bounded either way.
                        reason = (outcome.error if outcome.error in
                                  ("draining", "switch", "reset")
                                  else "replica_error")
                        if reason == "replica_error":
                            router.tracker.note_failure(name)
                        _FAILOVERS.labels(reason=reason).inc()
                    continue
                if outcome.kind == "midstream":
                    _FAILOVERS.labels(reason="midstream").inc()
                    router.tracker.note_failure(name)
                    if router.hops is not None:
                        router.hops.finish(tid, "midstream",
                                           replica=name,
                                           error=outcome.error)
                    return
                if outcome.kind == "relayed":
                    _SHEDS.labels(reason="relay").inc()
                    if router.hops is not None:
                        # the relayed code rides as http_status: a
                        # `status=` field would collide with finish's
                        # own argument and raise in the handler
                        router.hops.finish(tid, "relayed",
                                           replica=name,
                                           http_status=outcome.status)
                    return
                # "ok": relay complete (admission was counted by the
                # on_admitted callback when the 200 arrived)
                if router.hops is not None:
                    router.hops.finish(tid, "retire", replica=name)
                if self._stream_started:
                    # close OUR chunked response (the relay loop only
                    # forwards the replica's SSE lines)
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                    except OSError:
                        pass
                return

        # -- relay callbacks ---------------------------------------------

        def _relay_status(self, code: int, headers: dict,
                          data: bytes) -> None:
            self.send_response(code)
            tid = getattr(self, "_trace_id", None)
            if tid is not None and "x-cake-trace" not in headers:
                # successful non-stream responses get their trace id
                # too (the replica echoes it only on SSE and errors) —
                # every response through the front door hands the
                # client its federated-timeline key
                self.send_header("x-cake-trace", tid)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _relay_line(self, line: bytes) -> None:
            if not self._stream_started:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                # trace context back to the client: the trace id to
                # query the federated timeline with, plus the serving
                # replica and its echoed rid (on_admitted ran before
                # the first relayed line)
                tid = getattr(self, "_trace_id", None)
                if tid is not None:
                    self.send_header("x-cake-trace", tid)
                meta = getattr(self, "_sse_meta", None)
                if meta is not None:
                    self.send_header("x-cake-replica", meta[0])
                    if meta[1] is not None:
                        self.send_header("x-cake-rid", str(meta[1]))
                self.end_headers()
                self._stream_started = True
            self.wfile.write(hex(len(line))[2:].encode() + b"\r\n")
            self.wfile.write(line + b"\r\n")
            self.wfile.flush()

        def _terminal_error(self, message: str,
                            replica: Optional[str] = None) -> None:
            # the replica attribution rides the EVENT PAYLOAD, not
            # only a header: a mid-stream death happens long after the
            # response headers shipped, so the payload is the only
            # place a streaming client can still learn WHICH replica
            # died (non-stream 429/503s carry x-cake-replica instead)
            err = {"message": message, "type": "ReplicaDownError",
                   "retryable": True}
            if replica is not None:
                err["replica"] = replica
            tid = getattr(self, "_trace_id", None)
            if tid is not None:
                err["trace"] = tid
            payload = (b"data: " + json.dumps({"error": err}).encode()
                       + b"\n\n")
            try:
                if not self._stream_started:
                    # should not happen (midstream implies bytes went
                    # out), but never write a bare payload without
                    # headers
                    self.send_response(502)
                    self.send_header("Content-Type",
                                     "application/json")
                    self.send_header("Content-Length",
                                     str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                self.wfile.write(
                    hex(len(payload))[2:].encode() + b"\r\n")
                self.wfile.write(payload + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except OSError:
                pass   # client is gone too; nothing to tell anyone

    return Handler


def start_router(replicas, address: str = "127.0.0.1:10127",
                 block: bool = True, **router_kwargs):
    """Bind and serve the front door. Returns (httpd, router); with
    block=False the server runs on a daemon thread (tests, bench)."""
    host, port = address.rsplit(":", 1)
    router = RouterServer(replicas, **router_kwargs)
    router.tracker.start()
    if router.sentinel is not None:
        router.sentinel.start()
    if router.discovery is not None:
        router.discovery.start()
    httpd = ThreadingHTTPServer((host, int(port)),
                                make_router_handler(router))
    log.info("router listening on %s over replicas %s%s", address,
             ",".join(router.tracker.names()) or "(none yet)",
             ("; announce channel on port %d" % router.discovery.port
              if router.discovery is not None else ""))

    def serve():
        try:
            httpd.serve_forever()
        finally:
            router.close()

    if block:
        serve()
    else:
        threading.Thread(target=serve, daemon=True).start()
    return httpd, router
