"""Threaded HTTP server exposing the OpenAI-compatible text API.

Counterpart of `cake_tpu/api/server.py`, with its text and
observability routes:

  POST /api/v1/image: ImageGenerationArgs as the JSON body ->
       {"images": [base64 PNG, ...]}, one generation at a time (on a
       text model the master raises: a 500, as in JAX)
  POST /api/v1/chat/completions (and the /v1/chat/completions alias):
       buffered JSON, or SSE `chat.completion.chunk`s with "stream": true;
       the request's class in the body's "priority" or the
       x-cake-priority header (the body wins; an unknown class is a 400);
       x-cake-idempotency-key makes a retried submit attach to its
       stream instead of admitting it again, and on a streaming
       reconnect Last-Event-ID (the absolute token position of the last
       SSE `id:` the client saw) replays exactly the missing suffix
  POST /api/v1/drain {"timeout_s"}: close admissions (new submits get
       429 with the drain's Retry-After), let in-flight work finish,
       then stop and save; GET /api/v1/drain reads the drain's state
  GET  /v1/models (and /api/v1/models), GET /api/v1/health (with the
       recovery, journal and drain blocks; ?lite=1 the router's poll)
  GET  /metrics and /api/v1/metrics: the Prometheus text exposition
  GET  /api/v1/requests (?limit, ?rid, ?class, ?since): lifecycle traces
  GET  /api/v1/steps (?limit): the step flight recorder
  GET  /api/v1/events (?rid, ?type, ?since, ?limit, ?host): the event
       bus; ?host= a fleet host's stream held by the collector
  GET  /api/v1/fleet: per-host liveness, export age, clock offset and
       HBM gauges (this host alone, with a note, without a collector)
  GET  /api/v1/cluster: the process group (process index and count,
       devices, the hops' backend; parallel/distributed.cluster_info)
  GET  /api/v1/requests/{rid}/timeline: one request's spans, events and
       step records merged in time order (404 for an unknown rid)
  GET  /api/v1/autotune: the live config, the switch log and (auto mode)
       the controller's window; POST /api/v1/autotune {"config": {...}}:
       a live switch (400 for an invalid or refused config, a failed
       rebuild, or --autotune off; 409 while a switch is in flight)
  GET  /api/v1/anomalies (?limit): the sentinel's anomalies and
       detectors, and the action plane's history (--sentinel-act)
  POST /api/v1/profile {"seconds"}: a torch.profiler capture of the
       live process into --profile-dir (409 while one runs)

Every chat request goes through the continuous-batching engine, so N
requests decode together; a full queue, a shed request or a draining
server answers 429 with the computed Retry-After, an engine failure 503
(retryable) or 500 (a quarantined poison request). `start` always arms
a `ServingHealth` over the engine (parallel/health.py: the progress
watchdog of --stall-timeout; multi-process serving passes one that also
watches the followers' heartbeats): once it fails, every POST but a
drain answers 503 with the reason, /api/v1/health reads "failed" with
it, `cake_serving_healthy` is 0 and the fleet's local `live` is false.
`start` restores a --checkpoint and replays a --journal at startup,
and on SIGTERM drains, stops the engine, writes the postmortem bundle
(--postmortem-dir) and saves. With a fleet collector (`collector=`, obs/federation.py) the
fleet route, ?host= events, the host-labelled families appended to
/metrics and the fleet merge of a request's timeline read from it. With
`announce=` the replica registers itself with a front-door router
(router/discovery.py) and the shutdown sends its departure first.

The router's half of the contract: `?lite=1` on the health route (a
subtree of the full document with the replica's name and wall clock),
`x-cake-replica` on every 429 and 503 and on a stream's headers with
the engine rid (`x-cake-rid`), and the request's `x-cake-trace` threaded
to the engine and sent back on the stream and on every error.

An image model's master (an image generator and no text generator) is
served with no engine: the image, health, models and metrics routes
answer, and every other route is a 404.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import re
import threading
import time
import uuid
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from cake_tpu_torch.api.openai import (
    chunk_response, completion_response, parse_chat_request,
)
from cake_tpu_torch.args import ImageGenerationArgs
from cake_tpu_torch.models.llama.generator import incremental_decode
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import steps as obs_steps
from cake_tpu_torch.obs.events import EVENT_TYPES
from cake_tpu_torch.sched import ShedError, validate_priority
from cake_tpu_torch.serve.engine import QueueFullError
from cake_tpu_torch.serve.errors import (
    DrainingError, EngineRequestError, SwitchInFlightError,
)

log = logging.getLogger(__name__)

# routes worth a per-route counter series; anything else collapses into
# "other", so a 404 spray cannot grow the label set
KNOWN_ROUTES = frozenset({
    "/api/v1/chat/completions", "/v1/chat/completions",
    "/api/v1/health", "/v1/models", "/api/v1/models", "/metrics",
    "/api/v1/metrics", "/api/v1/requests", "/api/v1/steps",
    "/api/v1/events", "/api/v1/drain", "/api/v1/profile",
    "/api/v1/autotune", "/api/v1/requests/{rid}/timeline",
    "/api/v1/anomalies", "/api/v1/fleet", "/api/v1/image",
    "/api/v1/cluster",
})
_TIMELINE_RE = re.compile(r"^/api/v1/requests/(\d+)/timeline$")
# what a server with no engine (an image model) answers
IMAGE_MODEL_ROUTES = frozenset({
    "/api/v1/image", "/api/v1/health", "/v1/models", "/api/v1/models",
    "/metrics", "/api/v1/metrics",
})


class QueueFull(Exception):
    """Admission refused: the queue is full, (shed=True) load shedding
    refused it, or (draining=True) the server is draining; retry_after
    seconds ride the 429's Retry-After."""

    def __init__(self, retry_after: float = 1.0, shed: bool = False,
                 draining: bool = False):
        super().__init__("server draining" if draining
                         else "request shed" if shed else "queue full")
        self.retry_after = retry_after
        self.shed = shed
        self.draining = draining

# chat() return sentinel: the streaming client went away (handled; the
# HTTP layer must not touch the dead socket again)
DISCONNECTED = object()


class ApiServer:
    """Wraps a Master and its engine: chat requests batch continuously.
    An image model's master is wrapped with engine=None."""

    # cakelint guards discipline: the federation collector is optional
    # (coordinator-with---telemetry-collect only)
    OPTIONAL_PLANES = ("collector",)

    def __init__(self, master, model_name: str = "cake-tpu", engine=None,
                 collector=None, health=None, replica_id=None):
        import os
        import socket
        if engine is None and getattr(master, "image", None) is None:
            raise ValueError("the port serves text through the batching "
                             "engine only: pass engine=master.make_engine()")
        self.master = master
        self.model_name = model_name
        self.engine = engine
        # this serving process's id, as a front-door router attributes
        # backpressure and streams to it: the x-cake-replica header and
        # the health document's `replica`. start() passes the bind
        # address; CAKE_REPLICA_ID overrides the host name
        self.replica_id = (replica_id
                           or os.environ.get("CAKE_REPLICA_ID")
                           or socket.gethostname())
        # image requests inside HTTP admission (waiting on or holding
        # the generation lock): an image model's queue depth
        self._waiting = 0
        self._waiting_lock = threading.Lock()
        # the paged pool's (page size, free, total), as last read
        # (_pool_state)
        self._pool_cache = None
        # parallel.health.ServingHealth: once it fails, POSTs 503 and
        # /api/v1/health reports the reason
        self.health_state = health
        # obs/federation.TelemetryCollector: the fleet route, ?host=
        # events and the host-labelled /metrics families read from it;
        # attached to the engine, request timelines span hosts
        self.collector = collector
        if collector is not None and engine is not None:
            engine.telemetry = collector
        # POST /api/v1/image: one generation at a time, as JAX's lock
        self._gen_lock = threading.Lock()
        self.started_at = int(time.time())  # /v1/models "created"
        # drain: start() wires _shutdown to its save-and-exit closure,
        # which the drain thread calls once in-flight work finishes
        self._shutdown = None
        self._drain_thread = None
        self._drain_lock = threading.Lock()
        # POST /api/v1/profile's capture directory (--profile-dir; None:
        # a fresh temporary directory a capture). Naming one warms the
        # profiler here, on the thread that builds the server, so a
        # capture from a handler thread starts at once
        self._profile_dir = getattr(getattr(master, "args", None),
                                    "profile_dir", None)
        if self._profile_dir and engine is not None \
                and engine.device.type == "cuda":
            from cake_tpu_torch.utils.profiling import warm_profiler
            warm_profiler()
        self._m_http = obs_metrics.counter(
            "cake_http_requests_total",
            "HTTP requests served, by route and status code",
            labelnames=("route", "status"))
        if engine is not None:
            engine.start()

    def _count(self, path: str, code: int) -> None:
        route = path.split("?", 1)[0]
        if _TIMELINE_RE.match(route):
            route = "/api/v1/requests/{rid}/timeline"
        if route not in KNOWN_ROUTES:
            route = "other"
        self._m_http.labels(route=route, status=str(code)).inc()

    def _engine_retry_after(self, priority=None) -> float:
        """The Retry-After of a retryable engine failure's 503: the shed
        controller's estimate for the request's class when shedding is
        on (the 429 path's computation), else 1 s."""
        shed = getattr(self.engine, "_shed", None)
        if shed is not None:
            try:
                return shed.estimate_retry_after(
                    priority or "standard", self.engine.queue_depth)
            except Exception:  # noqa: BLE001 — an estimate, not a contract
                log.debug("retry-after estimate failed", exc_info=True)
        return 1.0

    def _submit(self, messages, kw):
        """engine.chat, its refusals as QueueFull (429)."""
        try:
            return self.engine.chat(messages, **kw)
        except (QueueFullError, ShedError) as e:
            raise QueueFull(getattr(e, "retry_after", 1.0),
                            shed=isinstance(e, ShedError))
        except DrainingError as e:
            raise QueueFull(e.retry_after, draining=True)

    def chat(self, body: dict, send_chunk=None, on_start=None,
             idempotency_key=None, last_event_id=None,
             trace_id=None) -> Optional[dict]:
        """Run one chat completion. With send_chunk, stream deltas through
        it and return None (or DISCONNECTED); else return the response
        dict. `on_start` fires after admission and before any token, so
        a queue rejection (QueueFullError) still surfaces as a clean
        429; it gets the engine rid as `rid=` (the handler sends it as
        x-cake-rid, a router's key for joining the trace).
        send_chunk(obj, event_id=N) gets each event's absolute token
        position (the SSE `id:`). trace_id (x-cake-trace): the
        originating trace id, threaded to the engine's tracer and event
        bus at admission.

        idempotency_key (x-cake-idempotency-key): a retried submit with
        the same key attaches to the live or finished stream instead of
        admitting again (across restarts too with --journal).
        last_event_id (Last-Event-ID): on a streaming reconnect, the
        held or journaled suffix after that position is replayed, then
        the stream continues live: no duplicates, no gaps."""
        messages, opts = parse_chat_request(body)
        want_lp = bool(opts.get("logprobs"))
        n_top = opts.get("top_logprobs") or 0
        kw = dict(
            max_new_tokens=opts["max_tokens"] or self.master.args.sample_len,
            temperature=opts["temperature"],
            top_p=opts["top_p"],
            want_top_logprobs=n_top > 0,
            priority=opts.get("priority"),
            idempotency_key=idempotency_key,
            trace_id=trace_id,
        )
        tok = self.engine.tokenizer

        def lp_entry(t, lp, top):
            text = tok.decode([t])
            e = {"token": text, "logprob": round(lp, 6),
                 "bytes": list(text.encode()), "top_logprobs": []}
            for at, al in top[:n_top]:
                atext = tok.decode([at])
                e["top_logprobs"].append({"token": atext,
                                          "logprob": round(al, 6),
                                          "bytes": list(atext.encode())})
            return e

        eos_ids = self.engine.config.eos_token_ids
        if send_chunk is None:
            h = self._submit(messages, kw)
            h.wait()
            text = h.text()   # raises the typed error if the engine failed
            lp = None
            if want_lp:
                lp = [lp_entry(t, l, top) for (t, l), top
                      in zip(h.token_logprobs, h.token_top_logprobs)]
            rep = list(h._req.replayed_tokens)
            if rep:
                # a resumed stream: the client's transcript is the whole
                # generation, earlier process generations included
                text = tok.decode([t for t in rep + list(h._req.out_tokens)
                                   if t not in eos_ids])
            return completion_response(text, self.model_name, logprobs=lp)

        rid = str(uuid.uuid4())
        # deltas are queued by the engine thread and written here on the
        # handler thread: a slow client must never block the engine loop
        deltas: queue.Queue = queue.Queue()

        def stream(delta: str, final: bool, n_done: int = 0):
            deltas.put((delta, final, n_done))

        # the engine snapshots the finalized-entry count at emit time, so
        # each chunk's logprob entries pair with the delta carrying them
        stream.wants_count = True
        h = self._submit(messages, dict(kw, stream=stream))
        if on_start is not None:
            on_start(rid=h._req.rid)
        r = h._req
        lp_cursor = 0
        # SSE event ids are absolute token positions: tokens of earlier
        # process generations count, so a Last-Event-ID survives any
        # number of restarts
        id_base = len(r.replayed_tokens)
        sent_id = id_base      # the highest event id delivered

        def chunk_lp(upto):
            nonlocal lp_cursor
            if not want_lp:
                return None
            entries = [
                lp_entry(r.out_tokens[i], r.out_logprobs[i], r.out_top[i])
                for i in range(lp_cursor, upto)
                if r.out_tokens[i] not in eos_ids]
            lp_cursor = upto
            return entries

        # trim_from: a fresh admission with a Last-Event-ID (a keyed
        # stream failed over to a process that re-runs it): events up to
        # the client's position are suppressed, and the batch crossing
        # it ships only the unseen suffix
        trim_from = None
        # shown: on an idempotent reconnect, the text sent since the
        # client's Last-Event-ID. The server decodes an attached stream's
        # text itself from the absolute token positions: the engine's
        # deltas follow its own decode state, which a resumed request
        # (no client until the attach) has not kept
        shown = None
        start_at = max(0, int(last_event_id or 0))

        def since_client(upto):
            history = list(r.replayed_tokens) + list(r.out_tokens)
            return [t for t in history[start_at:upto] if t not in eos_ids]

        if h.attached:
            # the held or journaled suffix after the client's
            # Last-Event-ID as one chunk, then the live loop drops queued
            # deltas at or below it
            n_hist = len(r.replayed_tokens) + len(r.out_tokens)
            text, shown = incremental_decode(
                tok, since_client(n_hist), "", final=r.done.is_set())
            try:
                if text:
                    send_chunk(chunk_response(text, self.model_name,
                                              rid=rid),
                               event_id=n_hist)
            except OSError:
                return DISCONNECTED
            sent_id = max(start_at, n_hist)
            lp_cursor = max(0, sent_id - id_base)
        elif last_event_id:
            sent_id = max(sent_id, int(last_event_id))
            lp_cursor = max(0, sent_id - id_base)
            trim_from = lp_cursor

        while True:
            try:
                delta, final, n_done = deltas.get(timeout=0.5)
            except queue.Empty:
                if r.done.is_set() and deltas.empty():
                    break  # request ended without a final delta (error)
                continue
            ev_id = id_base + n_done
            if shown is not None and ev_id > sent_id:
                delta, shown = incremental_decode(
                    tok, since_client(ev_id), shown, final=final)
            if delta and ev_id > sent_id:
                if trim_from is not None:
                    toks = [t for t in r.out_tokens[trim_from:n_done]
                            if t not in eos_ids]
                    delta = tok.decode(toks) if toks else ""
                    trim_from = None
                    if not delta:
                        sent_id = ev_id
                        if final:
                            break
                        continue
                try:
                    send_chunk(chunk_response(delta, self.model_name,
                                              rid=rid,
                                              logprobs=chunk_lp(n_done)),
                               event_id=ev_id)
                    sent_id = ev_id
                except OSError:
                    # the client went away: free the slot now, unless the
                    # request is keyed (its client will reconnect)
                    if r.idempotency_key is None:
                        log.info("client disconnected; cancelling request")
                        self.engine.cancel(h)
                    else:
                        log.info("client disconnected; rid=%d keeps "
                                 "decoding for an idempotent reconnect",
                                 r.rid)
                    return DISCONNECTED
            if final:
                break
        try:
            h.text()  # raises if the engine failed the request
        except Exception as e:  # noqa: BLE001
            # headers are long gone: end the stream with a terminal error
            # event the client can tell from success
            try:
                send_chunk({"error": {
                    "message": str(e), "type": type(e).__name__,
                    "retryable": bool(getattr(e, "retryable", False))}})
            except OSError:
                return DISCONNECTED
            return None
        try:
            send_chunk(chunk_response("", self.model_name, finish="stop",
                                      rid=rid,
                                      logprobs=chunk_lp(len(r.out_tokens))),
                       event_id=id_base + len(r.out_tokens))
        except OSError:
            return DISCONNECTED
        return None

    def image(self, body: dict) -> dict:
        """POST /api/v1/image: the master's generation for the body
        (ImageGenerationArgs as JSON, unknown keys ignored) as base64
        PNGs. A text model's master raises "no image generator loaded"
        (a 500, as in JAX)."""
        if not isinstance(body, dict):
            raise ValueError("the body must be a JSON object")
        images: list = []
        with self._waiting_lock:
            self._waiting += 1
        try:
            with self._gen_lock:
                self.master.generate_image(
                    ImageGenerationArgs.from_json(body), images.extend)
        finally:
            with self._waiting_lock:
                self._waiting -= 1
        return {"images": [base64.b64encode(p).decode() for p in images]}

    def _pool_state(self, eng):
        """(page size, free pages, total pages) of the paged engine's
        pool, or None before a first read. The pager swaps wholesale
        during a live reconfigure, under the engine's _admit_lock; its
        declared lock pins one consistent pool. NON-blocking on purpose
        (the refresh_page_gauges discipline): the health endpoint,
        including the router's sub-second lite poll, must never stall
        behind a switch holding the lock through its rebuild, or the
        router would eject a healthy replica exactly when it is
        switching. On contention the last-seen values serve one more
        poll."""
        if eng._admit_lock.acquire(blocking=False):
            try:
                # cakelint: skip[affinity] _admit_lock held via the non-blocking acquire above (the with-form would block the health path behind a switch)
                pager = eng._pager
                self._pool_cache = (pager.page_size, pager.free_pages,
                                    pager.n_pages)
            finally:
                eng._admit_lock.release()
        return self._pool_cache

    def health(self, lite: bool = False) -> dict:
        """/api/v1/health: engine occupancy, per-class queue depths (SLO
        scheduling on), pool pages, SLO accounting and throughput, and
        the recovery, journal and drain blocks. A stopped engine (a
        storm-breaker or failed-rebuild stop) reports status "stopped"
        and the reason. With no engine (an image model): the generator's
        device and whether a generation runs.

        lite (?lite=1): only what a front-door router polls every few
        hundred ms, each field a subtree of the full document: the
        replica, the document's wall clock (the router's clock-offset
        input), queue depths, draining, page size, config epoch, SLO
        attainment and the breaker, as JAX's lite document."""
        eng = self.engine
        failed = self._failed()
        out = {"status": ("failed" if failed
                          else "stopped" if eng is not None and eng.stopped
                          else "ok"),
               "replica": self.replica_id,
               "now": round(time.time(), 6),
               "queue_depth": self._waiting}
        if not lite:
            out["model"] = self.model_name
        if failed:
            out["reason"] = self.health_state.reason
        elif eng is not None and eng.stopped:
            out["reason"] = eng.stats.last_error or "engine stopped"
        if eng is None:
            if not lite:
                out.update(device=str(self.master.image.device),
                           busy=self._gen_lock.locked())
            return out
        out.update(queue_depth=eng.queue_depth,
                   active_requests=eng.active,
                   decode_slots=eng.max_slots)
        depths = getattr(eng.scheduler, "class_depths", None)
        if depths is not None:
            out["queue_depth_by_class"] = depths()
        if eng._draining:
            out["draining"] = True
            out["drain"] = eng.drain_state()
        pool = self._pool_state(eng) if eng.paged else None
        if pool is not None:
            out["page_size"] = pool[0]
        # the autotune epoch and the switch flag (a router redirects
        # fresh admissions while a fold-everything switch runs)
        out["config_epoch"] = eng.config_epoch
        out["autotune"] = eng.autotune_mode
        out["switch_in_flight"] = bool(eng._switch_inflight)
        if lite:
            # the router's weighted pick reads attainment, and a tripped
            # breaker means this replica is a restart away
            out["slo"] = {"attainment_1m": {
                c: round(v, 4) for c, v in
                eng.slo.attainment_by_class("1m").items()}}
            out["recovery"] = {"breaker": {"tripped": bool(
                eng._breaker_tripped)}}
            return out
        out["device"] = str(eng.device)
        out["slo"] = eng.slo.snapshot()
        out["recovery"] = eng.recovery_state()
        if eng._journal is not None:
            out["journal"] = eng._journal.state()
        if eng.paged:
            if pool is not None:
                out.update(pages_free=pool[1], pages_total=pool[2])
            out["paged_attn"] = eng.paged_attn
        st = eng.stats
        out.update(
            requests_completed=st.requests_completed,
            tokens_generated=st.tokens_generated,
            decode_tokens_per_s=round(st.decode_tokens_per_s, 2),
            errors=st.errors,
        )
        if depths is not None:
            out["preemptions"] = st.preemptions
            out["requests_shed"] = st.shed
        # the LIVE effective engine config, what the autotuner chose
        out["engine_config"] = eng.current_config().to_dict()
        return out

    def _failed(self) -> bool:
        return self.health_state is not None and self.health_state.failed

    def cluster(self) -> dict:
        """GET /api/v1/cluster: the process group as
        parallel/distributed.cluster_info reports it."""
        from cake_tpu_torch.parallel.distributed import cluster_info
        return cluster_info()

    def autotune(self) -> dict:
        """GET /api/v1/autotune: mode, live config, window signals and
        the switch and decision history (autotune/)."""
        return self.engine.autotune_state()

    def autotune_switch(self, body: dict) -> dict:
        """POST /api/v1/autotune {"config": {...}}: a manual live switch.
        ValueError (400) for a malformed, invalid or refused config, a
        failed rebuild, or --autotune off; SwitchInFlightError (409,
        mapped by the handler) while another switch runs."""
        if self.engine.autotune_mode == "off":
            raise ValueError(
                "autotune is off; restart with --autotune manual (or auto) "
                "to enable live config switching")
        cfg = body.get("config")
        if not isinstance(cfg, dict):
            raise ValueError('body must be {"config": {...}} with the '
                             "switchable engine knobs")
        switched = self.engine.reconfigure(cfg, reason="manual")
        return {"switched": bool(switched),
                "config": self.engine.current_config().to_dict(),
                "epoch": self.engine.config_epoch}

    def request_timeline(self, rid: int) -> Optional[dict]:
        """GET /api/v1/requests/{rid}/timeline (obs/timeline.py); None
        is the 404."""
        return self.engine.request_timeline(rid)

    def anomalies(self, limit: Optional[int] = None) -> dict:
        """GET /api/v1/anomalies: the active anomalies, the recent-firing
        ring (?limit=), every detector's threshold and state
        (obs/sentinel.py; --sentinel), and with --sentinel-act the
        action history (obs/actions.py)."""
        sen = self.engine.sentinel
        if sen is None:
            return {"active": [], "anomalies": [],
                    "note": "sentinel disabled (restart with --sentinel)"}
        out = sen.state(limit=limit)
        plane = self.engine._actions
        if plane is not None:
            out["actions"] = plane.history(limit)
            out["action_rate_per_min"] = plane.max_per_min
        return out

    def profile(self, body: dict) -> dict:
        """POST /api/v1/profile {"seconds": N}: a torch.profiler Chrome
        trace of the next N seconds of the live process, into
        --profile-dir (never a path from the body: clients must not pick
        server paths). The profiler starts and stops on the engine
        thread, between iterations: stopped while another thread
        replays a CUDA graph, it can deadlock with the replay.
        Single-flight: a concurrent capture raises ProfileBusyError
        (409)."""
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        seconds = body.get("seconds", 2.0)
        if not isinstance(seconds, (int, float)) or isinstance(
                seconds, bool):
            raise ValueError("seconds must be a number")
        eng = self.engine
        run = (eng._run_on_engine_thread
               if eng._thread is not None and eng._thread.is_alive()
               else None)
        return obs_steps.PROFILER.capture(seconds, self._profile_dir,
                                          run=run)

    def metrics(self) -> str:
        """Prometheus text exposition: the registry's families, with the
        engine's aggregate counters synced at scrape time (one scrape =
        one snapshot of EngineStats), as the JAX server renders them."""
        m = obs_metrics
        if self.health_state is None:
            # with a health state, its observe_metrics below refreshes
            # the device gauges (once a scrape)
            obs_steps.refresh_device_gauges()
        m.gauge("cake_serving_healthy",
                "1 = serving, 0 = failed (parallel/health.py)").set(
            0 if self._failed() else 1)
        if self.health_state is not None:
            # the heartbeat staleness gauge, the device and page gauges
            self.health_state.observe_metrics()
        if self.engine is not None:
            self._sync_engine_metrics(self.engine)
        if self.collector is not None:
            # the per-host liveness/age gauges live in the LOCAL
            # registry: refreshed before it renders
            try:
                self.collector.refresh_gauges()
            except Exception:  # noqa: BLE001 — a scrape must not fail
                log.debug("fleet gauge refresh failed", exc_info=True)
        text = m.REGISTRY.render()
        if self.collector is not None:
            # remote hosts' families appended with a host label: the
            # families this process also owns reuse its HELP/TYPE block
            # above, remote-only ones bring their own
            try:
                text += self.collector.render_federated(
                    {f.name for f in m.REGISTRY.families()})
            except Exception:  # noqa: BLE001 — a scrape must not fail
                log.debug("federated render failed", exc_info=True)
        return text

    @staticmethod
    def _sync_engine_metrics(eng) -> None:
        """The engine's gauges and aggregate counters, set from its
        EngineStats at scrape time."""
        m = obs_metrics
        st = eng.stats
        for name, help_, val in (
            ("cake_engine_queue_depth",
             "Admission queue depth", eng.queue_depth),
            ("cake_engine_active_requests",
             "Requests holding a decode slot", eng.active),
            ("cake_engine_decode_slots",
             "Configured decode slots", eng.max_slots),
            ("cake_engine_decode_tokens_per_second",
             "Aggregate decode throughput",
             round(st.decode_tokens_per_s, 2)),
            ("cake_engine_trace_active_requests",
             "Requests with an open lifecycle trace",
             eng.tracer.active_count),
        ):
            m.gauge(name, help_).set(val)
        for name, help_, val in (
            ("cake_engine_requests_completed_total",
             "Requests retired by the engine", st.requests_completed),
            ("cake_engine_tokens_generated_total",
             "Tokens generated across all requests", st.tokens_generated),
            ("cake_engine_decode_steps_total",
             "Batched decode steps dispatched", st.steps),
            ("cake_engine_decode_seconds_total",
             "Wall seconds inside decode dispatch",
             round(st.decode_time_s, 4)),
            ("cake_engine_prefill_seconds_total",
             "Wall seconds inside prefill dispatch",
             round(st.prefill_time_s, 4)),
            ("cake_engine_prefix_hits_total",
             "Prefills served from a registered prefix", st.prefix_hits),
            ("cake_engine_errors_total",
             "Engine iterations that failed and reset", st.errors),
        ):
            m.counter(name, help_).set_total(val)
        if getattr(eng, "_specp", None) is not None:
            # the engine's speculation (the JAX server keys these on its
            # dense spec engine, which the port does not have)
            m.counter("cake_engine_spec_proposed_total",
                      "Draft tokens proposed").set_total(st.spec_proposed)
            m.counter("cake_engine_spec_accepted_total",
                      "Draft tokens accepted").set_total(st.spec_accepted)
            m.gauge("cake_engine_spec_acceptance",
                    "Lifetime draft acceptance ratio").set(
                round(st.spec_acceptance, 4))
        eng._set_queue_gauges()
        obs_steps.refresh_page_gauges(eng)
        eng.slo.refresh_gauges()

    def fleet(self) -> dict:
        """GET /api/v1/fleet: this host's entry (live, active requests,
        queue depth, the card's memory under the remote rows' keys)
        beside the collector's remote views; without a collector, this
        host alone with JAX's note."""
        local_name = getattr(self.collector, "local_host", None) \
            or "coordinator"
        eng = self.engine
        failed = self._failed()
        local: dict = {"role": "coordinator", "live": not failed,
                       "active_requests": eng.active,
                       "queue_depth": eng.queue_depth}
        if failed:
            local["health"] = {"status": "failed",
                               "reason": self.health_state.reason}
        try:
            from cake_tpu_torch.utils.profiling import device_memory_stats
            keymap = (("bytes_in_use", "bytes_in_use"),
                      ("peak_bytes_in_use", "peak_bytes"),
                      ("bytes_limit", "bytes_limit"))
            local["hbm"] = {
                str(s["device"]): {out: s[src] for src, out in keymap
                                   if s.get(src) is not None}
                for s in device_memory_stats()
                if s.get("bytes_in_use") is not None}
        except Exception:  # noqa: BLE001 — the fleet view is best-effort
            log.debug("local memory stats unavailable", exc_info=True)
        out = {"local_host": local_name, "hosts": {local_name: local}}
        if self.collector is None:
            out["note"] = ("telemetry federation disabled "
                           "(single-host serving, or "
                           "--no-telemetry-export)")
            return out
        remote = self.collector.fleet()
        out["published_seq"] = remote.get("published_seq")
        out["stale_after_s"] = remote.get("stale_after_s")
        if out["published_seq"] is not None:
            local["applied_seq"] = out["published_seq"]
            local["lag_ops"] = 0
        out["hosts"].update(remote.get("hosts", {}))
        return out

    def requests(self, limit: Optional[int] = None,
                 rid: Optional[int] = None, cls: Optional[str] = None,
                 since: Optional[int] = None) -> dict:
        """GET /api/v1/requests: lifecycle traces, active then finished,
        newest first (oldest first with ?since=, a rid cursor); the
        response's cursor is the largest rid returned."""
        recs = self.engine.tracer.dump(limit, rid=rid, cls=cls,
                                       since=since)
        if recs:
            cursor = max(r["rid"] for r in recs)
        else:
            cursor = since if since is not None else 0
        return {"requests": recs, "cursor": cursor}

    def events(self, rid: Optional[int] = None,
               type: Optional[str] = None, since: Optional[int] = None,
               limit: Optional[int] = None,
               host: Optional[str] = None) -> dict:
        """GET /api/v1/events: ascending seq, filtered; the cursor is
        safe to pass back as ?since= (obs/events.EventBus.snapshot).
        ?host= selects a fleet host's stream: this host's name (or
        "local") serves the local bus as the unfiltered call does; a
        remote host's name serves the collector's view (timestamps
        clock-offset corrected, seqs and cursor that host's own). An
        unknown host, or any remote one without a collector, is a
        ValueError (the 400)."""
        local_name = getattr(self.collector, "local_host", None)
        if host is not None and host not in ("local", local_name):
            if self.collector is None:
                raise ValueError(
                    f"?host={host!r}: telemetry federation is "
                    "disabled (no collector); only local events exist")
            known = self.collector.hosts()
            if host not in known:
                raise ValueError(
                    f"unknown host {host!r} (local: "
                    f"{local_name or 'local'}; exporting: "
                    f"{', '.join(known) or 'none yet'})")
            evs, cursor = self.collector.events_page(
                host, rid=rid, type=type, since=since, limit=limit)
            return {"events": evs, "host": host, "cursor": cursor}
        bus = self.engine.events
        if bus is None:
            return {"events": [], "cursor": 0,
                    "note": "event bus disabled (--event-ring 0)"}
        evs, cursor = bus.snapshot(rid=rid, type=type, since=since,
                                   limit=limit)
        out = {"events": evs, "cursor": cursor}
        if host is not None:
            out["host"] = local_name or "local"
        return out

    def drain(self, body: dict) -> dict:
        """POST /api/v1/drain {"timeout_s": N?}: close admissions (new
        submits get 429 with the drain's ETA as Retry-After), let
        in-flight work finish for up to timeout_s (default 30), then run
        start()'s shutdown (stop the engine, save the --checkpoint).
        Answers at once with the drain's state; a second POST reports
        progress."""
        timeout_s = body.get("timeout_s", 30.0)
        if (not isinstance(timeout_s, (int, float))
                or isinstance(timeout_s, bool) or timeout_s <= 0):
            raise ValueError("timeout_s must be a positive number")
        st = self.engine.begin_drain()
        with self._drain_lock:
            if self._drain_thread is None:
                self._drain_thread = threading.Thread(
                    target=self._drain_then_exit, args=(float(timeout_s),),
                    daemon=True, name="cake-drain")
                self._drain_thread.start()
        return st

    def _drain_then_exit(self, timeout_s: float) -> None:
        """The drain thread: wait (bounded) for the queue and the
        in-flight requests to empty, then the shutdown."""
        eng = self.engine
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            st = eng.drain_state()
            if st["pending_requests"] == 0 and st["queue_depth"] == 0:
                break
            time.sleep(0.05)
        else:
            log.warning("drain: timeout after %.1fs with %d request(s) "
                        "still in flight (snapshotted or journaled where "
                        "armed)", timeout_s,
                        eng.drain_state()["pending_requests"])
        if self._shutdown is not None:
            self._shutdown()
        else:
            eng.stop()

    def steps(self, limit: Optional[int] = None) -> dict:
        """GET /api/v1/steps: newest step records first and the summary
        (per-kind counts, captures, decode-side MFU / HBM share)."""
        return {"steps": self.engine.flight.dump(limit),
                "summary": self.engine.flight.summary()}


def make_handler(api: ApiServer):
    """The request handler class of one server. A class is always in a
    reference cycle of its own (its __mro__, its descriptors), and the
    HTTP server keeps it after serve_forever has returned, so it holds
    the ApiServer weakly: the server's end leaves the ApiServer, and the
    engine it wraps, to their refcounts, not to a cyclic collection."""
    api = weakref.proxy(api)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: dict, headers=()):
            data = json.dumps(obj).encode()
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            if code >= 400 and getattr(self, "_trace", None):
                # a router relays non-200s as they are: a refused or
                # failed request still hands its caller the trace id
                self.send_header("x-cake-trace", self._trace)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            api._count(self.path, code)

        def _retry_json(self, code: int, retry_after_s: float, obj: dict):
            """_json with a Retry-After header (whole seconds, ceil'd,
            floor 1), also in the body as retry_after_s."""
            retry = max(1, int(-(-retry_after_s // 1)))
            # x-cake-replica: which replica computed the backpressure
            self._json(code, {**obj, "retry_after_s": retry},
                       headers=[("Retry-After", str(retry)),
                                ("x-cake-replica", str(api.replica_id))])

        def _query(self) -> dict:
            """The first value of each query parameter."""
            if "?" not in self.path:
                return {}
            from urllib.parse import parse_qs
            return {k: v[0] for k, v in
                    parse_qs(self.path.split("?", 1)[1]).items() if v}

        @staticmethod
        def _int_arg(q: dict, key: str):
            """An integer query parameter or None; a malformed one is a
            400 (ignoring ?rid=abc would dump everything)."""
            v = q.get(key)
            if v is None:
                return None
            try:
                return int(v)
            except ValueError:
                raise ValueError(f"?{key}= must be an integer, got {v!r}")

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            try:
                return json.loads(self.rfile.read(n))
            except json.JSONDecodeError:
                raise ValueError("invalid JSON body")

        def _no_engine(self, route: str) -> bool:
            """An image model's server: a route it does not serve is a
            404 (answered here)."""
            if api.engine is not None or route in IMAGE_MODEL_ROUTES:
                return False
            self._json(404, {"error": "not found: this server holds an "
                                      "image model (POST /api/v1/image)"})
            return True

        def do_GET(self):
            # stashed per request: on a keep-alive connection an earlier
            # POST's value must not label this request's errors
            self._trace = self.headers.get("x-cake-trace")
            route = self.path.split("?", 1)[0]
            if self._no_engine(route):
                return
            if route == "/api/v1/health":
                # ?lite=1: the router's cheap poll (any other value: the
                # full document)
                return self._json(200, api.health(
                    lite=self._query().get("lite") == "1"))
            if route == "/api/v1/drain":
                return self._json(200, api.engine.drain_state())
            if route == "/api/v1/requests":
                q = self._query()
                try:
                    cls = q.get("class")
                    if cls is not None:
                        validate_priority(cls)
                    return self._json(200, api.requests(
                        limit=self._int_arg(q, "limit"),
                        rid=self._int_arg(q, "rid"), cls=cls,
                        since=self._int_arg(q, "since")))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
            if route == "/api/v1/events":
                q = self._query()
                try:
                    t = q.get("type")
                    if t is not None and t not in EVENT_TYPES:
                        raise ValueError(
                            f"unknown event type {t!r} (choose one of "
                            f"{', '.join(EVENT_TYPES)})")
                    return self._json(200, api.events(
                        rid=self._int_arg(q, "rid"), type=t,
                        since=self._int_arg(q, "since"),
                        limit=self._int_arg(q, "limit"),
                        host=q.get("host")))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
            if route == "/api/v1/fleet":
                return self._json(200, api.fleet())
            if route == "/api/v1/cluster":
                return self._json(200, api.cluster())
            m = _TIMELINE_RE.match(route)
            if m:
                tl = api.request_timeline(int(m.group(1)))
                if tl is None:
                    return self._json(404, {
                        "error": f"unknown rid {m.group(1)} (not admitted, "
                                 "or out of the finished-trace ring)"})
                return self._json(200, tl)
            if route == "/api/v1/steps":
                try:
                    return self._json(200, api.steps(
                        self._int_arg(self._query(), "limit")))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
            if route == "/api/v1/anomalies":
                try:
                    return self._json(200, api.anomalies(
                        self._int_arg(self._query(), "limit")))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
            if route == "/api/v1/autotune":
                return self._json(200, api.autotune())
            if route in ("/metrics", "/api/v1/metrics"):
                data = api.metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                api._count(self.path, 200)
                return
            if route in ("/v1/models", "/api/v1/models"):
                # OpenAI client compatibility: SDKs list models on init
                return self._json(200, {
                    "object": "list",
                    "data": [{"id": api.model_name, "object": "model",
                              "created": api.started_at,
                              "owned_by": "cake-tpu"}],
                })
            self._json(404, {"error": "not found"})

        def do_POST(self):
            self._stream_started = False
            # for the error paths' x-cake-trace echo; a stream sends it
            # with its headers
            self._trace = self.headers.get("x-cake-trace")
            if self._no_engine(self.path):
                return
            try:
                body = self._read_body()
                if self.path == "/api/v1/drain":
                    # before the health gate: draining a failed server
                    # is how an operator evacuates it
                    return self._json(200, api.drain(body))
                # after the body read: answering early would leave body
                # bytes unread on this keep-alive connection
                if api._failed():
                    # fail fast instead of queueing work onto a dead mesh
                    return self._json(503, {
                        "error": "serving failed: "
                                 f"{api.health_state.reason}"})
                if self.path in ("/api/v1/chat/completions",
                                 "/v1/chat/completions"):
                    return self._chat(body)
                if self.path == "/api/v1/profile":
                    try:
                        return self._json(200, api.profile(body))
                    except obs_steps.ProfileBusyError as e:
                        return self._json(409, {"error": str(e)})
                if self.path == "/api/v1/image":
                    return self._json(200, api.image(body))
                if self.path == "/api/v1/autotune":
                    try:
                        return self._json(200, api.autotune_switch(body))
                    except SwitchInFlightError as e:
                        # one switch at a time: the client retries after
                        # the one in flight lands
                        return self._json(409, {"error": str(e)})
                return self._json(404, {"error": "not found"})
            except ValueError as e:
                if not self._stream_started:
                    self._json(400, {"error": str(e)})
            except QueueFull as e:
                if not self._stream_started:
                    # 429 with the computed Retry-After: the seconds
                    # until the class's backlog drains inside its SLO at
                    # the measured rate (sched/shed.py), 1 s otherwise
                    self._retry_json(429, e.retry_after, {
                        "error": ("server draining: admissions are closed"
                                  if e.draining
                                  else "request shed: server saturated for "
                                  "this priority class" if e.shed
                                  else "queue full")})
            except EngineRequestError as e:
                log.warning("engine failed request: %s", e)
                if self._stream_started:
                    return  # the stream already carried its error event
                if not e.retryable:
                    return self._json(500, {"error": str(e),
                                            "retryable": False})
                # body["priority"] holds the merged body/header class
                self._retry_json(
                    503, api._engine_retry_after(body.get("priority")),
                    {"error": str(e), "retryable": True})
            except Exception as e:  # noqa: BLE001
                log.exception("request failed")
                if not self._stream_started:
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _chat(self, body: dict):
            # x-cake-priority names the class for clients that cannot
            # edit the body; a body "priority" wins (a JSON null counts
            # as unset)
            hdr = self.headers.get("x-cake-priority")
            if hdr is not None and body.get("priority") is None:
                body["priority"] = hdr
            # durable serving: a retried submit with the same
            # x-cake-idempotency-key attaches to its stream; on a
            # streaming reconnect Last-Event-ID (the standard SSE resume
            # header) replays exactly the missing suffix
            idem_key = self.headers.get("x-cake-idempotency-key")
            last_id = self.headers.get("Last-Event-ID")
            # x-cake-trace (minted by a front-door router or a client):
            # threaded to the engine's tracer and event bus, sent back
            # with a stream's headers and on error responses
            trace = self.headers.get("x-cake-trace")
            if last_id is not None:
                try:
                    last_id = int(last_id)
                except ValueError:
                    raise ValueError(
                        f"Last-Event-ID must be an integer event id, "
                        f"got {last_id!r}")
                if idem_key is None:
                    raise ValueError(
                        "Last-Event-ID resume requires "
                        "x-cake-idempotency-key (the key names the "
                        "stream across reconnects and restarts)")
            if not body.get("stream"):
                return self._json(200, api.chat(body,
                                                idempotency_key=idem_key,
                                                trace_id=trace))

            def on_start(rid):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                # before any token: which replica serves the stream,
                # under which trace, as which engine rid (a router joins
                # the trace to this replica's timeline through the rid)
                self.send_header("x-cake-replica", str(api.replica_id))
                if trace is not None:
                    self.send_header("x-cake-trace", trace)
                if rid is not None:
                    self.send_header("x-cake-rid", str(rid))
                self.end_headers()
                self._stream_started = True

            def send_chunk(obj: dict, event_id=None):
                # a keyed stream is resumable: its `id:` field is the
                # absolute token position the event covers up to, which
                # a reconnect echoes as Last-Event-ID (an unkeyed stream
                # cannot be resumed and carries none)
                head = (f"id: {int(event_id)}\n"
                        if event_id is not None and idem_key is not None
                        else "")
                payload = f"{head}data: {json.dumps(obj)}\n\n".encode()
                self.wfile.write(hex(len(payload))[2:].encode() + b"\r\n")
                self.wfile.write(payload + b"\r\n")
                self.wfile.flush()

            if api.chat(body, send_chunk=send_chunk, on_start=on_start,
                        idempotency_key=idem_key, last_event_id=last_id,
                        trace_id=trace) is DISCONNECTED:
                return
            done = b"data: [DONE]\n\n"
            self.wfile.write(hex(len(done))[2:].encode() + b"\r\n")
            self.wfile.write(done + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return Handler


def start(master, address: str = "127.0.0.1:10128",
          model_name: str = "cake-tpu", block: bool = True, engine=None,
          checkpoint_path: Optional[str] = None, collector=None,
          health=None, announce: Optional[str] = None,
          announce_interval_s: float = 2.0,
          announce_token: Optional[str] = None):
    """Bind and serve. Without `engine`, one is built from the master
    (`master.make_engine()`), except for an image model's master (an
    image generator and no text generator), which is served with no
    engine. With block=False the server runs on a daemon thread and the bound ThreadingHTTPServer is returned: its
    shutdown() stops serving and runs the shutdown below.

    checkpoint_path (--checkpoint): arms the engine's pre-fail snapshot,
    restores the in-flight requests a previous process saved, and saves
    the engine's requests at shutdown. With the engine's --journal, the
    journal is replayed at startup over that checkpoint
    (serve/journal.recover). A snapshot or journal that cannot be
    resumed (another package's, other weights) is moved to *.invalid
    and the engine starts empty.

    The shutdown (SIGTERM when block=True, POST /api/v1/drain, or the
    server's end) closes admissions, stops the engine, then saves the checkpoint;
    without a checkpoint or a journal the requests still held fail with
    a retryable error.

    collector: an obs/federation.TelemetryCollector whose remote views
    the fleet route, ?host= events, /metrics and request timelines
    read.

    health: a parallel/health.ServingHealth (multi-process serving
    passes one watching the followers' heartbeats); without one, one is
    armed over the engine with --stall-timeout's watchdog, always.

    announce: a front-door router's announce listener ("host:port",
    --router-announce): this replica registers itself there and ships
    frames of its lite health (and more) every announce_interval_s
    (router/discovery.ReplicaAnnouncer); the shutdown sends the
    departure notice first, so the router stops routing new work here
    while the streams in flight finish."""
    import os

    from cake_tpu_torch.serve import checkpoint as ckpt
    from cake_tpu_torch.serve.errors import EngineResetError

    host, port = address.rsplit(":", 1)
    image_model = engine is None and getattr(master, "llm", None) is None \
        and getattr(master, "image", None) is not None
    if image_model and checkpoint_path:
        raise ValueError("--checkpoint saves a text engine's requests; an "
                         "image model's server has none")
    if engine is None and not image_model:
        engine = master.make_engine()
    journal_armed = engine is not None and engine._journal is not None
    if checkpoint_path or journal_armed:
        # the weights' digest now, while the card is healthy: the
        # failure path's snapshot (and the journal's header) must not
        # read the device
        if checkpoint_path:
            engine.snapshot_path = checkpoint_path
        ckpt.warm_fingerprint(engine)
    if health is None and engine is not None:
        from cake_tpu_torch.parallel.health import ServingHealth
        health = ServingHealth(engine, stall_after_s=getattr(
            getattr(master, "args", None), "stall_timeout", 600.0))
    api = ApiServer(master, model_name, engine=engine, collector=collector,
                    health=health, replica_id=address)
    if journal_armed:
        from cake_tpu_torch.serve import journal as jr
        try:
            handles, _ = jr.recover(engine, checkpoint_path=checkpoint_path,
                                    strict=True)
            if handles:
                log.info("journal replay resubmitted %d in-flight "
                         "request(s)", len(handles))
        except Exception as e:  # noqa: BLE001
            # an unusable journal or checkpoint must not crash-loop the
            # startup: keep the evidence beside it
            jpath = engine._journal.path
            for p in (checkpoint_path, jpath, jpath + ".replaying"):
                if p and os.path.exists(p):
                    try:
                        os.replace(p, p + ".invalid")
                    except OSError:
                        pass
            log.warning("journal/checkpoint replay failed (%s); sidelined "
                        "to *.invalid, starting with an empty engine", e)
    elif checkpoint_path and os.path.exists(checkpoint_path):
        try:
            handles, _ = ckpt.restore(engine, checkpoint_path, strict=True)
            log.info("restored %d in-flight request(s) from %s",
                     len(handles), checkpoint_path)
        except Exception as e:  # noqa: BLE001
            bad = f"{checkpoint_path}.invalid"
            try:
                os.replace(checkpoint_path, bad)
            except OSError:
                bad = checkpoint_path
            log.warning("checkpoint restore failed (%s); moved to %s, "
                        "starting with an empty engine", e, bad)
    httpd = ThreadingHTTPServer((host, int(port)), make_handler(api))
    httpd.daemon_threads = True
    log.info("REST API listening on %s:%d", host, httpd.server_address[1])
    announcer = None
    if announce is not None:
        from cake_tpu_torch.router.discovery import ReplicaAnnouncer
        # the announced name is the router's proxy target: the bound
        # port (a port-0 bind resolves here) and a concrete host where
        # the bind was a wildcard
        ahost = host if host not in ("", "0.0.0.0", "::") else "127.0.0.1"
        announcer = ReplicaAnnouncer(
            announce, f"{ahost}:{httpd.server_address[1]}",
            token=announce_token, interval_s=announce_interval_s,
            health=lambda: api.health(lite=True), engine=engine)
        log.info("announcing to router at %s as %s", announce,
                 announcer.replica)
    done = threading.Event()

    def save_and_exit(*_sig):
        if done.is_set():
            return
        done.set()
        if announcer is not None:
            # the router hears the departure first: no new work comes
            # here while the streams in flight finish
            announcer.depart()
        if engine is None:
            if announcer is not None:
                announcer.close()
            threading.Thread(target=httpd.shutdown, daemon=True).start()
            return
        # close admissions (new submits get the drain's 429 instead of
        # racing the stop), stop the engine, then save; shutdown() runs
        # on a helper thread (from the serving thread it deadlocks)
        engine.begin_drain()
        engine.stop()
        if engine._postmortem is not None:
            # the black-box bundle on the termination path too: the
            # engine thread is stopped, so every ring is final
            engine._postmortem.dump("sigterm", engine=engine, force=True)
        if checkpoint_path:
            engine.shutdown_save(checkpoint_path)
        elif not journal_armed:
            # nothing resumes these after a restart
            engine._fail_all(EngineResetError(
                "server stopped while this request was in flight"))
        if announcer is not None:
            # the terminal frame: the departure again, with the drained
            # (zero-load) health, the router's condition to forget
            announcer.close()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    api._shutdown = save_and_exit
    if block:
        # the serving process's SIGTERM (a block=False caller embeds the
        # server and owns its signals; a handler would also keep every
        # engine it ever started alive)
        try:
            import signal

            prev_handler = signal.getsignal(signal.SIGTERM)

            def on_sigterm(signum, frame):
                save_and_exit()
                # chain the handler that was there before
                if callable(prev_handler):
                    prev_handler(signum, frame)
                elif prev_handler == signal.SIG_DFL:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    signal.raise_signal(signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass  # not the main thread: the caller owns signals

    def serve(owner: ApiServer):
        # the serving thread holds the ApiServer (`owner`; the handler
        # class holds it weakly) for as long as it serves, and no longer
        try:
            httpd.serve_forever()
        finally:
            save_and_exit()
            if health is not None:
                health.close()
            del owner

    if block:
        serve(api)
    else:
        threading.Thread(target=serve, args=(api,), daemon=True,
                         name="cake-http").start()
    return httpd
