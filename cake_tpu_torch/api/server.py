"""Threaded HTTP server exposing the OpenAI-compatible text API.

Counterpart of `cake_tpu/api/server.py`, with its text and
observability routes:

  POST /api/v1/chat/completions (and the /v1/chat/completions alias):
       buffered JSON, or SSE `chat.completion.chunk`s with "stream": true;
       the request's class in the body's "priority" or the
       x-cake-priority header (the body wins; an unknown class is a 400)
  GET  /v1/models (and /api/v1/models), GET /api/v1/health
  GET  /metrics and /api/v1/metrics: the Prometheus text exposition
  GET  /api/v1/requests (?limit, ?rid, ?class, ?since): lifecycle traces
  GET  /api/v1/steps (?limit): the step flight recorder
  GET  /api/v1/events (?rid, ?type, ?since, ?limit): the event bus

Every chat request goes through the continuous-batching engine, so N
requests decode together; a full queue or a shed request answers 429
with the computed Retry-After, an engine failure 503 (retryable) or 500.
Not ported yet: the profile, fleet, drain, anomalies, autotune, cluster
and timeline routes.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from cake_tpu_torch.api.openai import (
    chunk_response, completion_response, parse_chat_request,
)
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import steps as obs_steps
from cake_tpu_torch.obs.events import EVENT_TYPES
from cake_tpu_torch.sched import ShedError, validate_priority
from cake_tpu_torch.serve.engine import QueueFullError
from cake_tpu_torch.serve.errors import EngineRequestError

log = logging.getLogger(__name__)

# routes worth a per-route counter series; anything else collapses into
# "other", so a 404 spray cannot grow the label set
KNOWN_ROUTES = frozenset({
    "/api/v1/chat/completions", "/v1/chat/completions",
    "/api/v1/health", "/v1/models", "/api/v1/models", "/metrics",
    "/api/v1/metrics", "/api/v1/requests", "/api/v1/steps",
    "/api/v1/events",
})


class QueueFull(Exception):
    """Admission refused: the queue is full, or (shed=True) load
    shedding refused it; retry_after seconds ride the 429's
    Retry-After."""

    def __init__(self, retry_after: float = 1.0, shed: bool = False):
        super().__init__("request shed" if shed else "queue full")
        self.retry_after = retry_after
        self.shed = shed

# chat() return sentinel: the streaming client went away (handled; the
# HTTP layer must not touch the dead socket again)
DISCONNECTED = object()


class ApiServer:
    """Wraps a Master and its engine: chat requests batch continuously."""

    def __init__(self, master, model_name: str = "cake-tpu", engine=None):
        if engine is None:
            raise ValueError("the port serves through the batching engine "
                             "only: pass engine=master.make_engine()")
        self.master = master
        self.model_name = model_name
        self.engine = engine
        self.started_at = int(time.time())  # /v1/models "created"
        self._m_http = obs_metrics.counter(
            "cake_http_requests_total",
            "HTTP requests served, by route and status code",
            labelnames=("route", "status"))
        engine.start()

    def _count(self, path: str, code: int) -> None:
        route = path.split("?", 1)[0]
        if route not in KNOWN_ROUTES:
            route = "other"
        self._m_http.labels(route=route, status=str(code)).inc()

    def _submit(self, messages, kw):
        """engine.chat, its refusals as QueueFull (429)."""
        try:
            return self.engine.chat(messages, **kw)
        except (QueueFullError, ShedError) as e:
            raise QueueFull(getattr(e, "retry_after", 1.0),
                            shed=isinstance(e, ShedError))

    def chat(self, body: dict, send_chunk=None,
             on_start=None) -> Optional[dict]:
        """Run one chat completion. With send_chunk, stream deltas through
        it and return None (or DISCONNECTED); else return the response
        dict. `on_start` fires after admission and before any token, so
        a queue rejection (QueueFullError) still surfaces as a clean
        429."""
        messages, opts = parse_chat_request(body)
        want_lp = bool(opts.get("logprobs"))
        n_top = opts.get("top_logprobs") or 0
        kw = dict(
            max_new_tokens=opts["max_tokens"] or self.master.args.sample_len,
            temperature=opts["temperature"],
            top_p=opts["top_p"],
            want_top_logprobs=n_top > 0,
            priority=opts.get("priority"),
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

        if send_chunk is None:
            h = self._submit(messages, kw)
            h.wait()
            text = h.text()   # raises the typed error if the engine failed
            lp = None
            if want_lp:
                lp = [lp_entry(t, l, top) for (t, l), top
                      in zip(h.token_logprobs, h.token_top_logprobs)]
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
            on_start()
        r = h._req
        eos_ids = self.engine.config.eos_token_ids
        lp_cursor = 0

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

        while True:
            try:
                delta, final, n_done = deltas.get(timeout=0.5)
            except queue.Empty:
                if r.done.is_set() and deltas.empty():
                    break  # request ended without a final delta (error)
                continue
            if delta:
                try:
                    send_chunk(chunk_response(delta, self.model_name,
                                              rid=rid,
                                              logprobs=chunk_lp(n_done)))
                except OSError:
                    # client disconnected mid-stream: free the slot now
                    log.info("client disconnected; cancelling request")
                    self.engine.cancel(h)
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
                                      logprobs=chunk_lp(len(r.out_tokens))))
        except OSError:
            return DISCONNECTED
        return None

    def health(self) -> dict:
        """/api/v1/health: engine occupancy, per-class queue depths (SLO
        scheduling on), pool pages, SLO accounting and throughput."""
        eng = self.engine
        st = eng.stats
        out = {
            "status": "ok",
            "model": self.model_name,
            "device": str(eng.device),
            "queue_depth": eng.queue_depth,
            "active_requests": eng.active,
            "decode_slots": eng.max_slots,
        }
        depths = getattr(eng.scheduler, "class_depths", None)
        if depths is not None:
            out["queue_depth_by_class"] = depths()
        out.update(
            page_size=eng.cache.page_size,
            pages_free=eng._pager.free_pages,
            pages_total=eng.cache.n_pages,
            paged_attn=eng.paged_attn,
            slo=eng.slo.snapshot(),
            requests_completed=st.requests_completed,
            tokens_generated=st.tokens_generated,
            decode_tokens_per_s=round(st.decode_tokens_per_s, 2),
            errors=st.errors,
        )
        if depths is not None:
            out["preemptions"] = st.preemptions
            out["requests_shed"] = st.shed
        return out

    def metrics(self) -> str:
        """Prometheus text exposition: the registry's families, with the
        engine's aggregate counters synced at scrape time (one scrape =
        one snapshot of EngineStats), as the JAX server renders them."""
        m = obs_metrics
        obs_steps.refresh_device_gauges()
        eng = self.engine
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
        eng._set_queue_gauges()
        obs_steps.refresh_page_gauges(eng)
        eng.slo.refresh_gauges()
        return m.REGISTRY.render()

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
               limit: Optional[int] = None) -> dict:
        """GET /api/v1/events: ascending seq, filtered; the cursor is
        safe to pass back as ?since= (obs/events.EventBus.snapshot)."""
        bus = self.engine.events
        if bus is None:
            return {"events": [], "cursor": 0,
                    "note": "event bus disabled (--event-ring 0)"}
        evs, cursor = bus.snapshot(rid=rid, type=type, since=since,
                                   limit=limit)
        return {"events": evs, "cursor": cursor}

    def steps(self, limit: Optional[int] = None) -> dict:
        """GET /api/v1/steps: newest step records first and the summary
        (per-kind counts, captures, decode-side MFU / HBM share)."""
        return {"steps": self.engine.flight.dump(limit),
                "summary": self.engine.flight.summary()}


def make_handler(api: ApiServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: dict, headers=()):
            data = json.dumps(obj).encode()
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            api._count(self.path, code)

        def _retry_json(self, code: int, retry_after_s: float, obj: dict):
            """_json with a Retry-After header (whole seconds, ceil'd,
            floor 1), also in the body as retry_after_s."""
            retry = max(1, int(-(-retry_after_s // 1)))
            self._json(code, {**obj, "retry_after_s": retry},
                       headers=[("Retry-After", str(retry))])

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

        def do_GET(self):
            route = self.path.split("?", 1)[0]
            if route == "/api/v1/health":
                return self._json(200, api.health())
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
                        limit=self._int_arg(q, "limit")))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
            if route == "/api/v1/steps":
                try:
                    return self._json(200, api.steps(
                        self._int_arg(self._query(), "limit")))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
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
            try:
                body = self._read_body()
                if self.path in ("/api/v1/chat/completions",
                                 "/v1/chat/completions"):
                    return self._chat(body)
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
                        "error": ("request shed: server saturated for "
                                  "this priority class" if e.shed
                                  else "queue full")})
            except EngineRequestError as e:
                log.warning("engine failed request: %s", e)
                if self._stream_started:
                    return  # the stream already carried its error event
                if not e.retryable:
                    return self._json(500, {"error": str(e),
                                            "retryable": False})
                self._json(503, {"error": str(e), "retryable": True},
                           headers=[("Retry-After", "1")])
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
            if not body.get("stream"):
                return self._json(200, api.chat(body))

            def on_start():
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._stream_started = True

            def send_chunk(obj: dict):
                payload = f"data: {json.dumps(obj)}\n\n".encode()
                self.wfile.write(hex(len(payload))[2:].encode() + b"\r\n")
                self.wfile.write(payload + b"\r\n")
                self.wfile.flush()

            if api.chat(body, send_chunk=send_chunk,
                        on_start=on_start) is DISCONNECTED:
                return
            done = b"data: [DONE]\n\n"
            self.wfile.write(hex(len(done))[2:].encode() + b"\r\n")
            self.wfile.write(done + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return Handler


def start(master, address: str = "127.0.0.1:10128",
          model_name: str = "cake-tpu", block: bool = True, engine=None):
    """Bind and serve. Without `engine`, one is built from the master
    (`master.make_engine()`). With block=False the server runs on a
    daemon thread and the bound ThreadingHTTPServer is returned: its
    shutdown() stops serving, then stops the engine and fails whatever
    it still held with a retryable error."""
    host, port = address.rsplit(":", 1)
    if engine is None:
        engine = master.make_engine()
    api = ApiServer(master, model_name, engine=engine)
    httpd = ThreadingHTTPServer((host, int(port)), make_handler(api))
    httpd.daemon_threads = True
    log.info("REST API listening on %s:%d", host, httpd.server_address[1])

    def serve():
        try:
            httpd.serve_forever()
        finally:
            engine.stop()
            from cake_tpu_torch.serve.errors import EngineResetError
            engine._fail_all(EngineResetError(
                "server stopped while this request was in flight"))

    if block:
        serve()
    else:
        threading.Thread(target=serve, daemon=True,
                         name="cake-http").start()
    return httpd
