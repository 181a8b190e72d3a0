"""Threaded HTTP server exposing the OpenAI-compatible text API.

Counterpart of `cake_tpu/api/server.py`, text routes only:

  POST /api/v1/chat/completions (and the /v1/chat/completions alias):
       buffered JSON, or SSE `chat.completion.chunk`s with "stream": true
  GET  /v1/models (and /api/v1/models), GET /api/v1/health

Every chat request goes through the continuous-batching engine, so N
requests decode together; a full queue answers 429 + Retry-After, an
engine failure 503 (retryable) or 500.
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
from cake_tpu_torch.serve.engine import QueueFullError
from cake_tpu_torch.serve.errors import EngineRequestError

log = logging.getLogger(__name__)

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
        engine.start()

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
            h = self.engine.chat(messages, **kw)
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
        h = self.engine.chat(messages, stream=stream, **kw)
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
        """/api/v1/health: engine occupancy, pool pages and throughput."""
        eng = self.engine
        st = eng.stats
        return {
            "status": "ok",
            "model": self.model_name,
            "device": str(eng.device),
            "queue_depth": eng.queue_depth,
            "active_requests": eng.active,
            "decode_slots": eng.max_slots,
            "page_size": eng.cache.page_size,
            "pages_free": eng._pager.free_pages,
            "pages_total": eng.cache.n_pages,
            "paged_attn": eng.paged_attn,
            "requests_completed": st.requests_completed,
            "tokens_generated": st.tokens_generated,
            "decode_tokens_per_s": round(st.decode_tokens_per_s, 2),
            "errors": st.errors,
        }


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
            except QueueFullError as e:
                if not self._stream_started:
                    retry = max(1, int(-(-e.retry_after // 1)))
                    self._json(429, {"error": "queue full",
                                     "retry_after_s": retry},
                               headers=[("Retry-After", str(retry))])
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
