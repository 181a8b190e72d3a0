"""Disaggregated prefill/decode: ship KV pages over the wire.

Counterpart of `cake_tpu/kv/transfer.py`. Prefill bursts steal card
time and pool pages from resident decode streams; the mixed step only
papers over the interference on one card. This module is the data plane
that splits the two phases onto separate engines: a token-gated,
length-prefixed page channel (the utils/wire.py framing the telemetry
plane speaks too) that ships raw pool slices and scale sidecars
dtype-blind through the host_tier.py fetch/install seam. f32, bf16,
fp8, int8 and int4 pages round-trip bit-identical, and a quantized
shipment moves ~4x (int8) / ~8x (int4) fewer bytes than f32 for the
same prefix.

Roles (``--disagg {prefill,decode}`` + ``--disagg-peer host:port``):

  * the DECODE engine is the front door: an admitted request is held
    out of the scheduler while ``DisaggDecodePlane`` forwards its
    prompt to the prefill peer; the shipped pages install through the
    refcounted allocator and the stream adopts at the shipped frontier
    (engine._adopt_install, the _restore_victim shape), serving SSE
    from the first decoded token;
  * the PREFILL engine (``DisaggPrefillPlane``) admits the forwarded
    prompt as a stock max_new_tokens=1 request (its prompt prefilled
    into pool pages, the first token sampled), then fetches the written
    pages at retirement (engine._capture_shipment) and ships them with a
    journal-style handoff record before the allocator frees them.

Wire shape, byte-identical to the JAX package's (so either package's
prefill host ships to either package's decode host): every frame is one
length-prefixed message whose payload is ``!I`` header-length + JSON
header + raw binary tail. A shipment is ``ship_begin`` (geometry,
dtype, array specs, handoff record), N ``ship_chunk`` frames, chunked
along the layer axis at ~1 MiB, each carrying (config epoch, layer
range, page ids, dtype, crc32), and ``ship_end``; ``ship_fail``
aborts. Arrays are torch tensors here and go on the wire as their raw
bytes (``view(torch.uint8)``: bf16 and fp8 have no numpy dtype), named
by JAX's dtype strings ("float32", "bfloat16", "float8_e4m3fn",
"int8", "uint8", ...); an unknown name is refused through the port's
own table (`DTYPES`). The receiver resumes partial frames across recv
timeouts and refuses checksum or config-epoch mismatches loudly.

On the card nothing here waits for the stream on the engine thread:
the prefill host's fetch fills pinned tensors with non-blocking copies
and records a CUDA event after them (`Shipment.ready`); the plane's
writer thread waits on that event before it reads, checksums or sends a
byte. The decode plane assembles a shipment straight into pinned host
tensors, so the decode host's install is a true asynchronous upload.

Failure is first-class: fault sites ``kv.ship``/``kv.adopt``
(faults/plan.py) inject at the capture/install seams, and every
channel failure (peer down, timeout, corrupt or stale shipment)
degrades to whole-prompt prefill on the decode host instead of wedging
the stream.

Metrics (obs/metrics.py registry, the JAX package's names and help):
  cake_kv_ship_total{dir}          counter  shipments sent | received
  cake_kv_ship_bytes_total{dtype}  counter  page bytes over the wire
  cake_kv_ship_seconds             histogram wall seconds per shipment
  cake_kv_adopt_total{outcome}     counter  adoption outcomes
"""

from __future__ import annotations

import hmac
import json
import logging
import queue
import socket
import struct
import threading
import time
import weakref
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.utils.wire import LEN, recv_bounded_msg, send_msg

log = logging.getLogger(__name__)

_SHIP_TOTAL = obs_metrics.counter(
    "cake_kv_ship_total",
    "KV page shipments over the disaggregated transfer channel, by "
    "direction (out = prefill host sent, in = decode host received "
    "intact)",
    labelnames=("dir",))
_SHIP_BYTES = obs_metrics.counter(
    "cake_kv_ship_bytes_total",
    "KV page payload bytes sent over the transfer channel, by pool "
    "storage dtype (int8/int4 shipments move the quantized pages + "
    "scale sidecars — ~4x/~8x fewer bytes than f32)",
    labelnames=("dtype",))
_SHIP_SECONDS = obs_metrics.histogram(
    "cake_kv_ship_seconds",
    "Wall seconds to encode and send one complete KV page shipment "
    "(prefill-host writer thread, ship_begin through ship_end)")
_ADOPT_TOTAL = obs_metrics.counter(
    "cake_kv_adopt_total",
    "Shipped-prefill adoption outcomes on the decode host (adopted = "
    "pages installed and the stream resumed at the shipped frontier; "
    "degraded/timeout/checksum/epoch/geometry/fault/error = the "
    "documented fall-back to whole-prompt local prefill)",
    labelnames=("outcome",))


def note_adopt(outcome: str) -> None:
    """One adoption outcome (engine._adopt_install / the decode plane
    degradation paths): the single writer for cake_kv_adopt_total."""
    _ADOPT_TOTAL.labels(outcome=outcome).inc()


# frame geometry: chunk blobs target ~1 MiB so a long prefix streams
# as a handful of frames (never one giant allocation at the receiver);
# the recv cap bounds what a corrupt/hostile length prefix can make us
# buffer. Hello frames are tiny and separately capped.
CHUNK_BYTES = 1 << 20
MAX_FRAME_BYTES = 64 << 20
HELLO_BYTES = 256
HELLO_TIMEOUT_S = 5.0

_HDR = struct.Struct("!I")

# the wire's array dtype names (numpy's and JAX's spelling) and the
# torch dtypes they stand for: the one table both directions go through
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
    "uint8": torch.uint8,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def dtype_name(t: torch.Tensor) -> str:
    """A tensor's wire dtype name; a dtype outside `DTYPES` raises."""
    try:
        return _NAMES[t.dtype]
    except KeyError:
        raise ValueError(f"no wire name for {t.dtype}") from None


def _layer_bytes(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU tensor's bytes as a [L, bytes a layer] uint8
    array (a view where the tensor allows one)."""
    t = t.contiguous()
    return t.view(torch.uint8).numpy().reshape(t.shape[0], -1)


def encode_frame(header: dict, blob: bytes = b"") -> bytes:
    """One channel frame payload: header-length + JSON header + raw
    binary tail (empty for control messages)."""
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return _HDR.pack(len(hdr)) + hdr + blob


def decode_frame(payload: bytes) -> Tuple[dict, bytes]:
    """Inverse of encode_frame; raises ValueError on anything
    malformed (a corrupt frame must refuse loudly, never mis-slice)."""
    if len(payload) < _HDR.size:
        raise ValueError("transfer frame shorter than its header length")
    (n,) = _HDR.unpack(payload[:_HDR.size])
    if not 0 < n <= len(payload) - _HDR.size:
        raise ValueError(f"transfer frame header length {n} out of "
                         f"bounds for a {len(payload)}-byte payload")
    try:
        header = json.loads(payload[_HDR.size:_HDR.size + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"transfer frame header is not JSON: {e}")
    if not isinstance(header, dict) or "t" not in header:
        raise ValueError("transfer frame header missing its type tag")
    return header, payload[_HDR.size + n:]


@dataclass
class Shipment:
    """One prefilled prompt's KV pages in flight: the raw pool slices
    (host_tier.fetch_pages layout: quantized pools ship (k_q, k_scale,
    v_q, v_scale), plain pools (k, v)) plus everything the decode host
    needs to adopt the stream at the shipped frontier. ``epoch`` is the
    DECODE host's config epoch, echoed from its prefill request: a
    reconfigure while the shipment was in flight makes it stale and
    adoption refuses it. ``ready`` (prefill host, on the card): the CUDA
    event recorded after the fetch's copies; `wait` blocks on it before
    any byte is read."""

    epoch: int
    dtype: str            # pool_dtype_name: "int8" | "int4" | a dtype name
    page_size: int
    n_tokens: int         # prompt tokens whose KV the pages hold
    n_written: int        # pages with content == ceil(n_tokens/page_size)
    first_tok: int        # sampled on the prefill host; emitted verbatim
    pages: List[int]      # prefill-host page ids (diagnostic provenance)
    arrays: Tuple[torch.Tensor, ...]
    handoff: dict = field(default_factory=dict)
    ready: object = field(default=None, repr=False, compare=False)

    @property
    def payload_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays)

    def wait(self) -> None:
        """Block until the fetch's copies have landed (no-op off the
        card)."""
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None


def validate_shipment_header(h: dict) -> None:
    """Refuse malformed ship_begin metadata loudly (ValueError) before
    allocating receive buffers: geometry that cannot describe a real
    pool slice (an int4 pool with an odd page size: nibble packing
    holds two tokens per byte; a written-page count that disagrees with
    the token count; a page axis that disagrees with both) or an array
    dtype outside `DTYPES`."""
    page_size = int(h["page_size"])
    n_tokens = int(h["n_tokens"])
    n_written = int(h["n_written"])
    if page_size < 1 or n_tokens < 1 or n_written < 1:
        raise ValueError(
            f"shipment geometry must be positive (page_size={page_size}"
            f", n_tokens={n_tokens}, n_written={n_written})")
    if h["dtype"] == "int4" and page_size % 2:
        raise ValueError(
            f"int4 pages nibble-pack two tokens per byte; odd "
            f"page_size {page_size} is not valid int4 metadata")
    if n_written != -(-n_tokens // page_size):
        raise ValueError(
            f"n_written {n_written} != ceil({n_tokens}/{page_size}) — "
            "the shipment does not cover exactly the prompt's pages")
    specs = h["arrays"]
    if not specs:
        raise ValueError("shipment carries no arrays")
    L = int(specs[0]["shape"][0])
    for spec in specs:
        shape = [int(d) for d in spec["shape"]]
        if len(shape) < 2 or shape[0] != L or shape[1] != n_written:
            raise ValueError(
                f"array spec {shape} does not match the shipment "
                f"geometry [L={L}, n_pages={n_written}, ...]")
        if spec["dtype"] not in DTYPES:
            raise ValueError(
                f"unknown array dtype {spec['dtype']!r} (the wire knows "
                f"{', '.join(DTYPES)})")
    if not isinstance(h.get("pages"), list) \
            or len(h["pages"]) != n_written:
        raise ValueError("shipment page-id list disagrees with "
                         "n_written")


def shipment_frames(ship: Shipment, tag: int):
    """Yield the encoded frames for one shipment: ship_begin, the
    layer-range chunks, ship_end. Chunks slice every array along the
    layer axis together so the receiver scatters each chunk straight
    into its preallocated buffers. Waits for the fetch first
    (`Shipment.wait`)."""
    ship.wait()
    arrays = [_layer_bytes(a) for a in ship.arrays]
    L = int(arrays[0].shape[0])
    per_layer = sum(a.shape[1] for a in arrays) or 1
    step = max(1, CHUNK_BYTES // per_layer)
    ranges = [(lo, min(lo + step, L)) for lo in range(0, L, step)]
    yield encode_frame({
        "t": "ship_begin", "tag": tag, "epoch": ship.epoch,
        "dtype": ship.dtype, "page_size": ship.page_size,
        "n_tokens": ship.n_tokens, "n_written": ship.n_written,
        "first_tok": ship.first_tok, "pages": list(ship.pages),
        "arrays": [{"shape": list(a.shape), "dtype": dtype_name(a)}
                   for a in ship.arrays],
        "n_chunks": len(ranges), "handoff": dict(ship.handoff),
    })
    for seq, (lo, hi) in enumerate(ranges):
        blob = b"".join(a[lo:hi].tobytes() for a in arrays)
        yield encode_frame({
            "t": "ship_chunk", "tag": tag, "seq": seq,
            "epoch": ship.epoch, "dtype": ship.dtype,
            "layer_lo": lo, "layer_hi": hi, "pages": list(ship.pages),
            "crc": zlib.crc32(blob) & 0xFFFFFFFF,
        }, blob)
    yield encode_frame({"t": "ship_end", "tag": tag,
                        "n_chunks": len(ranges)})


class ShipmentAssembler:
    """Receive-side reassembly of one shipment: preallocates the
    tensors from the ship_begin specs (pinned with `pin`, so the decode
    host's install uploads asynchronously), scatters each chunk's layer
    range, and refuses (ValueError; the caller degrades) checksum
    mismatches, config-epoch drift between frames, out-of-order or
    mis-sized chunks, and invalid (e.g. odd-page int4) metadata."""

    def __init__(self, begin: dict, pin: bool = False):
        validate_shipment_header(begin)
        self.begin = begin
        self.epoch = int(begin["epoch"])
        self.n_chunks = int(begin["n_chunks"])
        self.next_seq = 0
        self.arrays = tuple(
            torch.empty([int(d) for d in spec["shape"]],
                        dtype=DTYPES[spec["dtype"]], pin_memory=pin)
            for spec in begin["arrays"])
        self.L = int(begin["arrays"][0]["shape"][0])
        # each tensor's bytes, [L, bytes a layer], written in place
        self._bytes = [_layer_bytes(a) for a in self.arrays]

    def add_chunk(self, header: dict, blob: bytes) -> None:
        if int(header["epoch"]) != self.epoch:
            raise ValueError(
                f"config-epoch mismatch inside one shipment: chunk "
                f"{header['epoch']} vs ship_begin {self.epoch}")
        seq = int(header["seq"])
        if seq != self.next_seq or seq >= self.n_chunks:
            raise ValueError(f"chunk {seq} out of order (expected "
                             f"{self.next_seq} of {self.n_chunks})")
        lo, hi = int(header["layer_lo"]), int(header["layer_hi"])
        if not 0 <= lo < hi <= self.L:
            raise ValueError(f"chunk layer range [{lo},{hi}) outside "
                             f"[0,{self.L})")
        if zlib.crc32(blob) & 0xFFFFFFFF != int(header["crc"]):
            raise ValueError(f"chunk {seq} checksum mismatch")
        off = 0
        for dst in self._bytes:
            n = dst.shape[1] * (hi - lo)
            if off + n > len(blob):
                raise ValueError(f"chunk {seq} blob shorter than its "
                                 "layer range")
            dst[lo:hi] = np.frombuffer(
                blob, np.uint8, count=n, offset=off).reshape(hi - lo, -1)
            off += n
        if off != len(blob):
            raise ValueError(f"chunk {seq} carries {len(blob) - off} "
                             "trailing bytes")
        self.next_seq = seq + 1

    def finish(self, end: dict) -> Shipment:
        if self.next_seq != self.n_chunks \
                or int(end["n_chunks"]) != self.n_chunks:
            raise ValueError(
                f"shipment ended after {self.next_seq} of "
                f"{self.n_chunks} chunks")
        b = self.begin
        return Shipment(
            epoch=self.epoch, dtype=b["dtype"],
            page_size=int(b["page_size"]), n_tokens=int(b["n_tokens"]),
            n_written=int(b["n_written"]), first_tok=int(b["first_tok"]),
            pages=[int(p) for p in b["pages"]], arrays=self.arrays,
            handoff=dict(b.get("handoff") or {}))


class PageStream:
    """One connected transfer socket: framed sends plus the
    partial-frame timeout-resume recv: a recv timeout keeps the bytes
    read so far and the next call resumes the SAME frame; multiple
    frames read in one burst stay buffered for subsequent calls. The
    buffer is a bytearray (a 1 MiB chunk arrives in ~16 reads; JAX's
    bytes concatenation copies it each time)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._rbuf = bytearray()

    def send(self, payload: bytes) -> None:
        send_msg(self._sock, payload)

    def recv(self, timeout: float) -> Optional[bytes]:
        """One frame payload, or None on timeout (partial frame
        buffered for resume). ConnectionError on EOF, ValueError on an
        oversized length prefix: both mean the channel is dead."""
        self._sock.settimeout(timeout)
        try:
            while len(self._rbuf) < LEN.size:
                part = self._sock.recv(65536)
                if not part:
                    raise ConnectionError("transfer peer closed")
                self._rbuf += part
            (n,) = LEN.unpack(self._rbuf[:LEN.size])
            if not 0 < n <= MAX_FRAME_BYTES:
                raise ValueError(
                    f"transfer frame length {n} outside (0, "
                    f"{MAX_FRAME_BYTES}]")
            while len(self._rbuf) < LEN.size + n:
                part = self._sock.recv(65536)
                if not part:
                    raise ConnectionError("transfer peer closed")
                self._rbuf += part
        except socket.timeout:
            return None
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:
                pass
        payload = bytes(self._rbuf[LEN.size:LEN.size + n])
        del self._rbuf[:LEN.size + n]
        return payload

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class DisaggPrefillPlane:
    """The prefill half of a disaggregated pair: listens for the
    decode peer, admits forwarded prompts as stock max_new_tokens=1
    requests, and ships each retiring request's pages (the engine's
    _capture_shipment hands them to the per-request ship_sink). One
    peer connection at a time; its reader thread parses requests, its
    writer thread is the ONLY socket writer (shipments queue through
    _sendq from the engine thread)."""

    role = "prefill"
    # every deref of the optional event bus sits behind `is not None`
    # (the disabled-plane guard discipline, machine-checked)
    OPTIONAL_PLANES = ("_events",)
    # channel-thread single-writer state: handler-side entry points may
    # only reach the pending-handle map under the ship lock
    ENGINE_THREAD_ATTRS = {"_ship_pending": "_ship_lock"}
    HANDLER_THREAD_METHODS = ("stop",)

    def __init__(self, engine, bind: Tuple[str, int], token: str,
                 events=None):
        # weak: the engine owns the plane, so a stopped engine is freed
        # by its refcount (its pool and graphs with it), not by a
        # cyclic collection
        self._engine = weakref.proxy(engine)
        self._bind = bind
        self._token = token
        self._events = events
        self._ship_lock = threading.Lock()
        self._ship_pending: Dict[int, object] = {}   # tag -> handle
        self._sendq: "queue.Queue" = queue.Queue()
        self._stop_ev = threading.Event()
        self._lsock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        # plane-local counters (tests read these; the metric families
        # are process-global and a pair in one process shares them)
        self.stats = {"shipments": 0, "pages": 0, "bytes": 0,
                      "failures": 0}

    def start(self) -> None:
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind(self._bind)
        lsock.listen(1)
        self._lsock = lsock
        self.port = lsock.getsockname()[1]
        self._thread = threading.Thread(
            target=self._serve, name="cake-disagg-prefill", daemon=True)
        self._thread.start()
        log.info("disagg prefill channel listening on %s:%d",
                 self._bind[0], self.port)

    def stop(self) -> None:
        self._stop_ev.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- channel threads ---------------------------------------------------

    def _serve(self) -> None:
        while not self._stop_ev.is_set():
            try:
                self._lsock.settimeout(0.5)
                conn, addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return   # listener closed by stop()
            hello = recv_bounded_msg(conn, HELLO_BYTES,
                                     time.monotonic() + HELLO_TIMEOUT_S)
            if hello is None or not hmac.compare_digest(
                    hello, self._token.encode()):
                log.warning("disagg peer %s failed the token hello",
                            addr)
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            stream = PageStream(conn)
            dead = threading.Event()
            writer = threading.Thread(
                target=self._writer, args=(stream, dead),
                name="cake-disagg-ship", daemon=True)
            writer.start()
            try:
                self._reader(stream, dead)
            finally:
                dead.set()
                writer.join(timeout=5.0)
                stream.close()
                with self._ship_lock:
                    self._ship_pending.clear()

    def _reader(self, stream: PageStream, dead: threading.Event) -> None:
        while not self._stop_ev.is_set() and not dead.is_set():
            try:
                payload = stream.recv(timeout=0.5)
            except (OSError, ValueError):
                return
            if payload is None:
                continue
            try:
                header, _blob = decode_frame(payload)
            except ValueError:
                log.warning("disagg prefill channel: corrupt frame; "
                            "dropping the connection")
                return
            if header.get("t") == "prefill":
                self._admit(header)

    def _admit(self, header: dict) -> None:
        tag = int(header["tag"])
        epoch = int(header.get("epoch", 0))
        try:
            handle = self._engine.submit(
                [int(t) for t in header["ids"]],
                # the prefill engine's whole job is one prefill plus the
                # first sampled token; decode belongs to the peer
                max_new_tokens=1,
                temperature=header.get("temperature"),
                top_p=header.get("top_p"),
                repeat_penalty=header.get("repeat_penalty"),
                prime_penalty_tokens=header.get("prime") or None,
                priority=header.get("priority"),
                ship_sink=lambda ship, _tag=tag, _ep=epoch:
                    self._enqueue_ship(_tag, _ep, ship),
            )
        except Exception as e:  # noqa: BLE001 — refusal rides the wire
            log.warning("disagg prefill admission refused: %r", e)
            self._sendq.put(("fail", tag, repr(e)))
            return
        with self._ship_lock:
            self._ship_pending[tag] = handle

    def _enqueue_ship(self, tag: int, epoch: int,
                      ship: Optional[Shipment]) -> None:
        """ship_sink callback (ENGINE thread, inside _emit): stamp the
        requesting peer's config epoch and queue for the writer. Must
        never raise into retirement."""
        if ship is not None:
            ship.epoch = epoch
        self._sendq.put(("ship", tag, ship))

    def _writer(self, stream: PageStream, dead: threading.Event) -> None:
        while not self._stop_ev.is_set() and not dead.is_set():
            try:
                item = self._sendq.get(timeout=0.2)
            except queue.Empty:
                item = None
            # failure-scan candidates BEFORE draining: the engine
            # enqueues a shipment strictly before req.done is set, so
            # any done handle whose shipment exists is already visible
            # to the drain below; what remains pending afterwards
            # genuinely failed before capture (error/cancel path) and
            # owes the peer a ship_fail
            with self._ship_lock:
                stale = [t for t, h in self._ship_pending.items()
                         if h.finished()]
            try:
                while item is not None:
                    self._send_item(stream, item)
                    try:
                        item = self._sendq.get_nowait()
                    except queue.Empty:
                        item = None
                with self._ship_lock:
                    stale = [t for t in stale
                             if t in self._ship_pending]
                for tag in stale:
                    self._send_item(stream, ("fail", tag,
                                             "prefill failed"))
            except (OSError, ValueError):
                dead.set()
                return

    def _send_item(self, stream: PageStream, item) -> None:
        kind, tag = item[0], item[1]
        with self._ship_lock:
            self._ship_pending.pop(tag, None)
        if kind == "fail" or item[2] is None:
            reason = item[2] if kind == "fail" else "capture failed"
            self.stats["failures"] += 1
            stream.send(encode_frame(
                {"t": "ship_fail", "tag": tag, "reason": str(reason)}))
            return
        ship: Shipment = item[2]
        t0 = time.perf_counter()
        for frame in shipment_frames(ship, tag):
            stream.send(frame)
        dt = time.perf_counter() - t0
        _SHIP_SECONDS.observe(dt)
        _SHIP_TOTAL.labels(dir="out").inc()
        _SHIP_BYTES.labels(dtype=ship.dtype).inc(ship.payload_bytes)
        self.stats["shipments"] += 1
        self.stats["pages"] += ship.n_written
        self.stats["bytes"] += ship.payload_bytes
        if self._events is not None:
            self._events.publish(
                "kv_shipped", pages=ship.n_written,
                bytes=ship.payload_bytes, dtype=ship.dtype,
                wall_s=round(dt, 6))


class DisaggDecodePlane:
    """The decode half: forwards admitted prompts to the prefill peer
    and completes each deferred admission via engine.disagg_complete,
    with the reassembled shipment when it survives the wire, with None
    (local whole-prompt prefill) on peer-down, timeout, refusal or
    corruption. One channel thread owns the socket for both directions;
    request_prefill (a handler thread, under the engine's admission
    lock) only enqueues, so a wedged peer can never stall admissions.
    `pin`: assemble shipments into pinned host memory (a decode engine
    on the card)."""

    role = "decode"
    OPTIONAL_PLANES = ("_events",)
    # channel-thread single-writer state: the handler-side entry point
    # may only reach the pending map under the transfer lock
    ENGINE_THREAD_ATTRS = {"_xfer_pending": "_xfer_lock"}
    HANDLER_THREAD_METHODS = ("request_prefill", "stop")

    def __init__(self, engine, peer: Tuple[str, int], token: str,
                 events=None, timeout_s: float = 30.0, pin: bool = False):
        self._engine = weakref.proxy(engine)   # the engine owns the plane
        self._peer = peer
        self._token = token
        self._events = events
        self._pin = pin
        self.timeout_s = timeout_s
        self._xfer_lock = threading.Lock()
        self._xfer_pending: Dict[int, Tuple[int, float]] = {}
        self._next_tag = 0
        self._sendq: "queue.Queue" = queue.Queue()
        self._connected = threading.Event()
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None
        self.stats = {"requested": 0, "shipments": 0, "pages": 0,
                      "bytes": 0, "degraded": 0}

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="cake-disagg-decode", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_ev.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._fail_pending("plane stopped")

    def wait_connected(self, timeout: float) -> bool:
        """True once the channel to the prefill peer is up (before
        that, request_prefill declines and admissions prefill
        locally)."""
        return self._connected.wait(timeout)

    # -- handler-thread surface (called under the engine admission lock) --

    def request_prefill(self, req) -> bool:
        """Forward one admission to the prefill peer. True = deferred
        (disagg_complete will finish it); False = channel down, caller
        admits through the local path immediately. Enqueue-only: no
        socket I/O under the engine's admission lock."""
        if not self._connected.is_set():
            return False
        with self._xfer_lock:
            self._next_tag += 1
            tag = self._next_tag
            self._xfer_pending[tag] = (
                req.rid, time.monotonic() + self.timeout_s)
        self._sendq.put(encode_frame({
            "t": "prefill", "tag": tag,
            "ids": [int(t) for t in req.prompt_ids],
            "temperature": req.temperature, "top_p": req.top_p,
            "repeat_penalty": req.repeat_penalty,
            "prime": [int(t) for t in req.prime_tokens],
            "priority": req.priority,
            "epoch": self._engine.config_epoch,
        }))
        self.stats["requested"] += 1
        return True

    # -- channel thread ----------------------------------------------------

    def _run(self) -> None:
        backoff = 0.5
        while not self._stop_ev.is_set():
            try:
                sock = socket.create_connection(self._peer, timeout=5.0)
            except OSError:
                self._stop_ev.wait(backoff)
                backoff = min(backoff * 2, 5.0)
                continue
            backoff = 0.5
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            stream = PageStream(sock)
            try:
                send_msg(sock, self._token.encode())
            except OSError:
                stream.close()
                continue
            self._sock = sock
            self._connected.set()
            log.info("disagg decode channel connected to %s:%d",
                     *self._peer)
            try:
                self._pump(stream)
            finally:
                self._connected.clear()
                self._sock = None
                stream.close()
                self._fail_pending("transfer channel dropped")

    def _pump(self, stream: PageStream) -> None:
        asm: Dict[int, ShipmentAssembler] = {}
        while not self._stop_ev.is_set():
            while True:
                try:
                    stream.send(self._sendq.get_nowait())
                except queue.Empty:
                    break
                except OSError:
                    return
            try:
                payload = stream.recv(timeout=0.2)
            except (OSError, ValueError, ConnectionError):
                return
            if payload is not None:
                try:
                    self._dispatch(asm, payload)
                except ValueError:
                    log.warning("disagg decode channel: corrupt "
                                "frame; dropping the connection")
                    return
            self._expire()

    def _dispatch(self, asm: Dict[int, ShipmentAssembler],
                  payload: bytes) -> None:
        header, blob = decode_frame(payload)
        t = header.get("t")
        tag = int(header.get("tag", -1))
        if t == "ship_begin":
            try:
                asm[tag] = ShipmentAssembler(header, pin=self._pin)
            except (ValueError, KeyError, TypeError) as e:
                log.warning("refused shipment (tag %d): %s", tag, e)
                note_adopt("checksum" if "checksum" in str(e)
                           else "geometry")
                self._resolve(tag, None)
        elif t == "ship_chunk":
            a = asm.get(tag)
            if a is None:
                return   # already refused; drain the rest silently
            try:
                a.add_chunk(header, blob)
            except (ValueError, KeyError, TypeError) as e:
                log.warning("refused shipment chunk (tag %d): %s",
                            tag, e)
                asm.pop(tag, None)
                note_adopt("epoch" if "epoch" in str(e)
                           else "checksum")
                self._resolve(tag, None)
        elif t == "ship_end":
            a = asm.pop(tag, None)
            if a is None:
                return
            try:
                ship = a.finish(header)
            except (ValueError, KeyError, TypeError) as e:
                log.warning("refused shipment end (tag %d): %s", tag, e)
                note_adopt("checksum")
                self._resolve(tag, None)
                return
            _SHIP_TOTAL.labels(dir="in").inc()
            self.stats["shipments"] += 1
            self.stats["pages"] += ship.n_written
            self.stats["bytes"] += ship.payload_bytes
            self._resolve(tag, ship)
        elif t == "ship_fail":
            log.info("prefill peer failed tag %d: %s", tag,
                     header.get("reason"))
            note_adopt("degraded")
            self._resolve(tag, None)

    def _expire(self) -> None:
        now = time.monotonic()
        with self._xfer_lock:
            late = [tag for tag, (_rid, dl) in
                    self._xfer_pending.items() if dl < now]
        for tag in late:
            log.warning("disagg shipment tag %d timed out after "
                        "%.1fs; degrading to local prefill",
                        tag, self.timeout_s)
            note_adopt("timeout")
            self._resolve(tag, None)

    def _resolve(self, tag: int, ship: Optional[Shipment]) -> None:
        with self._xfer_lock:
            ent = self._xfer_pending.pop(tag, None)
        if ent is None:
            return   # duplicate / expired / unknown tag
        rid = ent[0]
        if ship is None:
            self.stats["degraded"] += 1
            if self._events is not None:
                self._events.publish("kv_ship_degraded", rid=rid)
        self._engine.disagg_complete(rid, ship)

    def _fail_pending(self, why: str) -> None:
        with self._xfer_lock:
            tags = list(self._xfer_pending)
        for tag in tags:
            note_adopt("degraded")
            self._resolve(tag, None)
        if tags:
            log.warning("disagg decode: degraded %d pending "
                        "request(s) to local prefill (%s)",
                        len(tags), why)


def build_disagg_plane(engine, role: str, peer: str, token: str,
                       events=None, timeout_s: float = 30.0,
                       pin: bool = False):
    """Engine-side constructor: parse the peer address and build the
    role's plane. Loud-parse discipline: a malformed role/peer is a
    startup ValueError, never a silently-dead channel."""
    if role not in ("prefill", "decode"):
        raise ValueError(
            f"--disagg must be prefill or decode, got {role!r}")
    host, sep, port_s = (peer or "").rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"--disagg-peer must be host:port, got {peer!r}")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(
            f"--disagg-peer port {port_s!r} is not an integer")
    if not token:
        raise ValueError(
            "--disagg needs a shared channel token: set "
            "$CAKE_DISAGG_TOKEN on both engines")
    if role == "prefill":
        return DisaggPrefillPlane(engine, (host, port), token,
                                  events=events)
    return DisaggDecodePlane(engine, (host, port), token,
                             events=events, timeout_s=timeout_s, pin=pin)
