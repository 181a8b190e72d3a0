"""The port's page channel (`cake_tpu_torch/kv/transfer.py`) against the
JAX package's (`cake_tpu/kv/transfer.py`), no engines.

  * For the same pages, the port's frames are byte-identical to JAX's at
    f32, bf16, fp8 e4m3, int8 and int4 (the quantized pools' scale
    sidecars included), in one chunk and in many; each package's
    assembler takes the other's frames and gives back the same bytes,
    dtypes, shapes and header fields.
  * Every malformed-frame and refusal case of tests/test_kv_transfer.py
    refuses with ValueError (checksum, config epoch, order, truncation,
    odd-page int4, written-page count, unknown dtype, page-id list).
  * `PageStream` resumes a partial frame across a recv timeout, keeps a
    burst's remainder buffered, and treats EOF and an oversized length
    as fatal.
"""

import socket

import numpy as np
import pytest

import torch

import cake_tpu_torch.kv.transfer as transfer
from cake_tpu_torch.kv.transfer import (
    DTYPES, MAX_FRAME_BYTES, PageStream, Shipment, ShipmentAssembler,
    decode_frame, encode_frame, shipment_frames, validate_shipment_header,
)
from cake_tpu_torch.utils.wire import LEN

FORMATS = ["float32", "bfloat16", "float8_e4m3fn", "int8", "int4"]


def _np_arrays(fmt, L=2, n_pages=3, P=4, KV=2, hd=8):
    """The host_tier.fetch_pages layout of each pool flavor as numpy
    arrays of JAX's dtypes: (k, v) plain, (k_q, k_scale, v_q, v_scale)
    quantized."""
    import jax.numpy as jnp

    rng = np.random.default_rng(42)
    if fmt in ("int8", "int4"):
        q = ((L, n_pages, P, KV, hd) if fmt == "int8"
             else (L, n_pages, P // 2, KV, hd))
        qdt = np.int8 if fmt == "int8" else np.uint8
        return tuple(
            rng.integers(0, 256, q).astype(np.uint8).view(qdt)
            if i % 2 == 0 else
            rng.standard_normal((L, n_pages, KV)).astype(np.float32)
            for i in range(4))
    dt = {"float32": np.float32, "bfloat16": jnp.bfloat16,
          "float8_e4m3fn": jnp.float8_e4m3fn}[fmt]
    return tuple(rng.standard_normal((L, n_pages, P, KV, hd)).astype(dt)
                 for _ in range(2))


def _torch_of(a: np.ndarray) -> torch.Tensor:
    """The same bytes as a torch tensor of the wire dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy())
    return t.view(DTYPES[str(a.dtype)])


def _ships(fmt, L=2, epoch=7):
    """(JAX shipment, port shipment) of the same pages."""
    from cake_tpu.kv.transfer import Shipment as JShipment

    arrays = _np_arrays(fmt, L=L)
    n_pages, P = 3, 4
    kw = dict(epoch=epoch, dtype=fmt if fmt in ("int8", "int4") else fmt,
              page_size=P, n_tokens=(n_pages - 1) * P + 1,
              n_written=n_pages, first_tok=5,
              pages=list(range(3, 3 + n_pages)),
              handoff={"rid": 11, "first_lp": -0.25})
    return (JShipment(arrays=arrays, **kw),
            Shipment(arrays=tuple(_torch_of(a) for a in arrays), **kw))


def _reassemble(frames, assembler=ShipmentAssembler):
    decoded = [decode_frame(f) for f in frames]
    asm = assembler(decoded[0][0])
    for header, blob in decoded[1:-1]:
        asm.add_chunk(header, blob)
    return asm.finish(decoded[-1][0])


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


# -- frames ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 64])
@pytest.mark.parametrize("fmt", FORMATS)
def test_frames_are_byte_identical_to_jax(fmt, chunk, monkeypatch):
    import cake_tpu.kv.transfer as jtransfer

    if chunk is not None:
        # many layer-range chunks, each with its own crc
        monkeypatch.setattr(transfer, "CHUNK_BYTES", chunk)
        monkeypatch.setattr(jtransfer, "CHUNK_BYTES", chunk)
    jship, tship = _ships(fmt, L=4)
    ours = list(shipment_frames(tship, tag=9))
    theirs = list(jtransfer.shipment_frames(jship, tag=9))
    assert ours == theirs
    if chunk is not None:
        assert len(ours) > 3


@pytest.mark.parametrize("fmt", FORMATS)
def test_each_package_assembles_the_others_frames(fmt):
    import cake_tpu.kv.transfer as jtransfer

    jship, tship = _ships(fmt)
    ours = _reassemble(list(jtransfer.shipment_frames(jship, tag=3)))
    theirs = _reassemble(list(shipment_frames(tship, tag=3)),
                         jtransfer.ShipmentAssembler)
    for got in (ours, theirs):
        assert (got.epoch, got.dtype, got.page_size, got.n_tokens,
                got.n_written, got.first_tok, got.pages, got.handoff) == (
            tship.epoch, tship.dtype, tship.page_size, tship.n_tokens,
            tship.n_written, tship.first_tok, tship.pages, tship.handoff)
        assert got.payload_bytes == tship.payload_bytes
    for a, j, t in zip(ours.arrays, theirs.arrays, tship.arrays):
        assert isinstance(a, torch.Tensor) and a.dtype == t.dtype
        assert tuple(a.shape) == tuple(t.shape) == j.shape
        assert _bytes(a) == _bytes(t) == _bytes(j)


def test_frame_roundtrip_and_payload_bytes():
    header = {"t": "ship_chunk", "tag": 3, "pages": [1, 2]}
    blob = bytes(range(256))
    assert decode_frame(encode_frame(header, blob)) == (header, blob)
    assert decode_frame(encode_frame({"t": "ship_end"})) == (
        {"t": "ship_end"}, b"")
    f32, q8 = _ships("float32")[1], _ships("int8")[1]
    # int8 pages are 1/4 the value bytes + two small f32 scale sidecars
    assert q8.payload_bytes < 0.3 * f32.payload_bytes


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("payload", [
    b"",                                     # shorter than header length
    b"\x00\x00",
    b"\xff\xff\xff\xff{}",                   # header length out of bounds
    b"\x00\x00\x00\x05nope!",                # header not JSON
    encode_frame({"x": 1})[:4] + b'{"x":1}',  # JSON but no type tag
])
def test_malformed_frames_refuse(payload):
    from cake_tpu.kv.transfer import decode_frame as jdecode

    with pytest.raises(ValueError):
        decode_frame(payload)
    with pytest.raises(ValueError):
        jdecode(payload)


def _frames(L=2, fmt="float32"):
    return [decode_frame(f) for f in shipment_frames(_ships(fmt, L=L)[1],
                                                     2)]


def _checksum():
    frames = _frames()
    asm = ShipmentAssembler(frames[0][0])
    header, blob = frames[1]
    corrupt = bytearray(blob)
    corrupt[0] ^= 0xFF
    asm.add_chunk(header, bytes(corrupt))


def _epoch():
    frames = _frames()
    asm = ShipmentAssembler(frames[0][0])
    header, blob = frames[1]
    asm.add_chunk(dict(header, epoch=header["epoch"] + 1), blob)


def _out_of_order():
    transfer.CHUNK_BYTES = 64
    try:
        frames = _frames(L=4)
    finally:
        transfer.CHUNK_BYTES = 1 << 20
    asm = ShipmentAssembler(frames[0][0])
    asm.add_chunk(*frames[2])   # seq 1 before seq 0


def _truncated():
    frames = _frames()
    ShipmentAssembler(frames[0][0]).finish(frames[-1][0])


def _short_blob():
    frames = _frames()
    asm = ShipmentAssembler(frames[0][0])
    header, blob = frames[1]
    blob = blob[:-8]
    import zlib
    asm.add_chunk(dict(header, crc=zlib.crc32(blob) & 0xFFFFFFFF), blob)


def _begin(**over):
    h = _frames()[0][0]
    validate_shipment_header(dict(h, **over))


def _unknown_dtype():
    h = _frames()[0][0]
    validate_shipment_header(
        dict(h, arrays=[dict(h["arrays"][0], dtype="complex257")]))


REFUSALS = {
    "checksum": (_checksum, "checksum mismatch"),
    "epoch": (_epoch, "config-epoch mismatch"),
    "order": (_out_of_order, "out of order"),
    "truncated": (_truncated, "ended after"),
    "short_blob": (_short_blob, "shorter than its layer range"),
    "int4_odd_page": (lambda: _begin(dtype="int4", page_size=5, n_tokens=9,
                                     n_written=2), "nibble-pack"),
    "n_written": (lambda: _begin(n_written=5), "n_written"),
    "unknown_dtype": (_unknown_dtype, "unknown array dtype"),
    "page_ids": (lambda: _begin(pages=[1]), "page-id list"),
    "no_arrays": (lambda: _begin(arrays=[]), "no arrays"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_assembler_refusals(case):
    fn, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        fn()


# -- PageStream --------------------------------------------------------------


def test_pagestream_partial_frame_timeout_resume():
    a, b = socket.socketpair()
    stream = PageStream(b)
    try:
        payload = encode_frame({"t": "x", "k": 1}, b"page-bytes")
        framed = LEN.pack(len(payload)) + payload
        # split mid-frame: the timeout keeps the partial buffer and the
        # next recv resumes the SAME frame
        a.sendall(framed[:7])
        assert stream.recv(timeout=0.05) is None
        a.sendall(framed[7:])
        assert stream.recv(timeout=5.0) == payload
    finally:
        stream.close()
        a.close()


def test_pagestream_burst_keeps_remainder_buffered():
    a, b = socket.socketpair()
    stream = PageStream(b)
    try:
        p1 = encode_frame({"t": "one"})
        p2 = encode_frame({"t": "two"}, b"tail" * 40000)
        a.sendall(LEN.pack(len(p1)) + p1 + LEN.pack(len(p2)) + p2)
        assert stream.recv(timeout=5.0) == p1
        assert stream.recv(timeout=5.0) == p2
    finally:
        stream.close()
        a.close()


@pytest.mark.parametrize("case", ["oversize", "eof"])
def test_pagestream_eof_and_oversize_are_fatal(case):
    a, b = socket.socketpair()
    stream = PageStream(b)
    try:
        if case == "oversize":
            a.sendall(LEN.pack(MAX_FRAME_BYTES + 1))
            with pytest.raises(ValueError):
                stream.recv(timeout=5.0)
        else:
            a.close()
            with pytest.raises(ConnectionError):
                stream.recv(timeout=5.0)
    finally:
        stream.close()
        a.close()
