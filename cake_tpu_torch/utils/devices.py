"""Device and dtype resolution for the port's entry points."""

from __future__ import annotations

import torch

_DTYPES = {
    "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f16": torch.float16, "float16": torch.float16,
}

# storage-only dtypes: valid for the KV pool and cache (--kv-dtype), where
# values are written once and upcast to the queries' dtype on read, but not
# for weights or activations (`cake_tpu/utils/devices.py:_KV_DTYPES`)
_KV_DTYPES = {
    **_DTYPES,
    "f8_e4m3": torch.float8_e4m3fn,
    "f8_e5m2": torch.float8_e5m2,
}
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's `device` argument. A CUDA
    device without a card is an error, never a silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                "available (torch.cuda.is_available() is False); pass "
                "device='cpu' explicitly to run on the CPU")
        if dev.index is None:   # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_dtype(name) -> torch.dtype:
    """torch dtype for a dtype name ("bf16", "f32", ...) or dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name).lower()]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r} (have "
                         f"{sorted(set(_DTYPES))})") from None


def resolve_kv_dtype(name) -> torch.dtype:
    """torch dtype for a --kv-dtype name: the compute dtypes and the fp8
    storage formats ("f8_e4m3", "f8_e5m2"), or a dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _KV_DTYPES[str(name).lower()]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r} (have "
                         f"{sorted(set(_KV_DTYPES))})") from None


# e4m3fn's largest finite value is 448; XLA rounds x to nearest even, so
# 448 < |x| <= 464 rounds down to 448 and anything larger (inf included)
# overflows to NaN, where torch saturates to 448
_E4M3_NAN_ABOVE = 464.0


def to_storage(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` cast to a KV storage dtype as the JAX package's `.astype`
    casts it (XLA's conversion). For f32/bf16/f16 and e5m2 that is
    torch's cast; for e4m3fn, finite values in range round identically
    in both, but overflow (|x| > 464, inf included) is NaN in XLA where
    torch saturates to +-448, so a stream that overflows in JAX does not
    go on in the port. A NaN's payload bits are not pinned (XLA's own
    differ between a convert and a convert fused into a scatter)."""
    if dtype == torch.float8_e4m3fn:
        x = x.masked_fill(x.abs() > _E4M3_NAN_ABOVE, float("nan"))
    return x.to(dtype)


def _bytes_of(pool: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its bytes (uint8, the same storage): indexing
    and index_put over fp8 are not implemented on every device and
    torch version, over bytes they are; another dtype as it is."""
    return pool.view(torch.uint8) if pool.dtype in FP8_DTYPES else pool


def take_rows(pool: torch.Tensor, idx) -> torch.Tensor:
    """pool[idx] (an advanced index on the leading axes), fp8 included."""
    return _bytes_of(pool)[idx].view(pool.dtype)


def put_rows(pool: torch.Tensor, idx, vals: torch.Tensor) -> None:
    """pool[idx] = vals cast to the pool's storage (`to_storage`), in
    place, fp8 included."""
    _bytes_of(pool)[idx] = _bytes_of(to_storage(vals, pool.dtype))


def zero_(t: torch.Tensor) -> torch.Tensor:
    """t zeroed in place, fp8 included (through its bytes: 0x00 is +0.0
    in both formats). Returns t."""
    _bytes_of(t).zero_()
    return t


def index_copy_rows(dst: torch.Tensor, dim: int, idx: torch.Tensor,
                    vals: torch.Tensor) -> None:
    """dst.index_copy_(dim, idx, vals cast to dst's storage), in place,
    fp8 included (through the bytes); vals already in dst's dtype are
    copied as they are."""
    if vals.dtype != dst.dtype:
        vals = to_storage(vals, dst.dtype)
    _bytes_of(dst).index_copy_(dim, idx, _bytes_of(vals))


_SM_COUNTS: dict = {}


def device_sm_count(device) -> int:
    """The SM count of a CUDA device, read once per device index (the
    kernels' split plans use it)."""
    device = torch.device(device)
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNTS[idx]


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on `device`. To a card it goes from pinned memory
    with non_blocking, so the host does not wait for the stream (the
    caching host allocator holds the pinned copy until the transfer is
    done); on the CPU it is `t` itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
