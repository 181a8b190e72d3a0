"""Device and dtype resolution for the port's entry points."""

from __future__ import annotations

import torch

_DTYPES = {
    "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f16": torch.float16, "float16": torch.float16,
}


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
