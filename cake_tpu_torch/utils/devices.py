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
