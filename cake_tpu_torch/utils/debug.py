"""Debug helpers (reference: panic_on_nan, utils/mod.rs:106-112).

Counterpart of `cake_tpu/utils/debug.py` over torch tensors. JAX's
`checked` runs its check inside a jitted step through a debug callback;
the port's counterpart of a jitted step is a captured CUDA graph, and a
NaN check must read a device value on the host, which is a stream sync
that no capture can record. So `checked` refuses inside a capture
(`torch.cuda.is_current_stream_capturing()`), with an error that says
so, and outside one it is `panic_on_nan`.
"""

from __future__ import annotations

import torch


def panic_on_nan(x, name: str = "tensor"):
    """Raise FloatingPointError if any element is NaN; returns x
    unchanged otherwise (one host read of a device flag)."""
    t = torch.as_tensor(x)
    if t.is_floating_point() and bool(torch.isnan(t).any()):
        raise FloatingPointError(f"NaN detected in {name}")
    return x


def checked(x, name: str = "tensor"):
    """`panic_on_nan` where it can run: outside a CUDA-graph capture.
    Inside one it raises RuntimeError instead of recording a sync the
    capture would fail on (or a check no replay would repeat)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"checked({name!r}) inside a CUDA-graph capture: a NaN check "
            "reads the device on the host, which a capture cannot record; "
            "check the graph's outputs after the replay instead")
    return panic_on_nan(x, name)
