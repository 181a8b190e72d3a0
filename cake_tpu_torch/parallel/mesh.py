"""Device mesh construction.

Counterpart of `cake_tpu/parallel/mesh.py`. Axis convention as in JAX:
("dp", "stage", "tp") — data parallel, pipeline stage, tensor parallel.
A `Mesh` is an object array of `torch.device` of shape (dp, stage, tp).

Default devices: on CUDA each visible card once (a mesh that needs more
cards than are visible raises JAX's message); on the CPU the CPU at
every position, as JAX's tests run on 8 virtual CPU devices. An explicit
`devices=` list may repeat a card: the co-located mesh, where every
shard of a plan lives on one card (JAX's counterpart is
`--xla_force_host_platform_device_count`). It is reachable from Python
only, through the `devices=` keyword that `Context` and `Master` pass
down.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cake_tpu_torch.utils.devices import resolve_device

AXES = ("dp", "stage", "tp")


class Mesh:
    """An array of torch devices over named axes."""

    def __init__(self, devices: np.ndarray, axis_names=AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} dims for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, *index) -> torch.device:
        """The device at a mesh position."""
        return self.devices[tuple(index)]

    def distinct_devices(self):
        """The mesh's devices, each once, in position order."""
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def default_devices(device_type: str = "cuda") -> list:
    """Every visible card once (CUDA), or the CPU (a CPU mesh repeats it
    at every position)."""
    if device_type == "cuda":
        resolve_device("cuda")    # no card: the port's error
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(dp: int = 1, stage: int = 1, tp: int = 1,
              devices: Optional[Sequence] = None,
              device_type: str = "cuda") -> Mesh:
    """Build a ("dp", "stage", "tp") mesh over the given devices, or the
    default ones of `device_type` (the CPU fills every position)."""
    need = dp * stage * tp
    if devices is None:
        devices = default_devices(device_type)
        if device_type != "cuda":
            devices = devices * need
    devices = [torch.device(d) for d in devices]
    if need > len(devices):
        raise ValueError(
            f"mesh dp={dp} x stage={stage} x tp={tp} = {need} devices, "
            f"but only {len(devices)} available"
        )
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return Mesh(arr.reshape(dp, stage, tp), AXES)


def single_device_mesh(device=None) -> Mesh:
    dev = torch.device(device) if device is not None else (
        default_devices("cuda")[0])
    arr = np.empty(1, dtype=object)
    arr[0] = dev
    return Mesh(arr.reshape(1, 1, 1), AXES)
