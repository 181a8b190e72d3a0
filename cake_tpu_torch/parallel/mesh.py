"""Device mesh construction.

Counterpart of `cake_tpu/parallel/mesh.py`. Axis convention as in JAX:
("dp", "stage", "tp") — data parallel, pipeline stage, tensor parallel.
A `Mesh` is an object array of `torch.device` of shape (dp, stage, tp).
Sequence parallelism builds JAX's meshes with an "sp" axis
(`cake_tpu/context.py`'s sp branch, `make_sp_mesh`): ("sp",),
("sp", "tp"), ("dp", "sp"[, "tp"]) and ("stage", "sp"[, "tp"]). A
position is addressed by its named coordinates (`Mesh.index`), an axis
the mesh lacks at coordinate 0.

Default devices: on CUDA each visible card once (a mesh that needs more
cards than are visible raises JAX's message); on the CPU the CPU at
every position, as JAX's tests run on 8 virtual CPU devices. An explicit
`devices=` list may repeat a card: the co-located mesh, where every
shard of a plan lives on one card (JAX's counterpart is
`--xla_force_host_platform_device_count`). It is reachable from Python
only, through the `devices=` keyword that `Context` and `Master` pass
down.

A mesh that spans processes (parallel/distributed.make_multihost_mesh)
carries each position's owning rank (`ranks`) and this process's
(`rank`): a process allocates, loads and runs only the positions it owns
(`owns`), and its tensors land on `home`, its first owned position's
device. A mesh built in one process owns every position.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cake_tpu_torch.utils.devices import resolve_device

AXES = ("dp", "stage", "tp")


class Mesh:
    """An array of torch devices over named axes."""

    def __init__(self, devices: np.ndarray, axis_names=AXES,
                 ranks: Optional[np.ndarray] = None, rank: int = 0):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} dims for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = (np.zeros(devices.shape, dtype=np.int64)
                      if ranks is None else ranks)
        self.rank = rank

    @property
    def multiprocess(self) -> bool:
        """True when the positions span more than one process."""
        return len(set(self.ranks.flat)) > 1

    def owns(self, pos) -> bool:
        """Whether this process owns the position (an index tuple)."""
        return int(self.ranks[tuple(pos)]) == self.rank

    def owner(self, *index) -> int:
        """The rank owning a position."""
        return int(self.ranks[tuple(index)])

    @property
    def home(self) -> torch.device:
        """This process's first owned position's device."""
        for pos in np.ndindex(*self.devices.shape):
            if self.owns(pos):
                return self.devices[pos]
        raise ValueError(f"process {self.rank} owns no position of {self}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def size_of(self, axis: str) -> int:
        """The axis' size (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1)

    def index(self, dp: int = 0, stage: int = 0, tp: int = 0,
              sp: int = 0) -> tuple:
        """The position of named coordinates; an axis the mesh lacks
        must be at 0."""
        coords = {"dp": dp, "stage": stage, "tp": tp, "sp": sp}
        for ax, c in coords.items():
            if c and ax not in self.axis_names:
                raise ValueError(f"mesh {self.axis_names} has no {ax!r} "
                                 f"axis (coordinate {c})")
        return tuple(coords[a] for a in self.axis_names)

    def device(self, *index) -> torch.device:
        """The device at a mesh position."""
        return self.devices[tuple(index)]

    def at(self, dp: int = 0, stage: int = 0, tp: int = 0,
           sp: int = 0) -> torch.device:
        """The device at named coordinates (`index`)."""
        return self.devices[self.index(dp=dp, stage=stage, tp=tp, sp=sp)]

    def distinct_devices(self):
        """The devices of this process's positions, each once, in
        position order."""
        seen = []
        for pos in np.ndindex(*self.devices.shape):
            d = self.devices[pos]
            if self.owns(pos) and d not in seen:
                seen.append(d)
        return seen

    def __repr__(self) -> str:
        out = f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}"
        if self.multiprocess:
            out += f", ranks={self.ranks.flat[:].tolist()}, rank={self.rank}"
        return out + ")"


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
    return _mesh((dp, stage, tp), AXES, devices, device_type,
                 f"mesh dp={dp} x stage={stage} x tp={tp} = {need} devices, "
                 "but only {have} available")


def _mesh(shape: tuple, axes: tuple, devices, device_type: str,
          too_few: str) -> Mesh:
    """A mesh of `shape` over `devices` (None: the defaults of
    `device_type`, the CPU at every position), or ValueError(too_few
    formatted with have=) when they are too few."""
    need = int(np.prod(shape))
    if devices is None:
        devices = default_devices(device_type)
        if device_type != "cuda":
            devices = devices * need
    devices = [torch.device(d) for d in devices]
    if need > len(devices):
        raise ValueError(too_few.format(have=len(devices)))
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return Mesh(arr.reshape(shape), axes)


def sp_axes(dp: int = 1, stage: int = 1, tp: int = 1) -> tuple:
    """JAX's axis names of an sp mesh (`cake_tpu/context.py`):
    ("stage", "sp"[, "tp"]) with stages, else ("dp",)? + ("sp",) +
    ("tp",)?; an axis of size 1 is left out."""
    lead = ("stage",) if stage > 1 else ("dp",) if dp > 1 else ()
    return lead + ("sp",) + (("tp",) if tp > 1 else ())


def make_sp_mesh(sp: int, dp: int = 1, stage: int = 1, tp: int = 1,
                 devices: Optional[Sequence] = None,
                 device_type: str = "cuda") -> Mesh:
    """A mesh with an "sp" axis over the given devices, or the default
    ones of `device_type` (the CPU fills every position). dp and stages
    do not compose in one sp mesh (the context refuses it first)."""
    if dp > 1 and stage > 1:
        raise ValueError("an sp mesh takes dp or stages, not both")
    axes = sp_axes(dp, stage, tp)
    sizes = {"dp": dp, "stage": stage, "sp": sp, "tp": tp}
    shape = tuple(sizes[a] for a in axes)
    return _mesh(shape, axes, devices, device_type,
                 f"stages {stage} x --dp {dp} x --sp {sp} x --tp {tp} needs "
                 f"{int(np.prod(shape))} devices, have {{have}}")


def single_device_mesh(device=None) -> Mesh:
    dev = torch.device(device) if device is not None else (
        default_devices("cuda")[0])
    arr = np.empty(1, dtype=object)
    arr[0] = dev
    return Mesh(arr.reshape(1, 1, 1), AXES)
