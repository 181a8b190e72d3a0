"""Multi-process runtime: the process group, the slice-aware mesh.

Counterpart of `cake_tpu/parallel/distributed.py`. JAX runs one SPMD
program on every process and moves hidden states between hosts inside
it; the port keeps one controller per process (each drives the mesh
positions it owns) and joins the processes with `torch.distributed`:

  * `initialize()` forms the process group from CAKE_COORDINATOR /
    CAKE_NUM_PROCESSES / CAKE_PROCESS_ID (explicit arguments first), as
    JAX's does. One process, or no coordinator, is a no-op. The TPU pod
    markers (TPU_WORKER_HOSTNAMES, MEGASCALE_*) that JAX auto-detects
    from mean nothing on a card and are ignored.
  * The backend rule (`hop_backend`): the default group is gloo (it
    carries the one-time address broadcast of serve/control.py), and the
    hops between mesh positions of different processes (parallel/hop.py)
    ride nccl when every rank has a card of its own, gloo otherwise: on
    the CPU, and when ranks share one card (nccl refuses two ranks on
    one GPU). The rule reads each rank's card identity (host and card
    UUID, gathered over gloo) and never catches an nccl failure.
  * `make_multihost_mesh()` lays out a ("dp", "stage", "tp") mesh whose
    `dcn_axis` crosses the process boundary, JAX's layout with a process
    as the slice; every position carries its owning rank (`Mesh.ranks`).
    `make_multihost_sp_mesh()` lays out JAX's sp meshes the same way,
    process-major.
  * `is_coordinator()` / `coordinator_only()`: rank-0 gating (the REST
    API binds on the coordinator).
  * `assign_hosts_to_stages`, `cluster_info` (`/api/v1/cluster`).
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cake_tpu_torch.parallel.mesh import AXES, Mesh

log = logging.getLogger(__name__)

# the process group's state: the backend the rule chose, the hop group,
# this process's device and its Hops (parallel/hop.py, made at first use)
_STATE: Dict = {"backend": None, "hop_group": None, "device": None,
                "hops": None}


class GlobalDevice(NamedTuple):
    """A device of some process: its owning rank and the torch device it
    is in that process."""

    process_index: int
    device: torch.device


def _env_int(env: Dict[str, str], key: str) -> Optional[int]:
    return int(env[key]) if env.get(key) else None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               env: Optional[Dict[str, str]] = None,
               device: Optional[torch.device] = None,
               timeout_s: float = 1800.0) -> bool:
    """Form the process group for multi-process serving.

    Returns True when it ran, False for a single process. Explicit args
    beat CAKE_* env vars. Safe to call unconditionally: with no
    coordinator, or one process, it is a no-op (JAX's pod markers are
    not a signal here). device: this process's card (or the CPU), which
    the backend rule reads; default cuda:0 with a card, else the CPU."""
    env = dict(os.environ if env is None else env)
    coordinator = coordinator or env.get("CAKE_COORDINATOR") or None
    if num_processes is None:
        num_processes = _env_int(env, "CAKE_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int(env, "CAKE_PROCESS_ID")
    if coordinator is None:
        return False              # single host, nothing to do
    if num_processes is None or process_id is None:
        raise ValueError(
            "CAKE_COORDINATOR is set but CAKE_NUM_PROCESSES / "
            "CAKE_PROCESS_ID are not: every process needs the world size "
            "and its own rank")
    if num_processes <= 1:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if device is None:
        device = (torch.device("cuda", 0) if torch.cuda.is_available()
                  else torch.device("cpu"))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    backend = _choose_backend(torch.device(device))
    _STATE.update(backend=backend, device=torch.device(device),
                  hop_group=(dist.new_group(backend="nccl")
                             if backend == "nccl" else None))
    log.info("distributed: process %d/%d, hops over %s", process_id,
             num_processes, backend)
    return True


def _card_identity(device: torch.device) -> str:
    """This process's card as the backend rule compares it: host and
    card UUID ("" for the CPU)."""
    if device.type != "cuda":
        return ""
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else device}"


def _choose_backend(device: torch.device) -> str:
    """The backend rule: nccl when every rank has a card of its own (its
    identities, gathered over gloo, are all distinct), gloo otherwise."""
    import torch.distributed as dist

    ident = _card_identity(device).encode()[:256]
    buf = torch.zeros(256, dtype=torch.uint8)
    if ident:
        buf[:len(ident)] = torch.frombuffer(bytearray(ident),
                                            dtype=torch.uint8)
    got = [torch.zeros(256, dtype=torch.uint8)
           for _ in range(dist.get_world_size())]
    dist.all_gather(got, buf)
    idents = [bytes(g.numpy().tobytes()).rstrip(b"\0") for g in got]
    return backend_rule(idents)


def backend_rule(identities: Sequence[bytes]) -> str:
    """nccl iff every rank names a card and no two name the same one."""
    if all(identities) and len(set(identities)) == len(identities):
        return "nccl"
    return "gloo"


def hop_backend() -> Optional[str]:
    """The backend of the hops between processes (None: one process)."""
    return _STATE["backend"]


def hop_group():
    """The process group the hops ride (None: the default group)."""
    return _STATE["hop_group"]


def hops():
    """This process's Hops over the hop group (one a process group)."""
    got = _STATE["hops"]
    if got is None:
        import torch.distributed as dist

        from cake_tpu_torch.parallel.hop import Hops
        got = _STATE["hops"] = Hops(dist.get_rank(), dist.get_world_size(),
                                    hop_backend() or "gloo", hop_group())
    return got


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group (the CLI's last teardown step)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, hop_group=None, device=None, hops=None)


def is_coordinator() -> bool:
    """True on the process that owns coordination (serves the REST API)."""
    return process_index() == 0


def coordinator_only(fn):
    """Decorator: run fn only on the coordinator; others return None."""
    def wrapper(*a, **kw):
        if is_coordinator():
            return fn(*a, **kw)
        return None
    return wrapper


def global_devices(local: Sequence[torch.device],
                   n_processes: Optional[int] = None) -> List[GlobalDevice]:
    """Every process's devices, rank by rank, each process holding the
    same local list as this one (hosts are alike)."""
    n = process_count() if n_processes is None else n_processes
    return [GlobalDevice(r, torch.device(d)) for r in range(n) for d in local]


def _slice_ids(devices: Sequence) -> List[int]:
    """Slice index per device: its process (the process boundary is the
    port's DCN boundary)."""
    return [getattr(d, "process_index", 0) for d in devices]


def _as_device(d) -> torch.device:
    return d.device if isinstance(d, GlobalDevice) else torch.device(d)


def _mesh_of(arr: np.ndarray, rank: int, axes=AXES) -> Mesh:
    devs = np.empty(arr.shape, dtype=object)
    ranks = np.zeros(arr.shape, dtype=np.int64)
    for pos in np.ndindex(*arr.shape):
        devs[pos] = _as_device(arr[pos])
        ranks[pos] = _slice_ids([arr[pos]])[0]
    return Mesh(devs, axes, ranks=ranks, rank=rank)


def make_multihost_sp_mesh(sp: int, dp: int = 1, stage: int = 1,
                           tp: int = 1, devices: Optional[Sequence] = None,
                           rank: Optional[int] = None) -> Mesh:
    """JAX's sp mesh over every process's devices (`cake_tpu/context.py`'s
    sp branch reshapes the global device list, process-major, into the
    mesh's shape): the leading axis crosses the process boundary, so
    ("sp"[, "tp"]) puts sp positions on different processes with each
    position's tp ranks in one, and ("stage", "sp"[, "tp"]) puts stages
    on different processes. devices: GlobalDevices in rank order
    (default every process's copy of this process's device, as many as
    the mesh needs)."""
    from cake_tpu_torch.parallel.mesh import sp_axes

    rank = process_index() if rank is None else rank
    axes = sp_axes(dp, stage, tp)
    sizes = {"dp": dp, "stage": stage, "sp": sp, "tp": tp}
    shape = tuple(sizes[a] for a in axes)
    need = int(np.prod(shape))
    if devices is None:
        dev = _STATE["device"] or torch.device("cpu")
        devices = global_devices([dev] * -(-need // process_count()))
    devices = list(devices)
    if need > len(devices):
        raise ValueError(
            f"stages {stage} x --dp {dp} x --sp {sp} x --tp {tp} needs "
            f"{need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return _mesh_of(arr.reshape(shape), rank, axes)


def make_multihost_mesh(dp: int = 1, stage: int = 1, tp: int = 1,
                        dcn_axis: str = "dp",
                        devices: Optional[Sequence] = None,
                        rank: Optional[int] = None) -> Mesh:
    """("dp","stage","tp") mesh aware of process (slice) boundaries.

    The `dcn_axis` dimension is factored as (num_slices x per-slice) with
    the slice factor slowest-varying, so neighbouring coordinates along
    every other axis always live in the same process. With one slice
    this degrades to `make_mesh` exactly. devices: GlobalDevices (or
    torch devices, all of process 0); default every process's copy of
    this process's device. rank: this process (default its rank in the
    group)."""
    if dcn_axis not in AXES:
        raise ValueError(f"dcn_axis must be one of {AXES}")
    rank = process_index() if rank is None else rank
    need = dp * stage * tp
    if devices is None:
        dev = _STATE["device"] or torch.device("cpu")
        per = -(-need // process_count())
        devices = global_devices([dev] * per)
    devices = list(devices)
    if need > len(devices):
        raise ValueError(
            f"mesh dp={dp} x stage={stage} x tp={tp} = {need} devices, "
            f"but only {len(devices)} available")

    sids = _slice_ids(devices)
    num_slices = len(set(sids))
    if num_slices == 1:
        arr = np.empty(need, dtype=object)
        for i, d in enumerate(devices[:need]):
            arr[i] = d
        return _mesh_of(arr.reshape(dp, stage, tp), rank)

    sizes = {"dp": dp, "stage": stage, "tp": tp}
    if sizes[dcn_axis] % num_slices != 0:
        raise ValueError(
            f"dcn axis '{dcn_axis}'={sizes[dcn_axis]} must be divisible by "
            f"num_slices={num_slices}")
    per_slice_need = need // num_slices

    # group devices by slice, order groups by slice id
    by_slice: Dict[int, List] = {}
    for d, sid in zip(devices, sids):
        by_slice.setdefault(sid, []).append(d)
    groups = [by_slice[s] for s in sorted(by_slice)]
    if any(len(g) < per_slice_need for g in groups):
        raise ValueError(
            f"every slice needs {per_slice_need} devices for this mesh; "
            f"got {[len(g) for g in groups]}")

    # build [num_slices, per_slice_dcn, other axes...] then move the slice
    # factor into the dcn axis's slow position
    inner = {a: sizes[a] for a in AXES}
    inner[dcn_axis] = sizes[dcn_axis] // num_slices
    stacked = np.empty((len(groups), inner["dp"], inner["stage"],
                        inner["tp"]), dtype=object)
    for i, g in enumerate(groups):
        flat = np.empty(per_slice_need, dtype=object)
        for j, d in enumerate(g[:per_slice_need]):
            flat[j] = d
        stacked[i] = flat.reshape(inner["dp"], inner["stage"], inner["tp"])
    axis_pos = AXES.index(dcn_axis)
    # move S next to (before) the dcn axis and merge
    stacked = np.moveaxis(stacked, 0, axis_pos)
    arr = stacked.reshape(dp, stage, tp)
    return _mesh_of(arr, rank)


def assign_hosts_to_stages(topology, num_slices: int) -> Dict[str, int]:
    """Map topology node names -> slice ids, preserving file order
    (reference: worker name -> host, topology.rs:14-21). With more nodes
    than slices, nodes wrap round-robin (several stages per slice)."""
    names = list(topology.keys())
    return {name: i % num_slices for i, name in enumerate(names)}


def cluster_info() -> dict:
    """Introspection snapshot (`/api/v1/cluster`): this process, the
    group's size, the devices, the hops' backend."""
    n = process_count()
    dev = _STATE["device"]
    if dev is None:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() else torch.device("cpu"))
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {
        "process_index": process_index(),
        "process_count": n,
        "device_count": local * n,
        "local_device_count": local,
        "slices": list(range(n)),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "backend": hop_backend() if n > 1 else None,
    }
