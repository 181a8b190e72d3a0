"""The port's multi-process runtime (`cake_tpu_torch/parallel/
distributed.py`) against the JAX package's (`cake_tpu/parallel/
distributed.py`):

  * `initialize` takes explicit arguments before the CAKE_* variables,
    and is a no-op with no coordinator or one process; JAX's TPU pod
    markers mean nothing on a card (a divergence: JAX initializes, or
    raises, on them);
  * the backend rule: nccl only when every rank names a card of its own;
  * `make_multihost_mesh` gives JAX's layouts for the same slice
    assignment (a process is the port's slice): dp outermost, stage
    outermost, one slice as `make_mesh`, and JAX's message for an
    indivisible dcn axis; each position carries its rank, and a placed
    leaf holds only this process's positions;
  * `assign_hosts_to_stages` and `ParallelPlan.build_mesh`'s automatic
    dcn axis are JAX's.
"""

import numpy as np
import pytest

import torch

import cake_tpu_torch.parallel.distributed as pdist
from cake_tpu_torch.parallel.distributed import (
    GlobalDevice, assign_hosts_to_stages, backend_rule, cluster_info,
    initialize, is_coordinator, make_multihost_mesh,
)


@pytest.fixture
def captured(monkeypatch):
    """init_process_group recorded instead of run."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(pdist, "_choose_backend", lambda dev: "gloo")
    yield calls
    pdist._STATE.update(backend=None, hop_group=None, device=None)


def test_initialize_noops_single_host():
    assert initialize(env={}) is False
    assert initialize(env={"HOSTNAME": "x"}) is False
    # one process is a no-op too
    assert initialize(env={"CAKE_COORDINATOR": "127.0.0.1:1",
                           "CAKE_NUM_PROCESSES": "1",
                           "CAKE_PROCESS_ID": "0"}) is False


@pytest.mark.parametrize("env", [
    {"TPU_WORKER_HOSTNAMES": "host0,host1"},
    {"MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.1:8080"},
    {"TPU_WORKER_HOSTNAMES": "localhost"},
])
def test_pod_markers_mean_nothing_on_a_card(env, captured):
    """JAX auto-initializes on a multi-worker pod marker (and raises
    after its backend is live); the port forms a group only from a
    coordinator."""
    assert initialize(env=env) is False
    assert captured == []


def test_initialize_precedence(captured):
    env = {"CAKE_COORDINATOR": "10.0.0.2:2", "CAKE_NUM_PROCESSES": "4",
           "CAKE_PROCESS_ID": "3"}
    # the variables alone
    assert initialize(env=env, device=torch.device("cpu")) is True
    assert captured[-1][0] == "gloo"
    kw = captured[-1][1]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://10.0.0.2:2", 4, 3)
    # explicit arguments first
    assert initialize("10.0.0.1:1", 2, 1, env=env,
                      device=torch.device("cpu")) is True
    kw = captured[-1][1]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://10.0.0.1:1", 2, 1)
    assert pdist.hop_backend() == "gloo"
    with pytest.raises(ValueError, match="CAKE_NUM_PROCESSES"):
        initialize(env={"CAKE_COORDINATOR": "10.0.0.1:1"})


def test_backend_rule():
    assert backend_rule([b"h/GPU-a", b"h/GPU-b"]) == "nccl"
    assert backend_rule([b"h1/GPU-a", b"h2/GPU-a"]) == "nccl"
    # two ranks on one card: nccl refuses it, the rule says gloo
    assert backend_rule([b"h/GPU-a", b"h/GPU-a"]) == "gloo"
    assert backend_rule([b"", b""]) == "gloo"          # the CPU
    assert backend_rule([b"h/GPU-a", b""]) == "gloo"


def test_is_coordinator_and_cluster_info_single_process():
    assert is_coordinator() is True
    info = cluster_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["slices"] == [0]
    assert info["platform"] in ("cpu", "gpu")


def _jax_layout(monkeypatch, per_slice, **kw):
    import jax

    import cake_tpu.parallel.distributed as jdist

    devs = jax.devices()
    fake = {id(d): i // per_slice for i, d in enumerate(devs)}
    monkeypatch.setattr(jdist, "_slice_ids",
                        lambda ds: [fake[id(d)] for d in ds])
    m = jdist.make_multihost_mesh(**kw)
    return [devs.index(d) for d in m.devices.flat], m.devices.shape


def _port_devices(n=8, per_slice=4):
    return [GlobalDevice(i // per_slice, torch.device("cpu", i))
            for i in range(n)]


@pytest.mark.parametrize("kw", [
    dict(dp=2, stage=2, tp=2, dcn_axis="dp"),
    dict(dp=1, stage=4, tp=2, dcn_axis="stage"),
    dict(dp=2, stage=2, tp=2, dcn_axis="stage"),
    dict(dp=1, stage=2, tp=4, dcn_axis="tp"),
])
def test_multislice_layouts_are_jaxs(monkeypatch, kw):
    want, shape = _jax_layout(monkeypatch, 4, **kw)
    m = make_multihost_mesh(devices=_port_devices(), rank=1, **kw)
    assert m.devices.shape == shape
    assert [d.index for d in m.devices.flat] == want
    # every position's rank is its device's slice; rank 1 owns slice 1
    assert [int(r) for r in m.ranks.flat] == [i // 4 for i in want]
    assert m.multiprocess and m.rank == 1
    owned = [pos for pos in np.ndindex(*m.devices.shape) if m.owns(pos)]
    assert len(owned) == 4
    assert m.home == m.devices[owned[0]]


def test_dp_and_stage_outermost(monkeypatch):
    m = make_multihost_mesh(dp=2, stage=2, tp=2, dcn_axis="dp",
                            devices=_port_devices(), rank=0)
    for i in range(2):
        assert set(m.ranks[i].flat) == {i}
    m = make_multihost_mesh(dp=1, stage=4, tp=2, dcn_axis="stage",
                            devices=_port_devices(), rank=0)
    assert set(m.ranks[:, :2].flat) == {0}
    assert set(m.ranks[:, 2:].flat) == {1}


def test_single_slice_mesh_matches_make_mesh():
    from cake_tpu_torch.parallel.mesh import make_mesh

    m = make_multihost_mesh(dp=2, stage=2, tp=2,
                            devices=[torch.device("cpu")] * 8, rank=0)
    ref = make_mesh(dp=2, stage=2, tp=2, device_type="cpu")
    assert m.axis_names == ("dp", "stage", "tp") == ref.axis_names
    assert m.devices.shape == (2, 2, 2)
    assert not m.multiprocess


def test_indivisible_dcn_axis_raises_jaxs_message(monkeypatch):
    import cake_tpu.parallel.distributed as jdist

    with pytest.raises(ValueError, match="divisible") as pe:
        make_multihost_mesh(dp=1, stage=1, tp=8, dcn_axis="stage",
                            devices=_port_devices(), rank=0)
    import jax
    devs = jax.devices()
    fake = {id(d): i // 4 for i, d in enumerate(devs)}
    monkeypatch.setattr(jdist, "_slice_ids",
                        lambda ds: [fake[id(d)] for d in ds])
    with pytest.raises(ValueError) as je:
        jdist.make_multihost_mesh(dp=1, stage=1, tp=8, dcn_axis="stage")
    assert str(pe.value) == str(je.value)


def test_a_placed_leaf_holds_only_this_process_positions():
    from cake_tpu_torch.parallel.sharding import place

    m = make_multihost_mesh(dp=1, stage=2, tp=2, dcn_axis="stage",
                            devices=_port_devices(4, 2), rank=1)
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    s = place(x, m, ("stage", "tp"))
    assert s.shards[0, 0, 0] is None and s.shards[0, 0, 1] is None
    assert torch.equal(s.shards[0, 1, 1], x[2:4, 3:6])
    assert len(s.distinct()) == 2
    assert torch.equal(s.first(), x[2:4, 0:3])


def test_assign_hosts_to_stages_is_jaxs():
    from cake_tpu.parallel.distributed import assign_hosts_to_stages as j

    topo = {"a": None, "b": None, "c": None}
    assert assign_hosts_to_stages(topo, 2) == {"a": 0, "b": 1, "c": 0}
    assert assign_hosts_to_stages(topo, 2) == j(topo, 2)


@pytest.mark.parametrize("dp,stages,tp", [(2, 2, 2), (1, 2, 2), (1, 1, 2),
                                          (1, 4, 1)])
def test_build_mesh_auto_dcn_axis_is_jaxs(monkeypatch, dp, stages, tp):
    import jax

    import cake_tpu.parallel.distributed as jdist
    from cake_tpu.parallel.plan import ParallelPlan as JPlan

    from cake_tpu_torch.parallel.plan import ParallelPlan

    need = dp * stages * tp
    devs = jax.devices()[:need]
    fake = {id(d): i // (need // 2) for i, d in enumerate(devs)}
    monkeypatch.setattr(jdist, "_slice_ids",
                        lambda ds: [fake[id(d)] for d in ds])
    layout = [(f"s{i}", [i]) for i in range(stages)]
    jm = JPlan(dp, stages, tp, layout).build_mesh(devices=devs)
    want = [fake[id(d)] for d in jm.devices.flat]

    monkeypatch.setattr(pdist, "process_count", lambda: 2)
    monkeypatch.setattr(pdist, "process_index", lambda: 0)
    pm = ParallelPlan(dp, stages, tp, layout).build_mesh(
        devices=[torch.device("cpu", i) for i in range(need // 2)],
        device_type="cpu")
    assert [int(r) for r in pm.ranks.flat] == want
    assert pm.devices.shape == jm.devices.shape
