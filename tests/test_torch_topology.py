"""The port's topology (cake_tpu_torch/topology.py) against the JAX
package's: the cases of tests/test_topology.py, the same stage
assignments and refusals on the same dicts, and the same topologies
read from every fixture file of the JAX tests."""

import pytest

from cake_tpu.topology import Topology as JTopology
from cake_tpu_torch.topology import Node, Topology, expand_layer_expr

# the fixture topologies of tests/test_serving_topology.py,
# tests/test_moe.py and tests/test_sd.py, and block/flow variants
FIXTURES = [
    """\
worker0:
  host: 10.0.0.1:10128
  description: first half
  layers:
    - model.layers.0-1
worker1:
  host: 10.0.0.2:10128
  description: second half
  layers:
    - model.layers.2-3
""",
    "s0:\n  layers:\n    - model.layers.0\n"
    "s1:\n  layers:\n    - model.layers.1\n",
    "enc:\n  host: 10.0.0.1:10128\n  description: clip\n"
    "  devices: [1]\n  layers:\n    - clip\n"
    "gpu:\n  host: 10.0.0.2:10128\n  description: unet\n"
    "  devices: [2]\n  layers:\n    - unet\n"
    "dec:\n  host: 10.0.0.3:10128\n  description: vae\n"
    "  devices: [3]\n  layers:\n    - vae\n",
    "# a comment\n---\nb:\n  stage: 1\n  layers: [model.layers.2-3]\n"
    "a:\n  stage: 0\n  host: 'h:1'\n  description: \"d\"\n"
    "  layers:\n  - model.layers.0-1\n  devices:\n    - 0\n    - 1\n",
    "lonely:\n  layers:\n",
]

STAGE_DICTS = [
    {"a": {"layers": ["model.layers.0-1"]},
     "b": {"layers": ["model.layers.2-3"]}},
    {"b": {"layers": ["model.layers.2-3"]}},
    {"b": {"stage": 0, "layers": ["model.layers.4-7"]},
     "a": {"stage": 1, "layers": ["model.layers.0-3"]}},
    {"x": {"layers": ["vae"]}},
]


def test_expand_range():
    assert expand_layer_expr("model.layers.0-3") == [
        "model.layers.0", "model.layers.1", "model.layers.2",
        "model.layers.3",
    ]


def test_expand_non_range_passthrough():
    assert expand_layer_expr("vae") == ["vae"]
    assert expand_layer_expr("model.layers.7") == ["model.layers.7"]


def test_expand_rejects_bad_range():
    for expr in ("model.layers.5-5", "model.layers.9-2"):
        with pytest.raises(ValueError, match="stop must be > start"):
            expand_layer_expr(expr)


def test_from_dict_and_lookup():
    topo = Topology.from_dict({
        "worker_a": {"host": "10.0.0.1:10128",
                     "layers": ["model.layers.0-1"]},
        "worker_b": {"host": "10.0.0.2:10128",
                     "layers": ["model.layers.2", "model.layers.3"]},
    })
    assert len(topo) == 2
    name, node = topo.get_node_for_layer("model.layers.2")
    assert name == "worker_b"
    assert topo.get_node_for_layer("model.layers.99") is None


def test_owns_layer_prefix_match():
    node = Node(layers=["model.layers.0-1"])
    assert node.owns_layer("model.layers.1.self_attn.q_proj.weight")
    assert not node.owns_layer("model.layers.10.self_attn.q_proj.weight")
    assert not node.owns_layer("model.norm.weight")


def test_stage_assignments_even():
    topo = Topology.from_dict(STAGE_DICTS[0])
    assert topo.stage_assignments(4) == [("a", [0, 1]), ("b", [2, 3])]


def test_stage_assignments_unclaimed_go_to_master():
    topo = Topology.from_dict(STAGE_DICTS[1])
    assert topo.stage_assignments(4) == [("master", [0, 1]), ("b", [2, 3])]


@pytest.mark.parametrize("raw", [
    {"a": {"layers": ["model.layers.0-2"]},
     "b": {"layers": ["model.layers.2-3"]}},
    {"a": {"layers": ["model.layers.0", "model.layers.2"]}},
    {"a": {"layers": ["model.layers.1"]},
     "b": {"layers": ["model.layers.3"]}},
])
def test_stage_assignments_rejects_overlap(raw):
    """Overlap, non-contiguous blocks and non-contiguous unclaimed
    blocks: both packages refuse with the same message."""
    with pytest.raises(ValueError) as got:
        Topology.from_dict(raw).stage_assignments(4)
    with pytest.raises(ValueError) as want:
        JTopology.from_dict(raw).stage_assignments(4)
    assert str(got.value) == str(want.value)


def test_yaml_roundtrip(tmp_path):
    topo = Topology.from_dict({
        "a": {"host": "h:1", "description": "d",
              "layers": ["model.layers.0-1"], "stage": 0,
              "devices": [0, 2]},
    })
    p = tmp_path / "topology.yml"
    p.write_text(topo.to_yaml())
    topo2 = Topology.from_path(str(p))
    assert topo2["a"].expanded_layers() == ["model.layers.0",
                                            "model.layers.1"]
    assert topo2.to_dict() == topo.to_dict()
    assert topo.to_yaml() == JTopology.from_dict(topo.to_dict()).to_yaml()


@pytest.mark.parametrize("raw, L", zip(STAGE_DICTS, (4, 4, 8, 3)))
def test_stage_assignments_are_jaxs(raw, L):
    assert (Topology.from_dict(raw).stage_assignments(L)
            == JTopology.from_dict(raw).stage_assignments(L))


@pytest.mark.parametrize("text", FIXTURES)
def test_files_read_as_jaxs(text, tmp_path):
    p = tmp_path / "t.yml"
    p.write_text(text)
    assert Topology.from_path(str(p)).to_dict() == \
        JTopology.from_path(str(p)).to_dict()
