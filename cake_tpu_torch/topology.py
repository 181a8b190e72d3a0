"""Topology: the user's mapping of model layers onto devices.

Counterpart of `cake_tpu/topology.py` (`expand_layer_expr`, `Node`,
`Topology`), copied: a YAML map of node name -> {host, description,
layers: [...]} whose layer lists take range expressions such as
``model.layers.0-15`` (inclusive; stop <= start is refused). A node owns
a contiguous block range, which becomes a pipeline stage of the mesh
(`parallel/plan.py`); `stage:` orders the stages explicitly and
`devices:` names device indices (Stable Diffusion's component
placement). `host` is kept for the file's compatibility.

The file is read with PyYAML's `safe_load`, as JAX reads it (the card's
machine has PyYAML too).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import yaml

# Range expression: everything up to a non-digit, then start-stop.
_LAYER_RANGE_PARSER = re.compile(r"^(.+\D)(\d+)-(\d+)$")


def expand_layer_expr(expr: str) -> List[str]:
    """Expand ``model.layers.0-15`` -> [model.layers.0, ...,
    model.layers.15]. Non-range expressions pass through unchanged.
    Inclusive on both ends; raises ValueError when stop <= start."""
    m = _LAYER_RANGE_PARSER.match(expr)
    if m is None:
        return [expr]
    prefix, start_s, stop_s = m.groups()
    start, stop = int(start_s), int(stop_s)
    if stop <= start:
        raise ValueError(
            f"invalid range expression '{expr}': stop must be > start"
        )
    return [f"{prefix}{i}" for i in range(start, stop + 1)]


@dataclass
class Node:
    """One entry of the topology: a named owner of a set of layers (a
    pipeline stage, or a device group for SD's components)."""

    host: str = ""
    description: str = ""
    layers: List[str] = field(default_factory=list)
    stage: Optional[int] = None          # explicit pipeline-stage index
    devices: Optional[List[int]] = None  # device indices

    _expanded: Optional[List[str]] = field(default=None, repr=False)

    def expanded_layers(self) -> List[str]:
        """Every concrete layer name this node owns (ranges expanded)."""
        if self._expanded is None:
            names: List[str] = []
            for expr in self.layers:
                names.extend(expand_layer_expr(expr))
            self._expanded = names
        return self._expanded

    def owns_layer(self, full_layer_name: str) -> bool:
        """Prefix match, for weight selection: a node owning
        `model.layers.3` owns `model.layers.3.self_attn.q_proj.weight`."""
        for layer in self.expanded_layers():
            if full_layer_name == layer or full_layer_name.startswith(
                    layer + "."):
                return True
        return False

    def block_indices(self, prefix: str = "model.layers.") -> List[int]:
        """Numeric transformer-block indices owned by this node."""
        idx = []
        for layer in self.expanded_layers():
            if layer.startswith(prefix):
                tail = layer[len(prefix):]
                if tail.isdigit():
                    idx.append(int(tail))
        return sorted(idx)


class Topology:
    """Ordered mapping node name -> Node (document order is the default
    stage order)."""

    def __init__(self, nodes: "Dict[str, Node]"):
        self.nodes: Dict[str, Node] = nodes

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_path(cls, path: str) -> "Topology":
        """Load and validate a topology.yml."""
        with open(path, "r") as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw or {})

    @classmethod
    def from_dict(cls, raw: dict) -> "Topology":
        nodes: Dict[str, Node] = {}
        for name, spec in raw.items():
            spec = spec or {}
            node = Node(
                host=spec.get("host", ""),
                description=spec.get("description", ""),
                layers=list(spec.get("layers", []) or []),
                stage=spec.get("stage"),
                devices=list(spec["devices"]) if spec.get("devices") else None,
            )
            node.expanded_layers()  # validate ranges eagerly
            nodes[name] = node
        return cls(nodes)

    # -- mapping interface --------------------------------------------------

    def __getitem__(self, name: str) -> Node:
        return self.nodes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self) -> Iterator[str]:
        return iter(self.nodes)

    def items(self):
        return self.nodes.items()

    def keys(self):
        return self.nodes.keys()

    def values(self):
        return self.nodes.values()

    # -- queries ------------------------------------------------------------

    def get_node_for_layer(self, layer_name: str) -> Optional[Tuple[str, Node]]:
        """Exact-match lookup of the owner of a concrete layer name."""
        for name, node in self.nodes.items():
            if layer_name in node.expanded_layers():
                return name, node
        return None

    def stage_assignments(
        self, num_layers: int, prefix: str = "model.layers."
    ) -> List[Tuple[str, List[int]]]:
        """Ordered (node_name, contiguous block indices) pipeline stages.

        Blocks no node claims go to a synthetic first stage `master`
        (the reference's master runs unclaimed layers itself). Each
        node's blocks must be contiguous, and no block may be claimed
        twice."""
        stages: List[Tuple[str, List[int]]] = []
        claimed = set()
        ordered = sorted(
            self.nodes.items(),
            key=lambda kv: (kv[1].stage if kv[1].stage is not None else 1 << 30),
        ) if any(n.stage is not None for n in self.nodes.values()) else list(self.nodes.items())
        for name, node in ordered:
            blocks = [b for b in node.block_indices(prefix) if b < num_layers]
            if not blocks:
                continue
            if blocks != list(range(blocks[0], blocks[-1] + 1)):
                raise ValueError(
                    f"node '{name}' owns non-contiguous blocks {blocks}; "
                    "pipeline stages must own contiguous ranges"
                )
            overlap = claimed.intersection(blocks)
            if overlap:
                raise ValueError(
                    f"blocks {sorted(overlap)} claimed by multiple nodes"
                )
            claimed.update(blocks)
            stages.append((name, blocks))
        unclaimed = [i for i in range(num_layers) if i not in claimed]
        if unclaimed:
            if stages and claimed:
                stages.insert(0, ("master", unclaimed))
                if unclaimed != list(range(unclaimed[0], unclaimed[-1] + 1)):
                    raise ValueError(
                        f"unclaimed blocks {unclaimed} are non-contiguous"
                    )
            else:
                stages = [("master", unclaimed)]
        # order stages by first block so the pipeline walks 0..num_layers
        stages.sort(key=lambda s: s[1][0])
        flat = [b for _, bs in stages for b in bs]
        if flat != list(range(num_layers)):
            raise ValueError(
                f"stage assignment does not cover 0..{num_layers - 1} exactly: {stages}"
            )
        return stages

    def to_dict(self) -> dict:
        raw = {}
        for name, node in self.nodes.items():
            spec: dict = {
                "host": node.host,
                "description": node.description,
                "layers": list(node.layers),
            }
            if node.stage is not None:
                spec["stage"] = node.stage
            if node.devices is not None:
                spec["devices"] = list(node.devices)
            raw[name] = spec
        return raw

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)
