"""Offline weight splitting: per-stage safetensors bundles.

Counterpart of `cake_tpu/tools/split_model.py`, the reference's
`cake-split-model` (cake-split-model/src/main.rs), over the port's
topology and loader: for each topology node, select the tensors whose
names prefix-match the node's layers (main.rs:86-100), copy them into
`{worker}-node/model/reduced.safetensors` with a rewritten index plus a
single-entry topology.yml (main.rs:158-221), and round-trip-validate the
output (main.rs:199-205). The bundles are byte for byte the JAX tool's
on the same checkpoint and topology.

Each host of a multi-process mesh can then stage only its pipeline
stage's weights. (In one process, `load_params_from_hf(layer_range=...)`
already loads stage-locally without an offline step.)

Usage:
    python -m cake_tpu_torch.tools.split_model --model-path DIR \
        --topology topology.yml --output OUT
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict

from cake_tpu_torch.topology import Node, Topology
from cake_tpu_torch.utils.loading import (
    StTensor, load_weight_index, load_weights, save_safetensors,
)

# Tensors every stage needs regardless of block range (embedding, final
# norm, lm_head live on the first/last stage; they are bundled with the
# first node).
SHARED_TENSOR_PREFIXES = ("model.embed_tokens", "model.norm", "lm_head")


def reduce_for_node(model_dir: str, node: Node,
                    include_shared: bool = False) -> Dict[str, StTensor]:
    """Select this node's tensors (reference reduce_for_worker semantics)."""
    def want(name: str) -> bool:
        if node.owns_layer(name):
            return True
        if include_shared and name.startswith(SHARED_TENSOR_PREFIXES):
            return True
        return False

    return load_weights(model_dir, filter_fn=want)


def split_model(model_dir: str, topology_path: str, output_dir: str) -> list:
    """Write one `{node}-node/` bundle per topology entry.

    Layout matches the reference (main.rs:158-221):
      {output}/{node}-node/model/reduced.safetensors
      {output}/{node}-node/model/model.safetensors.index.json
      {output}/{node}-node/topology.yml
      + config.json / tokenizer.json copied alongside when present.
    """
    topo = Topology.from_path(topology_path)
    index = load_weight_index(model_dir)
    written = []

    for i, (name, node) in enumerate(topo.items()):
        tensors = reduce_for_node(model_dir, node, include_shared=(i == 0))
        if not tensors:
            raise ValueError(f"node '{name}' matches no tensors in the index")
        missing = [t for t in tensors if t not in index]
        if missing:
            raise ValueError(f"tensors not in source index: {missing[:5]}")

        node_dir = os.path.join(output_dir, f"{name}-node", "model")
        os.makedirs(node_dir, exist_ok=True)
        st_path = os.path.join(node_dir, "reduced.safetensors")
        # torch tensors keep each tensor's stored dtype (BF16 included)
        save_safetensors(st_path, {k: v.to_torch()
                                   for k, v in tensors.items()})

        # rewritten single-file index
        new_index = {
            "metadata": {"total_size": sum(
                v.raw.nbytes for v in tensors.values())},
            "weight_map": {k: "reduced.safetensors" for k in tensors},
        }
        with open(os.path.join(node_dir, "model.safetensors.index.json"),
                  "w") as f:
            json.dump(new_index, f, indent=1)

        # single-node topology
        single = Topology.from_dict({name: {
            "host": node.host, "description": node.description,
            "layers": list(node.layers),
        }})
        with open(os.path.join(output_dir, f"{name}-node", "topology.yml"),
                  "w") as f:
            f.write(single.to_yaml())

        for extra in ("config.json", "tokenizer.json"):
            src = os.path.join(model_dir, extra)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(node_dir, extra))

        # round-trip validation (reference main.rs:199-205)
        reloaded = load_weights(node_dir)
        if set(reloaded) != set(tensors):
            raise RuntimeError(f"validation failed for node '{name}'")
        for k, v in tensors.items():
            if tuple(reloaded[k].shape) != tuple(v.shape):
                raise RuntimeError(f"shape mismatch for {k}")
        written.append((name, st_path, len(tensors)))
    return written


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="cake-split-model")
    p.add_argument("--model-path", required=True)
    p.add_argument("--topology", required=True)
    p.add_argument("--output", required=True)
    a = p.parse_args(argv)
    for name, path, n in split_model(a.model_path, a.topology, a.output):
        print(f"{name}: {n} tensors -> {path}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
