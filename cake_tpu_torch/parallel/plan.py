"""ParallelPlan: topology.yml + Args -> mesh shape and stage layout.

Counterpart of `cake_tpu/parallel/plan.py` (`ParallelPlan`,
`placement_memory`): the topology's contiguous block ranges become the
mesh's pipeline stages, `--tp` and `--dp` its other axes.

`HBM_BUDGET` holds the memory of the card the port runs on, as the
card reports it (`torch.cuda.get_device_properties(0).total_memory`),
not JAX's TPU table: `placement_memory` estimates a plan's bytes per
device without materialising anything (shapes from a meta-device init),
with the same placement specs the pipeline applies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.parallel.mesh import make_mesh

# bytes of device memory by card: the NVIDIA H100 80GB HBM3's
# total_memory as torch reports it on the card (chip_smoke.py's parallel
# phase prints it; the card's power limit 700 W)
HBM_BUDGET = {
    "h100": 85_017_493_504,
}


@dataclass
class ParallelPlan:
    dp: int
    stages: int
    tp: int
    stage_layout: List[Tuple[str, List[int]]]  # (node name, block indices)

    @classmethod
    def from_topology(
        cls,
        config: LlamaConfig,
        topology,
        args=None,
        num_devices: Optional[int] = None,
    ) -> "ParallelPlan":
        """The plan of a topology (None: one stage) and the args' --dp /
        --tp. Stages must be of equal size (one program a stage);
        num_devices: the devices the mesh may use (None: no limit,
        which the mesh checks itself when it is built)."""
        L = config.num_hidden_layers
        dp = args.dp if args else 1
        tp = args.tp if args else 1

        if topology is None or len(topology) == 0:
            return cls(dp=dp, stages=1, tp=tp,
                       stage_layout=[("master", list(range(L)))])

        layout = topology.stage_assignments(L)
        sizes = {len(blocks) for _, blocks in layout}
        if len(sizes) != 1:
            raise ValueError(
                "SPMD pipeline requires equal-size stages; topology gives "
                f"ranges of sizes {sorted(len(b) for _, b in layout)}. "
                "Rebalance topology.yml block ranges."
            )
        stages = len(layout)
        n = num_devices
        if n is not None and dp * stages * tp > n:
            raise ValueError(
                f"plan dp={dp} stages={stages} tp={tp} needs "
                f"{dp * stages * tp} devices, have {n}"
            )
        return cls(dp=dp, stages=stages, tp=tp, stage_layout=layout)

    @property
    def sharded(self) -> bool:
        return self.stages > 1 or self.tp > 1 or self.dp > 1

    def build_mesh(self, devices=None, device_type: str = "cuda",
                   dcn_axis: Optional[str] = None):
        """The (dp, stage, tp) mesh over `devices` (None: each visible
        card once on CUDA, the CPU at every position on the CPU).

        With more than one process (parallel/distributed.initialize) the
        mesh spans them (`make_multihost_mesh`): `devices` are this
        process's (every process holds alike), and the `dcn_axis`, the
        one that crosses the process boundary, is JAX's auto-selection
        when None: the first of dp -> stage -> tp whose size the process
        count divides (dp replicas are independent; a stage crosses
        once per pipeline hop; tp is the last resort)."""
        from cake_tpu_torch.parallel.distributed import (
            _slice_ids, global_devices, make_multihost_mesh, process_count,
        )
        n = process_count()
        if n == 1:
            return make_mesh(dp=self.dp, stage=self.stages, tp=self.tp,
                             devices=devices, device_type=device_type)
        need = self.dp * self.stages * self.tp
        per = -(-need // n)
        if devices is None:
            from cake_tpu_torch.parallel.mesh import default_devices
            devices = default_devices(device_type)
            if device_type != "cuda":
                devices = devices * per
        gdevs = global_devices([torch.device(d) for d in devices], n)
        if dcn_axis is None:
            n_slices = len(set(_slice_ids(gdevs)))
            sizes = {"dp": self.dp, "stage": self.stages, "tp": self.tp}
            dcn_axis = next((a for a in ("dp", "stage", "tp")
                             if sizes[a] % n_slices == 0), "dp")
        return make_multihost_mesh(dp=self.dp, stage=self.stages,
                                   tp=self.tp, dcn_axis=dcn_axis,
                                   devices=gdevs)

    def describe(self) -> str:
        lines = [f"mesh: dp={self.dp} x stage={self.stages} x tp={self.tp}"]
        for name, blocks in self.stage_layout:
            lines.append(
                f"  stage[{name}]: blocks {blocks[0]}..{blocks[-1]}"
            )
        return "\n".join(lines)


def placement_memory(config, *, dp: int = 1, stages: int = 1, tp: int = 1,
                     batch_size: int = 1, max_seq_len: int = 4096,
                     dtype=torch.bfloat16,
                     quant: "bool | str" = False) -> dict:
    """Bytes per device of a pipeline placement, from shapes only (a
    meta-device init, nothing allocated).

    quant: False = full precision, True or "int8" = per-channel int8,
    "int4" = packed group-wise int4 (the lm_head stays int8). The specs
    are `place_params`', so the estimate cannot drift from the real
    placement."""
    from cake_tpu_torch.models.llama.params import cache_specs, init_params
    from cake_tpu_torch.ops.quant import (
        QTensor, expand_specs_for_quant, quantize_params,
    )
    from cake_tpu_torch.parallel.pipeline import pipeline_param_specs

    shapes = init_params(config, None, device="meta", dtype=dtype)
    if quant:
        shapes = quantize_params(shapes, bits=4 if quant == "int4" else 8)

    axis_size = {"dp": dp, "stage": stages, "tp": tp, None: 1}
    tp_axis = "tp" if tp > 1 else None
    specs = expand_specs_for_quant(
        shapes, pipeline_param_specs(shapes["blocks"].keys(), tp_axis))

    def div(spec) -> int:
        n = 1
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                n *= axis_size.get(ax, 1)
        return n

    def per_device(leaf, spec) -> float:
        if isinstance(leaf, QTensor):
            return (per_device(leaf.q, spec.q)
                    + per_device(leaf.scale, spec.scale))
        if isinstance(leaf, dict):
            return sum(per_device(v, spec[k]) for k, v in leaf.items())
        return leaf.numel() * leaf.element_size() / div(spec)

    params_bytes = per_device(shapes, specs)

    cspec = cache_specs(tp_axis=tp_axis or "tp",
                        dp_axis="dp" if dp > 1 else None,
                        stage_axis="stage").k
    L = config.num_hidden_layers
    KV, hd = config.num_key_value_heads, config.head_dim
    cache_elems = L * batch_size * max_seq_len * KV * hd
    cache_bytes = 2 * cache_elems * 2 / div(cspec)  # k+v, bf16

    total = params_bytes + cache_bytes
    return {
        "dp": dp, "stages": stages, "tp": tp,
        "devices": dp * stages * tp,
        "params_bytes_per_device": int(params_bytes),
        "cache_bytes_per_device": int(cache_bytes),
        "total_bytes_per_device": int(total),
        "total_gib_per_device": round(total / 2**30, 2),
    }
