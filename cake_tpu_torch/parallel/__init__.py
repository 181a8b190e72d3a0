"""Topology-sharded execution on one controller: a mesh of torch
devices, placement of params and caches by spec, the GPipe pipeline and
sequence parallelism.

Counterpart of `cake_tpu/parallel/` (`mesh.py`, `plan.py`,
`sharding.py`, `pipeline.py`, `context_parallel.py`, `sp_pipeline.py`)
for pipeline stages, tensor, data, expert and sequence parallelism. JAX
runs one SPMD program over a `jax.sharding.Mesh` from one process; the
port keeps that shape: one process drives a `Mesh`, an array of
`torch.device` over JAX's axes ("dp", "stage", "tp", or an sp mesh's
with "sp"), where a position may repeat a device (the co-located mesh
of the tests, and of one card). A stage's hidden state moves to the
next stage's device; a tensor-parallel reduction sums the shards'
partials on the stage's device; `context_parallel.py` runs ring
attention over the sp positions and merges the decode's per-shard
stats, `sp_pipeline.py` chains it over stages.

Across processes (`distributed.py`, `hop.py`, `health.py`): one
controller per process, each running the mesh positions it owns; a
stage's output crosses to another process by a torch.distributed
send/recv, and the logits reach every rank; an sp mesh's ring chunks,
decode stats and stage hand-offs, and an image model's UNet rows,
cross the same way.
"""

from cake_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from cake_tpu_torch.parallel.plan import ParallelPlan  # noqa: F401
