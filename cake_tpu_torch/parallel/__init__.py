"""Topology-sharded execution on one controller: a mesh of torch
devices, placement of params and caches by spec, and the GPipe pipeline.

Counterpart of `cake_tpu/parallel/` (`mesh.py`, `plan.py`,
`sharding.py`, `pipeline.py`) for pipeline stages, tensor, data and
expert parallelism. JAX runs one SPMD program over a
`jax.sharding.Mesh` from one process; the port keeps that shape: one
process drives a `Mesh`, an array of `torch.device` over JAX's axes
("dp", "stage", "tp"), where a position may repeat a device (the
co-located mesh of the tests, and of one card). A stage's hidden state
moves to the next stage's device; a tensor-parallel reduction sums the
shards' partials on the stage's device. Sequence parallelism and
multi-host serving are not ported.
"""

from cake_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from cake_tpu_torch.parallel.plan import ParallelPlan  # noqa: F401
