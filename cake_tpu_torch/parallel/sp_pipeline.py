"""Sequence parallelism composed with pipeline stages:
("stage", "sp"[, "tp"]).

Counterpart of `cake_tpu/parallel/sp_pipeline.py`: the long-context
deployment of a model too big for one device, layer ranges over stages
and, within every stage, the context sequence over "sp", so each
stage's sp group runs the ring prefill and the merged-stats decode of
parallel/context_parallel.py over its own block range. The stacked
block params are placed with their layer dim over "stage" (the GPipe
pipeline's rule, parallel/pipeline.pipeline_param_specs), heads / ffn
over "tp"; the caches' layer dim over "stage" too.

The chain is depth-1, one request in flight, as in JAX (this mode exists
for capacity and context; the batching engine batches across slots).
JAX ticks every stage under SPMD, keeps the live stage's writes
(`where(live, ...)`), ppermutes the hidden state to the next stage and
psums the last stage's output back to every stage. One controller runs
the live stage alone at each tick (`_stage_chain`): stage s runs its
block range on what stage s - 1 handed it, and the head reads the last
stage's output where it is. The bodies are context_parallel's, with
this chain: a fix to one mode cannot miss the other.
"""

from __future__ import annotations

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.parallel.context_parallel import (
    SPForward, create_sp_engine_cache, instrument_sp_engine,
    make_decode_ragged_fns, make_slot_prefill_fn, make_sp_engine_decode_body,
    make_sp_forward, sp_mode,
)
from cake_tpu_torch.parallel.mesh import Mesh
from cake_tpu_torch.parallel.pipeline import pipeline_param_specs
from cake_tpu_torch.parallel.sharding import tree_shard


def _stage_chain(x, run_stage, n_stages: int):
    """Depth-1 pipeline over the "stage" axis: run_stage(s, x) runs
    stage s's blocks on its devices over what stage s - 1 returned.
    Returns the last stage's output."""
    for s in range(n_stages):
        x = run_stage(s, x)
    return x


def make_sp_stage_forward(mesh: Mesh, config: LlamaConfig, ctx_len: int,
                          tail_len: int, kv_dtype=None):
    """(sp_prefill, sp_decode) over a ("stage", "sp"[, "tp"]) mesh, with
    context_parallel.make_sp_forward's call contract, so
    SPGeneratorForward drives either. The stages must divide the
    layers."""
    return make_sp_forward(mesh, config, ctx_len, tail_len,
                           kv_dtype=kv_dtype, chain=_stage_chain)


def place_sp_stage_params(mesh: Mesh, config: LlamaConfig, params):
    """The param dict placed as make_sp_stage_forward reads it: blocks
    layer-over-"stage" (heads / ffn over "tp" where the mesh has it),
    the embedding, final norm and lm_head replicated
    (pipeline_param_specs, so the two paths cannot drift)."""
    specs = pipeline_param_specs(
        params["blocks"].keys(), "tp" if "tp" in mesh.axis_names else None)
    return tree_shard(params, mesh, specs)


# the SPEngineCache over the stage x sp mesh: create_sp_engine_cache puts
# the layer dim over "stage" where the mesh has it (each stage holds its
# block range's KV)
create_sp_stage_engine_cache = create_sp_engine_cache


def make_sp_stage_engine_step_fns(mesh: Mesh, config: LlamaConfig,
                                  ctx_len: int, tail_len: int,
                                  kv_dtype=None):
    """The engine's step fns over the ("stage", "sp"[, "tp"]) mesh,
    context_parallel.make_sp_engine_step_fns' signatures and
    position-contiguous layout, the blocks chained over the stages."""
    core = SPForward(mesh, config, ctx_len, tail_len, kv_dtype=kv_dtype,
                     chain=_stage_chain)
    forward, step = make_decode_ragged_fns(make_sp_engine_decode_body(core))
    return instrument_sp_engine(
        (make_slot_prefill_fn(core), step, forward),
        sp_mode(mesh), ctx_len, tail_len)
