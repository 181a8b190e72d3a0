"""Microbatched pipeline parallelism over a mesh of torch devices.

Counterpart of `cake_tpu/parallel/pipeline.py` (`_gpipe_stage_loop`,
`make_pipeline_forward`, `make_engine_step_fns`,
`pipeline_param_specs`, `place_for_pipeline`). The stacked block
params are placed with their layer dim over the mesh's `stage` axis
(and heads / ffn over `tp`); each stage runs its contiguous blocks, and
the hidden state moves to the next stage's device.

The GPipe schedule (`_gpipe`): JAX runs a `fori_loop` over ticks
0 .. M + S - 2 inside shard_map, every stage at every tick, masking the
side effects of a stage with no live microbatch (`where(live, ...)`)
and handing results on with `ppermute`. With one controller the tick
loop is a static Python loop, and a stage with no live microbatch at a
tick simply does not run, so no masking is needed; stage s runs
microbatch t - s at tick t, from what stage s - 1 handed it at tick
t - 1. The results are JAX's.

Tensor parallelism runs the stage's blocks through `model.run_blocks`
with a tp_reduce (JAX's psum over tp inside the block): every rank of
the stage computes its heads and its ffn slice on its own device, and
the row-parallel partials are summed in rank order on the stage's
first device (`model.tp_sum`). Data parallelism splits the batch into
the dp replicas' rows, each replica running its own pipeline (the
uniform forwards; the engine's steps, whose slots are admitted one at a
time, run replica 0, as JAX keeps the engine's batch off the dp axis).

On a mesh whose positions repeat one card every shard lives there and
every move is a no-op, so the pipelined steps capture into one CUDA
graph like the unsharded ones (serve/graphs). A mesh over several
distinct cards has not been run: its steps would launch on every card
from one stream of the first, untested.

On a mesh that spans processes (parallel/distributed.make_multihost_mesh,
the process boundary on the "stage" or "dp" axis) each process runs the
stages it owns: a stage's output crosses to a stage of another process
by a send/recv (parallel/hop.py), and the logits of each replica's last
stage reach every rank, so every process samples the same tokens. A
captured step is then cut at its hops (serve/graphs.segment_cut). The
tp ranks of a stage must live in one process.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.model import (
    RopeTables, run_blocks, run_blocks_ragged, slot_prefill,
)
from cake_tpu_torch.models.llama.params import block_specs
from cake_tpu_torch.ops.attention import (
    decode_mask_per_row, ring_decode_mask_per_row, uniform_forward_mask,
)
from cake_tpu_torch.ops.norms import rms_norm
from cake_tpu_torch.ops.quant import qmatmul
from cake_tpu_torch.ops.rope import rope_rows, rope_rows_per_row
from cake_tpu_torch.parallel.mesh import Mesh
from cake_tpu_torch.parallel.sharding import (
    ShardedKVCache, local, map_shards, shard_cache, tree_shard,
)
from cake_tpu_torch.utils.devices import index_copy_rows

def _to(t, dev):
    return t.to(dev) if isinstance(t, torch.Tensor) else t


class _Link:
    """One replica's stages across processes: which stages this process
    owns, and the hops of a microbatch's hidden state [mb, S, D] between
    stages of different processes."""

    def __init__(self, placement: "_Placement", d: int, S: int, dtype):
        self.p, self.d, self.S, self.dtype = placement, d, S, dtype

    def owns(self, s: int) -> bool:
        return self.p.owns(self.d, s)

    def send(self, y: torch.Tensor, s: int) -> None:
        """Stage s - 1's output to stage s's process."""
        self.p.hops.send(y, self.p.owner(self.d, s))

    def recv(self, s: int, mb: int) -> torch.Tensor:
        """Stage s's input from stage s - 1's process."""
        return self.p.hops.recv(
            (mb, self.S, self.p.config.hidden_size), self.dtype,
            self.p.mesh.device(self.d, s, 0), self.p.owner(self.d, s - 1))


def _gpipe(x: Optional[torch.Tensor], n_stages: int, num_microbatches: int,
           run_stage, link: Optional[_Link] = None,
           B: Optional[int] = None) -> Optional[torch.Tensor]:
    """GPipe over one replica's rows: x [B, ...] in microbatches of
    B / M rows; run_stage(s, inp, idx, mb) runs stage s's blocks over
    rows idx..idx+mb and returns its output. Returns the last stage's
    outputs for every row, in row order. With a `link` (a mesh across
    processes) only this process's stages run, a stage's output is sent
    where the next stage lives in another process and received there
    (x is None and B given where stage 0 is not this process's), and
    the result is None unless this process owns the last stage."""
    M = num_microbatches
    B = x.shape[0] if x is not None else B
    assert B % M == 0, f"local batch {B} not divisible by microbatches {M}"
    mb = B // M
    handed: dict = {}          # stage -> (microbatch, its input)
    outs: List[Optional[torch.Tensor]] = [None] * M
    for tick in range(M + n_stages - 1):
        nxt: dict = {}
        for s in range(n_stages):
            m = tick - s
            if not 0 <= m < M:
                continue       # the pipeline's bubble: nothing runs
            if link is not None and not link.owns(s):
                continue       # another process's stage
            if s == 0:
                inp = x[m * mb:(m + 1) * mb]
            elif link is not None and not link.owns(s - 1):
                inp = link.recv(s, mb)
            else:
                got_m, inp = handed[s]
                assert got_m == m
            y = run_stage(s, inp, m * mb, mb)
            if s == n_stages - 1:
                outs[m] = y
            elif link is not None and not link.owns(s + 1):
                link.send(y, s + 1)
            else:
                nxt[s + 1] = (m, y)
        handed.update(nxt)
    if outs[0] is None:
        return None
    return outs[0] if M == 1 else torch.cat(outs, dim=0)


class _Placement:
    """What the pipelined forwards share: the mesh, the config, the
    schedule's knobs, per-device copies of the rope tables, and each
    (replica, stage)'s local blocks and caches."""

    def __init__(self, mesh: Mesh, config: LlamaConfig,
                 num_microbatches: int, tp: bool, dp: bool, ring: bool):
        self.mesh, self.config = mesh, config
        self.M = num_microbatches
        self.tp, self.dp, self.ring = tp, dp, ring
        self.n_stages = mesh.shape["stage"]
        self.n_tp = mesh.shape["tp"]
        self.n_dp = mesh.shape["dp"] if dp else 1
        self._ropes: dict = {}
        self.hops = None
        if mesh.multiprocess:
            from cake_tpu_torch.parallel.distributed import hops
            for pos in np.ndindex(*mesh.devices.shape):
                if mesh.owner(*pos) != mesh.owner(pos[0], pos[1], 0):
                    raise ValueError(
                        "a stage's tp ranks span processes: the port "
                        "hops between processes on the 'stage' or 'dp' "
                        "axis only (dcn_axis='tp' is not supported)")
            self.hops = hops()

    def owns(self, d: int, s: int) -> bool:
        """Whether this process runs stage s of replica d."""
        return self.mesh.owns((d, s, 0))

    def owner(self, d: int, s: int) -> int:
        return self.mesh.owner(d, s, 0)

    def link(self, d: int, S: int, dtype) -> Optional[_Link]:
        """Replica d's cross-process link (None in one process)."""
        return None if self.hops is None else _Link(self, d, S, dtype)

    def base(self, d: int) -> torch.device:
        """Where replica d's per-row inputs (rope rows, mask) are built:
        stage 0's device, or this process's home where stage 0 is
        another's."""
        return (self.mesh.device(d, 0, 0) if self.owns(d, 0)
                else self.mesh.home)

    def embed(self, params, tokens, d: int, dev):
        """The embedded tokens on stage 0's device (None where stage 0
        is another process's)."""
        if not self.owns(d, 0):
            return None
        return local(params["embed"], d, 0, 0)[tokens.to(dev).long()]

    def act_dtype(self, params, d: int):
        """The hidden state's dtype (the embedding's, which every
        position holds)."""
        for s in range(self.n_stages):
            if self.owns(d, s):
                return local(params["embed"], d, s, 0).dtype
        return torch.float32

    def logits_to_all(self, params, y, d: int, rows: int, last_idx=None):
        """Replica d's logits [rows, V] f32 on every rank: the head on
        the last stage's process, then sent to every other (in one
        process, the head alone)."""
        s = self.n_stages - 1
        lg = self.head(params, y, d, last_idx) if y is not None else None
        if self.hops is None:
            return lg
        return self.hops.bcast(lg, self.owner(d, s),
                               (rows, self.config.vocab_size),
                               torch.float32, self.mesh.home)

    def rope(self, rope: RopeTables, dev) -> RopeTables:
        """The rope tables on `dev` (copied once a device)."""
        if rope.cos.device == dev:
            return rope
        key = (id(rope.cos), dev)
        got = self._ropes.get(key)
        if got is None:
            got = self._ropes[key] = RopeTables(rope.cos.to(dev),
                                                rope.sin.to(dev))
        return got

    def blocks(self, params, d: int, s: int) -> list:
        """Stage s's block params for replica d: the tp ranks' dicts (the
        one rank's without tp, `model.run_blocks`)."""
        return [local(params["blocks"], d, s, t)
                for t in range(self.n_tp if self.tp else 1)]

    def caches(self, cache: ShardedKVCache, d: int, s: int, idx: int,
               mb: int) -> list:
        """Stage s's cache lines of rows idx..idx+mb (views), one
        KVCache a tp rank."""
        out = []
        for t in range(self.n_tp if self.tp else 1):
            c = cache.local(d, s, t)
            if mb != c.k.shape[1]:
                c = KVCache(c.k.narrow(1, idx, mb), c.v.narrow(1, idx, mb))
            out.append(c)
        return out

    def head(self, params, y, d: int, last_idx=None) -> torch.Tensor:
        """Final norm and lm_head on the last stage's device: logits
        [B, V] f32 at each row's last_idx (default the last position)."""
        s = self.n_stages - 1
        norm = local(params["final_norm"], d, s, 0)
        y = rms_norm(y, norm, self.config.rms_norm_eps)
        if y.shape[1] == 1 or last_idx is None:
            last = y[:, -1]
        else:
            li = last_idx.to(y.device).long()
            last = y[torch.arange(y.shape[0], device=y.device), li]
        return qmatmul(last, local(params["lm_head"], d, s, 0)).float()


class PipelineForward(_Placement):
    """The pipelined uniform-position forward, JAX's
    `make_pipeline_forward` product: __call__(params, tokens, cache,
    pos, rope, last_idx=None, is_prefill=False, chunked=False,
    write_len=None, slot=None) -> (logits [B, V] f32 on the mesh's first
    device, cache). tokens [B, S] at absolute position pos (an int or a
    device tensor, read on the device); the cache is a ShardedKVCache
    written in place. slot: a one-slot prefill's [1] slot tensor (each
    stage splices that row of its lines, `model.run_blocks`)."""

    def __call__(self, params, tokens, cache: ShardedKVCache, pos,
                 rope: RopeTables, last_idx=None, is_prefill: bool = False,
                 chunked: bool = False, write_len=None, slot=None,
                 prefix=None):
        if prefix is not None:
            raise NotImplementedError(
                "the pipelined path installs a prefix and windows the "
                "suffix (install_prefix_sharded); it has no prefixed "
                "one-program prefill")
        B, S = tokens.shape
        T = cache.max_seq_len
        rows = B // self.n_dp
        pos = pos.reshape(()) if isinstance(pos, torch.Tensor) else int(pos)
        logits = []
        for d in range(self.n_dp):
            dev0 = self.base(d)
            tok = tokens[d * rows:(d + 1) * rows]
            x = self.embed(params, tok, d, dev0)
            r0 = self.rope(rope, dev0)
            p0 = _to(pos, dev0)
            rope_c, rope_s = rope_rows(r0.cos, r0.sin, p0, S)
            mask = uniform_forward_mask(
                p0, S, T, self.config.sliding_window, ring=self.ring,
                n_real=_to(write_len, dev0), device=dev0)
            li = (None if last_idx is None
                  else last_idx[d * rows:(d + 1) * rows])

            def run_stage(s, inp, idx, mb, d=d, rope_c=rope_c,
                          rope_s=rope_s, mask=mask):
                dev = self.mesh.device(d, s, 0)
                # a slot prefill splices its slot's rows out of the whole
                # cache; a batch takes its microbatch's rows
                rows = (self.caches(cache, d, s, 0, cache.batch_size)
                        if slot is not None
                        else self.caches(cache, d, s, idx, mb))
                y, _ = run_blocks(
                    self.blocks(params, d, s), inp.to(dev), rows,
                    _to(pos, dev),
                    rope_c.to(dev), rope_s.to(dev), mask.to(dev),
                    self.config, is_prefill=is_prefill, chunked=chunked,
                    ring=self.ring, write_len=_to(write_len, dev),
                    slot=_to(slot, dev))
                return y

            y = _gpipe(x, self.n_stages, self.M, run_stage,
                       self.link(d, S, self.act_dtype(params, d)), B=rows)
            logits.append(self.logits_to_all(params, y, d, rows, li))
        first = self.mesh.home
        out = (logits[0].to(first) if len(logits) == 1
               else torch.cat([lg.to(first) for lg in logits], dim=0))
        return out, cache


class PipelineRagged(_Placement):
    """The pipelined per-row-position decode, with `forward_ragged`'s
    signature (params, tokens [B, 1], cache, pos [B], active [B], rope,
    config) -> (logits [B, V] f32, cache): what the engine's decode step
    replays (JAX's `ragged_forward` inside `decode_ragged_fn` and the
    decode scan). Every per-row value (pos, active, rope rows, mask) is
    sliced per microbatch. Replica 0 only (the engine's slots are not
    dp-sharded)."""

    def __call__(self, params, tokens, cache: ShardedKVCache, pos, active,
                 rope: RopeTables, config=None):
        T = cache.max_seq_len
        dev0 = self.base(0)
        x = self.embed(params, tokens, 0, dev0)
        r0 = self.rope(rope, dev0)
        pos, active = pos.to(dev0), active.to(dev0)
        rope_c, rope_s = rope_rows_per_row(r0.cos, r0.sin, pos.long())
        if self.ring:
            mask = ring_decode_mask_per_row(pos, T)
        else:
            mask = decode_mask_per_row(pos, T,
                                       window=self.config.sliding_window)

        def run_stage(s, inp, idx, mb):
            dev = self.mesh.device(0, s, 0)
            sl = slice(idx, idx + mb)
            y, _ = run_blocks_ragged(
                self.blocks(params, 0, s), inp.to(dev),
                self.caches(cache, 0, s, idx, mb), pos[sl].to(dev),
                active[sl].to(dev), rope_c[sl].to(dev), rope_s[sl].to(dev),
                mask[sl].to(dev), self.config, ring=self.ring)
            return y

        y = _gpipe(x, self.n_stages, self.M, run_stage,
                   self.link(0, 1, self.act_dtype(params, 0)),
                   B=tokens.shape[0])
        logits = self.logits_to_all(params, y, 0, tokens.shape[0])
        return logits.to(self.mesh.home), cache


def make_pipeline_forward(mesh: Mesh, config: LlamaConfig,
                          num_microbatches: int = 1, tp: bool = False,
                          dp: bool = False,
                          ring: bool = False) -> PipelineForward:
    """The pipelined forward over `mesh` (see PipelineForward).

    Placement contract (`place_for_pipeline`): the blocks' layer dim
    over "stage" (heads / ffn over "tp" with tp), the cache's layers
    over "stage", batch over "dp" with dp, kv heads over "tp" with tp;
    embedding, final norm and lm_head replicated. JAX's `params=` (it
    sized the quantized specs there) has no counterpart: the port reads
    each leaf's shards."""
    return PipelineForward(mesh, config, num_microbatches, tp, dp, ring)


def make_engine_step_fns(mesh: Mesh, config: LlamaConfig,
                         num_microbatches: int = 1, tp: bool = False,
                         ring: bool = False):
    """Pipelined replacements for the dense engine's steps: returns
    (prefill_slot_fn, decode_ragged_fn, decode_scan_fn,
    prefill_chunk_fn) with the signatures of model.prefill_slot,
    model.decode_step_ragged, the ragged forward the engine's decode
    runner replays K times a burst (model.forward_ragged's; JAX's
    decode scan of it) and model.prefill_slot_chunk, so the engine runs
    continuous batching, K-step bursts and chunked prefill over the
    sharded model unchanged. The ring variant refuses whole-bucket
    prefill (every ring prompt walks chunk windows)."""
    fwd = PipelineForward(mesh, config, 1, tp, False, ring)
    ragged = PipelineRagged(mesh, config, num_microbatches, tp, False, ring)

    @torch.inference_mode()
    def prefill_slot_fn(params, tokens, prompt_len, slot, cache, rope,
                        config=None):
        if ring:
            # the engine routes EVERY ring prompt through chunk windows;
            # a whole-bucket prefill could exceed the ring capacity
            raise RuntimeError(
                "whole-bucket prefill is not available on the ring "
                "pipelined path (engine forces chunked prefill)")

        def pipelined(p, t, c, pos, last_idx, slot=None, prefix=None):
            return fwd(p, t, c, pos, rope, last_idx=last_idx,
                       is_prefill=True, slot=slot, prefix=prefix)

        return slot_prefill(params, tokens, prompt_len, slot, cache,
                            pipelined)

    @torch.inference_mode()
    def decode_ragged_fn(params, tokens, pos, active, cache, rope,
                         config=None):
        return ragged(params, tokens, cache, pos, active, rope, config)

    @torch.inference_mode()
    def prefill_chunk_fn(params, tokens, n_real, slot, pos0, cache, rope,
                         config=None):
        """One fixed-size window into slot `slot` at absolute position
        pos0, through the cache-aware (chunked) pipelined forward."""
        n = n_real.reshape(()) if isinstance(n_real, torch.Tensor) else n_real

        def pipelined(p, t, c, pos, last_idx, slot=None, prefix=None):
            return fwd(p, t, c, pos, rope, last_idx=last_idx,
                       is_prefill=True, chunked=True,
                       write_len=n if ring else None, slot=slot,
                       prefix=prefix)

        return slot_prefill(params, tokens, n_real, slot, cache, pipelined,
                            pos0=pos0)

    return prefill_slot_fn, decode_ragged_fn, ragged, prefill_chunk_fn


def pipeline_param_specs(blocks_keys,
                         tp_axis: Optional[str] = None) -> dict:
    """The param specs make_pipeline_forward expects: the stacked layer
    dim over "stage" (the topology's block ranges), heads / ffn over tp;
    embedding, lm_head and norms replicated."""
    return {
        "embed": (None, None),
        "blocks": block_specs(blocks_keys, stage_axis="stage",
                              tp_axis=tp_axis),
        "final_norm": (None,),
        "lm_head": (None, None),
    }


def place_params(params, mesh: Mesh, *, tp: bool = False):
    """The param dict placed as make_pipeline_forward expects (QTensor
    leaves by their expanded (q, scale) specs)."""
    specs = pipeline_param_specs(params["blocks"].keys(),
                                 "tp" if tp else None)
    return tree_shard(params, mesh, specs)


def place_for_pipeline(params, cache: KVCache, mesh: Mesh, *,
                       tp: bool = False, dp: bool = False):
    """params and cache placed with the specs make_pipeline_forward
    expects."""
    out = place_params(params, mesh, tp=tp)
    cache = shard_cache(cache, mesh, tp_axis="tp" if tp else None,
                        dp_axis="dp" if dp else None, stage_axis="stage")
    return out, cache


@torch.inference_mode()
def prefix_lines(cache: ShardedKVCache, P: int) -> ShardedKVCache:
    """Positions 0..P-1 of a one-slot sharded cache, each shard its own
    copy (a registered prefix's KV on the pipelined engine, sharded as
    the serving cache is)."""
    def cut(s):
        shape = list(s.shape)
        shape[2] = P
        return map_shards(s, shape, s.dtype, s.spec,
                          lambda pos, t: t[:, :, :P].contiguous())

    return ShardedKVCache(cut(cache.k), cut(cache.v))


@torch.inference_mode()
def install_prefix_sharded(cache: ShardedKVCache, prefix: ShardedKVCache,
                           slot: int) -> ShardedKVCache:
    """Copy a sharded prefix's lines [L, 1, P, ...] into slot `slot`'s
    positions 0..P-1 of the serving cache, shard by shard
    (`model.install_prefix_slot` over a sharded cache)."""
    P = prefix.max_seq_len
    done = set()
    for pos in np.ndindex(*cache.k.shards.shape):
        for dst, src in ((cache.k, prefix.k), (cache.v, prefix.v)):
            t = dst.shards[pos]
            if t is None or id(t) in done:
                continue
            done.add(id(t))
            s = torch.tensor([int(slot)], dtype=torch.int64, device=t.device)
            index_copy_rows(t[:, :, :P], 1, s, src.shards[pos])
    return cache
