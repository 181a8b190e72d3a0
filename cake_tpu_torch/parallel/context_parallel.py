"""Sequence (context) parallelism: ring attention over an "sp" mesh axis.

Counterpart of `cake_tpu/parallel/context_parallel.py`. The prompt's
context window [0, ctx_len) is split into sp chunks of Sl = ctx_len / sp
tokens, chunk i on the mesh's sp position i. A prefill runs every
block over the chunks: each chunk's q/k/v on its position, ring
attention over the chunks (`ring_attention`), then each chunk's wo,
residual and FFN. Decode keeps the prefilled KV where it was computed
(the context cache, sharded over sp) and gives the group a replicated
decode tail for the generated tokens: a step computes partial attention
stats (m, l, o) against every context shard, merges them with a
logsumexp reduction and adds the tail (`sp_merged_attention`), so the
long context is never resharded.

JAX runs each position's body under `shard_map` and moves data with
`ppermute`, `pmax` and `psum`. In one process the port keeps the
pipeline's one controller over a mesh of torch devices
(parallel/mesh.py), with no torch.distributed: the ring is a static
Python loop over the sp positions, where a hop moves each k/v chunk to
the next position's device into buffers allocated before the loop (a
co-located hop moves nothing); the decode merge is a loop in which the
first position takes the max of the shards' m and sums their rescaled
l and o. A body that JAX replicates over sp (the decode block around
its attention, the last-token projection) runs once, on the group's
first position.

Tensor parallelism runs every chunk's heads per tp rank through the
halves of `model.block_skeleton` (`block_qkv`, `block_finish`), the wo
and FFN partials summed by `model.tp_sum`; the ring rotates chunks of
a rank's own heads. Data parallelism splits the batch (the engine's
slots) into dp groups, each running its own ring. Pipeline stages
(parallel/sp_pipeline.py) chain each stage's block range through the
same bodies. MoE blocks (a `router` leaf) run through the same FFN
half.

Caches: `SPCache` (context [L, B, ctx_len, KV, hd], its sequence dim
over "sp"; tail [L, B, tail_len, KV, hd], replicated over sp; layers
over "stage", batch over "dp" and kv heads over "tp" where the mesh has
them) is allocated once and written in place, since captured steps
hold it (JAX's prefill allocates a fresh one and donates it through
decode). The k/v are cast to the storage dtype (`--kv-dtype`, fp8
included) inside the layer, and attention reads them upcast.

The engine's step fns (`make_sp_engine_step_fns`) keep JAX's
position-contiguous layout: row b's generated token t sits at rope
position plen[b] + t in tail slot t, so greedy streams equal the dense
engine's for any prompt length. The batch-1 generator adapter
(`SPGeneratorForward`) keeps JAX's window layout: generated tokens sit
at positions ctx_len + k, a gap after a short prompt.

Observability: `cake_sp_dispatch_total{op,mode}`,
`cake_sp_dispatch_seconds{op,mode}`, `cake_sp_ctx_window_tokens{mode}`
and `cake_sp_tail_window_tokens{mode}` (`instrument_sp_engine`). A
dispatch is an eager call of a step fn, or on the card a replay of its
captured graph (serve/graphs.on_replay).

Across processes (a mesh from `distributed.make_multihost_sp_mesh`,
each position carrying its rank) each process runs only its positions
and the moves become hops (parallel/hop.py; `SPHop`): without stages the
sp axis crosses processes, so a ring chunk moves forward by send/recv
while a later position still needs it (`_ring_across`), a decode
step's q goes out and each shard's (m, l, o) comes back to the group's
first position every layer (`_serve_decode` on the other processes),
the last token's hidden state is summed on the head's process and the
logits reach every rank; with stages each stage's sp group lives in
one process and the hidden state crosses at the stage boundary
(`_across`). A captured step is cut at each hop (serve/graphs).

A mesh over several distinct cards has not been run: its hops and
merges would copy between cards from one stream of the first, untested.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cake_tpu_torch.models.llama.cache import (
    _blend_rows, update_layer_cache, update_layer_cache_per_row,
)
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.model import (
    RopeTables, block_finish, block_qkv, block_skeleton, layer_params,
)
from cake_tpu_torch.models.llama.params import block_param_keys, block_specs
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.ops.norms import rms_norm
from cake_tpu_torch.ops.quant import qmatmul
from cake_tpu_torch.ops.rope import apply_rope, rope_rows, rope_rows_per_row
from cake_tpu_torch.parallel.mesh import Mesh
from cake_tpu_torch.parallel.sharding import Sharded, local, tree_shard
from cake_tpu_torch.utils.devices import index_copy_rows, to_storage, zero_

NEG_INF = -1e30

# host-side dispatch counters and timers of the sp and stage x sp engine
# step fns, labeled by op and serving mode (JAX's families)
_SP_DISPATCH = obs_metrics.counter(
    "cake_sp_dispatch_total",
    "Device-program dispatches of the sp engine step fns",
    labelnames=("op", "mode"))
_SP_DISPATCH_SECONDS = obs_metrics.histogram(
    "cake_sp_dispatch_seconds",
    "Wall seconds per sp engine step-fn dispatch",
    labelnames=("op", "mode"))


def _counted(fn, op: str, mode: str):
    """fn counted and wall-timed once a dispatch: an eager call, or
    inside a capture a hook that each replay of the graph calls
    (serve/graphs.on_replay); the capture itself is not a dispatch."""
    from cake_tpu_torch.serve.graphs import on_replay

    child = _SP_DISPATCH.labels(op=op, mode=mode)
    hist = _SP_DISPATCH_SECONDS.labels(op=op, mode=mode)

    def count(seconds: float) -> None:
        child.inc()
        hist.observe(seconds)

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if on_replay(count):
            return fn(*args, **kw)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            count(time.perf_counter() - t0)
    return wrapper


def instrument_sp_engine(step_fns, mode: str, ctx_len: int,
                         tail_len: int):
    """The observability tail of every sp engine step-fn factory (plain
    sp here, stage x sp in sp_pipeline): each step fn of (prefill_slot,
    decode_ragged, decode_scan) dispatch-counted and wall-timed, and the
    window gauges set. None entries pass through. The engine's decode
    runner replays the ragged forward (the third) for single steps and
    bursts alike, so its decode steps count under op "decode_scan", one
    a step."""
    obs_metrics.gauge(
        "cake_sp_ctx_window_tokens",
        "Sequence-sharded prompt window of the sp engine",
        labelnames=("mode",)).labels(mode=mode).set(ctx_len)
    obs_metrics.gauge(
        "cake_sp_tail_window_tokens",
        "Replicated decode tail of the sp engine",
        labelnames=("mode",)).labels(mode=mode).set(tail_len)
    ops = ("prefill", "decode", "decode_scan")
    return tuple(
        _counted(fn, op, mode) if fn is not None else None
        for fn, op in zip(step_fns, ops))


# -- the attention math -------------------------------------------------------


def _chunk_scores(q, k, *, scale):
    """[B,Sq,KV,G,hd] x [B,Sk,KV,hd] -> f32 [B,KV,G,Sq,Sk] (JAX's f32
    preferred element type: the operands upcast, the sums in f32)."""
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale


def _fold(qg, k, v, m, l, acc, mask, scale):
    """One visiting chunk folded into the online-softmax state (m, l,
    acc); mask [Sq, Sk] (True = attend) or None."""
    s = _chunk_scores(qg, k, scale=scale)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # exp(NEG_INF - NEG_INF) would be 1 for a fully masked row; zero the
    # probabilities explicitly instead
    p = torch.exp(s - m_new).masked_fill(s <= NEG_INF / 2, 0.0)
    alpha = torch.exp(m - m_new)
    l = alpha * l + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bkgst,btkd->bkgsd",
                                     p.to(v.dtype).float(), v.float())
    return m_new, l, acc


def ring_attention(qs, ks, vs, *, causal: bool = True,
                   scale: Optional[float] = None,
                   hop: Optional[SPHop] = None) -> list:
    """Ring attention over the sp positions' chunks.

    qs[i]: [B, Sl, H, hd] position i's query chunk (global rows i*Sl..),
    ks[i], vs[i]: [B, Sl, KV, hd] its key/value chunk, each on the
    position's device. A static loop over hops t: position i folds the
    chunk that started at src = (i - t) % sp into its online-softmax
    state, then every chunk moves to the next position (its device, into
    buffers allocated before the loop; nothing moves on a co-located
    mesh); the last hop folds without a rotation. Masking uses global
    positions, so the result equals full causal attention over the
    gathered sequence. Under causal masking a chunk wholly after
    position i's queries (src > i) would fold to nothing (every
    probability zeroed, alpha exactly 1), so that fold is skipped.
    Returns each position's [B, Sl, H, hd] in q's dtype, on its device.

    hop: the positions of a group that spans processes (`SPHop`; qs, ks,
    vs None at another process's positions, causal only): the ring runs
    `_ring_across`, the same folds in the same order.
    """
    if hop is not None:
        if not causal:
            raise ValueError("a ring across processes is causal")
        ref = next(q for q in qs if q is not None)
        if scale is None:
            scale = 1.0 / (ref.shape[-1] ** 0.5)
        return _ring_across(qs, ks, vs, scale, hop)
    sp = len(qs)
    B, Sl, H, hd = qs[0].shape
    KV = ks[0].shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    devs = [q.device for q in qs]
    qg = [q.reshape(B, Sl, KV, G, hd) for q in qs]
    m = [torch.full((B, KV, G, Sl, 1), NEG_INF, dtype=torch.float32,
                    device=d) for d in devs]
    l = [torch.zeros((B, KV, G, Sl, 1), dtype=torch.float32, device=d)
         for d in devs]
    acc = [torch.zeros((B, KV, G, Sl, hd), dtype=torch.float32, device=d)
           for d in devs]
    diag = {d: torch.ones(Sl, Sl, dtype=torch.bool, device=d).tril()
            for d in set(devs)}
    # the hops' receive buffers, two a position used in turn (a chunk
    # that lands at hop t is sent on at hop t + 1), where a position's
    # neighbour sits on another device
    moves = any(devs[i - 1] != devs[i] for i in range(sp))
    bufs = ([[(torch.empty_like(ks[i]), torch.empty_like(vs[i]))
              for i in range(sp)] for _ in range(2)] if moves else None)
    k_cur, v_cur = list(ks), list(vs)
    for t in range(sp):
        for i in range(sp):
            src = (i - t) % sp
            if causal and src > i:
                continue
            mask = diag[devs[i]] if causal and src == i else None
            m[i], l[i], acc[i] = _fold(qg[i], k_cur[i], v_cur[i], m[i],
                                       l[i], acc[i], mask, scale)
        if t == sp - 1:
            break
        # hop: position i receives position i - 1's chunk
        if moves:
            k_cur = [bufs[t % 2][i][0].copy_(k_cur[i - 1])
                     for i in range(sp)]
            v_cur = [bufs[t % 2][i][1].copy_(v_cur[i - 1])
                     for i in range(sp)]
        else:
            k_cur = k_cur[-1:] + k_cur[:-1]
            v_cur = v_cur[-1:] + v_cur[:-1]
    out = []
    for i in range(sp):
        li = torch.where(l[i] == 0.0, torch.ones_like(l[i]), l[i])
        # [B, KV, G, Sl, hd] -> [B, Sl, KV, G, hd] -> [B, Sl, H, hd]
        out.append((acc[i] / li).permute(0, 3, 1, 2, 4)
                   .reshape(B, Sl, H, hd).to(qs[i].dtype))
    return out


class SPHop:
    """The cross-process moves of an sp group: the hops (parallel/hop.py)
    of a tensor to or from the process of another sp position. One
    process a position's tp ranks (SPForward checks it), so a position's
    owner is its tp rank 0's."""

    def __init__(self, core: "SPForward", d: int, s: int):
        self.core, self.d, self.s = core, d, s
        self.hops = core.hops

    def owner(self, i: int) -> int:
        return self.core.owner(self.d, self.s, i)

    def send(self, x: torch.Tensor, i: int) -> None:
        """x to position i's process."""
        self.hops.send(x, self.owner(i))

    def recv(self, shape, dtype, dev, i: int) -> torch.Tensor:
        """A tensor from position i's process, on dev."""
        return self.hops.recv(shape, dtype, dev, self.owner(i))


def _ring_across(qs, ks, vs, scale, hop: SPHop) -> list:
    """`ring_attention`'s causal ring over positions of several
    processes: qs/ks/vs hold this process's positions (None elsewhere).
    Position i folds, at hop t, the chunk that started at i - t (the
    causal ring's fold order: its own chunk under the diagonal mask,
    then i - 1 down to 0); a chunk moves forward only while a later
    position still needs it, by a send/recv where the next position is
    another process's (every send of a hop before its receives: the
    sends go forward only, so no cycle can wait). Returns the owned
    positions' outputs (None elsewhere)."""
    sp = len(qs)
    own = [q is not None for q in qs]
    ref = next(q for q in qs if q is not None)
    B, Sl, H, hd = ref.shape
    kv_ref = next(k for k in ks if k is not None)
    KV, kv_dt = kv_ref.shape[2], kv_ref.dtype
    G = H // KV
    st = {}
    for i in range(sp):
        if own[i]:
            d = qs[i].device
            st[i] = [qs[i].reshape(B, Sl, KV, G, hd),
                     torch.full((B, KV, G, Sl, 1), NEG_INF,
                                dtype=torch.float32, device=d),
                     torch.zeros((B, KV, G, Sl, 1), dtype=torch.float32,
                                 device=d),
                     torch.zeros((B, KV, G, Sl, hd), dtype=torch.float32,
                                 device=d),
                     torch.ones(Sl, Sl, dtype=torch.bool, device=d).tril()]
    k_cur, v_cur = list(ks), list(vs)
    for t in range(sp):
        for i in range(t, sp):
            if own[i]:
                qg, m, l, acc, diag = st[i]
                st[i][1:4] = _fold(qg, k_cur[i], v_cur[i], m, l, acc,
                                   diag if t == 0 else None, scale)
        if t == sp - 1:
            break
        for i in range(t, sp - 1):
            if own[i] and not own[i + 1]:
                hop.send(k_cur[i], i + 1)
                hop.send(v_cur[i], i + 1)
        k_new, v_new = [None] * sp, [None] * sp
        for i in range(t, sp - 1):
            if not own[i + 1]:
                continue
            dev = qs[i + 1].device
            if own[i]:
                k_new[i + 1] = k_cur[i].to(dev)
                v_new[i + 1] = v_cur[i].to(dev)
            else:
                k_new[i + 1] = hop.recv((B, Sl, KV, hd), kv_dt, dev, i)
                v_new[i + 1] = hop.recv((B, Sl, KV, hd), kv_dt, dev, i)
        k_cur, v_cur = k_new, v_new
    out = [None] * sp
    for i, (_, _, l, acc, _) in st.items():
        li = torch.where(l == 0.0, torch.ones_like(l), l)
        out[i] = ((acc / li).permute(0, 3, 1, 2, 4)
                  .reshape(B, Sl, H, hd).to(qs[i].dtype))
    return out


def partial_attention_stats(q, k, v, valid, *, scale: Optional[float] = None):
    """Partial attention of q against one KV shard, as unnormalised
    online-softmax stats for a merge across shards.

    q: [B, S, H, hd]; k, v: [B, T, KV, hd] (an fp8 or other storage
    dtype upcast to q's on read); valid: bool broadcastable to
    [B, KV, G, S, T] marking the slots that may be attended. Returns
    (m, l, o): [B,KV,G,S,1], [B,KV,G,S,1], [B,KV,G,S,hd] f32."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if k.dtype != q.dtype:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    s = _chunk_scores(q.reshape(B, S, KV, G, hd), k, scale=scale)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(s <= NEG_INF / 2, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    return m, l, o


def merge_attention_stats(stats_list):
    """Merge per-shard (m, l, o) stats (on one device) into the
    normalised output [B, KV, G, S, hd] f32."""
    m_g = stats_list[0][0]
    for m, _, _ in stats_list[1:]:
        m_g = torch.maximum(m_g, m)
    l_g = o_g = 0.0
    for m, l, o in stats_list:
        scale = torch.exp(m - m_g)
        l_g = l_g + scale * l
        o_g = o_g + scale * o
    l_g = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    return o_g / l_g


def sp_merged_attention(q, ctx_k, ctx_v, tail_k, tail_v, ctx_valid,
                        tail_valid, remote=None):
    """Decode attention over the sharded context plus the replicated
    tail.

    q: [B, S, H, hd] on the group's first position; ctx_k, ctx_v,
    ctx_valid: lists over the sp positions of each shard's
    [B, Tl, KV, hd] k/v and its valid mask, on that position's device;
    tail_k, tail_v: [B, T_tail, KV, hd] beside q. Each shard's partial
    stats are computed where it lives; the first position takes the
    max of the shards' m and sums their rescaled l and o (JAX's pmax and
    two psums over sp), folds in the tail's stats and normalises.
    Returns [B, S, H, hd] in q's dtype.

    remote: for a group spanning processes, a function of q giving
    {i: (m, l, o)} for the positions of other processes (ctx_k[i] None
    there), computed by their owners and received on q's device."""
    B, S, H, hd = q.shape
    dev = q.device
    got = remote(q) if remote is not None else {}
    stats = [got[i] if k is None else
             partial_attention_stats(q.to(k.device), k, v,
                                     mask.to(k.device))
             for i, (k, v, mask) in enumerate(zip(ctx_k, ctx_v,
                                                  ctx_valid))]
    ms = [st[0].to(dev) for st in stats]
    m_g = ms[0]
    for m in ms[1:]:
        m_g = torch.maximum(m_g, m)
    l_cg = o_cg = 0.0
    for m, (_, l, o) in zip(ms, stats):
        scale = torch.exp(m - m_g)
        l_cg = l_cg + scale * l.to(dev)
        o_cg = o_cg + scale * o.to(dev)
    tail = partial_attention_stats(q, tail_k, tail_v, tail_valid)
    out = merge_attention_stats([(m_g, l_cg, o_cg), tail])
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


# -- the per-layer bodies -------------------------------------------------------
# One source for the sp layer steps and the decode masks: the generator
# forwards (make_sp_forward, sp_pipeline.make_sp_stage_forward) and the
# engine's step fns all run these.


def sp_prefill_layer(config: LlamaConfig, ranks, xs, ropes, kv_dtype,
                     hop: Optional[SPHop] = None):
    """One block of a ring prefill over the sequence chunks.

    ranks[i]: chunk i's tp ranks' layer params (one entry unsharded);
    xs[i]: [B, Sl, D] the chunk's hidden state; ropes[i][t]: (cos, sin)
    rows of the chunk's global positions on rank t's device. Each
    chunk's q/k/v (`block_qkv`), RoPE, the ring over the chunks per tp
    rank, then each chunk's wo, residual and FFN (`block_finish`).
    Returns (xs, kv): kv[i][t] the chunk's (k, v) cast to the storage
    dtype here, inside the layer, as JAX casts them.

    hop: a group spanning processes (`SPHop`): ranks[i] and xs[i] are
    None at another process's positions, and so are the results."""
    n_sp = len(xs)
    own = [x is not None for x in xs]
    n_tp = len(next(r for r in ranks if r is not None))
    qkv = [block_qkv(ranks[i], xs[i], config) if own[i] else None
           for i in range(n_sp)]
    attns = [[None] * n_tp if own[i] else None for i in range(n_sp)]
    kv = [[None] * n_tp if own[i] else None for i in range(n_sp)]
    for t in range(n_tp):
        qs, ks, vs = [None] * n_sp, [None] * n_sp, [None] * n_sp
        for i in range(n_sp):
            if not own[i]:
                continue
            q, k, v = qkv[i][t]
            cos, sin = ropes[i][t]
            qs[i] = apply_rope(q, cos, sin)
            ks[i] = apply_rope(k, cos, sin)
            vs[i] = v
        outs = ring_attention(qs, ks, vs, causal=True, hop=hop)
        for i in range(n_sp):
            if not own[i]:
                continue
            attns[i][t] = outs[i]
            k, v = ks[i], vs[i]
            if kv_dtype is not None:
                k, v = to_storage(k, kv_dtype), to_storage(v, kv_dtype)
            kv[i][t] = (k, v)
    return ([block_finish(ranks[i], xs[i], attns[i], config)
             if own[i] else None for i in range(n_sp)], kv)


def sp_decode_layer(rope_c, rope_s, ctx_k, ctx_v, tail_k, tail_v,
                    ctx_valid, tail_valid, tail_update, remote=None):
    """One tp rank's attention of a merged-stats decode block, for
    `block_skeleton`: RoPE, the step's k/v written into every distinct
    copy of the rank's tail (tail_update(tk, tv, k, v), in place: the
    lockstep write at one slot for the generator adapter, the per-row
    active-masked write for the engine), then `sp_merged_attention` over
    the context shards (lists over sp) and the first tail copy."""
    def attn_fn(q, k, v):
        q = apply_rope(q, rope_c, rope_s)
        k = apply_rope(k, rope_c, rope_s)
        for tk, tv in zip(tail_k, tail_v):
            tail_update(tk, tv, k.to(tk.device), v.to(tk.device))
        out = sp_merged_attention(q, ctx_k, ctx_v, tail_k[0], tail_v[0],
                                  ctx_valid, tail_valid, remote=remote)
        return out, None
    return attn_fn


def sp_decode_masks(Sl: int, n_sp: int, plen, tail_T: int, t_slot,
                    B: int):
    """(ctx_valid, tail_valid) of one decode step, on plen's device:
    ctx_valid[i] [B,1,1,1,Sl] marks position i's context slots (global
    ids i*Sl..) below each row's prompt length; tail_valid [B,1,1,1,T]
    the tail slots up to and including the one being written. t_slot:
    one slot for every row (an int or a 0-d / [1] tensor: the generator
    adapter) or [B] per row (the engine's ragged decode)."""
    dev = plen.device
    ar = torch.arange(Sl, device=dev)
    ctx = [((i * Sl + ar)[None] < plen[:, None])[:, None, None, None, :]
           for i in range(n_sp)]
    t = torch.as_tensor(t_slot, device=dev).reshape(-1)
    tail = torch.arange(tail_T, device=dev)[None] <= t[:, None]
    tail = tail.expand(B, tail_T)[:, None, None, None, :]
    return ctx, tail


def sp_last_hidden(xs, plen, Sl: int) -> Optional[torch.Tensor]:
    """The hidden state at each row's plen - 1 (it lives on one chunk),
    summed over the chunks held (None entries skipped) onto the first
    held chunk's device: JAX's psum over sp of the owner's value and the
    others' zeros. None when no chunk is held."""
    held = [x for x in xs if x is not None]
    if not held:
        return None
    dev = held[0].device
    last = (plen.to(dev) - 1).long()
    rows = torch.arange(last.shape[0], device=dev)
    val = None
    for i, x in enumerate(xs):
        if x is None:
            continue
        local_idx = (last - i * Sl).clamp(0, Sl - 1)
        mine = (last >= i * Sl) & (last < (i + 1) * Sl)
        got = x.to(dev)[rows, local_idx]
        got = torch.where(mine[:, None], got, torch.zeros_like(got))
        val = got if val is None else val + got
    return val


def sp_select_last(xs, plen, Sl: int, final_norm, lm_head, eps: float):
    """`sp_last_hidden` final-normed and projected: logits [B, V] f32."""
    h = rms_norm(sp_last_hidden(xs, plen, Sl), final_norm, eps)
    return qmatmul(h, lm_head).float()


def _one_stage(x, run_stage, n_stages: int):
    """The chain of a mesh without stages: stage 0's blocks."""
    return run_stage(0, x)


def sp_mode(mesh: Mesh) -> str:
    """The metrics' mode label, the mesh's axes in order: sp, sp_tp,
    dp_sp, dp_sp_tp, stage_sp, stage_sp_tp."""
    return "_".join(a for a in ("stage", "dp", "sp", "tp")
                    if a in mesh.axis_names)


def _cache_specs(mesh: Mesh) -> tuple:
    """(ctx spec, tail spec) of the [L, B, T, KV, hd] cache leaves: the
    layers over "stage", the batch over "dp", the context's sequence
    over "sp" and the kv heads over "tp", each where the mesh has the
    axis (make_sp_mesh leaves out an axis of size 1)."""
    st, dp, tp = (a if a in mesh.axis_names else None
                  for a in ("stage", "dp", "tp"))
    return (st, dp, "sp", tp, None), (st, dp, None, tp, None)


class SPForward:
    """What the sp forwards share: the mesh and its axis sizes, the
    window split, per-device rope tables, and the bodies of one dp
    group's prefill (`prefill_group`: JAX's make_sp_prefill_body, and
    with the stage chain its make_sp_stage_prefill_body) and decode step
    (`decode_group`: the decode bodies of make_sp_forward and
    make_sp_engine_decode_body). The dp, stage and tp sizes are the
    mesh's. chain(x, run_stage, n_stages): how a stage's blocks follow
    the last (`_one_stage`; sp_pipeline._stage_chain over stages)."""

    def __init__(self, mesh: Mesh, config: LlamaConfig, ctx_len: int,
                 tail_len: int, kv_dtype=None,
                 chain: Optional[Callable] = None):
        n_sp = mesh.shape["sp"]
        if ctx_len % n_sp != 0:
            raise ValueError(
                f"sp context window {ctx_len} must divide over sp={n_sp}")
        self.mesh, self.config = mesh, config
        self.ctx_len, self.tail_len = ctx_len, tail_len
        self.kv_dtype = kv_dtype
        self.n_sp, self.Sl = n_sp, ctx_len // n_sp
        self.n_tp = mesh.size_of("tp")
        self.n_dp = mesh.size_of("dp")
        self.n_stage = mesh.size_of("stage")
        L = config.num_hidden_layers
        if L % self.n_stage:
            raise ValueError(f"topology stages {self.n_stage} must divide "
                             f"layer count {L}")
        if chain is None and self.n_stage > 1:
            raise ValueError("a mesh with stages runs through "
                             "sp_pipeline's stage chain")
        self.layers = L // self.n_stage           # a stage's blocks
        self.chain = chain or _one_stage
        self._ropes: dict = {}
        self._dtype = None       # the hidden state's, set by each group
        self.hops = None
        if mesh.multiprocess:
            self._check_multiprocess()
            from cake_tpu_torch.parallel.distributed import hops
            self.hops = hops()

    def _check_multiprocess(self) -> None:
        """The layouts a mesh across processes may take: an sp
        position's tp ranks in one process, no dp (JAX's refusal), and
        with stages each stage whole in one process (the stage axis
        crosses processes, the sp group stays in one)."""
        mesh = self.mesh
        if self.n_dp > 1:
            raise ValueError(
                "dp x sp serving is single-host only (dp-sharded "
                "decode outputs are process-local); drop --dp or "
                "serve on one host")
        for pos in np.ndindex(*mesh.devices.shape):
            at = dict(zip(mesh.axis_names, pos))
            head = mesh.index(stage=at.get("stage", 0),
                              sp=0 if self.n_stage > 1 else at["sp"])
            if mesh.owner(*pos) != mesh.owner(*head):
                raise ValueError(
                    "this sp mesh splits an sp position's tp ranks, or "
                    "with stages a stage's sp group, across processes: "
                    "the port hops between processes on the 'sp' axis "
                    "(no stages) or the 'stage' axis only")

    def dev(self, d: int, s: int, i: int, t: int = 0) -> torch.device:
        return self.mesh.at(dp=d, stage=s, sp=i, tp=t)

    def owns(self, d: int, s: int, i: int) -> bool:
        """Whether this process holds sp position i of stage s."""
        return self.mesh.owns(self.mesh.index(dp=d, stage=s, sp=i))

    def owner(self, d: int, s: int, i: int) -> int:
        return self.mesh.owner(*self.mesh.index(dp=d, stage=s, sp=i))

    def hop(self, d: int, s: int) -> Optional[SPHop]:
        """Stage s's cross-process moves (None in one process)."""
        return None if self.hops is None else SPHop(self, d, s)

    def base(self, d: int) -> torch.device:
        """Where group d's step inputs and logits live: its first
        position's device, or this process's home where that position is
        another's."""
        return (self.dev(d, 0, 0) if self.owns(d, 0, 0)
                else self.mesh.home)

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

    def ranks(self, params, d: int, s: int, i: int) -> list:
        """The stacked block params of every tp rank at sp position i of
        stage s in group d."""
        return [local(params["blocks"], d, s, t, i)
                for t in range(self.n_tp)]

    def head(self, params, d: int):
        """(final_norm, lm_head) on the last stage's first position."""
        s = self.n_stage - 1
        return (local(params["final_norm"], d, s, 0, 0),
                local(params["lm_head"], d, s, 0, 0))

    def prefill_group(self, params, tokens, plen, rope: RopeTables, d: int,
                      sink) -> torch.Tensor:
        """One dp group's ring prefill: tokens [b, ctx_len] (right-padded
        to the window) and plen [b] -> logits [b, V] f32 at each row's
        plen - 1, on the group's first device. sink(s, li, i, t, k, v)
        takes the storage-cast key/value chunk of stage s's local layer
        li at sp position i, tp rank t (the cache write)."""
        Sl, cfg = self.Sl, self.config
        self._dtype = params["embed"].dtype    # the hidden state's
        xs = []
        for i in range(self.n_sp):
            if not self.owns(d, 0, i):
                xs.append(None)        # another process's chunk
                continue
            dev = self.dev(d, 0, i)
            tok = tokens[:, i * Sl:(i + 1) * Sl].to(dev).long()
            xs.append(local(params["embed"], d, 0, 0, i)[tok])

        def run_stage(s, xs):
            ropes, blocks = [], []
            for i in range(self.n_sp):
                if not self.owns(d, s, i):
                    ropes.append(None)
                    blocks.append(None)
                    continue
                row = []
                for t in range(self.n_tp):
                    r = self.rope(rope, self.dev(d, s, i, t))
                    row.append((r.cos[i * Sl:(i + 1) * Sl],
                                r.sin[i * Sl:(i + 1) * Sl]))
                ropes.append(row)
                blocks.append(self.ranks(params, d, s, i))
            xs = [x.to(self.dev(d, s, i)) if x is not None else None
                  for i, x in enumerate(xs)]
            hop = self.hop(d, s)
            for li in range(self.layers):
                ranks = [[layer_params(b, li) for b in blocks[i]]
                         if blocks[i] is not None else None
                         for i in range(self.n_sp)]
                xs, kv = sp_prefill_layer(cfg, ranks, xs, ropes,
                                          self.kv_dtype, hop=hop)
                for i in range(self.n_sp):
                    if kv[i] is not None:
                        for t in range(self.n_tp):
                            sink(s, li, i, t, *kv[i][t])
            return xs

        b = tokens.shape[0]
        xs = self.chain(xs, self._across(d, run_stage, [
            (b, Sl, cfg.hidden_size)] * self.n_sp), self.n_stage)
        if self.hops is None:
            norm, lm_head = self.head(params, d)
            return sp_select_last(xs, plen, Sl, norm, lm_head,
                                  cfg.rms_norm_eps)
        return self._logits_to_all(params, self._gather_last(
            xs if xs is not None else [None] * self.n_sp, plen, d), d, b)

    def decode_group(self, params, tokens, rope_c, rope_s, plen, t_slot,
                     cache: "SPCache", d: int, tail_update_for):
        """One dp group's merged-stats decode step: tokens [b, 1] and
        their rope rows (rope_c/rope_s: [1, hd/2] shared, or
        [b, 1, hd/2] per row), plen [b] and the tail slot(s) t_slot, on
        the group's first device -> logits [b, V] f32 there. The block
        around the attention runs once on the group's first position
        (JAX replicates it over sp). tail_update_for(device) -> the tail
        write on that device (`sp_decode_layer`)."""
        cfg = self.config
        b = tokens.shape[0]
        self._dtype = params["embed"].dtype    # the hidden state's
        x = (local(params["embed"], d, 0, 0, 0)[tokens.long()]
             if self.owns(d, 0, 0) else None)
        ctx_valid, tail_valid = sp_decode_masks(
            self.Sl, self.n_sp, plen, self.tail_len, t_slot, b)

        def run_stage(s, x):
            if not self.owns(d, s, 0):
                # another process runs the block: this one answers its
                # positions' attention stats, layer by layer
                self._serve_decode(params, cache, d, s, b, ctx_valid)
                return None
            attn_of = [self._decode_rank(cache, d, s, t, rope_c, rope_s,
                                         ctx_valid, tail_valid,
                                         tail_update_for)
                       for t in range(self.n_tp)]
            blocks = self.ranks(params, d, s, 0)
            x = x.to(self.dev(d, s, 0))
            for li in range(self.layers):
                x, _ = block_skeleton([layer_params(b, li) for b in blocks],
                                      x, cfg, [attn(li) for attn in attn_of])
            return x

        x = self.chain(x, self._across(d, run_stage, (b, 1, cfg.hidden_size)),
                       self.n_stage)
        if self.hops is None:
            norm, lm_head = self.head(params, d)
            x = rms_norm(x.to(norm.device), norm, cfg.rms_norm_eps)
            return qmatmul(x[:, -1], lm_head).float()
        return self._logits_to_all(
            params, x[:, -1] if x is not None else None, d, b)

    # -- across processes -------------------------------------------------------

    def _across(self, d: int, run_stage, shape):
        """run_stage for a chain whose stages live in different
        processes (each stage whole in one, `_check_multiprocess`): a
        stage runs where it lives, its input received from the previous
        stage's process and its output sent to the next's; elsewhere it
        passes None on. shape: the hidden state's, [b, 1, D] a decode
        step's, or a list over the sp chunks of [b, Sl, D] a prefill's.
        Without stages across processes, run_stage itself."""
        if self.hops is None or self.n_stage == 1:
            return run_stage
        rank, hops = self.mesh.rank, self.hops
        chunked = isinstance(shape, list)

        def run(s, x):
            if self.owner(d, s, 0) != rank:
                return None
            if s > 0 and self.owner(d, s - 1, 0) != rank:
                src = self.owner(d, s - 1, 0)
                x = ([hops.recv(shp, self._dtype, self.dev(d, s, i), src)
                      for i, shp in enumerate(shape)] if chunked else
                     hops.recv(shape, self._dtype, self.dev(d, s, 0), src))
            y = run_stage(s, x)
            if s + 1 < self.n_stage and self.owner(d, s + 1, 0) != rank:
                for part in (y if chunked else [y]):
                    hops.send(part, self.owner(d, s + 1, 0))
                return None
            return y

        return run

    def _gather_last(self, xs, plen, d: int):
        """The last token's hidden state [b, D] on the head's process:
        each process's share over the chunks it holds, summed there in
        rank order (None elsewhere)."""
        s = self.n_stage - 1
        head = self.owner(d, s, 0)
        val = sp_last_hidden(xs, plen, self.Sl)
        holders = sorted({self.owner(d, s, i) for i in range(self.n_sp)})
        if self.mesh.rank != head:
            if self.mesh.rank in holders:
                self.hops.send(val, head)
            return None
        for r in holders:
            if r != head:
                got = self.hops.recv(val.shape, val.dtype, val.device, r)
                val = val + got
        return val

    def _logits_to_all(self, params, h, d: int, b: int) -> torch.Tensor:
        """The head over h [b, D] on the last stage's first position's
        process, and the logits [b, V] f32 on every rank."""
        s = self.n_stage - 1
        head = self.owner(d, s, 0)
        lg = None
        if self.mesh.rank == head:
            norm, lm_head = self.head(params, d)
            h = rms_norm(h.to(norm.device), norm, self.config.rms_norm_eps)
            lg = qmatmul(h, lm_head).float()
        return self.hops.bcast(lg, head, (b, self.config.vocab_size),
                               torch.float32, self.base(d))

    def _remote_stats(self, d: int, s: int, t: int, dev):
        """On the group's first position's process: a function of tp
        rank t's q [b, S, H_t, hd] that sends q to every process holding
        other positions (once a process) and receives each position's
        (m, l, o) on dev, as one [b, KV_t, G, S, hd + 2] f32 tensor a
        position (None when this process holds every position)."""
        remote = [i for i in range(self.n_sp) if not self.owns(d, s, i)]
        if not remote:
            return None
        hop = self.hop(d, s)
        KV = self.config.num_key_value_heads // self.n_tp

        def stats(q):
            b, S, H, hd = q.shape
            sent = set()
            for i in remote:
                if hop.owner(i) not in sent:
                    hop.send(q, i)
                    sent.add(hop.owner(i))
            out = {}
            for i in remote:
                pack = hop.recv((b, KV, H // KV, S, hd + 2), torch.float32,
                                dev, i)
                out[i] = (pack[..., :1], pack[..., 1:2], pack[..., 2:])
            return out
        return stats

    def _serve_decode(self, params, cache, d: int, s: int, b: int,
                      ctx_valid) -> None:
        """On a process holding context shards but not the group's first
        position: for each layer and tp rank, receive q, compute each
        held position's partial stats (`partial_attention_stats`, where
        the shard lives) and send them back packed as (m, l, o)."""
        mine = [i for i in range(self.n_sp) if self.owns(d, s, i)]
        if not mine:
            return
        hop = self.hop(d, s)
        cfg = self.config
        H = cfg.num_attention_heads // self.n_tp
        dtype = self._dtype
        shards = {(i, t): (cache.ctx_k.shard(d, s, t, i),
                           cache.ctx_v.shard(d, s, t, i))
                  for i in mine for t in range(self.n_tp)}
        valid = {i: ctx_valid[i].to(self.dev(d, s, i)) for i in mine}
        for li in range(self.layers):
            for t in range(self.n_tp):
                dev = self.dev(d, s, mine[0], t)
                q = hop.recv((b, 1, H, cfg.head_dim), dtype, dev, 0)
                for i in mine:
                    ck, cv = shards[(i, t)]
                    m, l, o = partial_attention_stats(
                        q.to(ck.device), ck[li], cv[li],
                        valid[i].to(ck.device))
                    hop.send(torch.cat([m, l, o], dim=-1), 0)

    def _decode_rank(self, cache: "SPCache", d: int, s: int, t: int,
                     rope_c, rope_s, ctx_valid, tail_valid,
                     tail_update_for):
        """Tp rank t of stage s: a function of a local layer li giving
        its decode attention (`sp_decode_layer`) over the rank's context
        shard at every sp position and every distinct copy of its tail,
        the rope rows and masks moved once to their devices."""
        dev = self.dev(d, s, 0, t)
        held = [self.owns(d, s, i) for i in range(self.n_sp)]
        ck = [cache.ctx_k.shard(d, s, t, i) if held[i] else None
              for i in range(self.n_sp)]
        cv = [cache.ctx_v.shard(d, s, t, i) if held[i] else None
              for i in range(self.n_sp)]
        tk, tv = [], []
        for i in range(self.n_sp):
            if not held[i]:
                continue    # another process's copy: attention reads ours
            k = cache.tail_k.shard(d, s, t, i)
            if all(k is not seen for seen in tk):
                tk.append(k)
                tv.append(cache.tail_v.shard(d, s, t, i))
        valid = [m.to(c.device) if c is not None else m
                 for m, c in zip(ctx_valid, ck)]
        rc, rs = rope_c.to(dev), rope_s.to(dev)
        t_valid, update = tail_valid.to(dev), tail_update_for(dev)
        remote = self._remote_stats(d, s, t, dev)

        def attn(li):
            return sp_decode_layer(rc, rs,
                                   [c[li] if c is not None else None
                                    for c in ck],
                                   [c[li] if c is not None else None
                                    for c in cv], [c[li] for c in tk],
                                   [c[li] for c in tv], valid, t_valid,
                                   update, remote=remote)
        return attn

    # -- placement ------------------------------------------------------------

    def new_cache(self, batch: int, dtype) -> "SPCache":
        """A zeroed SPCache of `batch` rows in `dtype`, each shard
        allocated on its device (the whole buffer never exists)."""
        cfg = self.config
        KV, hd, L = cfg.num_key_value_heads, cfg.head_dim, \
            cfg.num_hidden_layers
        ctx_spec, tail_spec = _cache_specs(self.mesh)

        def leaf(T, spec):
            return _zeros_sharded((L, batch, T, KV, hd), dtype, spec,
                                  self.mesh)
        return SPCache(leaf(self.ctx_len, ctx_spec),
                       leaf(self.ctx_len, ctx_spec),
                       leaf(self.tail_len, tail_spec),
                       leaf(self.tail_len, tail_spec))


def _zeros_sharded(shape, dtype, spec, mesh: Mesh) -> Sharded:
    def zeros(sl, dev):
        return torch.zeros([s.stop - s.start for s in sl], dtype=dtype,
                           device=dev)
    return Sharded.build(shape, dtype, spec, mesh, zeros)


# -- the caches -------------------------------------------------------------------


class SPCache(NamedTuple):
    """Long-context KV cache: the prefilled context sharded over sp, the
    decode tail replicated. ctx_*: Sharded [L, B, ctx_len, KV, hd] (the
    sequence dim over "sp"); tail_*: Sharded [L, B, T_tail, KV, hd]."""
    ctx_k: Sharded
    ctx_v: Sharded
    tail_k: Sharded
    tail_v: Sharded

    def zero_(self) -> "SPCache":
        """Every shard zeroed in place (captured steps hold them)."""
        for x in self:
            x.zero_()
        return self

    def fresh(self) -> "SPCache":
        """A zeroed cache of the same placement (new allocations)."""
        return SPCache(*(_zeros_sharded(x.shape, x.dtype, x.spec, x.mesh)
                         for x in self))

    def memory_bytes(self) -> int:
        """Bytes of every distinct shard."""
        return sum(sum(x.bytes_per_device().values()) for x in self)


def sp_block_specs(mesh: Mesh, config: LlamaConfig, params=None) -> dict:
    """The block-param specs of the sp mesh (one source for the forwards'
    placement, `place_sp_params`): heads / ffn over "tp" where the mesh
    has it, replicated otherwise; the keys are the params' own when
    given (QTensor leaves expand in `tree_shard`)."""
    keys = (params["blocks"].keys() if params is not None
            else block_param_keys(config))
    return block_specs(keys, stage_axis=None,
                       tp_axis="tp" if "tp" in mesh.axis_names else None)


def sp_param_specs(mesh: Mesh, config: LlamaConfig, params=None) -> dict:
    """The whole tree's specs: the blocks by `sp_block_specs`, the
    embedding, final norm and lm_head replicated."""
    return {"embed": (None, None),
            "blocks": sp_block_specs(mesh, config, params),
            "final_norm": (None,), "lm_head": (None, None)}


def place_sp_params(mesh: Mesh, config: LlamaConfig, params):
    """The param dict placed as the sp forwards read it (a copy of a
    slice on each device; a replicated leaf once a device, so a
    co-located mesh holds one copy)."""
    return tree_shard(params, mesh, sp_param_specs(mesh, config, params))


# -- the generator's forwards -------------------------------------------------


def _uniform_tail_write(t_slot):
    """The generator's tail write: every row's k/v at one slot (JAX's
    dynamic_update_slice, clamped)."""
    def for_device(dev):
        slot = (t_slot.to(dev) if isinstance(t_slot, torch.Tensor)
                else t_slot)

        def update(tk, tv, k, v):
            update_layer_cache(tk, tv, k, v, slot)
        return update
    return for_device


def make_sp_forward(mesh: Mesh, config: LlamaConfig, ctx_len: int,
                    tail_len: int, kv_dtype=None, chain=None):
    """(sp_prefill, sp_decode) over the mesh's "sp" axis: sp alone,
    sp x tp (heads over tp within each sequence shard, the ring rotating
    chunks of a rank's heads), dp x sp(x tp) (the batch over dp groups,
    each its own ring), as the mesh's axes say. kv_dtype: the SPCache's storage dtype (None: the
    compute dtype); values upcast into attention on read. JAX's
    `params=` sized its quantized specs; the port reads each leaf's
    shards (`place_sp_params`), so it has none.

    sp_prefill(params, tokens [B, ctx_len], plen [B], rope, cache=None)
        -> (logits [B, V] f32, SPCache): tokens right-padded to the
        window; cache: an SPCache written in place (its tail zeroed),
        None allocates one (JAX's prefill allocates its own)
    sp_decode(params, token [B, 1], pos, plen [B], cache, rope)
        -> (logits, cache): pos the window position in
        [ctx_len, ctx_len + tail_len) (an int or a device tensor), the
        tail written in place at slot pos - ctx_len
    """
    core = SPForward(mesh, config, ctx_len, tail_len, kv_dtype=kv_dtype,
                     chain=chain)

    @torch.inference_mode()
    def sp_prefill(params, tokens, plen, rope: RopeTables, cache=None):
        B = tokens.shape[0]
        if cache is None:
            dtype = (kv_dtype if kv_dtype is not None
                     else params["embed"].dtype)
            cache = core.new_cache(B, dtype)
        else:
            cache.tail_k.zero_()
            cache.tail_v.zero_()
        rows = B // core.n_dp
        logits = []
        for d in range(core.n_dp):
            dev = core.base(d)

            def sink(s, li, i, t, k, v, d=d):
                for dst, new in ((cache.ctx_k, k), (cache.ctx_v, v)):
                    line = dst.shard(d, s, t, i)[li]
                    line.copy_(new.to(line.device))

            logits.append(core.prefill_group(
                params, tokens[d * rows:(d + 1) * rows].to(dev),
                plen[d * rows:(d + 1) * rows].to(dev), rope, d, sink))
        return _gather_rows(logits, core.base(0)), cache

    @torch.inference_mode()
    def sp_decode(params, token, pos, plen, cache: SPCache,
                  rope: RopeTables):
        B = token.shape[0]
        rows = B // core.n_dp
        t_slot = pos - ctx_len
        logits = []
        for d in range(core.n_dp):
            dev = core.base(d)
            r = core.rope(rope, dev)
            p = pos.to(dev) if isinstance(pos, torch.Tensor) else pos
            rope_c, rope_s = rope_rows(r.cos, r.sin, p, 1)
            ts = t_slot.to(dev) if isinstance(t_slot, torch.Tensor) \
                else t_slot
            logits.append(core.decode_group(
                params, token[d * rows:(d + 1) * rows].to(dev), rope_c,
                rope_s, plen[d * rows:(d + 1) * rows].to(dev), ts, cache,
                d, _uniform_tail_write(ts)))
        return _gather_rows(logits, core.base(0)), cache

    sp_prefill.core = core
    return sp_prefill, sp_decode


def _gather_rows(parts: list, dev) -> torch.Tensor:
    """The dp groups' rows in order, on `dev`."""
    if len(parts) == 1:
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts], dim=0)


class SPSessionCache(NamedTuple):
    """An SPCache with its session's prompt lengths [B] (on the mesh's
    first device): carrying plen in the cache keeps the adapter
    stateless, so a scratch generation (`generate_on_device`) cannot
    clobber a live session's decode positions."""
    sp: SPCache
    plen: torch.Tensor

    def zero_(self) -> "SPSessionCache":
        self.sp.zero_()
        self.plen.zero_()
        return self

    def fresh(self) -> "SPSessionCache":
        return SPSessionCache(self.sp.fresh(), torch.zeros_like(self.plen))


class SPGeneratorForward:
    """The generator's forward_fn over the sp mesh (cli --sp N
    --max-seq-len ...): (sp_prefill, sp_decode) under the generator's
    pluggable-forward contract.

    Window layout: the prompt is right-padded into the sp-sharded
    context window [0, ctx_len); generated tokens live in the replicated
    tail at window positions ctx_len + k. With a full prompt (len ==
    ctx_len, the long-context case this mode exists for) the positions
    are the dense path's; a shorter prompt leaves a positional gap
    between prompt and generation (JAX's documented semantics, masked
    either way).

    The generator reads `max_prompt_len` (inclusive, at encode time),
    `max_decode_tokens` (what the tail holds) and `new_cache` (the
    generator takes its session cache from it once and zeroes it in
    place after: its captured step holds it). Its decode replays are
    the captured step's, one a token (JAX's `decode_scan`, one
    `lax.scan` program, has no counterpart here). Stages, dp and tp are
    the mesh's axes."""

    def __init__(self, mesh: Mesh, config: LlamaConfig, ctx_len: int,
                 tail_len: int, kv_dtype=None):
        self.ctx_len = ctx_len
        self.tail_len = tail_len
        self.max_prompt_len = ctx_len
        self.max_decode_tokens = tail_len
        # kept for engine_pieces (master.make_engine builds the sp
        # continuous-batching engine from the same mesh and window)
        self._mesh = mesh
        self._config = config
        self._kv_dtype = kv_dtype
        if "stage" in mesh.axis_names:
            from cake_tpu_torch.parallel.sp_pipeline import (
                make_sp_stage_forward,
            )
            self._prefill, self._decode = make_sp_stage_forward(
                mesh, config, ctx_len, tail_len, kv_dtype=kv_dtype)
        else:
            self._prefill, self._decode = make_sp_forward(
                mesh, config, ctx_len, tail_len, kv_dtype=kv_dtype)

    def new_cache(self, batch: int, dtype) -> SPSessionCache:
        """A zeroed session cache of `batch` rows (dtype: the storage
        when the adapter has no kv_dtype)."""
        core = self._prefill.core
        store = self._kv_dtype if self._kv_dtype is not None else dtype
        return SPSessionCache(
            core.new_cache(batch, store),
            torch.zeros(batch, dtype=torch.int32, device=core.base(0)))

    def __call__(self, params, tokens, cache: SPSessionCache, pos, rope,
                 last_idx=None, is_prefill: bool = False):
        if is_prefill:
            B, S = tokens.shape
            if S >= self.ctx_len:
                # bucket padding may exceed the window; real tokens cannot
                # (max_prompt_len): trim the pad, keep the window
                toks = tokens[:, :self.ctx_len]
            else:
                toks = F.pad(tokens, (0, self.ctx_len - S))
            plen = ((last_idx + 1).to(torch.int32) if last_idx is not None
                    else torch.full((B,), S, dtype=torch.int32,
                                    device=tokens.device))
            logits, _ = self._prefill(params, toks, plen, rope,
                                      cache=cache.sp)
            cache.plen.copy_(plen)
            return logits, cache
        # generator positions count from the prompt's end; the tail's
        # from the context window's
        k = pos - cache.plen.max()
        logits, _ = self._decode(params, tokens, self.ctx_len + k,
                                 cache.plen, cache.sp, rope)
        return logits, cache

    def engine_pieces(self, slots: int, params):
        """(step_fns, cache, ctx_len, tail_len) of the continuous-
        batching engine over this adapter's mesh: stage x sp through
        sp_pipeline's factories, dp x sp with the slots over dp (max
        slots divisible by dp)."""
        dtype = (self._kv_dtype if self._kv_dtype is not None
                 else params["embed"].dtype)
        n_dp = self._mesh.size_of("dp")
        if slots % n_dp != 0:
            raise ValueError(
                f"--max-slots {slots} must be divisible by --dp {n_dp} "
                f"(the sp engine shards slots over dp)")
        if "stage" in self._mesh.axis_names:
            from cake_tpu_torch.parallel.sp_pipeline import (
                make_sp_stage_engine_step_fns,
            )
            fns = make_sp_stage_engine_step_fns(
                self._mesh, self._config, self.ctx_len, self.tail_len,
                kv_dtype=self._kv_dtype)
        else:
            fns = make_sp_engine_step_fns(
                self._mesh, self._config, self.ctx_len, self.tail_len,
                kv_dtype=self._kv_dtype)
        cache = create_sp_engine_cache(
            self._mesh, self._config, slots, self.ctx_len, self.tail_len,
            kv_dtype=dtype)
        return fns, cache, self.ctx_len, self.tail_len


# -- the continuous-batching engine over the sp mesh --------------------------


class SPEngineCache(NamedTuple):
    """The engine's SPCache with each slot's prompt length: ctx region
    [0, plen[b]) holds slot b's ring-prefilled prompt, tail slot t its
    token at position plen[b] + t. plen [B] int32 lives on the mesh's
    first device."""
    ctx_k: Sharded          # [L, B, S_ctx, KV, hd], sequence over "sp"
    ctx_v: Sharded
    tail_k: Sharded         # [L, B, T_tail, KV, hd], replicated over sp
    tail_v: Sharded
    plen: torch.Tensor

    def zero_(self) -> "SPEngineCache":
        """Every shard and plen zeroed in place (a recovery keeps the
        graphs that hold them)."""
        for x in self[:4]:
            x.zero_()
        zero_(self.plen)
        return self

    def fresh(self) -> "SPEngineCache":
        return self.placement()()

    def placement(self):
        """A function of no arguments that allocates a zeroed cache
        placed like this one, holding no tensor of it (the engine's
        rebuild after an error)."""
        leaves = [(x.shape, x.dtype, x.spec, x.mesh) for x in self[:4]]
        plen = (tuple(self.plen.shape), self.plen.dtype, self.plen.device)
        return functools.partial(_sp_engine_cache_zeros, leaves, plen)

    @property
    def max_seq_len(self) -> int:
        """The window: context plus tail."""
        return self.ctx_k.shape[2] + self.tail_k.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.ctx_k.dtype

    def memory_bytes(self) -> int:
        return sum(sum(x.bytes_per_device().values()) for x in self[:4])


def _sp_engine_cache_zeros(leaves, plen) -> SPEngineCache:
    shape, dtype, device = plen
    return SPEngineCache(*(_zeros_sharded(*leaf) for leaf in leaves),
                         torch.zeros(shape, dtype=dtype, device=device))


def create_sp_engine_cache(mesh: Mesh, config: LlamaConfig, slots: int,
                           ctx_len: int, tail_len: int,
                           kv_dtype=torch.bfloat16) -> SPEngineCache:
    """The engine's multi-slot sp cache, placed as the step fns read it
    (`_cache_specs`: with stages the layer dim over "stage", with dp the
    slot dim over "dp", slots % dp == 0), each shard allocated on its
    device."""
    if slots % mesh.size_of("dp") != 0:
        raise ValueError(f"{slots} slots do not divide over dp="
                         f"{mesh.size_of('dp')}")
    KV, hd = config.num_key_value_heads, config.head_dim
    L = config.num_hidden_layers
    ctx, tail = _cache_specs(mesh)
    leaves = [((L, slots, ctx_len, KV, hd), kv_dtype, ctx, mesh),
              ((L, slots, ctx_len, KV, hd), kv_dtype, ctx, mesh),
              ((L, slots, tail_len, KV, hd), kv_dtype, tail, mesh),
              ((L, slots, tail_len, KV, hd), kv_dtype, tail, mesh)]
    return _sp_engine_cache_zeros(leaves, ((slots,), torch.int32, mesh.home))


def _slot_index(slot, device) -> torch.Tensor:
    if isinstance(slot, torch.Tensor):
        return slot.reshape(1).long().to(device)
    return torch.tensor([int(slot)], dtype=torch.int64, device=device)


def _put_slot(dst, slot, lo: int, n: int, new) -> None:
    """new [1, ...] into row slot - lo of dst [n, ...] when the slot is
    one of rows lo..lo+n (a dp group's rows), else nothing: a
    read-modify-write of the clamped row, so the slot is read on the
    card."""
    idx = (slot - lo).clamp(0, n - 1)
    own = ((slot >= lo) & (slot < lo + n)).reshape(
        1, *([1] * (new.dim() - 1)))
    _blend_rows(dst, (idx,), own, new)


def make_slot_prefill_fn(core: SPForward):
    """The engine's slot prefill, shared by the plain sp and stage x sp
    factories: [1, S] prompt -> trimmed or zero-padded to [1, ctx_len]
    -> the ring prefill (the first dp group's positions) -> the slot's
    context lines written in its owner group's shards, per layer as they
    are computed, and plen[slot] set; the slot is a device tensor, so
    one captured step serves every slot. Bucket padding beyond ctx_len
    is trimmed (real tokens are capped at ctx_len by the engine's
    prompt_limit). Returns (logits [1, V] f32, cache)."""
    ctx_len = core.ctx_len

    @torch.inference_mode()
    def prefill_slot_fn(params, tokens, prompt_len, slot,
                        cache: SPEngineCache, rope: RopeTables,
                        config=None):
        S = tokens.shape[1]
        toks = (tokens[:, :ctx_len] if S >= ctx_len
                else F.pad(tokens, (0, ctx_len - S)))
        dev = core.base(0)
        plen = prompt_len.reshape(1).to(dev, torch.int32)
        slot_t = _slot_index(slot, dev)
        rows = cache.plen.shape[0] // core.n_dp
        slots = {}

        def sink(s, li, i, t, k, v):
            for d in range(core.n_dp):
                for dst, new in ((cache.ctx_k, k), (cache.ctx_v, v)):
                    line = dst.shard(d, s, t, i)[li]
                    sl = slots.get(line.device)
                    if sl is None:
                        sl = slots[line.device] = slot_t.to(line.device)
                    if core.n_dp == 1:
                        index_copy_rows(line, 0, sl, new.to(line.device))
                    else:
                        _put_slot(line, sl, d * rows, rows,
                                  new.to(line.device))

        logits = core.prefill_group(params, toks.to(dev), plen, rope, 0,
                                    sink)
        index_copy_rows(cache.plen, 0, slot_t.to(cache.plen.device),
                        plen.to(cache.plen.device))
        return logits, cache

    return prefill_slot_fn


def make_sp_engine_decode_body(core: SPForward):
    """The engine's ragged decode over the sp cache, shared by the plain
    sp and stage x sp factories (they differ in the core's chain):
    (params, tokens [B, 1], pos [B], active [B], cache, rope) -> logits
    [B, V] f32. Row b sits at rope position pos[b] and writes tail slot
    pos[b] - plen[b] (clamped into the tail) when active; each dp group
    decodes its own slots."""
    T = core.tail_len

    def decode_body(params, tokens, pos, active, cache: SPEngineCache,
                    rope: RopeTables) -> torch.Tensor:
        B = tokens.shape[0]
        rows = B // core.n_dp
        out = []
        for d in range(core.n_dp):
            dev = core.base(d)
            sl = slice(d * rows, (d + 1) * rows)
            p = pos[sl].to(dev).long()
            plen = cache.plen[sl].to(dev).long()
            act = active[sl].to(dev)
            t_slot = (p - plen).clamp(0, T - 1)
            r = core.rope(rope, dev)
            rope_c, rope_s = rope_rows_per_row(r.cos, r.sin, p)

            def update_for(dv, t_slot=t_slot, act=act):
                return functools.partial(update_layer_cache_per_row,
                                         pos=t_slot.to(dv),
                                         active=act.to(dv))

            out.append(core.decode_group(params, tokens[sl].to(dev),
                                         rope_c, rope_s, plen, t_slot,
                                         cache, d, update_for))
        return _gather_rows(out, core.base(0))

    return decode_body


def make_decode_ragged_fns(decode_body):
    """(decode_ragged_forward, decode_ragged_fn) over an sp decode body,
    shared by the plain sp and stage x sp factories: the ragged forward
    in the argument order the engine's decode runner replays (params,
    tokens, cache, pos, active, rope, config), and the decode step in
    model.decode_step_ragged's."""

    @torch.inference_mode()
    def decode_ragged_forward(params, tokens, cache: SPEngineCache, pos,
                              active, rope: RopeTables, config=None):
        return decode_body(params, tokens, pos, active, cache, rope), cache

    @torch.inference_mode()
    def decode_ragged_fn(params, tokens, pos, active, cache: SPEngineCache,
                         rope: RopeTables, config=None):
        return decode_ragged_forward(params, tokens, cache, pos, active,
                                     rope, config)

    return decode_ragged_forward, decode_ragged_fn


def make_sp_engine_step_fns(mesh: Mesh, config: LlamaConfig, ctx_len: int,
                            tail_len: int, kv_dtype=None):
    """The engine's step fns over the sp(x tp) mesh, for continuous
    batching of long-context requests: every slot's prompt
    ring-prefills over the sequence shards, and concurrent requests
    decode together with merged-stats attention. Returns
    (prefill_slot_fn, decode_ragged_fn, decode_ragged_forward) with the
    signatures of model.prefill_slot, model.decode_step_ragged and the
    ragged forward the decode runner replays K times a burst (JAX's
    decode scan of it), over an SPEngineCache.

    Unlike the generator adapter (whose tail starts at ctx_len), the
    layout is position-contiguous: row b's generated token t sits at
    rope position plen[b] + t and tail slot t, so the streams match the
    dense engine's for any prompt length. sp alone, sp x tp, dp x
    sp(x tp) (the slots over dp, each group its own ring), as the mesh's
    axes say, or through sp_pipeline.make_sp_stage_engine_step_fns,
    stage x sp."""
    core = SPForward(mesh, config, ctx_len, tail_len, kv_dtype=kv_dtype)
    forward, step = make_decode_ragged_fns(make_sp_engine_decode_body(core))
    return instrument_sp_engine(
        (make_slot_prefill_fn(core), step, forward),
        sp_mode(mesh), ctx_len, tail_len)
