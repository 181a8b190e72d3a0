"""Parameter and cache placement on a mesh.

Counterpart of `cake_tpu/parallel/sharding.py` (`tree_shard`,
`shard_params`, `shard_cache`, `create_sharded_cache`; JAX's
`replicate` is `place(x, mesh, ())`).
Where JAX places a leaf with a `NamedSharding` and GSPMD partitions the
program, the port places it as a `Sharded`: the global shape, dtype and
spec, and one tensor per mesh position holding only that position's
slice (a copy, never a view that keeps the whole tensor's storage
alive). Positions whose slice and device coincide share one tensor, so
a replicated leaf is held once per distinct device: a co-located mesh
keeps one embedding, not one a position. The forwards of
`parallel/pipeline.py` read a position's slices (`local`). On a mesh
that spans processes a position another process owns holds None: the
leaf is allocated, loaded and quantized only where this process runs.

A spec is a tuple with one entry per dim: None (replicated), an axis
name of the mesh, or a tuple of names (major to minor); entries past
the spec's length are None.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np
import torch

from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.params import block_specs, cache_specs
from cake_tpu_torch.ops.quant import QTensor, expand_specs_for_quant
from cake_tpu_torch.parallel.mesh import Mesh
from cake_tpu_torch.utils.devices import zero_

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _full_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def shard_slices(shape, spec, mesh: Mesh, pos) -> tuple:
    """The slice of each dim that mesh position `pos` (an index of the
    mesh's array, (dp, stage, tp) on a pipeline mesh) holds of a leaf of `shape` placed by `spec`. A dim must divide over
    its axes."""
    out = []
    for dim, entry in enumerate(_full_spec(spec, len(shape))):
        n, idx = 1, 0
        for ax in _axes(entry):
            size = mesh.shape[ax]
            idx = idx * size + pos[mesh.axis_names.index(ax)]
            n *= size
        if shape[dim] % n:
            raise ValueError(
                f"dim {dim} of a leaf of shape {tuple(shape)} does not "
                f"divide over {_axes(entry)} ({n} shards)")
        w = shape[dim] // n
        out.append(slice(idx * w, (idx + 1) * w))
    return tuple(out)


def _key(slices) -> tuple:
    return tuple((s.start, s.stop) for s in slices)


class Sharded:
    """One leaf placed on a mesh: its global shape, dtype and spec, and a
    tensor per mesh position (an object array shaped like the mesh)."""

    def __init__(self, shape, dtype, spec, mesh: Mesh, shards: np.ndarray):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = _full_spec(spec, len(shape))
        self.mesh = mesh
        self.shards = shards

    @classmethod
    def build(cls, shape, dtype, spec, mesh: Mesh,
              make: Callable[[tuple, torch.device], torch.Tensor]
              ) -> "Sharded":
        """make(slices, device) -> that shard, called once for each
        distinct (slice, device) of the positions this process owns."""
        made: dict = {}
        shards = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(*mesh.devices.shape):
            if not mesh.owns(pos):
                continue
            dev = mesh.devices[pos]
            sl = shard_slices(shape, spec, mesh, pos)
            key = (_key(sl), dev)
            if key not in made:
                made[key] = make(sl, dev)
            shards[pos] = made[key]
        return cls(shape, dtype, spec, mesh, shards)

    # -- tensor-like queries ---------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        """The first owned position's device."""
        return self.first().device

    def first(self) -> torch.Tensor:
        """The first owned position's tensor."""
        return next(t for t in self.shards.flat if t is not None)

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self.first().element_size()

    def shard(self, dp: int = 0, stage: int = 0, tp: int = 0,
              sp: int = 0):
        """The tensor the mesh position of these coordinates holds (an
        axis the mesh lacks at 0, `Mesh.index`)."""
        return self.shards[self.mesh.index(dp=dp, stage=stage, tp=tp,
                                           sp=sp)]

    def distinct(self) -> list:
        """Every tensor this process holds, once (positions may share
        one)."""
        seen, out = set(), []
        for t in self.shards.flat:
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def bytes_per_device(self) -> dict:
        """Bytes this leaf holds on each distinct device."""
        out: dict = {}
        for t in self.distinct():
            out[t.device] = out.get(t.device, 0) + t.numel() * t.element_size()
        return out

    def gather(self, device="cpu") -> torch.Tensor:
        """The whole tensor, assembled from the shards on `device`."""
        full = torch.empty(self.shape, dtype=self.dtype, device=device)
        for pos in np.ndindex(*self.mesh.devices.shape):
            sl = shard_slices(self.shape, self.spec, self.mesh, pos)
            full[sl] = self.shards[pos].to(device)
        return full

    def zero_(self) -> "Sharded":
        for t in self.distinct():
            zero_(t)
        return self

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")


def place(x: torch.Tensor, mesh: Mesh, spec) -> Sharded:
    """x placed on the mesh by spec: each shard a contiguous copy of its
    slice on its device (the whole tensor itself where a position holds
    all of it on x's own device)."""
    def make(sl, dev):
        part = x[sl]
        if part.shape == x.shape and dev == x.device:
            return x
        out = torch.empty(part.shape, dtype=x.dtype, device=dev)
        return out.copy_(part)

    with torch.no_grad():
        return Sharded.build(x.shape, x.dtype, spec, mesh, make)


def _map(tree, spec_tree, fn):
    if isinstance(tree, QTensor):
        return QTensor(q=fn(tree.q, spec_tree.q),
                       scale=fn(tree.scale, spec_tree.scale))
    if isinstance(tree, dict):
        return {k: _map(v, spec_tree[k], fn) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, spec_tree)


def tree_shard(tree, mesh: Mesh, spec_tree):
    """Place every leaf of a param dict with its spec. QTensor leaves
    first get their spec expanded from the weight's
    (ops/quant.expand_specs_for_quant), so `--quant` composes with every
    placement."""
    spec_tree = expand_specs_for_quant(tree, spec_tree)
    return _map(tree, spec_tree, lambda x, s: place(x, mesh, s))


def local(tree, dp: int = 0, stage: int = 0, tp: int = 0, sp: int = 0):
    """A placed tree as one mesh position sees it: each Sharded leaf its
    shard, QTensor nodes of shards, other leaves as they are."""
    if isinstance(tree, Sharded):
        return tree.shard(dp, stage, tp, sp)
    if isinstance(tree, QTensor):
        return QTensor(local(tree.q, dp, stage, tp, sp),
                       local(tree.scale, dp, stage, tp, sp))
    if isinstance(tree, dict):
        return {k: local(v, dp, stage, tp, sp) for k, v in tree.items()}
    return tree


def gather_tree(tree, device="cpu"):
    """A placed tree reassembled into whole tensors (tests)."""
    if isinstance(tree, Sharded):
        return tree.gather(device)
    if isinstance(tree, QTensor):
        return QTensor(gather_tree(tree.q, device),
                       gather_tree(tree.scale, device))
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    return tree


def shard_params(params, mesh: Mesh, *, tp_axis: Optional[str] = "tp",
                 stage_axis: Optional[str] = None,
                 ep_axis: Optional[str] = None):
    """Place a text-model param dict: Megatron TP (the embedding and the
    lm_head over the vocabulary), optionally the layer dim over a stage
    axis and MoE experts over an expert axis. Specs derive from the
    actual block leaves, so dense and MoE trees both place. The
    pipeline's forwards take `pipeline.place_for_pipeline`'s placement
    instead (the embedding and the lm_head replicated)."""
    specs = {
        "embed": (tp_axis, None),
        "blocks": block_specs(params["blocks"].keys(), stage_axis=stage_axis,
                              tp_axis=tp_axis, ep_axis=ep_axis),
        "final_norm": (None,),
        "lm_head": (None, tp_axis),
    }
    return tree_shard(params, mesh, specs)


class ShardedKVCache:
    """A KV cache placed on a mesh: k and v are `Sharded` [L, B, T, KV,
    hd] leaves; `local` is one position's KVCache of its slices."""

    def __init__(self, k: Sharded, v: Sharded):
        self.k = k
        self.v = v

    def local(self, dp: int = 0, stage: int = 0, tp: int = 0) -> KVCache:
        return KVCache(self.k.shard(dp, stage, tp),
                       self.v.shard(dp, stage, tp))

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch_size(self) -> int:
        return self.k.shape[1]

    def zero_(self) -> "ShardedKVCache":
        """Zero every shard in place (a captured step holds them)."""
        self.k.zero_()
        self.v.zero_()
        return self

    def fresh(self) -> "ShardedKVCache":
        """A zeroed cache of the same placement (new allocations)."""
        return zeros_placed(self.placement())

    def memory_bytes(self) -> int:
        """Bytes of every distinct shard of both buffers."""
        return 2 * sum(self.k.bytes_per_device().values())

    def gather(self, device="cpu") -> KVCache:
        return KVCache(self.k.gather(device), self.v.gather(device))

    def placement(self) -> tuple:
        """What `zeros_placed` needs to allocate a cache placed like this
        one: (shape, dtype, spec, mesh), no tensor."""
        return (tuple(self.k.shape), self.k.dtype, self.k.spec, self.k.mesh)


def zeros_placed(placement: tuple, batch: Optional[int] = None,
                 length: Optional[int] = None) -> ShardedKVCache:
    """A zeroed cache of a `ShardedKVCache.placement()`, each shard
    allocated on its device (optionally `batch` rows of `length`
    positions instead of the placement's)."""
    shape, dtype, spec, mesh = placement
    shape = list(shape)
    if batch is not None:
        shape[1] = batch
    if length is not None:
        shape[2] = length

    def zeros(sl, dev):
        return torch.zeros([s.stop - s.start for s in sl], dtype=dtype,
                           device=dev)

    return ShardedKVCache(k=Sharded.build(shape, dtype, spec, mesh, zeros),
                          v=Sharded.build(shape, dtype, spec, mesh, zeros))


def shard_cache(cache: KVCache, mesh: Mesh, *,
                tp_axis: Optional[str] = "tp",
                dp_axis: Optional[str] = "dp",
                stage_axis: Optional[str] = None) -> ShardedKVCache:
    specs = cache_specs(tp_axis=tp_axis, dp_axis=dp_axis,
                        stage_axis=stage_axis)
    return ShardedKVCache(k=place(cache.k, mesh, specs.k),
                          v=place(cache.v, mesh, specs.v))


def create_sharded_cache(config, batch_size: int, max_seq_len: int,
                         mesh: Mesh, *, tp_axis: Optional[str] = None,
                         dp_axis: Optional[str] = None,
                         stage_axis: Optional[str] = "stage",
                         dtype=torch.bfloat16) -> ShardedKVCache:
    """Allocate a KV cache directly in its sharded layout: each shard is
    zeros of its own slice's shape on its device, and the whole buffer
    never exists (it could exceed a card sized for the slice)."""
    specs = cache_specs(tp_axis=tp_axis, dp_axis=dp_axis,
                        stage_axis=stage_axis)
    shape = (config.num_hidden_layers, batch_size, max_seq_len,
             config.num_key_value_heads, config.head_dim)

    def zeros(sl, dev):
        return torch.zeros([s.stop - s.start for s in sl], dtype=dtype,
                           device=dev)

    return ShardedKVCache(
        k=Sharded.build(shape, dtype, specs.k, mesh, zeros),
        v=Sharded.build(shape, dtype, specs.v, mesh, zeros))


def stream_leaf(get, transpose: bool, spec, mesh: Mesh, dtype,
                lead: tuple = ()) -> Sharded:
    """A leaf read from safetensors straight onto its shards: `get(*i)`
    returns the file tensor (utils/loading.StTensor, its HF layout) at
    index i of the `lead` stacked dims (layers, experts); each shard
    reads only its slice of each of them from the mmap (transposed
    first when `transpose`), casts it to `dtype` and copies it to its
    device."""
    first = get(*([0] * len(lead)))
    inner = tuple(reversed(first.shape)) if transpose else tuple(first.shape)
    shape = tuple(lead) + inner
    n = len(lead)

    def make(sl, dev):
        rows = []
        for idx in itertools.product(*(range(s.start, s.stop)
                                       for s in sl[:n])):
            raw = get(*idx).raw
            view = raw.T if transpose else raw
            rows.append(view[sl[n:]])
        part = np.stack(rows) if n else rows[0]
        t = torch.from_numpy(np.array(part))      # a copy: the mmap stays read-only
        if first.st_dtype == "BF16":
            t = t.view(torch.bfloat16)
        out = torch.empty([s.stop - s.start for s in sl], dtype=dtype,
                          device=dev)
        return out.copy_(t.reshape(out.shape))

    with torch.no_grad():
        return Sharded.build(shape, dtype, spec, mesh, make)


def _positions(x: Sharded):
    return list(np.ndindex(*x.shards.shape))


def map_shards(x: Sharded, shape, dtype, spec, fn) -> Sharded:
    """A Sharded whose tensor at each position is fn(pos, x's tensor
    there), computed once for each distinct tensor of x."""
    made: dict = {}
    shards = np.empty(x.shards.shape, dtype=object)
    for pos in _positions(x):
        t = x.shards[pos]
        if t is None:
            continue
        if id(t) not in made:
            made[id(t)] = fn(pos, t)
        shards[pos] = made[id(t)]
    return Sharded(shape, dtype, spec, x.mesh, shards)


@torch.no_grad()
def _quantize_sharded_leaf(x: Sharded, dims, bits: int,
                           group: int) -> QTensor:
    """One placed weight quantized shard by shard, to the bytes and scales
    the whole weight's quantization gives: int4 groups lie inside a
    shard (the caller checks that each shard is group-aligned), and an
    int8 channel's max|w| over a contract dim split across shards is
    the max over those shards."""
    from cake_tpu_torch.ops.quant import expand_spec, pick_group, \
        quantize_group

    if bits == 4:
        cd = dims[0] % x.ndim
        g = pick_group(x.shape[cd], group)
        qs = {}

        def one(pos, t):
            if t.shape[cd] % g:
                raise ValueError(
                    f"a shard of {t.shape[cd]} contract rows splits an "
                    f"int4 group of {g}")
            qs[id(t)] = quantize_group(t, cd, g)
            return qs[id(t)]

        both = map_shards(x, x.shape, None, x.spec, one)
        specs = expand_spec(x.spec, dims, x.ndim, groupwise=True)
        qshape = list(x.shape)
        qshape[cd] //= 2
        sshape = list(x.shape)
        sshape[cd] //= g
        q = map_shards(both, qshape, torch.uint8, specs.q,
                     lambda pos, t: t.q)
        scale = map_shards(both, sshape, torch.float32, specs.scale,
                         lambda pos, t: t.scale)
        return QTensor(q, scale)

    dims = tuple(d % x.ndim for d in dims)

    def amax(t):
        if t.ndim >= 3 and 0 not in dims:   # a layer at a time
            inner = tuple(d - 1 for d in dims)
            return torch.stack([t[i].float().abs().amax(dim=inner,
                                                        keepdim=True)
                                for i in range(t.shape[0])])
        return t.float().abs().amax(dim=dims, keepdim=True)

    # the max over every shard that holds the same channels
    groups: dict = {}
    for pos in _positions(x):
        if x.shards[pos] is None:
            continue
        sl = shard_slices(x.shape, x.spec, x.mesh, pos)
        key = tuple(_key(sl)[d] for d in range(x.ndim) if d not in dims)
        groups.setdefault(key, {})[id(x.shards[pos])] = x.shards[pos]
    gmax: dict = {}
    for key, ts in groups.items():
        ms = [amax(t) for t in ts.values()]
        m = ms[0]
        for other in ms[1:]:
            m = torch.maximum(m, other.to(m.device))
        for t in ts.values():
            gmax[id(t)] = m.to(t.device)

    def q_of(pos, t):
        scale = gmax[id(t)].clamp(min=1e-8) * (1.0 / 127.0)
        return (t.float() / scale).round().clamp(-127, 127).to(torch.int8)

    def scale_of(pos, t):
        scale = gmax[id(t)].clamp(min=1e-8) * (1.0 / 127.0)
        for d in sorted(dims, reverse=True):
            scale = scale.squeeze(d)
        return scale

    specs = expand_spec(x.spec, dims, x.ndim)
    sshape = [n for d, n in enumerate(x.shape) if d not in dims]
    return QTensor(map_shards(x, x.shape, torch.int8, specs.q, q_of),
                   map_shards(x, sshape, torch.float32, specs.scale, scale_of))


def quantize_sharded(params: dict, bits: int, group: int = 128) -> dict:
    """--quant over a placed param dict, shard by shard (the streamed
    load's tree): every block matmul weight and the lm_head (int8 at
    bits=4 too), as `ops/quant.quantize_params` quantizes a whole tree;
    the embedding, norms and biases stay."""
    from cake_tpu_torch.ops.quant import _BLOCK_CONTRACT, _check_bits

    _check_bits(params, bits)
    out = dict(params)
    out["blocks"] = {
        k: (_quantize_sharded_leaf(v, _BLOCK_CONTRACT[k], bits, group)
            if k in _BLOCK_CONTRACT else v)
        for k, v in params["blocks"].items()}
    out["lm_head"] = _quantize_sharded_leaf(params["lm_head"], (0,), 8, group)
    return out
