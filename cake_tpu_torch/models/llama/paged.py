"""Paged KV cache: a shared page pool + per-slot page tables.

Counterpart of `cake_tpu/models/llama/paged.py`: the two steps of the
mixed-batch serving path (`decode_step_ragged_paged`,
`mixed_step_paged`), and the phase-split and shared-prefix prefills
(`prefill_slot_paged`, `prefill_prefix_pages`,
`prefill_slot_paged_prefixed`, `prefill_slot_paged_chunk`) with their
one-slot writers (`write_prompt_pages`, `write_window_pages`). Layout as
there:

  pool k/v: [L, N_pages + 1, page, KV, hd]   (page = tokens per page)
  table:    [slots, max_pages] int32          (page ids; -1 = unmapped)

The page past the last real one is the steps' sink: a position a step
drops (an inactive row, a padding column, an unmapped page) writes
there, where JAX's scatter drops its out-of-bounds index with
mode="drop". No table maps it, no kernel reads it, and the allocator
and `n_pages` count only the real pages; it keeps the decode and the
mixed step free of data-dependent shapes, so both capture into CUDA
graphs (serve/graphs.py).

The pool is f32/bf16 (`PagedKVCache`), or int8 / nibble-packed int4 with
per-page scales (`kv/quantized_pool.py`: `QuantizedPagedKVCache`,
`Int4PagedKVCache`). The steps read one layer's pool leaves through
`cache.layer(i)`, which all three caches have, and the writers and the
attention dispatch on the leaf type, as the JAX package's do.

Page j of a slot covers absolute positions [j*page, (j+1)*page). The
JAX steps donate the cache and return a new one; here the pool and the
table are updated IN PLACE (the steps run under torch.inference_mode)
and the same cache object is returned, so the signatures match.

Attention impl (`attn`): "kernel" = the CUDA kernels of
`ops/ragged_paged_attention.py` for the steps and of
`ops/flash_attention.py` for the prefills (raises on a CPU tensor, and
on a shape outside a kernel's gate); "plain" = the steps' plain PyTorch
folds and the prefills' masked `gqa_attention` einsum; "auto" = the
kernel for CUDA tensors and plain for CPU tensors. The JAX package's
"fold" maps to "plain", its "pallas" to "kernel".
"""

from __future__ import annotations

from typing import List, Optional

import torch

from cake_tpu_torch.kv.quantized_pool import (
    Int4Pool, QuantPool, _pool_page, decode_targets, dequantize_pages,
    prompt_targets, qupdate_pool_per_row, qwrite_prompt_pages,
    qwrite_windows_pages, window_page_targets,
)
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.model import block_skeleton, layer_params
from cake_tpu_torch.ops.attention import causal_mask, gqa_attention
from cake_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_cached,
)
from cake_tpu_torch.ops.norms import rms_norm
from cake_tpu_torch.ops.quant import qmatmul
from cake_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_mixed,
    ragged_paged_attention_mixed_plain, ragged_paged_attention_plain,
)
from cake_tpu_torch.ops.rope import apply_rope, rope_rows, rope_rows_per_row
from cake_tpu_torch.utils.devices import to_device

ATTN_IMPLS = ("auto", "plain", "kernel")


class PagedKVCache:
    """Device state of the paged cache: the pools and the page table.
    The free list stays host-side in the allocator.

    The constructor takes the whole storage, the sink page included
    ([L, N_pages + 1, page, KV, hd]); `k` and `v` are views of the real
    pages, and `layer(i)` gives the steps a layer's whole storage."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 table: torch.Tensor):
        self.k_store = k      # [L, N_pages + 1, page, KV, hd] (+ the sink)
        self.v_store = v
        self.table = table    # [slots, max_pages] int32, -1 = unmapped

    @property
    def k(self) -> torch.Tensor:
        """The real pages [L, N_pages, page, KV, hd] (a view)."""
        return self.k_store[:, :-1]

    @property
    def v(self) -> torch.Tensor:
        return self.v_store[:, :-1]

    @property
    def page_size(self) -> int:
        return self.k_store.shape[2]

    @property
    def n_pages(self) -> int:
        """Real pages (the sink past them not counted)."""
        return self.k_store.shape[1] - 1

    @property
    def max_pages(self) -> int:
        return self.table.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.table.shape[1] * self.page_size

    @property
    def num_layers(self) -> int:
        return self.k_store.shape[0]

    def layer(self, i: int):
        """Layer i's (k, v) pools [N_pages + 1, page, KV, hd], the sink
        last: views, so a writer updates the cache in place."""
        return self.k_store[i], self.v_store[i]

    def clone(self) -> "PagedKVCache":
        return PagedKVCache(self.k_store.clone(), self.v_store.clone(),
                            self.table.clone())

    @classmethod
    def create(cls, config: LlamaConfig, slots: int, n_pages: int,
               page_size: int, max_seq_len: int, dtype=torch.bfloat16,
               device="cuda") -> "PagedKVCache":
        if max_seq_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq_len "
                f"{max_seq_len}")
        L = config.num_hidden_layers
        KV = config.num_key_value_heads
        hd = config.head_dim
        shape = (L, n_pages + 1, page_size, KV, hd)        # + the sink
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            table=torch.full((slots, max_seq_len // page_size), -1,
                             dtype=torch.int32, device=device),
        )

    def memory_bytes(self) -> int:
        """Storage bytes, the sink page included."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k_store, self.v_store))


class PageAllocator:
    """Host-side free list with per-page refcounts. The engine calls it
    at admission and retire; the device steps see only the table.

    The invariant `free_pages + live_pages == n_pages` holds after every
    operation; double-frees and foreign page ids raise instead of
    silently corrupting the pool."""

    def __init__(self, n_pages: int, page_size: int):
        self.page_size = page_size
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        # page id -> refcount, for every currently-allocated page
        self._refs: dict = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Distinct pages currently allocated (each counted once however
        many holders share it)."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, n_tokens: int) -> Optional[List[int]]:
        """Pages covering n_tokens (each at refcount 1), or None when the
        pool is exhausted (the caller keeps the request queued)."""
        need = self.pages_for(n_tokens)
        if need > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, pages: List[int]) -> None:
        """Add one reference to each (already-live) page; retaining a
        free or foreign page raises before the table can alias it."""
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise ValueError(
                    f"retain of page {p} which is not allocated "
                    f"(refcount 0) — the mapping would alias freed "
                    "storage")
        for p in pages:
            self._refs[p] += 1

    def release(self, pages: List[int]) -> None:
        """Drop one reference per page; a page returns to the free list
        only at refcount 0. Raises on foreign ids and double-frees."""
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(
                    f"release of foreign page id {p!r} (pool has pages "
                    f"0..{self.n_pages - 1})")
        for p in pages:
            n = self._refs.get(p, 0)
            if n <= 0:
                raise ValueError(
                    f"double-free of page {p} (refcount already 0)")
            if n == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = n - 1


def table_set_slot(table: torch.Tensor, slot: int,
                   pages: List[int]) -> torch.Tensor:
    """Map `slot` to `pages` in place (one small host-to-device copy, from
    pinned memory on the card so that the host does not wait for the
    stream); returns the table."""
    row = torch.full((table.shape[1],), -1, dtype=torch.int32)
    row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
    if table.is_cuda:
        row = row.pin_memory()
    table[slot].copy_(row, non_blocking=True)
    return table


# -- pool writers (one layer's pool leaves, in place) -------------------------
#
# A step's write targets are the same for every layer, so the steps compute
# them once (`step_write_targets`) and every layer writes through them. They
# have fixed shapes, one per row (a decode step) or per row and window
# column (a mixed step), and what JAX's scatter drops with mode="drop" goes
# to the pool's sink page instead: no step waits for the stream or has a
# shape that depends on the data, so both capture into CUDA graphs
# (serve/graphs.py). A writer called without targets, on a pool leaf that
# may have no sink, drops those positions (`_drop`).


def _quantized(pool) -> bool:
    return isinstance(pool, (QuantPool, Int4Pool))


def _window_targets(pos, q_len, active, table, P: int, C: int, sink: int):
    """(rows [B, 1], cols [1, C], pages [B, C], offsets [B, C]): column c
    of row b writes position pos[b] + c. What JAX drops (columns >=
    q_len, so every column of a q_len = 0 row; inactive rows; positions
    past the table or on an unmapped page) targets page `sink`. Several
    dropped positions may share a sink slot, and which one lands there
    is unspecified: harmless, since no table maps the sink and nothing
    reads it."""
    B = pos.shape[0]
    max_pages = table.shape[1]
    cols = torch.arange(C, device=table.device)
    positions = pos[:, None].long() + cols[None, :]              # [B, C]
    pidx = positions // P
    pages = torch.gather(table, 1, pidx.clamp(max=max_pages - 1)).long()
    valid = ((cols[None, :] < q_len[:, None]) & active[:, None]
             & (pidx < max_pages) & (pages >= 0))
    return (torch.arange(B, device=table.device)[:, None], cols[None, :],
            torch.where(valid, pages, sink), positions % P)


def _drop(targets, sink: int):
    """The targets that do not land on page `sink`, for a pool leaf
    without one (`sink` past its last page): JAX's mode="drop". A
    boolean selection, so on the card it waits for the stream; the steps
    keep the sink instead."""
    rows, cols, pages, offs = targets
    keep = pages != sink
    return (rows.expand(pages.shape)[keep], cols.expand(pages.shape)[keep],
            pages[keep], offs[keep])


def step_write_targets(cache, pos, active, q_len=None, C: int = 1,
                       table=None):
    """The write targets of one step, shared by every layer: a decode
    step's (q_len None) tokens, or a mixed step's windows of C columns,
    with the cache's sink page (`n_pages`) where JAX drops. For a
    quantized pool, a window write touches whole pages
    (`window_page_targets`). `table`: the rows the step writes through
    (cache.table when not given)."""
    P = cache.page_size
    table = cache.table if table is None else table
    sink = cache.n_pages
    if q_len is None:
        return decode_targets(pos, active, table, P, sink)
    if _quantized(cache.k):
        return window_page_targets(pos, q_len, active, table, P, C, sink)
    return _window_targets(pos, q_len, active, table, P, C, sink)


def _scatter(pool_k, pool_v, k, v, targets):
    rows, cols, pages, offs = targets
    pool_k[pages, offs] = k[rows, cols].to(pool_k.dtype)
    pool_v[pages, offs] = v[rows, cols].to(pool_v.dtype)


def write_windows_pages(pool_k, pool_v, k, v, pos, q_len, active, table,
                        targets=None):
    """Every row writes its q_len-token window at absolute position
    pos[b] into its own pages. k/v: [B, C, KV, hd]; pos/q_len: [B];
    active: [B] bool; table: [slots(=B), max_pages]. Padding columns,
    inactive rows and positions on unmapped pages or past the table are
    not written to the real pages. A quantized pool quantizes on write
    (`qwrite_windows_pages`). `targets` come from `step_write_targets`
    (the dropped positions on the sink page); without them the writer
    computes its own and drops those positions."""
    if _quantized(pool_k):
        return (qwrite_windows_pages(pool_k, k, pos, q_len, active, table,
                                     targets),
                qwrite_windows_pages(pool_v, v, pos, q_len, active, table,
                                     targets))
    if targets is None:
        sink = pool_k.shape[0]
        targets = _drop(_window_targets(pos, q_len, active, table,
                                        pool_k.shape[1], k.shape[1], sink),
                        sink)
    _scatter(pool_k, pool_v, k, v, targets)
    return pool_k, pool_v


def _page_of(pool) -> int:
    """Tokens per page of one layer's pool leaf."""
    return _pool_page(pool) if _quantized(pool) else pool.shape[1]


def _one_window(pos0: int, C: int, n_real, quantized: bool, device):
    """(pos, q_len, active) of one slot's C-token window at pos0 as the
    batched writers take them: an f32/bf16 pool writes every column
    (JAX's window writer writes the padding too), a quantized pool only
    the n_real real ones."""
    n = C if n_real is None or not quantized else int(n_real)
    return (torch.tensor([int(pos0)], device=device),
            torch.tensor([n], device=device),
            torch.ones(1, dtype=torch.bool, device=device))


def _host_row(table_row, row):
    """A slot's table row on the host, for the write targets: the
    caller's list of its pages padded with -1 (no wait for the stream),
    or, when the caller passes none, `table_row` read back."""
    if row is None:
        return table_row.cpu()
    out = torch.full(table_row.shape, -1, dtype=torch.int32)
    out[:len(row)] = torch.tensor(list(row), dtype=torch.int32)
    return out


def _on(targets, device):
    """Write targets computed on the host, moved to `device`
    (`to_device`: the host does not wait for the stream)."""
    moved = [to_device(t, device) for t in targets]
    return targets._make(moved) if hasattr(targets, "_make") else \
        tuple(moved)


def write_prompt_pages(pool_k, pool_v, k, v, table_row, n_real=None,
                       targets=None):
    """Scatter a prompt window's KV ([1, S, KV, hd], starting at position
    0) into one slot's pages (one layer's pool leaves, in place). The
    window is zero-padded to whole pages; window j goes to page
    table_row[j] whole, padding included (dead data that decode
    overwrites before it is attended). Unmapped windows (-1) write
    nothing: no page 0, no sink. A quantized pool quantizes each window
    fresh (`qwrite_prompt_pages`), where `n_real` keeps the bucket
    padding out of the page scales. `targets` come from
    `prompt_targets`; computed here when not given."""
    if targets is None:
        targets = prompt_targets(table_row, k.shape[1], _page_of(pool_k))
    if _quantized(pool_k):
        return (qwrite_prompt_pages(pool_k, k, table_row, n_real, targets),
                qwrite_prompt_pages(pool_v, v, table_row, n_real, targets))
    P = pool_k.shape[1]
    S, KV, hd = k.shape[1], k.shape[2], k.shape[3]
    n_win = -(-S // P)
    pad = n_win * P - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    win, pages = targets
    pool_k[pages] = k[0].reshape(n_win, P, KV, hd)[win].to(pool_k.dtype)
    pool_v[pages] = v[0].reshape(n_win, P, KV, hd)[win].to(pool_v.dtype)
    return pool_k, pool_v


def write_window_pages(pool_k, pool_v, k, v, table_row, pos0,
                       n_real=None):
    """Scatter one prefill window's KV ([1, C, KV, hd]) at absolute
    position pos0 (any in-page offset) into one slot's pages, in place:
    the one-row case of `write_windows_pages`. Positions on unmapped
    pages or past the table write nothing, as JAX's mode="drop" drops
    them. An f32/bf16 pool writes the padding columns that land on
    mapped pages, as JAX does; a quantized pool read-modify-writes the
    pages the n_real real columns touch."""
    pos, q_len, active = _one_window(pos0, k.shape[1], n_real,
                                     _quantized(pool_k), table_row.device)
    return write_windows_pages(pool_k, pool_v, k, v, pos, q_len, active,
                               table_row[None])


def update_pool_per_row(pool_k, pool_v, k, v, pos, active, table,
                        targets=None):
    """Write one decode token per row into its page. k/v: [B, 1, KV, hd];
    pos: [B]; active: [B] bool; the pools' last page is the sink.
    Inactive rows and rows whose position lands on an unmapped page are
    dropped onto the sink. A quantized pool re-quantizes the written page
    (`qupdate_pool_per_row`)."""
    if _quantized(pool_k):
        return (qupdate_pool_per_row(pool_k, k, pos, active, table, targets),
                qupdate_pool_per_row(pool_v, v, pos, active, table, targets))
    if targets is None:
        targets = decode_targets(pos, active, table, pool_k.shape[1],
                                 pool_k.shape[0] - 1)
    _scatter(pool_k, pool_v, k, v, targets)
    return pool_k, pool_v


# -- attention over the pages ---------------------------------------------------


def _check_impl(impl: str, q: torch.Tensor) -> None:
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown paged_attn impl {impl!r} "
                         f"(have {ATTN_IMPLS})")
    if impl == "kernel" and not q.is_cuda:
        raise ValueError(
            "paged_attn='kernel' needs CUDA tensors: the paged-attention "
            "and flash kernels run only on the card (use 'plain' or "
            "'auto' on the CPU)")


def _attn_args(pool_k, pool_v):
    """The kernels' page arguments for a layer's pool leaves: the raw
    pools, plus scales and packing for quantized ones."""
    if not _quantized(pool_k):
        return (pool_k, pool_v), {}
    return (pool_k.q, pool_v.q), dict(
        scale_k=pool_k.scale, scale_v=pool_v.scale,
        packed4=isinstance(pool_k, Int4Pool))


def paged_attention(q, pool_k, pool_v, table, pos, *, impl: str = "auto"):
    """Ragged decode attention over paged KV. q: [B, 1, H, hd] (rope
    applied; the current token's KV written); pool_k/v: one layer's
    pools [N, P, KV, hd] or quantized pool leaves; table: [B, max_pages];
    pos: [B]. Returns [B, 1, H, hd]."""
    _check_impl(impl, q)
    pools, quant = _attn_args(pool_k, pool_v)
    fn = (ragged_paged_attention_plain if impl == "plain"
          else ragged_paged_attention)
    return fn(q, *pools, table, pos, **quant)


def paged_attention_mixed(q, pool_k, pool_v, table, pos, q_len, *,
                          impl: str = "auto"):
    """Mixed ragged attention over paged KV: decode rows (q_len=1) and
    prefill-chunk rows in one batch. q: [B, C, H, hd]; pos: [B] position
    of each row's first query; q_len: [B] (0 = idle row). Columns past
    q_len come back as zeros. Returns [B, C, H, hd]."""
    _check_impl(impl, q)
    pools, quant = _attn_args(pool_k, pool_v)
    fn = (ragged_paged_attention_mixed_plain if impl == "plain"
          else ragged_paged_attention_mixed)
    return fn(q, *pools, table, pos, q_len, **quant)


# -- model-level steps ------------------------------------------------------


def run_blocks_ragged_paged(blocks, x, cache: PagedKVCache, pos, active,
                            rope_c, rope_s, config: LlamaConfig,
                            attn: str = "auto"):
    """Every block over the page pool: write the token, attend the
    pages. x: [B, 1, D]; pos/active: [B]."""
    targets = step_write_targets(cache, pos, active)
    for i in range(cache.num_layers):
        pk, pv = cache.layer(i)

        def attn_fn(q, k, v):
            q = apply_rope(q, rope_c, rope_s)
            k = apply_rope(k, rope_c, rope_s)
            update_pool_per_row(pk, pv, k, v, pos, active, cache.table,
                                targets)
            return paged_attention(q, pk, pv, cache.table, pos,
                                   impl=attn), None

        x, _ = block_skeleton(layer_params(blocks, i), x, config, attn_fn)
    return x, cache


def forward_ragged_paged(params, tokens, cache: PagedKVCache, pos,
                         active, rope, config: LlamaConfig,
                         attn: str = "auto"):
    """One decode token per row over a paged cache. tokens: [B, 1];
    pos: [B] int32; active: [B] bool. Returns ([B, V] f32 logits,
    cache)."""
    x = params["embed"][tokens.long()]
    rope_c, rope_s = rope_rows_per_row(rope.cos, rope.sin, pos.long())
    x, cache = run_blocks_ragged_paged(params["blocks"], x, cache, pos,
                                       active, rope_c, rope_s, config,
                                       attn=attn)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    logits = qmatmul(x[:, -1], params["lm_head"]).float()
    return logits, cache


@torch.inference_mode()
def decode_step_ragged_paged(params, tokens, pos, active,
                             cache: PagedKVCache, rope,
                             config: LlamaConfig, attn: str = "auto"):
    """The engine's pure-decode step over the page pool: each active row
    writes its token's KV at pos and attends its pages (the pool is
    updated in place, where JAX donated it)."""
    return forward_ragged_paged(params, tokens, cache, pos, active,
                                rope, config, attn=attn)


def run_blocks_mixed_paged(blocks, x, cache: PagedKVCache, pos, q_len,
                           active, rope_c, rope_s, config: LlamaConfig,
                           attn: str = "auto"):
    """Every block over a mixed batch of per-row windows: write each
    row's window into its pages, attend everything written through the
    table. x: [B, C, D]; rope_c/rope_s: [B, C, hd//2]."""
    targets = step_write_targets(cache, pos, active, q_len, x.shape[1])
    for i in range(cache.num_layers):
        pk, pv = cache.layer(i)

        def attn_fn(q, k, v):
            q = apply_rope(q, rope_c, rope_s)
            k = apply_rope(k, rope_c, rope_s)
            write_windows_pages(pk, pv, k, v, pos, q_len, active,
                                cache.table, targets)
            return paged_attention_mixed(q, pk, pv, cache.table, pos,
                                         q_len, impl=attn), None

        x, _ = block_skeleton(layer_params(blocks, i), x, config, attn_fn)
    return x, cache


def _mixed_windows_trunk(params, tokens, pos, q_len, active,
                         cache: PagedKVCache, rope, config: LlamaConfig,
                         attn: str):
    """Embed, per-row per-column rope, the blocks, final norm."""
    C = tokens.shape[1]
    x = params["embed"][tokens.long()]
    # query i of row b sits at pos[b] + i (clamped into the table for
    # padding columns past the window, whose values nothing reads)
    T = rope.cos.shape[0]
    cols = torch.arange(C, device=tokens.device)
    pos_grid = (pos[:, None].long() + cols[None, :]).clamp(max=T - 1)
    rope_c = rope.cos[pos_grid]                              # [B, C, hd/2]
    rope_s = rope.sin[pos_grid]
    x, cache = run_blocks_mixed_paged(params["blocks"], x, cache, pos,
                                      q_len, active, rope_c, rope_s,
                                      config, attn=attn)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return x, cache


@torch.inference_mode()
def mixed_step_paged(params, tokens, pos, q_len, active,
                     cache: PagedKVCache, rope, config: LlamaConfig,
                     attn: str = "auto"):
    """ONE step over a mixed batch of row descriptors: a decode row
    carries (pos = current position, q_len = 1), a prefill-chunk row
    (pos = window start, q_len = real window tokens), an idle row
    (q_len = 0, active = False) touches nothing.

    tokens: [B, C] right-padded windows; pos/q_len: [B] int32; active:
    [B] bool. Returns ([B, V] f32 logits of each row's LAST real token,
    cache); the pool is updated in place."""
    B = tokens.shape[0]
    x, cache = _mixed_windows_trunk(params, tokens, pos, q_len, active,
                                    cache, rope, config, attn)
    last = (q_len.long().clamp(min=1) - 1)
    h = x[torch.arange(B, device=x.device), last]
    logits = qmatmul(h, params["lm_head"]).float()
    return logits, cache


# -- phase-split and shared-prefix prefills (one slot, B = 1) -----------------
#
# The JAX package's jitted prefills, run eagerly: a Python loop over the
# layers, the pool written in place. Each writes one slot's (or one
# prefix's) pages, through write targets computed once a call (one host
# sync, not one a layer), and attends with the flash kernels ("kernel")
# or the masked einsum ("plain"); on the card a shape outside
# `flash_supported` raises in the wrapper instead of falling back.


def _use_flash(attn: str, x: torch.Tensor) -> bool:
    """Whether a prefill attends with the flash kernels: "kernel", or
    "auto" on a CUDA tensor."""
    _check_impl(attn, x)
    return attn == "kernel" or (attn == "auto" and x.is_cuda)


def _gather_pages(pool, pages, dtype):
    """Pages `pages` ([n] ids, -1 = unmapped) of one layer's pool leaf as
    a position-ordered [1, n * P, KV, hd] view in `dtype`; unmapped pages
    read as zeros (a quantized pool dequantizes on the gather)."""
    if _quantized(pool):
        kv = dequantize_pages(pool, pages.long(), fill_zero=True)
    else:
        mapped = (pages >= 0)[:, None, None, None]
        kv = torch.where(mapped, pool[pages.long().clamp(min=0)],
                         torch.zeros((), dtype=pool.dtype,
                                     device=pool.device))
    n, P, KV, hd = kv.shape
    return kv.reshape(1, n * P, KV, hd).to(dtype)


def _last_logits(params, x, n_real: int, config: LlamaConfig):
    """Final norm and lm_head at the window's last real token ([1, V]
    f32)."""
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return qmatmul(x[:, n_real - 1], params["lm_head"]).float()


def _prompt_prefill_blocks(params, tokens, table_row, cache, rope,
                           config: LlamaConfig, attn: str, n_real=None,
                           row=None):
    """Every block over a window at position 0 whose KV goes whole to the
    pages of `table_row` (`write_prompt_pages`), attending the window
    itself: causal `flash_attention`, or the einsum under a causal
    mask. Returns the hidden state [1, S, D]."""
    S = tokens.shape[1]
    x = params["embed"][tokens.long()]
    rope_c, rope_s = rope_rows(rope.cos, rope.sin, 0, S)
    flash = _use_flash(attn, x)
    mask = None if flash else causal_mask(S, device=x.device)
    targets = _on(prompt_targets(_host_row(table_row, row), S,
                                 cache.page_size), x.device)
    for i in range(cache.num_layers):
        pk, pv = cache.layer(i)

        def attn_fn(q, k, v):
            q = apply_rope(q, rope_c, rope_s)
            k = apply_rope(k, rope_c, rope_s)
            write_prompt_pages(pk, pv, k, v, table_row, n_real, targets)
            if flash:
                return flash_attention(q, k, v, causal=True), None
            return gqa_attention(q, k, v, mask=mask), None

        x, _ = block_skeleton(layer_params(params["blocks"], i), x, config,
                              attn_fn)
    return x


@torch.inference_mode()
def prefill_prefix_pages(params, tokens, table_row, cache: PagedKVCache,
                         rope, config: LlamaConfig, attn: str = "auto",
                         row=None):
    """Prefill a registered prefix once into its own pool pages.

    tokens: [1, S], S page-aligned (the engine rounds a registration down
    to a page); table_row: [max_pages] int32 mapping the prefix's pages
    (a standalone row, no engine slot; the engine later maps the same
    pages at the head of every matching slot's row). Causal prefill at
    position 0 with each layer's KV written to those pages; no logits
    (the next token comes from each request's suffix). Returns the
    cache.

    row (here and in the slot prefills): the caller's host list of the
    row's pages, from which the write targets are computed without a
    wait for the stream; when not given, the row is read back from the
    device."""
    _prompt_prefill_blocks(params, tokens, table_row, cache, rope, config,
                           attn, row=row)
    return cache


@torch.inference_mode()
def prefill_slot_paged(params, tokens, prompt_len, slot,
                       cache: PagedKVCache, rope, config: LlamaConfig,
                       attn: str = "auto", row=None):
    """A whole right-padded prompt bucket at position 0 into slot
    `slot`'s pages: causal prefill over the fresh window (no page reads),
    each layer's KV written through the slot's table row. tokens: [1, S];
    prompt_len: the real token count (an int or a [1] tensor). Returns
    ([1, V] f32 logits at prompt_len - 1, cache)."""
    n = int(prompt_len)
    x = _prompt_prefill_blocks(params, tokens, cache.table[int(slot)],
                               cache, rope, config, attn, n_real=n,
                               row=row)
    return _last_logits(params, x, n, config), cache


@torch.inference_mode()
def prefill_slot_paged_prefixed(params, tokens, suffix_len, slot,
                                cache: PagedKVCache, rope,
                                config: LlamaConfig, n_prefix: int,
                                attn: str = "auto", row=None):
    """The suffix window of a prompt whose first n_prefix tokens are a
    registered prefix, already mapped (shared, read-only) at the head of
    slot `slot`'s table row. The window's KV goes only to the row's pages
    after the shared ones; attention reads the shared pages (gathered,
    dequantized for a quantized pool) followed by the window, at
    pos = n_prefix: `flash_attention_cached`, or the einsum under the
    same mask. tokens: [1, S] right-padded suffix; suffix_len: its real
    length. Returns ([1, V] f32 logits at suffix_len - 1, cache)."""
    S = tokens.shape[1]
    n = int(suffix_len)
    P = cache.page_size
    n_pp = n_prefix // P
    T = n_prefix + S
    x = params["embed"][tokens.long()]
    rope_c, rope_s = rope_rows(rope.cos, rope.sin, n_prefix, S)
    table_row = cache.table[int(slot)]
    prefix_pages = table_row[:n_pp].clamp(min=0)
    suffix_row = table_row[n_pp:]
    flash = _use_flash(attn, x)
    qpos = n_prefix + torch.arange(S, device=x.device)
    mask = (None if flash else
            torch.arange(T, device=x.device)[None, :] <= qpos[:, None])
    targets = _on(prompt_targets(_host_row(table_row, row)[n_pp:], S, P),
                  x.device)
    for i in range(cache.num_layers):
        pk, pv = cache.layer(i)

        def attn_fn(q, k, v):
            q = apply_rope(q, rope_c, rope_s)
            k = apply_rope(k, rope_c, rope_s)
            # the shared pages, read before the suffix write (the two
            # sets of pages are disjoint)
            kp = _gather_pages(pk, prefix_pages, q.dtype)
            vp = _gather_pages(pv, prefix_pages, q.dtype)
            write_prompt_pages(pk, pv, k, v, suffix_row, n, targets)
            k_full = torch.cat([kp, k.to(q.dtype)], dim=1)
            v_full = torch.cat([vp, v.to(q.dtype)], dim=1)
            if flash:
                return flash_attention_cached(q, k_full, v_full,
                                              n_prefix), None
            return gqa_attention(q, k_full, v_full, mask=mask), None

        x, _ = block_skeleton(layer_params(params["blocks"], i), x, config,
                              attn_fn)
    return _last_logits(params, x, n, config), cache


@torch.inference_mode()
def prefill_slot_paged_chunk(params, tokens, n_real, slot, pos0,
                             cache: PagedKVCache, rope,
                             config: LlamaConfig, attn: str = "auto",
                             row=None):
    """One C-token prefill window at absolute position pos0 into slot
    `slot`'s pages (pos0 anywhere in a page). The window's KV goes
    through the batched writer at one row (as `write_window_pages`
    writes it); then the slot's whole row is gathered
    in position order (unmapped pages as zeros; a shared prefix at the
    row head and earlier windows included) and the window attends it at
    pos0: `flash_attention_cached`, or the einsum under
    kj <= pos0 + qi. tokens: [1, C]; n_real: real tokens in the window.
    Returns ([1, V] f32 logits at n_real - 1, cache)."""
    C = tokens.shape[1]
    n = int(n_real)
    pos0 = int(pos0)
    T = cache.max_seq_len
    x = params["embed"][tokens.long()]
    rope_c, rope_s = rope_rows(rope.cos, rope.sin, pos0, C)
    table_row = cache.table[int(slot)]
    flash = _use_flash(attn, x)
    qpos = pos0 + torch.arange(C, device=x.device)
    mask = (None if flash else
            torch.arange(T, device=x.device)[None, :] <= qpos[:, None])
    pos, q_len, active = _one_window(pos0, C, n, _quantized(cache.k),
                                     "cpu")
    targets = _on(step_write_targets(
        cache, pos, active, q_len, C,
        table=_host_row(table_row, row)[None]), x.device)
    for i in range(cache.num_layers):
        pk, pv = cache.layer(i)

        def attn_fn(q, k, v):
            q = apply_rope(q, rope_c, rope_s)
            k = apply_rope(k, rope_c, rope_s)
            write_windows_pages(pk, pv, k, v, pos, q_len, active,
                                table_row[None], targets)
            k_full = _gather_pages(pk, table_row, q.dtype)
            v_full = _gather_pages(pv, table_row, q.dtype)
            if flash:
                return flash_attention_cached(q, k_full, v_full,
                                              pos0), None
            return gqa_attention(q, k_full, v_full, mask=mask), None

        x, _ = block_skeleton(layer_params(params["blocks"], i), x, config,
                              attn_fn)
    return _last_logits(params, x, n, config), cache
