"""int8/int4 KV page pools with per-page, per-kv-head scales.

Counterpart of `cake_tpu/kv/quantized_pool.py`. Layout, as there:

  QuantPool (int8):  q     [(L,) N_pages, page,    KV, hd] int8
                     scale [(L,) N_pages, KV]              f32
  Int4Pool (int4):   q     [(L,) N_pages, page//2, KV, hd] uint8
                     scale [(L,) N_pages, KV]              f32

An int4 page nibble-packs two tokens per byte: token t rides the low
nibble of packed row t, token t + page//2 the high nibble, with a +8
bias. A whole-window write (prompt pages) sets each page's scale fresh
from the window's amax; an incremental write (decode tokens, chunk
windows at any offset) reads the touched pages back, grows each scale
monotonically to cover the new values, re-quantizes the resident values
by old/new, writes the new tokens and stores the pages again. The engine
zeroes the scales of freshly allocated pages (`reset_page_scales`).

The arithmetic is the JAX package's, line for line: f32 math, round
half to even, clip to +-127 (int8) or +-7 (int4), the `_EPS` amax
floor, and padding positions (`n_real`, `q_len`) kept out of the
scales, so the same inputs give the same bytes and scales as the JAX
writers under jit, as its engine runs them. There, XLA turns the
division of the amax by the constant qmax into a multiplication by its
f32 reciprocal; so does the code here (`* (1.0 / qmax)`: the scale may
differ by an ulp from an op-by-op `amax / qmax`).

Where the JAX writers are pure and drop out-of-bounds page ids with
mode="drop", these write the pool in place, through targets of fixed
shape: the decode writer has one target per row, the window writers
JAX's W = ceil(C/P) + 1 window pages a row (`window_page_targets`), and
what JAX drops goes to the sink page past the real ones, which every
cache allocates and no table maps. No writer waits for the stream, so
the decode and the mixed step capture into CUDA graphs. A step's write
targets are the same for every layer, so the steps compute them once
and every layer's writer reuses them. A window writer called without
targets, on a leaf that may have no sink, stores only the touched pages
(a boolean selection).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cake_tpu_torch.utils.devices import resolve_kv_dtype, to_device

# symmetric int8 range and the amax floor
_QMAX = 127.0
# symmetric int4 range: clip to [-7, 7] so the +8 packing bias keeps
# every value a strict nibble
_QMAX4 = 7.0
_EPS = 1e-8


class QuantPool(NamedTuple):
    """One int8 page pool half (k or v): values + per-page scales (a
    cache's pools hold one more page than it has: the sink).

    q:     int8, [(L,) N_pages, page, KV, hd]
    scale: f32,  [(L,) N_pages, KV]
    """

    q: torch.Tensor
    scale: torch.Tensor


class Int4Pool(NamedTuple):
    """One int4 page pool half (k or v): nibble-packed values + scales.

    q:     uint8, [(L,) N_pages, page//2, KV, hd] (token t in the low
           nibble of packed row t, token t + page//2 in the high nibble,
           +8 bias)
    scale: f32,   [(L,) N_pages, KV]
    """

    q: torch.Tensor
    scale: torch.Tensor


def pack_page_nibbles(q: torch.Tensor) -> torch.Tensor:
    """[..., P, KV, hd] ints in [-8, 7] -> [..., P//2, KV, hd] uint8:
    +8 bias, low nibble = token t, high nibble = token t + P//2."""
    P = q.shape[-3]
    v = (q.to(torch.int32) + 8) & 0xF
    lo = v[..., : P // 2, :, :]
    hi = v[..., P // 2:, :, :]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_page_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_page_nibbles: [..., P//2, KV, hd] uint8 ->
    [..., P, KV, hd] int8 in [-8, 7], token order restored."""
    p32 = packed.to(torch.int32)
    lo = (p32 & 0xF) - 8
    hi = (p32 >> 4) - 8
    return torch.cat([lo, hi], dim=-3).to(torch.int8)


def _pool_qmax(pool) -> float:
    return _QMAX4 if isinstance(pool, Int4Pool) else _QMAX


def _pool_page(pool) -> int:
    """Tokens per page of a per-layer pool leaf (the packed int4 axis
    stores two tokens per row)."""
    return pool.q.shape[1] * (2 if isinstance(pool, Int4Pool) else 1)


def _gather_q(pool, idx: torch.Tensor) -> torch.Tensor:
    """Pages `idx` (valid ids) as UNPACKED int values [..., P, KV, hd]."""
    q = pool.q[idx]
    if isinstance(pool, Int4Pool):
        q = unpack_page_nibbles(q)
    return q


def _scatter_q(pool, idx: torch.Tensor, qw: torch.Tensor,
               new_s: torch.Tensor) -> None:
    """Store whole pages `idx` back in place (packing int4 values
    first). qw: [n, P, KV, hd] ints; new_s: [n, KV] f32."""
    if isinstance(pool, Int4Pool):
        qw = pack_page_nibbles(qw)
    else:
        qw = qw.to(torch.int8)
    pool.q[idx] = qw
    pool.scale[idx] = new_s


class _QuantizedCache:
    """A paged cache whose k/v pools are quantized: the property surface
    of `models/llama/paged.PagedKVCache` (page_size counts REAL tokens),
    with the pools updated in place. The constructor takes the whole
    storage, the sink page included; `k` and `v` are views of the real
    pages, and `layer(i)` gives the steps a layer's whole storage."""

    pool_type = QuantPool
    _tokens_per_row = 1
    _storage = torch.int8

    def __init__(self, k, v, table: torch.Tensor):
        self.k_store = k      # pool_type, q [L, N_pages + 1, rows, KV, hd]
        self.v_store = v
        self.table = table    # [slots, max_pages] int32, -1 = unmapped

    def _real(self, pool):
        return self.pool_type(pool.q[:, :-1], pool.scale[:, :-1])

    @property
    def k(self):
        """The real pages' values and scales (views)."""
        return self._real(self.k_store)

    @property
    def v(self):
        return self._real(self.v_store)

    @property
    def page_size(self) -> int:
        return self.k_store.q.shape[2] * self._tokens_per_row

    @property
    def n_pages(self) -> int:
        """Real pages (the sink past them not counted)."""
        return self.k_store.q.shape[1] - 1

    @property
    def max_pages(self) -> int:
        return self.table.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.table.shape[1] * self.page_size

    @property
    def num_layers(self) -> int:
        return self.k_store.q.shape[0]

    def layer(self, i: int):
        """Layer i's (k, v) pool leaves, the sink last: views of the
        stacked pools, so a writer updates the cache in place."""
        cls, k, v = self.pool_type, self.k_store, self.v_store
        return cls(k.q[i], k.scale[i]), cls(v.q[i], v.scale[i])

    def clone(self):
        return type(self)(*(self.pool_type(h.q.clone(), h.scale.clone())
                            for h in (self.k_store, self.v_store)),
                          self.table.clone())

    @classmethod
    def create(cls, config, slots: int, n_pages: int, page_size: int,
               max_seq_len: int, device="cuda"):
        if max_seq_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq_len "
                f"{max_seq_len}")
        if page_size % cls._tokens_per_row:
            raise ValueError(
                f"int4 KV pages nibble-pack two tokens per byte: "
                f"page_size {page_size} must be even")
        L = config.num_hidden_layers
        KV = config.num_key_value_heads
        hd = config.head_dim
        # one page past the real ones: the decode writers' sink
        shape = (L, n_pages + 1, page_size // cls._tokens_per_row, KV, hd)
        sshape = (L, n_pages + 1, KV)

        def half():
            return cls.pool_type(
                q=torch.zeros(shape, dtype=cls._storage, device=device),
                scale=torch.zeros(sshape, dtype=torch.float32,
                                  device=device))

        return cls(half(), half(),
                   torch.full((slots, max_seq_len // page_size), -1,
                              dtype=torch.int32, device=device))

    def memory_bytes(self) -> int:
        """Storage bytes: the quantized pools plus their f32 scales, the
        sink page included."""
        return sum(t.numel() * t.element_size()
                   for t in (*self.k_store, *self.v_store))


class QuantizedPagedKVCache(_QuantizedCache):
    """Paged cache with int8 pools and per-page, per-kv-head scales."""


class Int4PagedKVCache(_QuantizedCache):
    """Paged cache with nibble-packed int4 pools and per-page,
    per-kv-head scales; page_size is REAL tokens per page (2x the packed
    storage axis)."""

    pool_type = Int4Pool
    _tokens_per_row = 2
    _storage = torch.uint8


# the --kv-dtype names of the quantized pools, and their caches
QUANTIZED_CACHES = {"int8": QuantizedPagedKVCache, "int4": Int4PagedKVCache}


def page_bytes(config, page_size: int, dtype=torch.float32) -> int:
    """Storage bytes ONE pool page costs (k + v, all layers, scales
    included for int8/int4)."""
    L = config.num_hidden_layers
    KV = config.num_key_value_heads
    hd = config.head_dim
    if dtype == "int8":
        per = L * page_size * KV * hd * 1 + L * KV * 4
    elif dtype == "int4":
        per = L * (page_size // 2) * KV * hd * 1 + L * KV * 4
    else:
        per = L * page_size * KV * hd * resolve_kv_dtype(dtype).itemsize
    return 2 * per          # k and v


def _quantize_windows(vals: torch.Tensor, qmax: float = _QMAX):
    """Quantize whole page windows: vals [..., P, KV, hd] -> (q int8 in
    [-qmax, qmax], scale f32 [..., KV]) with amax over (P, hd)."""
    v32 = vals.float()
    amax = v32.abs().amax(dim=(-3, -1))                     # [..., KV]
    scale = amax.clamp(min=_EPS) * (1.0 / qmax)
    q = (v32 / scale[..., None, :, None]).round().clamp(-qmax, qmax)
    return q.to(torch.int8), scale


def _requant(q_old: torch.Tensor, ratio: torch.Tensor,
             qmax: float = _QMAX) -> torch.Tensor:
    """Re-quantize resident int values after a monotone scale growth:
    q' = round(q * old/new). ratio [..., KV] broadcasts over
    [..., P, KV, hd]."""
    return (q_old.float() * ratio[..., None, :, None]).round().clamp(
        -qmax, qmax).to(torch.int8)


def dequantize_pages(pool, idx: torch.Tensor,
                     fill_zero: bool = False) -> torch.Tensor:
    """Pages `idx` dequantized to f32: [*idx.shape, P, KV, hd].
    fill_zero reads out-of-range ids as a zero page (the fold's
    unmapped-page semantics; an int4 fill page unpacks to -8s, and its
    zero scale zeroes the product)."""
    if fill_zero:
        ok = (idx >= 0) & (idx < pool.q.shape[0])
        safe = torch.where(ok, idx, torch.zeros_like(idx))
        q = pool.q[safe] * ok[..., None, None, None]
        s = pool.scale[safe] * ok[..., None]
    else:
        q = pool.q[idx]
        s = pool.scale[idx]
    if isinstance(pool, Int4Pool):
        q = unpack_page_nibbles(q)
    return q.float() * s[..., None, :, None]


def reset_page_scales(cache, pages):
    """Zero the scales of freshly allocated pages, in every layer, so a
    fresh page's first incremental write sets its own scale instead of
    inheriting a previous occupant's amax (which would quantize a new
    request's small values to ~0). Returns the cache."""
    idx = to_device(torch.tensor(list(pages), dtype=torch.long),
                    cache.k.scale.device)
    # index_fill_, not `[:, idx] = 0.0`: a scalar set through an index
    # copies the scalar up from the host and waits for the stream
    cache.k.scale.index_fill_(1, idx, 0.0)
    cache.v.scale.index_fill_(1, idx, 0.0)
    return cache


# -- write targets (computed once per step, shared by every layer) -----------


def decode_targets(pos, active, table, P: int, sink: int):
    """(rows, cols, pages, offsets) of a decode step's writes, one per
    row: each active row's token at pos on its page (the page index
    clamps into the table, as JAX's gather does); an inactive row, or one
    whose page is unmapped, targets page `sink` instead (the pool's page
    past the real ones), where JAX's scatter drops it. Fixed shapes and
    no host sync."""
    B = pos.shape[0]
    rows = torch.arange(B, device=table.device)
    pidx = (pos.long() // P).clamp(max=table.shape[1] - 1)
    pages = table[rows, pidx].long()
    keep = active & (pages >= 0)
    pages = torch.where(keep, pages, torch.full_like(pages, sink))
    return rows, torch.zeros_like(rows), pages, pos.long() % P


def prompt_targets(table_row, S: int, P: int):
    """(windows, pages) of an S-token prompt write at position 0: the
    windows j (positions [jP, (j+1)P)) whose page table_row[j] is
    mapped, and those pages; unmapped windows write nothing. A row on
    the device costs one wait for the stream: the prefills compute the
    targets on the host (`models/llama/paged.py`)."""
    pages = table_row[:-(-S // P)].long()
    win = (pages >= 0).nonzero(as_tuple=True)[0]
    return win, pages[win]


class WindowTargets(NamedTuple):
    """A windowed write's fixed-shape targets, JAX's: each row's W =
    ceil(C/P) + 1 window pages (its window's first page onwards), and
    where each of its C columns lands among them, in a buffer of W + 1
    window pages a row whose last page (where the columns that write
    nothing land) is dropped. The same for every layer of a step."""

    pages: torch.Tensor   # [B, W] pages read back and stored; a page no
    #                       position of the row writes is the sink
    slots: torch.Tensor   # [B * C] each column's slot in the buffer:
    #                       (b * (W + 1) + window page) * P + offset
    mask: torch.Tensor    # [B, W, P] the slots a column writes


def window_page_targets(pos, q_len, active, table, P: int, C: int,
                        sink: int) -> WindowTargets:
    """Targets of every row's q_len-token window at absolute position
    pos[b]. A row's window spans at most ceil(C/P)+1 consecutive pages;
    a page is touched iff the row is active, q_len > 0, the page lies in
    [pos // P, (pos + q_len - 1) // P] inside the table, and it is
    mapped. Every other window page is page `sink`, never the row's own
    page: a shared prefix page mapped there is neither read back nor
    stored. Padding columns (>= q_len), inactive rows and positions past
    the table or on unmapped pages write nothing (window page W, the
    buffer page the writer drops, as JAX's does). Fixed shapes and no
    host sync."""
    dev = table.device
    B = pos.shape[0]
    max_pages = table.shape[1]
    W = -(-C // P) + 1
    pos = pos.long()
    q_len = q_len.long()
    cols = torch.arange(C, device=dev)
    positions = pos[:, None] + cols[None, :]                  # [B, C]
    pidx = positions // P
    first = pos // P                                          # [B]
    win_pidx = first[:, None] + torch.arange(W, device=dev)[None, :]
    pages = torch.gather(table, 1, win_pidx.clamp(max=max_pages - 1))
    last_q = q_len.clamp(min=1) - 1
    touched = (active[:, None] & (q_len[:, None] > 0)
               & (win_pidx <= ((pos + last_q) // P)[:, None])
               & (win_pidx < max_pages) & (pages >= 0))
    p_pages = torch.gather(table, 1, pidx.clamp(max=max_pages - 1))
    valid = ((cols[None, :] < q_len[:, None]) & active[:, None]
             & (pidx < max_pages) & (p_pages >= 0))
    win = torch.where(valid, pidx - first[:, None], W)
    rows = torch.arange(B, device=dev)[:, None]
    slots = ((rows * (W + 1) + win) * P + positions % P).flatten()
    mask = torch.zeros(B * (W + 1) * P, dtype=torch.bool, device=dev)
    mask.index_fill_(0, slots, True)
    return WindowTargets(pages=torch.where(touched, pages.long(), sink),
                         slots=slots,
                         mask=mask.view(B, W + 1, P)[:, :W].contiguous())


# -- writers (one layer's pool leaf, in place) --------------------------------


def qwrite_prompt_pages(pool, vals: torch.Tensor, table_row: torch.Tensor,
                        n_real=None, targets=None):
    """Page-ALIGNED prompt windows [1, S, KV, hd] fully overwrite their
    pages, so each window quantizes fresh (scale from its own amax) and
    both q and scale are stored in one write; unmapped windows write
    nothing. Positions >= n_real (bucket padding) are zeroed before
    quantization so their garbage cannot raise a page's scale for the
    page's whole life. `targets` are `prompt_targets(...)` (a prefill
    computes them once for every layer), computed here when not given.
    Returns the pool."""
    P = _pool_page(pool)
    S = vals.shape[1]
    KV, hd = vals.shape[2], vals.shape[3]
    if n_real is not None:
        live = torch.arange(S, device=vals.device)[None, :, None,
                                                    None] < n_real
        vals = torch.where(live, vals, torch.zeros_like(vals))
    n_win = -(-S // P)
    pad = n_win * P - S
    if pad:
        vals = torch.nn.functional.pad(vals, (0, 0, 0, 0, 0, pad))
    if targets is None:
        targets = prompt_targets(table_row, S, P)
    win, pages = targets
    w = vals[0].reshape(n_win, P, KV, hd)
    q, scale = _quantize_windows(w, _pool_qmax(pool))
    _scatter_q(pool, pages, q[win], scale[win])
    return pool


def qupdate_pool_per_row(pool, vals: torch.Tensor, pos, active, table,
                         targets=None):
    """Each active row's decode token ([B, 1, KV, hd]) lands in ONE
    page: read that page and its scale, grow the scale to cover the
    token, re-quantize the residents by old/new, write the token, store
    the page. Distinct rows own distinct pages; the rows dropped go
    through the same round trip on the pool's last page, the sink.
    `targets` are `decode_targets(...)`, computed here when not given.
    Returns the pool."""
    P = _pool_page(pool)
    qmax = _pool_qmax(pool)
    if targets is None:
        targets = decode_targets(pos, active, table, P, pool.q.shape[0] - 1)
    rows, _, pages, offs = targets
    qs = _gather_q(pool, pages)                         # [n, P, KV, hd]
    ss = pool.scale[pages]                              # [n, KV]
    tok = vals[rows, 0].float()                         # [n, KV, hd]
    need = tok.abs().amax(dim=-1).clamp(min=_EPS) * (1.0 / qmax)
    new_s = torch.maximum(ss, need)
    qr = _requant(qs, ss / new_s, qmax)
    qt = (tok / new_s[..., None]).round().clamp(-qmax, qmax).to(
        torch.int8)                                     # [n, KV, hd]
    mask = torch.arange(P, device=pages.device)[None, :] == offs[:, None]
    qw = torch.where(mask[..., None, None], qt[:, None], qr)
    _scatter_q(pool, pages, qw, new_s)
    return pool


def _window_pages_rmw(pool, vals: torch.Tensor, tg: WindowTargets,
                      drop: bool = False) -> None:
    """The window writers' shared core over each row's window pages
    (vals [B, C, KV, hd]): read them back, place the window's values in
    page coordinates (W + 1 pages a row, the last one, where the columns
    that write nothing land, dropped), grow each scale to cover what
    lands on the page, re-quantize the residents, overwrite the written
    slots, store the pages. The sink's entries take the same round trip
    (several rows may store it: nothing reads it); with `drop` the leaf
    has no sink (tg.pages holds its page count there) and those entries
    are not stored, JAX's mode="drop", through a boolean selection."""
    P = _pool_page(pool)
    qmax = _pool_qmax(pool)
    B, KV, hd = vals.shape[0], vals.shape[-2], vals.shape[-1]
    W = tg.pages.shape[1]
    N = pool.q.shape[0]
    idx = tg.pages.clamp(max=N - 1) if drop else tg.pages
    qs = _gather_q(pool, idx)                      # [B, W, P, KV, hd]
    ss = pool.scale[idx]                           # [B, W, KV]
    buf = torch.zeros((B * (W + 1) * P, KV, hd), dtype=torch.float32,
                      device=vals.device)
    buf.index_copy_(0, tg.slots, vals.reshape(-1, KV, hd).float())
    buf = buf.view(B, W + 1, P, KV, hd)[:, :W]
    msk = tg.mask
    amax = torch.where(msk[..., None, None], buf.abs(),
                       torch.zeros_like(buf)).amax(dim=(-3, -1))
    need = amax.clamp(min=_EPS) * (1.0 / qmax)
    new_s = torch.maximum(ss, need)
    ratio = torch.where(new_s > 0, ss / new_s.clamp(min=_EPS),
                        torch.zeros_like(ss))
    qr = _requant(qs, ratio, qmax)
    qt = (buf / new_s.clamp(min=_EPS)[..., None, :, None]).round().clamp(
        -qmax, qmax).to(torch.int8)
    qw = torch.where(msk[..., None, None], qt, qr)
    if drop:
        keep = tg.pages < N
        _scatter_q(pool, tg.pages[keep], qw[keep], new_s[keep])
    else:
        _scatter_q(pool, tg.pages, qw, new_s)


def qwrite_window_pages(pool, vals: torch.Tensor, table_row, pos0,
                        n_real=None):
    """One C-token window [1, C, KV, hd] at absolute position pos0 (any
    in-page offset) into one slot's pages: the one-row case of
    `qwrite_windows_pages`. Positions >= n_real (the chunk path's bucket
    padding) neither write nor enter the amax, and pages touched only by
    padding are left alone. Returns the pool."""
    C = vals.shape[1]
    dev = table_row.device
    n = C if n_real is None else n_real
    return qwrite_windows_pages(
        pool, vals, torch.as_tensor([pos0], device=dev).reshape(1),
        torch.as_tensor([n], device=dev).reshape(1),
        torch.ones(1, dtype=torch.bool, device=dev), table_row[None])


def qwrite_windows_pages(pool, vals: torch.Tensor, pos, q_len, active,
                         table, targets: Optional[WindowTargets] = None):
    """The batched mixed writer: every row's q_len-token window
    ([B, C, KV, hd]) at its own offset, decode rows (q_len=1) included.
    Rows own disjoint pages, so the page round trips never collide.
    `targets` are `window_page_targets(...)` over the cache's sink (a
    step computes them once for every layer); without them the writer
    computes its own and stores only the touched pages, so a leaf
    without a sink page is fine. Returns the pool."""
    drop = targets is None
    if drop:
        targets = window_page_targets(pos, q_len, active, table,
                                      _pool_page(pool), vals.shape[1],
                                      sink=pool.q.shape[0])
    _window_pages_rmw(pool, vals, targets, drop)
    return pool
