"""Host-RAM spill tier for the paged KV pool.

Counterpart of `cake_tpu/kv/host_tier.py`: the LRU store (`HostTier`,
`SpilledPages`), its capacity in pages (`--kv-host-pages N`), and the
five `cake_kv_*` metric families under the JAX package's names, labels
and help, copied as they are; `fetch_pages` / `install_pages` rewritten
for the port's pools. A preemption victim's pages, a cold shared
prefix's pages and a parked decode-resident stream's pages move to host
RAM, their device pages go back to the allocator, and a later admission
streams them back into fresh pages, bit for bit. An over-capacity `put`
evicts least-recently-used entries first (everything here can be
recomputed, so an eviction loses a shortcut, never data). The engine
thread owns every call that pairs with an allocator or table change;
the tier only moves bytes and keeps the LRU map.

The pools (models/llama/paged.PagedKVCache and the quantized caches of
kv/quantized_pool.py) keep [L, N_pages + 1, ...] storage, the steps'
sink page last; an entry holds the spilled pages' slices in the JAX
order: (k, v) for f32/bf16/fp8 pages, (k_q, k_scale, v_q, v_scale) for
int8 and nibble-packed int4 pages with their scales. The sink page is
never spilled nor written.

No wait for the stream, in either direction (the JAX tier blocks on
`jax.device_get` and `block_until_ready`; the port's preemption wave
runs under `torch.cuda.set_sync_debug_mode("error")`): a spill gathers
the pages with `index_select` and copies them into pinned host tensors
with non_blocking; a restore uploads them from there, non_blocking, on
the same stream, and scatters them with `index_copy_`. Stream order
alone makes a spill read the pages before any later write to the freed
pages, and a restore land before any step that reads them. An entry's
bytes are read on the host only by a caller that synchronizes (a test).
fp8 pools move as their bytes (uint8 views), which every device and
torch version can index.

Metrics (obs/metrics.py registry; also refreshed at scrape by
obs/steps.refresh_page_gauges):
  cake_kv_host_pages{state,dtype}  gauge    used | free host pages
  cake_kv_spill_total{dir}         counter  spill | restore page moves
  cake_kv_resident_spills_total    counter  decode-resident streams
                                            parked under pool pressure
  cake_kv_spill_seconds            histogram device<->host copy time
  cake_kv_pool_bytes{tier,dtype}   gauge    device | host bytes
`cake_kv_spill_seconds` takes, on the card, the device time between
CUDA events recorded around each movement, observed once the stream has
passed them (at a later movement or scrape), never by waiting: a
deliberate divergence from JAX's host wall clock around blocking copies.
On the CPU it is the wall clock of the (synchronous) copy.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.utils.devices import to_device

log = logging.getLogger(__name__)

_HOST_PAGES = obs_metrics.gauge(
    "cake_kv_host_pages",
    "Host-tier KV pages by state (used = spilled pages resident in "
    "host RAM, free = remaining --kv-host-pages capacity) and pool "
    "storage dtype",
    labelnames=("state", "dtype"))
_SPILLS = obs_metrics.counter(
    "cake_kv_spill_total",
    "KV pages moved across the HBM/host boundary, by direction "
    "(spill = device->host, restore = host->device)",
    labelnames=("dir",))
_RESIDENT_SPILLS = obs_metrics.counter(
    "cake_kv_resident_spills_total",
    "Actively-decoding streams parked in the host tier because the "
    "pool could not admit a new request (decode-resident spill; "
    "preemption victims and cold prefixes count in cake_kv_spill_total "
    "only)")
_SPILL_SECONDS = obs_metrics.histogram(
    "cake_kv_spill_seconds",
    "Wall seconds per spill/restore page movement (device_get or "
    "scatter-back, engine-thread)")
_POOL_BYTES = obs_metrics.gauge(
    "cake_kv_pool_bytes",
    "KV pool bytes resident per tier (device = the paged pool incl. "
    "int8/int4 scale sidecars, host = spilled pages in RAM) and pool "
    "storage dtype",
    labelnames=("tier", "dtype"))

# (start, end) CUDA events of movements not yet observed in
# cake_kv_spill_seconds: observed once the stream has passed the end
_PENDING: list = []
_PENDING_LOCK = threading.Lock()


def _quantized(cache) -> bool:
    return hasattr(cache.k_store, "q")


def pool_dtype_name(cache) -> str:
    """Storage-dtype label value for a paged cache: quantized pools
    report their logical precision (a packed int4 pool is uint8-backed
    but stores int4 values), plain pools their dtype's name as numpy and
    JAX spell it ("float32", "bfloat16", "float8_e4m3fn", ...). The ONE
    source for the {dtype} label on cake_kv_pool_bytes /
    cake_kv_host_pages."""
    if _quantized(cache):
        return "int4" if cache.k_store.q.dtype == torch.uint8 else "int8"
    return str(cache.k_store.dtype).rsplit(".", 1)[-1]


def note_resident_spill() -> None:
    """Count one decode-resident stream parked in the host tier (the
    engine's _spill_resident_stream seam)."""
    _RESIDENT_SPILLS.inc()


def observe_spill_times() -> None:
    """Observe the device time of every movement whose end event the
    stream has passed (never waits)."""
    with _PENDING_LOCK:
        keep = []
        for a, b in _PENDING:
            if b.query():
                _SPILL_SECONDS.observe(a.elapsed_time(b) / 1e3)
            else:
                keep.append((a, b))
        _PENDING[:] = keep


def refresh_gauges(cache, tier: Optional["HostTier"]) -> None:
    """Scrape-time refresh of every cake_kv_* gauge (the seam for
    obs/steps.refresh_page_gauges). cache is the engine's paged pool
    (device tier: memory_bytes, the sink page and scales included);
    tier is the engine's HostTier or None when --kv-host-pages is
    unset. Host entries always match the device pool's dtype, so one
    name labels both tiers."""
    name = pool_dtype_name(cache)
    _POOL_BYTES.labels("device", name).set(cache.memory_bytes())
    observe_spill_times()
    if tier is not None:
        tier.dtype_name = name
        tier._set_gauges()


@dataclass
class SpilledPages:
    """One spill entry: the raw page contents + resume metadata."""

    n_pages: int
    # pool slices [L, n, ...] in pinned host memory (on the card), device
    # layout preserved: for a quantized pool (k_q, k_scale, v_q, v_scale),
    # else (k, v); restore scatters them back verbatim, so a host round
    # trip is bit-identical
    arrays: Tuple[torch.Tensor, ...]
    kind: str = "pages"            # "victim" | "prefix"
    # victim resume state (engine mirrors at preemption time)
    pos: int = 0
    last_tok: int = 0
    n_prefix_tokens: int = 0
    meta: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays)


class HostTier:
    """LRU store of spilled KV pages, capacity-bounded in pages."""

    # cakelint guards discipline: the event bus is an optional plane
    OPTIONAL_PLANES = ("_events",)

    def __init__(self, capacity_pages: int, page_bytes: int = 0,
                 events=None, dtype_name: str = "float32"):
        if capacity_pages < 1:
            raise ValueError(
                f"--kv-host-pages {capacity_pages} must be >= 1")
        self.capacity = capacity_pages
        self.page_bytes = page_bytes
        # {dtype} gauge label: set at construction from the engine's
        # storage name, re-derived from the live cache at every scrape
        self.dtype_name = dtype_name
        self._entries: "OrderedDict[object, SpilledPages]" = OrderedDict()
        self._used = 0
        self.spills = 0
        self.restores = 0
        self.evictions = 0
        # obs/events.EventBus (None = disabled plane): put/pop are the
        # spill/restore seams every caller goes through, so kv_spill /
        # kv_restore events published here cover victims AND prefixes
        self._events = events
        self._set_gauges()

    def _publish(self, type: str, key, entry: SpilledPages) -> None:
        if self._events is None:
            return
        # ("victim", rid) keys link the event to its request; prefix
        # entries carry the pid as a field instead (no rid exists)
        rid = pid = None
        if isinstance(key, tuple) and len(key) == 2:
            if key[0] == "victim":
                rid = key[1]
            elif key[0] == "prefix":
                pid = key[1]
        self._events.publish(type, rid=rid, kind=entry.kind,
                             pages=entry.n_pages, pid=pid)

    # -- accounting --------------------------------------------------------

    @property
    def used_pages(self) -> int:
        return self._used

    @property
    def free_pages(self) -> int:
        return self.capacity - self._used

    @property
    def used_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def can_hold(self, n_pages: int) -> bool:
        """Whether n_pages could be stored at all (evicting colder
        entries if needed): the engine's spill-vs-recompute gate."""
        return n_pages <= self.capacity

    def _set_gauges(self) -> None:
        try:
            _HOST_PAGES.labels("used", self.dtype_name).set(self._used)
            _HOST_PAGES.labels("free", self.dtype_name).set(
                self.free_pages)
            _POOL_BYTES.labels("host", self.dtype_name).set(
                self.used_bytes)
        except Exception:  # noqa: BLE001 — telemetry never fails serving
            log.debug("host tier gauge update failed", exc_info=True)

    # -- store -------------------------------------------------------------

    def put(self, key, entry: SpilledPages) -> bool:
        """Store an entry, evicting LRU entries until it fits; False
        (and no mutation) when it can never fit."""
        if entry.n_pages > self.capacity:
            return False
        self.drop(key)
        while self._used + entry.n_pages > self.capacity:
            old_key, old = self._entries.popitem(last=False)
            self._used -= old.n_pages
            self.evictions += 1
            log.debug("host tier: evicted %r (%d pages)", old_key,
                      old.n_pages)
        self._entries[key] = entry
        self._used += entry.n_pages
        self.spills += entry.n_pages
        _SPILLS.labels("spill").inc(entry.n_pages)
        if self._events is not None:
            self._publish("kv_spill", key, entry)
        self._set_gauges()
        return True

    def peek(self, key) -> Optional[SpilledPages]:
        """Entry lookup WITHOUT removal; refreshes LRU recency."""
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
        return e

    def pop(self, key, restored: bool = True) -> Optional[SpilledPages]:
        """Remove and return an entry (restored=True counts it as a
        restore; False is a plain discard)."""
        e = self._entries.pop(key, None)
        if e is None:
            return None
        self._used -= e.n_pages
        if restored:
            self.restores += e.n_pages
            _SPILLS.labels("restore").inc(e.n_pages)
            if self._events is not None:
                self._publish("kv_restore", key, e)
        self._set_gauges()
        return e

    def drop(self, key) -> None:
        self.pop(key, restored=False)

    def clear(self) -> None:
        self._entries.clear()
        self._used = 0
        self._set_gauges()

    def keys(self) -> List[object]:
        return list(self._entries.keys())

    # -- device <-> host movement -----------------------------------------

    @staticmethod
    def _stores(cache) -> Tuple[torch.Tensor, ...]:
        """The cache's storage tensors [L, N_pages + 1, ...] in the JAX
        array order, fp8 ones as their bytes."""
        k, v = cache.k_store, cache.v_store
        leaves = (k.q, k.scale, v.q, v.scale) if _quantized(cache) else (k, v)
        return tuple(t.view(torch.uint8) if t.element_size() == 1 else t
                     for t in leaves)

    @staticmethod
    def _index(cache, pages) -> torch.Tensor:
        pages = [int(p) for p in pages]
        n = cache.n_pages
        if any(not 0 <= p < n for p in pages):
            # the sink page (n) and foreign ids are never moved
            raise ValueError(f"pages {pages} outside the pool's real "
                             f"pages 0..{n - 1}")
        return to_device(torch.tensor(pages, dtype=torch.long),
                         cache.table.device)

    @staticmethod
    def _timed(device):
        """(finish(), ...) around a movement: CUDA events queued for
        observe_spill_times on the card, the wall clock on the CPU."""
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            a.record(torch.cuda.current_stream(device))

            def finish():
                b = torch.cuda.Event(enable_timing=True)
                b.record(torch.cuda.current_stream(device))
                with _PENDING_LOCK:
                    _PENDING.append((a, b))
                observe_spill_times()
            return finish
        t0 = time.perf_counter()
        return lambda: _SPILL_SECONDS.observe(time.perf_counter() - t0)

    @staticmethod
    def fetch_pages(cache, pages) -> Tuple[torch.Tensor, ...]:
        """The contents of `pages` of a paged cache (plain, fp8 or
        quantized pool) as host tensors, each keeping its [L, n, ...]
        pool slice shape, so restore is a verbatim scatter (a
        bit-identical round trip). Layout: quantized -> (k_q, k_scale,
        v_q, v_scale), else (k, v). On the card the copies go into
        pinned memory with non_blocking: nothing here waits for the
        stream, and the bytes are there once the stream has passed
        them."""
        dev = cache.table.device
        idx = HostTier._index(cache, pages)
        finish = HostTier._timed(dev)
        leaves = HostTier._stores(cache)
        dtypes = ((cache.k_store.q.dtype, torch.float32) * 2
                  if _quantized(cache)
                  else (cache.k_store.dtype, cache.v_store.dtype))
        out = []
        for leaf, dt in zip(leaves, dtypes):
            part = leaf.index_select(1, idx)
            if dev.type == "cuda":
                host = torch.empty(part.shape, dtype=part.dtype,
                                   pin_memory=True)
                host.copy_(part, non_blocking=True)
            else:
                host = part
            out.append(host.view(dt))
        finish()
        return tuple(out)

    @staticmethod
    def install_pages(cache, pages, arrays: Tuple[torch.Tensor, ...]):
        """Scatter spilled contents back into freshly-allocated pages of
        (a possibly different generation of) the pool, in place; returns
        the cache. Inverse of fetch_pages, the same array order. The
        uploads leave pinned memory with non_blocking, on the stream the
        steps run on."""
        dev = cache.table.device
        idx = HostTier._index(cache, pages)
        leaves = HostTier._stores(cache)
        if len(arrays) != len(leaves):
            raise ValueError(f"{len(arrays)} spilled arrays for a pool of "
                             f"{len(leaves)} leaves")
        finish = HostTier._timed(dev)
        for leaf, host in zip(leaves, arrays):
            if host.element_size() == 1:
                host = host.view(torch.uint8)
            if host.dtype != leaf.dtype or host.shape[1] != idx.numel():
                raise ValueError(
                    f"spilled {host.dtype} {tuple(host.shape)} does not "
                    f"fit {leaf.dtype} pages {idx.numel()}")
            leaf.index_copy_(1, idx, host.to(dev, non_blocking=True))
        finish()
        return cache
