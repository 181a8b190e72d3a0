"""KV tiers: int8 and int4 page pools with per-page scales
(`quantized_pool.py`, counterpart of `cake_tpu/kv/quantized_pool.py`) and
the host-RAM spill tier (`host_tier.py`, counterpart of
`cake_tpu/kv/host_tier.py`)."""

from cake_tpu_torch.kv.host_tier import HostTier, SpilledPages  # noqa: F401

from cake_tpu_torch.kv.quantized_pool import (  # noqa: F401
    QUANTIZED_CACHES, Int4PagedKVCache, Int4Pool, QuantizedPagedKVCache,
    QuantPool, dequantize_pages, page_bytes, pack_page_nibbles,
    qupdate_pool_per_row, qwrite_prompt_pages, qwrite_window_pages,
    qwrite_windows_pages, reset_page_scales, unpack_page_nibbles,
)
