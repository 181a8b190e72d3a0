"""The autotuner's configuration space.

Counterpart of `cake_tpu/autotune/space.py`. The best engine
configuration depends on the offered load, so the switchable knobs are a
declarative point in a config space:

  * ``EngineConfig`` — one point: the knobs the engine can switch LIVE
    (serve/engine.reconfigure) without reloading weights: decode slots,
    decode-scan burst length, page pool geometry, KV storage dtype, mixed
    batching, and the paged attention impl. Everything else (model,
    max_seq_len, sampling defaults, scheduling policy) is the engine's
    identity and never moves.
  * ``validate_config`` — validity rules that REUSE args.Args.validate
    (the CLI and the autotuner cannot drift on what a legal config is),
    plus the engine-level geometry rules.
  * ``switch_guard`` — the legality of a LIVE transition between two
    valid points. A quantized pool cannot hot-switch to a wider one: the
    emitted history was sampled under quantized KV numerics, and the
    fold-tokens-into-prompt resume would re-derive wider-KV logits that
    need not agree with the tokens already streamed.
  * ``config_key`` — the canonical comparison key: ``auto`` knobs
    resolve the way the engine resolves them and dtype spellings
    normalize, so "the same config spelled differently" never triggers a
    pointless switch.

One deliberate divergence from the JAX package: the attention impls
are the port's ``plain`` / ``kernel`` (JAX's ``fold`` / ``pallas`` are
refused with the port's names).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields
from typing import Optional, Tuple

# knob names, in the order operators read them (health/autotune JSON)
CONFIG_KEYS = ("slots", "decode_scan", "kv_pages", "kv_page_size",
               "kv_dtype", "mixed_batch", "paged_attn")

# the port's attention impls, and the JAX package's names for them
PAGED_ATTN_IMPLS = ("auto", "plain", "kernel")
JAX_ATTN_NAMES = {"fold": "plain", "pallas": "kernel"}


@dataclass(frozen=True)
class EngineConfig:
    """One switchable engine configuration point.

    ``kv_pages is None`` selects the dense engine (one [L, B, T] cache);
    a value selects the paged engine with that pool geometry. Field
    defaults mirror the JAX package's Args, so a config built from
    partial JSON means what it means there."""

    slots: int = 8
    decode_scan: int = 1
    kv_pages: Optional[int] = None
    kv_page_size: int = 128
    kv_dtype: Optional[str] = None
    mixed_batch: str = "auto"
    paged_attn: str = "auto"

    @property
    def paged(self) -> bool:
        return self.kv_pages is not None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown engine config keys {unknown}; the switchable "
                f"knobs are {list(CONFIG_KEYS)}")
        kw = {}
        for f in fields(cls):
            if f.name not in d or d[f.name] is None:
                continue
            v = d[f.name]
            if f.name in ("slots", "decode_scan", "kv_pages",
                          "kv_page_size"):
                v = int(v)
            kw[f.name] = v
        return cls(**kw)


def resolve_paged_attn(paged_attn: Optional[str], device=None) -> str:
    """THE paged_attn auto-resolution rule — the CUDA kernels on a card,
    their plain versions on the CPU — shared by the engine's setup and
    config_key, so the comparison key can never resolve "auto"
    differently from the engine. device: the engine's (None: the card
    when one is present). Other names pass through unvalidated (the
    engine and validate_config validate them)."""
    impl = paged_attn or "auto"
    if impl == "auto":
        if device is None:
            import torch
            cuda = torch.cuda.is_available()
        else:
            cuda = getattr(device, "type", str(device).split(":")[0]) \
                == "cuda"
        impl = "kernel" if cuda else "plain"
    return impl


def _canon_kv_dtype(name: Optional[str]) -> Optional[str]:
    """Spelling-normalized storage dtype: "f32"/"float32" and friends map
    to one canonical string (the dtype's name, as numpy names it in the
    JAX package: "float32", "bfloat16", "float8_e4m3fn"); the quantized
    pool names (int8/int4) and None (follow the engine's cache dtype)
    pass through."""
    if name is None or name in ("int8", "int4"):
        return name
    try:
        from cake_tpu_torch.utils.devices import resolve_kv_dtype
        return str(resolve_kv_dtype(name)).replace("torch.", "")
    except Exception:  # noqa: BLE001 — comparison key, not dispatch
        return name


def config_key(cfg: EngineConfig,
               default_kv_dtype: Optional[str] = None,
               device=None) -> Tuple:
    """Canonical comparison key: ``auto`` knobs resolved the way the
    engine resolves them (on `device`), dtype spellings normalized,
    paged-only knobs dropped for dense points.

    default_kv_dtype: what an UNSET kv_dtype resolves to (the engine's
    base cache dtype). The engine passes it so a policy spelling the
    default explicitly ("bf16" on a bf16-cache engine) compares equal to
    one omitting it; callers that cannot know the default (the
    controller) leave None distinct."""
    if not cfg.paged:
        return ("dense", cfg.slots, cfg.decode_scan)
    mixed = (cfg.mixed_batch or "auto") != "off"
    kd = _canon_kv_dtype(cfg.kv_dtype)
    if kd is None and default_kv_dtype is not None:
        kd = _canon_kv_dtype(default_kv_dtype)
    return ("paged", cfg.slots, cfg.decode_scan, cfg.kv_pages,
            cfg.kv_page_size, kd,
            resolve_paged_attn(cfg.paged_attn, device), mixed)


def validate_config(cfg: EngineConfig,
                    max_seq_len: Optional[int] = None) -> EngineConfig:
    """Validity rules. REUSES args.Args.validate (the single source of
    CLI-level config legality) by projecting the point onto the matching
    flags, then adds the engine rules args.py leaves to the engine."""
    from cake_tpu_torch.args import Args

    impl = cfg.paged_attn or "auto"
    if impl in JAX_ATTN_NAMES:
        raise ValueError(
            f"paged_attn {impl!r} is the JAX package's name: the port's "
            f"impls are {list(PAGED_ATTN_IMPLS)} (use "
            f"{JAX_ATTN_NAMES[impl]!r})")
    if impl not in PAGED_ATTN_IMPLS:
        raise ValueError(
            f"unsupported paged_attn '{impl}' (choose auto, plain or "
            "kernel)")
    # Args.validate covers: the mixed_batch enum, kv_dtype name
    # resolution, int8/int4-requires-pages, int4's even page size,
    # decode_scan >= 1
    Args(model="", max_slots=cfg.slots, decode_scan=cfg.decode_scan,
         kv_pages=cfg.kv_pages, kv_page_size=cfg.kv_page_size,
         kv_dtype=cfg.kv_dtype, mixed_batch=cfg.mixed_batch,
         paged_attn=impl).validate()
    if cfg.mixed_batch == "on" and not cfg.paged:
        raise ValueError(
            "mixed_batch=on requires kv_pages: the mixed ragged step "
            "dispatches over the paged pool")
    if cfg.paged and (cfg.kv_pages < 1 or cfg.kv_page_size < 1):
        raise ValueError(
            f"kv_pages {cfg.kv_pages} / kv_page_size "
            f"{cfg.kv_page_size} must be >= 1")
    # deliberately NO pool-vs-max_seq_len floor: the engine accepts pools
    # smaller than one max-length stream (submit() fails fast on
    # requests that can never fit), so the autotuner is not stricter
    # than the CLI; a live switch instead refuses any pool an IN-FLIGHT
    # stream does not fit (engine._reconfigure_sync)
    del max_seq_len
    return cfg


def _dtype_rank(name: Optional[str]) -> int:
    """Precision rank of a KV storage dtype: int4 < int8 < float (fp8
    counts as float, as in the JAX package). A live switch may only hold
    precision or narrow it."""
    return {"int4": 0, "int8": 1}.get(_canon_kv_dtype(name), 2)


def switch_guard(old: EngineConfig, new: EngineConfig) -> Optional[str]:
    """Reason a LIVE old -> new switch is refused, or None when legal.

    Any precision-WIDENING direction (int8 -> float, int4 -> int8,
    int4 -> float) is gated off: streams served from the quantized pool
    emitted tokens sampled under QUANTIZED KV numerics, and the resume
    re-prefills their transcripts at the wider KV, so the continuation
    could disagree with the history the client already received.
    Quantizing forward (float -> int8 -> int4) stays allowed: no
    identity claim is made for a quantized target."""
    ro, rn = _dtype_rank(old.kv_dtype), _dtype_rank(new.kv_dtype)
    if ro < rn:
        names = {0: "int4-pool", 1: "int8-pool", 2: "float-pool"}
        return (
            f"refusing the {names[ro]} -> {names[rn]} hot switch: "
            "in-flight streams were decoded against quantized KV, and "
            "the fold-tokens-into-prompt resume would re-prefill their "
            "transcripts at wider KV — continuations could diverge "
            "from the already-streamed history, breaking the greedy "
            "token-identity contract. Drain the engine and restart "
            f"with the {names[rn]} instead.")
    return None
