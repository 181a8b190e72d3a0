"""Offline joint configuration search -> piecewise policy table.

Counterpart of `cake_tpu/autotune/search.py`, copied as it is
(host-only). The best serving configuration is a function of offered
load, so the server carries a small *policy table* — offered-load
regime -> best measured config — fitted OFFLINE from measurements and
consulted ONLINE by the controller (controller.py). This module owns the
table format and the fitter; ``python -m
cake_tpu_torch.tools.autotune_fit`` is the CLI front end.

Inputs the fitter understands:

  * **observation records** — dicts with a ``config`` (EngineConfig
    JSON) plus measured ``tok_s`` and the ``offered_rps`` the
    measurement was taken under. ``extract_observations`` walks any
    JSON document and collects every such record wherever it nests.
  * **step-log JSONL** (the ``--step-log`` flight recorder): has no
    config column — the whole log was captured under ONE config the
    caller names — so ``observations_from_step_log`` slices it into
    time windows and emits one observation per window (offered load =
    admissions/s from prefill-side records, achieved = generated
    tokens/s from decode-side records).

Policy file format (``--autotune-policy``)::

    {"version": 2,
     "regimes": [
       {"max_offered_rps": 2.0,  "config": {"slots": 8, ...},
        "max_ttft_p99_s": {"interactive": 0.2},
        "min_attainment": 0.95},
       {"max_offered_rps": null, "config": {"slots": 32, ...}}]}

Regimes are sorted by ascending boundary; ``lookup(offered_rps)``
returns the first regime whose boundary covers the load (``null`` =
catch-all). The fitter guarantees a catch-all regime so lookup is
total. Version 2 adds optional per-regime **quality guards**
(``max_ttft_p99_s`` and ``min_attainment``, a bare number or a
``{class: bound}`` mapping): a covering regime whose guards FAIL is
skipped, so lookup escalates toward the catch-all. Version-1 files
load unchanged.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from cake_tpu_torch.autotune.space import (
    EngineConfig, config_key, validate_config,
)

log = logging.getLogger(__name__)

POLICY_VERSION = 2
# version-1 files (no quality guards) read identically; writes are
# always the current version
READABLE_VERSIONS = (1, 2)

# the per-regime quality-guard keys and their comparison direction
# (True = the live value must stay BELOW the bound)
_GUARD_KEYS = (("max_ttft_p99_s", True), ("min_attainment", False))

# step-record kinds that generate tokens / admit prompts — mirrors the
# obs/steps.py flight-recorder vocabulary
_DECODE_KINDS = ("decode", "decode_scan", "spec", "mixed")


@dataclass
class Observation:
    """One measured (config, load) -> throughput point."""

    config: EngineConfig
    offered_rps: float
    tok_s: float
    ttft_p99_s: Optional[float] = None
    # worst-class SLO attainment over the observation window (0..1],
    # from obs/slo.py — feeds the auto-fitted min_attainment guard
    attainment: Optional[float] = None

    def to_dict(self) -> dict:
        out = {"config": self.config.to_dict(),
               "offered_rps": round(self.offered_rps, 4),
               "tok_s": round(self.tok_s, 4)}
        if self.ttft_p99_s is not None:
            out["ttft_p99_s"] = round(self.ttft_p99_s, 6)
        if self.attainment is not None:
            out["attainment"] = round(self.attainment, 6)
        return out


@dataclass
class PolicyTable:
    """Piecewise offered-load -> EngineConfig policy."""

    regimes: List[dict] = field(default_factory=list)

    def __post_init__(self):
        # normalize: parse configs, sort ascending with the catch-all
        # (None boundary) last, so lookup() is a linear scan
        regs = []
        for r in self.regimes:
            cfg = r["config"]
            if not isinstance(cfg, EngineConfig):
                cfg = EngineConfig.from_dict(dict(cfg))
            regs.append({**r, "config": cfg})
        regs.sort(key=lambda r: (r.get("max_offered_rps") is None,
                                 r.get("max_offered_rps") or 0.0))
        self.regimes = regs

    def validate(self, max_seq_len: Optional[int] = None) -> "PolicyTable":
        if not self.regimes:
            raise ValueError("policy table has no regimes")
        if self.regimes[-1].get("max_offered_rps") is not None:
            raise ValueError(
                "policy table needs a catch-all regime "
                '("max_offered_rps": null) so every load maps somewhere')
        for r in self.regimes:
            validate_config(r["config"], max_seq_len=max_seq_len)
            for key, _below in _GUARD_KEYS:
                g = r.get(key)
                if g is None:
                    continue
                vals = (g.values() if isinstance(g, dict) else (g,))
                if not all(isinstance(v, (int, float))
                           and not isinstance(v, bool) and v > 0
                           for v in vals):
                    raise ValueError(
                        f"policy regime {key} must be a positive "
                        "number or a {class: number} mapping, got "
                        f"{g!r}")
        return self

    @staticmethod
    def _guards_ok(regime: dict,
                   ttft_p99_by_class: Optional[Dict[str, float]],
                   attainment: Optional[Dict[str, float]]) -> bool:
        """Whether the live quality signals let this regime hold. A
        guard with no corresponding live signal passes — quality can
        only ESCALATE a lookup, never block it on missing data."""
        for key, below, live in (
                ("max_ttft_p99_s", True, ttft_p99_by_class),
                ("min_attainment", False, attainment)):
            g = regime.get(key)
            if g is None or not live:
                continue
            bounds = g if isinstance(g, dict) else {c: g for c in live}
            for cls, bound in bounds.items():
                v = live.get(cls)
                if v is None:
                    continue
                if (v > bound) if below else (v < bound):
                    return False
        return True

    def lookup(self, offered_rps: float,
               ttft_p99_by_class: Optional[Dict[str, float]] = None,
               attainment: Optional[Dict[str, float]] = None
               ) -> EngineConfig:
        """First regime whose offered-load boundary covers the load AND
        whose quality guards pass against the live signals (obs/slo.py
        attainment + TTFT p99 by class, via AutotuneSignals). A
        covering regime failing its guards is skipped — the lookup
        escalates toward the catch-all, which is returned
        unconditionally (lookup stays total even when every guard
        fails: there is no bigger config to escalate to)."""
        for r in self.regimes[:-1]:
            bound = r.get("max_offered_rps")
            if bound is not None and offered_rps > bound:
                continue
            if self._guards_ok(r, ttft_p99_by_class, attainment):
                return r["config"]
        return self.regimes[-1]["config"]

    def to_dict(self) -> dict:
        return {"version": POLICY_VERSION,
                "regimes": [{**r, "config": r["config"].to_dict()}
                            for r in self.regimes]}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyTable":
        if d.get("version") not in READABLE_VERSIONS:
            raise ValueError(
                f"unsupported policy version {d.get('version')!r} "
                f"(this build reads versions "
                f"{', '.join(map(str, READABLE_VERSIONS))})")
        return cls(regimes=list(d.get("regimes", ())))

    @classmethod
    def load(cls, path: str) -> "PolicyTable":
        with open(path) as f:
            return cls.from_dict(json.load(f)).validate()


# -- ingestion --------------------------------------------------------------


def extract_observations(obj) -> List[Observation]:
    """Walk any JSON structure and collect observation records: dicts
    carrying a ``config`` mapping plus ``tok_s`` (and optionally
    ``offered_rps``/``ttft_p99_s``/``attainment``). Records that fail
    config parsing are skipped with a warning — a BENCH file holds many
    shapes of line, and one malformed record must not abort a fit."""
    out: List[Observation] = []
    if isinstance(obj, dict):
        if isinstance(obj.get("config"), dict) and "tok_s" in obj:
            try:
                att = obj.get("attainment")
                if isinstance(att, dict):
                    # per-class mapping (obs/slo.py shape): the guard
                    # tracks the worst class
                    att = min(att.values()) if att else None
                out.append(Observation(
                    config=EngineConfig.from_dict(dict(obj["config"])),
                    offered_rps=float(obj.get("offered_rps", 0.0)),
                    tok_s=float(obj["tok_s"]),
                    ttft_p99_s=(float(obj["ttft_p99_s"])
                                if obj.get("ttft_p99_s") is not None
                                else None),
                    attainment=(float(att) if att is not None
                                else None)))
            except (ValueError, TypeError) as e:
                log.warning("skipping malformed observation: %s", e)
        for v in obj.values():
            out.extend(extract_observations(v))
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            out.extend(extract_observations(v))
    return out


def observations_from_step_log(path: str, config: EngineConfig,
                               window_s: float = 10.0
                               ) -> List[Observation]:
    """One observation per `window_s` slice of a --step-log JSONL
    capture, all under the caller-named `config` (the flight recorder
    has no config column — one log file is one config's flight)."""
    from cake_tpu_torch.obs.jsonl import read_jsonl

    recs = [r for r in read_jsonl(path)
            if isinstance(r.get("ts"), (int, float))]
    if not recs:
        return []
    t0 = min(r["ts"] for r in recs)
    w = max(1e-3, float(window_s))
    # one linear pass bucketing by floor((ts - t0) / w): an hour-long
    # capture at a 10s window is O(records), not O(windows x records)
    buckets: Dict[int, List[float]] = {}   # idx -> [tokens, admits]
    for r in recs:
        b = buckets.setdefault(int((r["ts"] - t0) // w), [0.0, 0.0])
        kind = r.get("kind")
        if kind in _DECODE_KINDS:
            b[0] += int(r.get("tokens", 0))
        if kind == "prefill":
            # one prefill record per admission group; rows carries the
            # group size on the batched path
            b[1] += max(1, int(r.get("rows", 1)))
        elif kind == "mixed":
            # mixed batching (the paged default) admits prompts as
            # chunk rows inside mixed steps — there are NO standalone
            # prefill records, so the admission proxy is the prefill-
            # side row activity (an upper proxy: a long prompt's
            # chunks count once per step, but the load axis only
            # needs a monotone proxy, and without this every
            # mixed-mode window would read offered_rps = 0)
            b[1] += int(r.get("rows_prefill") or 0)
    return [Observation(config=config, offered_rps=admits / w,
                        tok_s=toks / w)
            for _idx, (toks, admits) in sorted(buckets.items())]


# -- fitting ----------------------------------------------------------------


def fit(observations: Sequence[Observation],
        max_regimes: int = 4,
        emit_guards: bool = True,
        ttft_headroom: float = 1.5,
        attainment_margin: float = 0.9) -> PolicyTable:
    """Fit a piecewise policy: bucket the observed offered-load axis
    into up to `max_regimes` quantile bins, pick the config with the
    best mean tok/s inside each bin, and merge adjacent bins that chose
    the same config. The last regime is always the catch-all.

    When `emit_guards` is set (the default), each non-catch-all regime
    additionally carries auto-fitted quality guards derived from the
    winning config's own observation windows: `max_ttft_p99_s` is the
    worst observed TTFT p99 times `ttft_headroom` (live TTFT drifting
    past what the config ever delivered — plus headroom — escalates the
    lookup), and `min_attainment` is the worst observed SLO attainment
    times `attainment_margin`. Regimes whose observations carry no
    quality signal get no guard, and the catch-all never does (lookup
    returns it unconditionally — a guard there would be dead)."""
    obs = [o for o in observations if o.tok_s > 0]
    if not obs:
        raise ValueError("no usable observations (tok_s > 0) to fit")
    uniq = sorted({o.offered_rps for o in obs})
    n_bins = max(1, min(int(max_regimes), len(uniq)))
    # quantile edges over the DISTINCT observed loads: regimes cover
    # where data exists instead of slicing an empty axis evenly, and
    # every bin is guaranteed non-empty (edges are upper-inclusive)
    edges = [uniq[(i + 1) * len(uniq) // n_bins - 1]
             for i in range(n_bins - 1)]

    def bin_of(load: float) -> int:
        for i, e in enumerate(edges):
            if load <= e:
                return i
        return n_bins - 1

    regimes: List[dict] = []
    for b in range(n_bins):
        members = [o for o in obs if bin_of(o.offered_rps) == b]
        if not members:
            continue
        # mean tok/s per config key inside the bin; best config wins
        by_cfg: Dict[tuple, List[Observation]] = {}
        for o in members:
            by_cfg.setdefault(config_key(o.config), []).append(o)
        best = max(by_cfg.values(),
                   key=lambda os: sum(o.tok_s for o in os) / len(os))
        bound = edges[b] if b < n_bins - 1 else None
        regimes.append({
            "max_offered_rps": bound,
            "config": best[0].config,
            "expected_tok_s": round(
                sum(o.tok_s for o in best) / len(best), 2),
            "n_observations": len(members),
            "_winners": best,  # stripped before return
        })
    # merge adjacent regimes that picked the same config (the boundary
    # between them carries no information)
    merged: List[dict] = []
    for r in regimes:
        if merged and (config_key(merged[-1]["config"])
                       == config_key(r["config"])):
            merged[-1]["max_offered_rps"] = r["max_offered_rps"]
            merged[-1]["n_observations"] += r["n_observations"]
            merged[-1]["_winners"] = merged[-1]["_winners"] + r["_winners"]
        else:
            merged.append(r)
    if merged:
        merged[-1]["max_offered_rps"] = None  # guarantee a catch-all
    for r in merged:
        winners = r.pop("_winners")
        if not emit_guards or r["max_offered_rps"] is None:
            continue
        ttfts = [o.ttft_p99_s for o in winners
                 if o.ttft_p99_s is not None and o.ttft_p99_s > 0]
        g = round(float(ttft_headroom) * max(ttfts), 6) if ttfts else 0
        if g > 0:
            r["max_ttft_p99_s"] = g
        attains = [o.attainment for o in winners
                   if o.attainment is not None and o.attainment > 0]
        g = (round(min(1.0, float(attainment_margin) * min(attains)), 6)
             if attains else 0)
        if g > 0:
            r["min_attainment"] = g
    return PolicyTable(regimes=merged).validate()
