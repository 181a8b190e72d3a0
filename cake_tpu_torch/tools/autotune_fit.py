"""Fit an --autotune-policy table from measured serving data.

Counterpart of `tools/autotune_fit.py`, with its flags and exit codes,
over the port's autotune package (the card's machine has no JAX). The
offline half of the online autotuner (cake_tpu_torch/autotune): ingest
(config, offered load, throughput) observations from JSON files and/or
--step-log flight recorder captures, bucket the offered-load axis into
regimes, pick the best measured config per regime, and write the
piecewise policy file the live controller consults (--autotune auto
--autotune-policy PATH).

Each non-catch-all regime also gets auto-fitted quality guards
(``max_ttft_p99_s`` / ``min_attainment``) derived from the winning
config's own observation windows. Disable with ``--no-guards``; tune
with ``--ttft-headroom`` / ``--attainment-margin``.

Inputs:

  * ``--bench FILE [FILE ...]`` — JSON documents scanned recursively
    for observation records: any dict carrying ``config`` (EngineConfig
    JSON) plus ``tok_s`` (and optionally ``offered_rps``).
  * ``--step-log PATH --step-config JSON`` — one flight-recorder JSONL
    per engine config (the recorder has no config column): the log is
    sliced into ``--window`` second windows, each contributing one
    observation under the named config. Repeat the pair per config.

Usage:
    python -m cake_tpu_torch.tools.autotune_fit \
        --step-log s8.jsonl --step-config '{"slots": 8, "kv_pages": 128}' \
        --step-log s16.jsonl --step-config '{"slots": 16, "kv_pages": 256}' \
        --out policy.json --regimes 3

Exit status: 0 = policy written, 1 = fit failed (no usable
observations), 2 = bad arguments / unreadable input.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", nargs="*", default=[],
                    help="BENCH-style JSON files to scan for "
                         "observation records")
    ap.add_argument("--step-log", action="append", default=[],
                    help="--step-log JSONL capture (pair each with a "
                         "--step-config)")
    ap.add_argument("--step-config", action="append", default=[],
                    help="EngineConfig JSON the paired --step-log was "
                         "captured under")
    ap.add_argument("--window", type=float, default=10.0,
                    help="step-log slice width, seconds (default 10)")
    ap.add_argument("--regimes", type=int, default=4,
                    help="max offered-load regimes (default 4)")
    ap.add_argument("--no-guards", action="store_true",
                    help="do not auto-fit per-regime quality guards "
                         "(max_ttft_p99_s / min_attainment) from the "
                         "observation windows")
    ap.add_argument("--ttft-headroom", type=float, default=1.5,
                    help="max_ttft_p99_s guard = headroom x worst "
                         "observed TTFT p99 of the winning config "
                         "(default 1.5)")
    ap.add_argument("--attainment-margin", type=float, default=0.9,
                    help="min_attainment guard = margin x worst "
                         "observed attainment of the winning config "
                         "(default 0.9)")
    ap.add_argument("--out", required=True,
                    help="policy file to write (--autotune-policy)")
    args = ap.parse_args(argv)

    from cake_tpu_torch.autotune import (
        EngineConfig, PolicyTable, extract_observations, fit,
        observations_from_step_log,
    )

    if len(args.step_log) != len(args.step_config):
        print("autotune_fit: each --step-log needs a matching "
              "--step-config (the recorder has no config column)",
              file=sys.stderr)
        return 2
    obs = []
    for path in args.bench:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"autotune_fit: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        found = extract_observations(doc)
        print(f"autotune_fit: {path}: {len(found)} observation(s)")
        obs.extend(found)
    for path, cfg_json in zip(args.step_log, args.step_config):
        try:
            cfg = EngineConfig.from_dict(json.loads(cfg_json))
        except (ValueError, TypeError) as e:
            print(f"autotune_fit: bad --step-config {cfg_json!r}: {e}",
                  file=sys.stderr)
            return 2
        try:
            found = observations_from_step_log(path, cfg,
                                               window_s=args.window)
        except OSError as e:
            print(f"autotune_fit: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        print(f"autotune_fit: {path}: {len(found)} window(s) under "
              f"{cfg.to_dict()}")
        obs.extend(found)

    try:
        policy: PolicyTable = fit(
            obs, max_regimes=args.regimes,
            emit_guards=not args.no_guards,
            ttft_headroom=args.ttft_headroom,
            attainment_margin=args.attainment_margin)
    except ValueError as e:
        print(f"autotune_fit: fit failed: {e}", file=sys.stderr)
        return 1
    policy.save(args.out)
    for r in policy.regimes:
        bound = r.get("max_offered_rps")
        guards = "".join(
            f" [{k} {r[k]}]" for k in ("max_ttft_p99_s",
                                       "min_attainment") if k in r)
        print(f"autotune_fit: regime <= "
              f"{'inf' if bound is None else bound} req/s -> "
              f"{r['config'].to_dict()} "
              f"(~{r.get('expected_tok_s', '?')} tok/s over "
              f"{r.get('n_observations', '?')} obs)" + guards)
    print(f"autotune_fit: wrote {len(policy.regimes)} regime(s) to "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
