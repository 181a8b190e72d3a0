"""cakelint over the port: static concurrency & capture-discipline gate.

Counterpart of `tools/cakelint.py`, with its flags, exit codes and JSON
report, over the port's analyzer (cake_tpu_torch/analysis; the card's
machine has no JAX).

Usage:
    python -m cake_tpu_torch.tools.cakelint cake_tpu_torch/ [--json]
        [--rules r1,r2] [--baseline FILE] [--write-baseline FILE]

Checks (declaration-driven; see cake_tpu_torch/analysis/core.py for the
vocabulary grammar):

    affinity        handler-thread entry points only reach declared
                    engine-thread state via _run_on_engine_thread or the
                    attr's declared lock; no direct calls to
                    @engine_thread_only methods
    guards          every optional-plane dereference (_faults, events,
                    _journal, _shed, _control, _host_tier, ...) is
                    `is not None`-guarded
    locks           declared lock order (_switch_lock -> _admit_lock ->
                    _rid_lock -> _ckpt_lock); no blocking calls under
                    _rid_lock
    capture-purity  the bodies a CUDA-graph capture runs once (every
                    serve/graphs._Graphs runner's step and _idle) fetch
                    nothing to the host, sync nothing and call no
                    time.*/random.*/print

Inline suppression (reason required):  # cakelint: skip[rule] reason

Exit codes: 0 clean, 1 findings, 2 usage/internal error. --json emits a
machine-readable report (version/counts/sites/findings).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

JSON_SCHEMA_VERSION = 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cakelint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="+", help="files or directories")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset (default: all)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppress findings whose fingerprints are "
                         "recorded in FILE")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="write current findings' fingerprints to FILE "
                         "and exit 0")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    from cake_tpu_torch.analysis import core

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    baseline = None
    if args.baseline:
        try:
            baseline = core.load_baseline(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"cakelint: cannot read baseline: {e}",
                  file=sys.stderr)
            return 2

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"cakelint: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2

    try:
        report = core.analyze(args.paths, rules=rules, baseline=baseline)
    except ValueError as e:
        print(f"cakelint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        core.write_baseline(args.write_baseline, report["fingerprints"])
        print(f"cakelint: wrote {len(report['fingerprints'])} "
              f"fingerprint(s) to {args.write_baseline}")
        return 0

    findings = report["findings"]
    if args.as_json:
        out = {
            "version": JSON_SCHEMA_VERSION,
            "rc": 1 if findings else 0,
            "files": report["files"],
            "counts": report["counts"],
            "sites": report["sites"],
            "suppressed": report["suppressed"],
            "baselined": report["baselined"],
            "findings": [dict(f.to_dict(), fingerprint=fp)
                         for f, fp in zip(findings,
                                          report["fingerprints"])],
        }
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        for f in findings:
            print(f"{f.path}:{f.line}:{f.col}: [{f.rule}] {f.message}")
        checked = ", ".join(f"{r}={n}" for r, n in
                            sorted(report["sites"].items()))
        print(f"cakelint: {len(findings)} finding(s) in "
              f"{report['files']} file(s) "
              f"({report['suppressed']} suppressed, "
              f"{report['baselined']} baselined; sites: {checked})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
