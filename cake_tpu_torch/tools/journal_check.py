"""Offline verifier for the write-ahead request journal (--journal).

Counterpart of `tools/journal_check.py`, with its rc contract, text and
`--json` document, over the port's journal (cake_tpu_torch/serve/
journal.py; the card's machine has no JAX). It replays a journal file
through the SAME reconstruction the server uses at startup
(`replay_state`, so the checker can never drift from the recovery
semantics) and reports, per rid: admitted / emitted-token / retired
state, plus whatever the replay flags: orphaned emits, cumulative-count
gaps, duplicate admits, emits after retire, mid-file corruption.

A torn FINAL line is the expected signature of a killed writer
(tolerated, like obs/jsonl.read_jsonl, and like recovery itself);
mid-file corruption is a real finding.

Exit status:
    0  journal replays cleanly (a torn tail alone is still rc 0)
    1  findings: the journal replays, but something is inconsistent
    2  unusable input (missing/unreadable file, bad usage)

Usage:
    python -m cake_tpu_torch.tools.journal_check JOURNAL [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def check(path: str, as_json: bool = False, out=None) -> int:
    """The testable core: read + replay + report. Returns the rc."""
    from cake_tpu_torch.serve.journal import read_records, replay_state

    out = sys.stdout if out is None else out
    if not os.path.exists(path):
        print(f"journal_check: no such file: {path}", file=sys.stderr)
        return 2
    try:
        records, corrupt, torn = read_records(path)
    except OSError as e:
        print(f"journal_check: cannot read {path}: {e}",
              file=sys.stderr)
        return 2
    recs, findings, header = replay_state(records)
    if corrupt:
        findings = [f"{corrupt} corrupt mid-file line(s) skipped"] \
            + findings
    requests = []
    for r in recs:
        requests.append({
            "rid": r["rid"],
            "prompt_tokens": len(r.get("prompt_ids") or ()),
            "emitted_tokens": (len(r.get("replayed") or ())
                               + len(r.get("out_tokens") or ())),
            "emit_records": r.get("emits", 0),
            "remaining": r.get("remaining"),
            "retired": bool(r.get("finished")),
            "status": r.get("status",
                            "in_flight" if not r.get("finished")
                            else "retired"),
            "priority": r.get("priority"),
            "idempotency_key": r.get("idempotency_key"),
            "error": r.get("error"),
        })
    resumable = sum(1 for q in requests
                    if not q["retired"] and not q["error"]
                    and (q["remaining"] or 0) > 0)
    rc = 1 if findings else 0
    doc = {
        "path": path,
        "records": len(records),
        "corrupt_lines": corrupt,
        "torn_tail": torn,
        "version": (header or {}).get("v"),
        "requests": requests,
        "resumable": resumable,
        "findings": findings,
        "rc": rc,
    }
    if as_json:
        print(json.dumps(doc), file=out)
        return rc
    print(f"journal: {path}", file=out)
    print(f"  {len(records)} record(s), {corrupt} corrupt line(s), "
          f"torn tail: {torn}", file=out)
    for q in requests:
        print(f"  rid {q['rid']}: {q['prompt_tokens']} prompt + "
              f"{q['emitted_tokens']} emitted tokens in "
              f"{q['emit_records']} batch(es), "
              f"{q['status']}"
              + (f" [{q['error']}]" if q["error"] else "")
              + (f" key={q['idempotency_key']}"
                 if q["idempotency_key"] else ""),
              file=out)
    print(f"  {resumable} request(s) would resume", file=out)
    if findings:
        print("FINDINGS:", file=out)
        for f in findings:
            print(f"  - {f}", file=out)
        return rc
    print("JOURNAL OK" + (" (torn tail tolerated)" if torn else ""),
          file=out)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Replay a --journal file offline and report "
                    "per-request state + inconsistencies")
    p.add_argument("journal", help="journal file path")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON document")
    try:
        args = p.parse_args(argv)
    except SystemExit:
        return 2
    return check(args.journal, as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())
