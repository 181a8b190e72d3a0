"""Shared append-only JSONL plumbing for the observability event logs.

Counterpart of `cake_tpu/obs/jsonl.py`, copied as it is.

One writer class serves both `--trace-events` (request-lifecycle spans,
obs/tracing.py) and `--step-log` (per-step flight records, obs/steps.py)
so the two logs cannot drift in durability semantics:

  * append-only, one `json.dumps` line per record, flushed per line (a
    crash loses at most the line being written);
  * fsync on close, so a clean shutdown's records are durable;
  * fail-open: the first OSError (full disk, revoked path) logs ONE
    warning and disables the writer — serving must never trade a token
    emit for a logging exception.

`read_jsonl` is the matching corrupt-tail-tolerant reader: a process
killed mid-write leaves a torn final line (or, after power loss, a
garbage tail), and resume-time parsing must shrug that off instead of
wedging on a JSONDecodeError. Undecodable lines are skipped, complete
records are returned.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


class JsonlAppender:
    """Thread-safe append-only JSONL writer (lazy open, fail-open).

    The file is opened on the first append, so a process that never
    writes (e.g. a multi-host follower) never touches the path.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._file = None
        self._failed = False
        self._warned_unserializable = False

    @property
    def failed(self) -> bool:
        return self._failed

    def append(self, obj: Dict) -> int:
        """Write one record as one line. Returns the bytes written
        (line + newline — callers accounting journal growth need it
        without re-serializing), or 0 when the writer is disabled (a
        previous failure) or this write failed — so boolean tests
        keep working."""
        if self._failed:
            return 0
        try:
            line = json.dumps(obj)
        except (TypeError, ValueError):
            # warn ONCE per appender, like the OSError path: a non-JSON
            # field leaking into every record must not turn each append
            # (the token-emit hot path) into a logged warning
            if not self._warned_unserializable:
                self._warned_unserializable = True
                log.warning("jsonl: unserializable record(s) dropped "
                            "(%s); further drops are silent", self.path)
            return 0
        try:
            with self._lock:
                if self._file is None:
                    self._file = open(self.path, "a")
                self._file.write(line + "\n")
                self._file.flush()
            return len(line) + 1
        except OSError:
            # one warning, then disable: a full disk must not turn every
            # record into a logged exception
            self._failed = True
            log.warning("jsonl log disabled: cannot write %s", self.path,
                        exc_info=True)
            return 0

    def close(self) -> None:
        """Flush + fsync + close: records written before a clean
        shutdown survive a power loss right after it."""
        with self._lock:
            f, self._file = self._file, None
        if f is None:
            return
        try:
            f.flush()
            os.fsync(f.fileno())
        except OSError:
            pass
        try:
            f.close()
        except OSError:
            pass


def read_jsonl(path: str, limit: Optional[int] = None) -> List[Dict]:
    """Read a JSONL log tolerantly: a torn tail (killed writer) or any
    other undecodable line is skipped, never raised — so log parsing at
    resume time cannot be wedged by the crash that made resume
    necessary. Returns complete records in file order (the last `limit`
    when set); a missing file reads as empty."""
    out: List[Dict] = []
    try:
        fh = open(path, "r", errors="replace")
    except OSError:
        return out
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue   # torn/corrupt line: skip, keep reading
            if isinstance(rec, dict):
                out.append(rec)
    if limit is not None:
        limit = int(limit)
        out = out[-limit:] if limit > 0 else []
    return out
