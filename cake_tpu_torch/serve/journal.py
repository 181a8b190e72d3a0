"""Write-ahead request journal: durable serving across hard process death.

Counterpart of `cake_tpu/serve/journal.py`, copied with its record
format, so each package replays the other's journal to the same state
(`replay_state`); the header's fingerprint is the writer's own
(serve/checkpoint.py), so `recover` resumes only its own package's
journal. The engine survives step failures and clean stops snapshot
in-flight work (serve/checkpoint.py), but a SIGKILL, an OOM kill or a
power loss between snapshots would lose every in-flight stream. This
module closes that gap with a WAL (``--journal PATH``) on the shared
obs/jsonl.py appender:

  * one ``admit`` record per admission (rid, prompt ids, sampling
    params, priority class, idempotency key, config epoch);
  * one ``emit`` record per emitted-token batch (rid, token ids,
    cumulative count) — batched per engine iteration, so the journal
    costs one line per (request, iteration), not per token;
  * ``retire`` tombstones (retired / error / cancelled);
  * periodic in-place compaction (admit+emit consolidated per live
    request, tombstoned requests dropped) once the file exceeds
    ``compact_bytes``, plus the checkpoint handshake: every
    ``checkpoint.write`` of this engine's state truncates the journal
    (the snapshot now owns everything pre-write), so journal records
    are always strictly post-snapshot and the two sources never
    double-count a request.

On startup, ``recover(engine, ...)`` = ``checkpoint.restore`` + journal
replay: the merged state resubmits every non-retired request through
the existing fold-tokens-into-prompt path (checkpoint.resume), with
seniority class, preempt budget, penalty ring and idempotency key
preserved — greedy streams complete token-identical at f32 KV across a
``kill -9`` (the ``--fault-plan`` ``abort`` error kind stages one
deterministically).

Durability modes (``--journal-fsync``):

  * ``never``  — flush per line (OS buffer); a machine death can lose
    recent records, a process death cannot.
  * ``batch``  — fsync once per engine-iteration flush (default): at
    most one iteration's tokens are lost to power loss.
  * ``always`` — fsync after every append: admissions and token
    batches are durable before the engine proceeds. Slowest; for
    when a lost admission is unacceptable.

Replay is crash-safe itself: the journal is renamed to
``<path>.replaying`` before resubmission (each resubmitted request is
re-journaled into a fresh file as it lands), and a startup that finds a
leftover ``.replaying`` file replays from IT, discarding the partial
re-seed — a crash mid-recovery never loses a request.

Chaos: the ``journal.append`` / ``journal.fsync`` / ``journal.replay``
fault sites thread through here with the ``is not None``
discipline, and the ``abort`` error kind (``os._exit``) is the in-tree
way to stage the crash drills this module exists to survive.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.obs.jsonl import JsonlAppender

log = logging.getLogger(__name__)

FSYNC_MODES = ("never", "batch", "always")

# journal format version (the "start" header record carries it); bump
# on any record-grammar change so an old journal fails loudly instead
# of replaying misparsed state
JOURNAL_VERSION = 1

# default compaction threshold: once this many bytes have been
# appended since the last compaction/truncation, the engine-thread
# maybe_compact() rewrites the file in place (live requests only)
DEFAULT_COMPACT_BYTES = 16 * 1024 * 1024

_APPENDS = _m.counter(
    "cake_journal_appends_total",
    "Write-ahead request-journal records appended, by record type "
    "(serve/journal.py; admit / emit / retire / start)",
    labelnames=("rec",))
_BYTES = _m.counter(
    "cake_journal_bytes_total",
    "Bytes appended to the write-ahead request journal (--journal; "
    "resets never — compaction rewrites the file but the counter "
    "keeps accumulating)")
_FSYNC_SECONDS = _m.histogram(
    "cake_journal_fsync_seconds",
    "Latency of journal fsync barriers (--journal-fsync batch/always)",
    buckets=(.0001, .0005, .001, .005, .01, .05, .1, .5, 1.0))
_REPLAYED = _m.counter(
    "cake_journal_replayed_requests_total",
    "Requests reconstructed from the journal (+ checkpoint base) and "
    "resubmitted into a restarted engine (serve/journal.recover)")
_DROPPED = _m.counter(
    "cake_journal_dropped_requests_total",
    "Journal-reconstructed requests that could not be resubmitted at "
    "replay (queue full, shrunk limits, malformed record)")
_REPLAY_SECONDS = _m.histogram(
    "cake_journal_replay_seconds",
    "Wall seconds for a startup journal replay (read + reconstruct + "
    "resubmit)",
    buckets=(.01, .05, .1, .5, 1.0, 5.0, 15.0, 60.0))
_COMPACTIONS = _m.counter(
    "cake_journal_compactions_total",
    "In-place journal compactions (size-triggered rewrite) plus "
    "checkpoint-handshake truncations",
    labelnames=("reason",))


class RequestJournal:
    """The engine-side WAL. Thread-safe: admissions journal from HTTP
    handler threads (under the engine's admission lock), emits/retires
    from the engine thread; one internal lock serializes the file.

    Fail-open like every obs sink: a real OSError (full disk, revoked
    path) disables the underlying appender with ONE warning — serving
    never trades a token emit for a journaling exception — and
    ``state()`` reports ``failed`` so /api/v1/health shows the journal
    went dark. Injected faults (--fault-plan journal.* sites) raise
    through instead: chaos exercises the failure path deliberately.
    """

    # cakelint guards discipline: the chaos plane is optional
    # (attached by the engine after construction; None without a
    # --fault-plan) — every dotted use needs `is not None`
    OPTIONAL_PLANES = ("faults",)

    def __init__(self, path: str, fsync: str = "batch",
                 compact_bytes: int = DEFAULT_COMPACT_BYTES):
        if fsync not in FSYNC_MODES:
            raise ValueError(
                f"--journal-fsync must be one of {', '.join(FSYNC_MODES)},"
                f" got {fsync!r}")
        self.path = path
        self.fsync = fsync
        self.compact_bytes = compact_bytes
        self._lock = threading.RLock()
        self._appender = JsonlAppender(path)
        self._header_written = False
        # engine attaches these after construction: the chaos plane
        # (faults) and the fingerprint source (owner — used for the
        # header so replay can refuse a different model's weights)
        self.faults = None
        self.owner = None
        # rid -> (token ids since last flush, absolute cumulative count)
        self._pending: Dict[int, Tuple[List[int], int]] = {}
        self._dirty = False           # appended since last fsync
        self._bytes_since_compact = 0
        # a replay_done marker is live in the current file (recover
        # consumed a sideline): compaction must preserve it, or a
        # failed sideline removal could mis-truncate the next startup
        self._replay_done = False
        self.appends = 0
        self.bytes_written = 0
        self.compactions = 0
        self.last_replay: Optional[Dict] = None

    # -- record writers ---------------------------------------------------

    def _fingerprint(self) -> Optional[Dict]:
        if self.owner is None:
            return None
        try:
            from cake_tpu_torch.serve.checkpoint import _fingerprint
            return _fingerprint(self.owner)
        except Exception:  # noqa: BLE001 — header metadata must never
            # fail an append (e.g. a wedged device before warm)
            log.debug("journal: fingerprint unavailable", exc_info=True)
            return None

    def _append(self, obj: Dict) -> None:
        """One physical record append (caller holds the lock). Writes
        the generation header first on a fresh/truncated file."""
        if self.faults is not None:
            self.faults.check("journal.append")
        if not self._header_written:
            # set before the recursive call (it re-checks the flag),
            # but roll back if the header append itself fails — a
            # later append must retry the header, or the journal would
            # be permanently headerless (no version/fingerprint guard)
            self._header_written = True
            try:
                self._append({"rec": "start", "v": JOURNAL_VERSION,
                              "t": time.time(),
                              "fp": self._fingerprint()})
            except Exception:
                self._header_written = False
                raise
        line_len = self._appender.append(obj)
        if line_len:
            self.appends += 1
            self.bytes_written += line_len
            self._bytes_since_compact += line_len
            self._dirty = True
            _APPENDS.labels(rec=obj.get("rec", "?")).inc()
            _BYTES.inc(line_len)
            if self.fsync == "always":
                self._sync()

    def _sync(self) -> None:
        if not self._dirty:
            return
        if self.faults is not None:
            self.faults.check("journal.fsync")
        t0 = time.perf_counter()
        self._appender.sync()
        _FSYNC_SECONDS.observe(time.perf_counter() - t0)
        self._dirty = False

    @staticmethod
    def _request_records(req, epoch: int,
                         include_out: bool = False) -> tuple:
        """THE (admit, emit) record pair for one request, in ORIGINAL
        stream coordinates — shared by note_admit and the compactor so
        the two producers cannot drift. A replay-resubmitted request
        (req.replayed_tokens set) gets its fold suffix stripped back
        out of the prompt/prime and re-recorded as an emit, so a
        second crash replays the same stream and SSE event ids stay
        monotonic across any number of restarts. include_out
        additionally folds the current generation into the emit (the
        compactor's whole-state form). emit is None when there is
        nothing generated."""
        replayed = list(getattr(req, "replayed_tokens", ()) or ())
        ids = list(req.prompt_ids)
        if replayed:
            if ids[-len(replayed):] == replayed:
                ids = ids[:-len(replayed)]
            else:  # fold drifted (should not happen) — keep the fold
                replayed = []
        prime = list(req.prime_tokens or ())
        if replayed and prime[-len(replayed):] == replayed:
            # the resume fold primes the penalty ring with the
            # generated history; the emit record re-carries it, so
            # strip the overlap from the stored prime
            prime = prime[:-len(replayed)]
        admit = {"rec": "admit", "rid": req.rid, "t": time.time(),
                 "ids": ids,
                 "max_new": int(req.max_new_tokens) + len(replayed),
                 "temp": req.temperature, "top_p": req.top_p,
                 "pen": req.repeat_penalty, "prime": prime,
                 "prio": req.priority,
                 "key": getattr(req, "idempotency_key", None),
                 "epoch": epoch}
        out = replayed + (list(req.out_tokens) if include_out else [])
        emit = ({"rec": "emit", "rid": req.rid, "toks": out,
                 "n": len(out)} if out else None)
        return admit, emit

    def note_admit(self, req, config_epoch: int = 0) -> None:
        """Journal one admission (engine.submit, inside the admission
        lock, BEFORE the request is registered — the write-ahead
        invariant)."""
        with self._lock:
            admit, emit = self._request_records(req, config_epoch)
            self._append(admit)
            if emit is not None:
                self._append(emit)

    def note_emit(self, rid: int, token_id: int, n_abs: int) -> None:
        """Buffer one emitted token (engine thread). n_abs: the
        request's absolute generated count INCLUDING replayed tokens
        from previous process generations — the same coordinate SSE
        ``id:`` fields use."""
        with self._lock:
            toks, _ = self._pending.get(rid, ([], 0))
            toks.append(int(token_id))
            self._pending[rid] = (toks, int(n_abs))

    def _flush_rid(self, rid: int) -> None:
        ent = self._pending.pop(rid, None)
        if ent is not None and ent[0]:
            self._append({"rec": "emit", "rid": rid, "toks": ent[0],
                          "n": ent[1]})

    def flush(self) -> None:
        """Write one emit record per request touched since the last
        flush (end of each engine iteration), then the batch-mode
        fsync barrier."""
        with self._lock:
            rids = list(self._pending)
            for rid in rids:
                self._flush_rid(rid)
            if self.fsync == "batch":
                self._sync()

    def note_retire(self, rid: int, status: str,
                    error: Optional[str] = None) -> None:
        """Tombstone one request (retired / error / cancelled). Flushes
        the rid's buffered emits first so the tombstone is last."""
        with self._lock:
            self._flush_rid(rid)
            rec: Dict = {"rec": "retire", "rid": rid, "status": status}
            if error:
                rec["error"] = error
            self._append(rec)
            if self.fsync == "batch":
                self._sync()

    # -- compaction -------------------------------------------------------

    def truncate(self, reason: str = "checkpoint") -> None:
        """The checkpoint handshake: a just-written snapshot owns every
        record up to now, so the journal restarts empty — keeping the
        two sources disjoint by construction."""
        with self._lock:
            self._pending.clear()
            self._appender.close()
            try:
                open(self.path, "w").close()
            except OSError:
                log.warning("journal: truncate failed for %s", self.path,
                            exc_info=True)
            if reason == "checkpoint":
                # the snapshot supersedes ANY leftover replay sideline
                # too (one whose removal failed at recover time): drop
                # it so the next startup cannot merge stale state
                try:
                    os.remove(self.path + ".replaying")
                except OSError:
                    pass
            self._appender = JsonlAppender(self.path)
            self._header_written = False
            self._dirty = False
            self._bytes_since_compact = 0
            self._replay_done = False
            self.compactions += 1
            _COMPACTIONS.labels(reason=reason).inc()

    def maybe_compact(self, engine) -> None:
        """Size-triggered in-place compaction (engine thread, between
        iterations — the request registry is stable there): rewrite
        the journal as one admit+emit pair per LIVE request, dropping
        tombstoned history. Atomic (tmp + rename); on any failure the
        original file stays authoritative."""
        with self._lock:
            if self._bytes_since_compact < self.compact_bytes:
                return
            tmp = f"{self.path}.{os.getpid()}.compact.tmp"
            try:
                with open(tmp, "w") as f:
                    f.write(json.dumps(
                        {"rec": "start", "v": JOURNAL_VERSION,
                         "t": time.time(),
                         "fp": self._fingerprint()}) + "\n")
                    if self._replay_done:
                        f.write(json.dumps({"rec": "replay_done",
                                            "t": time.time()}) + "\n")
                    for _rid, req in sorted(dict(engine._requests).items()):
                        if req.done.is_set():
                            continue
                        admit, emit = self._request_records(
                            req, getattr(engine, "config_epoch", 0),
                            include_out=True)
                        f.write(json.dumps(admit) + "\n")
                        if emit is not None:
                            f.write(json.dumps(emit) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                log.warning("journal: compaction write failed; keeping "
                            "the uncompacted journal", exc_info=True)
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                # back off: do not retry every iteration on a full disk
                self._bytes_since_compact = 0
                return
            self._appender.close()
            os.replace(tmp, self.path)
            self._appender = JsonlAppender(self.path)
            self._header_written = True   # the tmp wrote the header
            self._dirty = False
            self._bytes_since_compact = 0
            self.compactions += 1
            _COMPACTIONS.labels(reason="size").inc()
            log.info("journal: compacted %s (%d live request(s))",
                     self.path, len(engine._requests))

    # -- lifecycle / introspection ---------------------------------------

    def state(self) -> Dict:
        """Health-endpoint view (/api/v1/health "journal" block)."""
        with self._lock:
            out = {
                "path": self.path,
                "fsync": self.fsync,
                "appends": self.appends,
                "bytes_written": self.bytes_written,
                "buffered_rids": len(self._pending),
                "compactions": self.compactions,
                "failed": self._appender.failed,
            }
            if self.last_replay is not None:
                out["last_replay"] = dict(self.last_replay)
            return out

    def close(self) -> None:
        with self._lock:
            for rid in list(self._pending):
                self._flush_rid(rid)
            self._appender.close()


# -- reading / replay ------------------------------------------------------


def read_records(path: str) -> Tuple[List[Dict], int, bool]:
    """Tolerant journal read: returns (records, bad_lines, torn_tail).
    A torn FINAL line is the expected signature of a killed writer
    (tolerated, like obs/jsonl.read_jsonl); bad lines elsewhere are
    mid-file corruption the caller may want to report. A missing file
    reads as empty."""
    records: List[Dict] = []
    bad = 0
    last_bad = False
    try:
        fh = open(path, "r", errors="replace")
    except OSError:
        return records, 0, False
    with fh:
        for line in fh:
            stripped = line.strip()
            if not stripped:
                # any following line — even a blank — proves the bad
                # line was newline-terminated: complete-but-corrupt,
                # not a torn tail
                last_bad = False
                continue
            try:
                rec = json.loads(stripped)
                if not isinstance(rec, dict):
                    raise ValueError("not an object")
                records.append(rec)
                last_bad = False
            except (json.JSONDecodeError, ValueError):
                bad += 1
                last_bad = True
    torn_tail = last_bad
    if torn_tail:
        bad -= 1   # the torn tail is reported separately, not as corruption
    return records, bad, torn_tail


def replay_state(records: List[Dict],
                 base: Optional[List[Dict]] = None
                 ) -> Tuple[List[Dict], List[str], Optional[Dict]]:
    """Pure reconstruction: fold journal `records` over an optional
    checkpoint `base` (snapshot request records) into checkpoint-style
    request records, newest state last. Returns (records, findings,
    header) — findings are human-readable inconsistencies (orphaned
    emits, cumulative-count gaps, duplicate admits, emits after
    retire); replay proceeds best-effort past them, journal_check
    turns them into its rc=1 contract."""
    state: Dict[int, Dict] = {}
    findings: List[str] = []
    header: Optional[Dict] = None
    for rec in base or ():
        s = dict(rec)
        s.setdefault("replayed", [])
        s.setdefault("out_tokens", [])
        s["_base_out"] = len(s["out_tokens"])
        s["_base_remaining"] = s.get("remaining", 0)
        state[s["rid"]] = s
    for r in records:
        kind = r.get("rec")
        if kind == "start":
            if header is None:
                header = r
            continue
        if kind == "replay_done":
            # the consumed-sideline marker (recover): carries no
            # request state
            continue
        rid = r.get("rid")
        if not isinstance(rid, int):
            findings.append(f"{kind or '?'} record without a rid")
            continue
        if kind == "admit":
            if rid in state:
                findings.append(f"rid {rid}: duplicate admit")
            state[rid] = {
                "rid": rid,
                "prompt_ids": list(r.get("ids") or ()),
                "out_tokens": [],
                "replayed": [],
                "max_new": int(r.get("max_new") or 0),
                "temperature": r.get("temp", 0.0),
                "top_p": r.get("top_p", 1.0),
                "repeat_penalty": r.get("pen", 1.0),
                "prime": list(r.get("prime") or ()),
                "priority": r.get("prio", "standard"),
                "idempotency_key": r.get("key"),
                "finished": False,
                "error": None,
                "emits": 0,
            }
        elif kind == "emit":
            s = state.get(rid)
            if s is None:
                findings.append(f"rid {rid}: orphaned emit (no admit, "
                                "no checkpoint record)")
                continue
            if s.get("finished"):
                findings.append(f"rid {rid}: emit after retire")
            toks = list(r.get("toks") or ())
            out = s["out_tokens"]
            offset = len(s.get("replayed") or ())
            n = r.get("n")
            s["emits"] = s.get("emits", 0) + 1
            if isinstance(n, int):
                rel = n - len(toks) - offset
                if rel < 0 or rel > len(out):
                    findings.append(
                        f"rid {rid}: emit cumulative count {n} does not "
                        f"extend the {offset + len(out)} tokens on "
                        "record (gap or overlap)")
                    out.extend(toks)
                else:
                    del out[rel:]
                    out.extend(toks)
            else:
                out.extend(toks)
        elif kind == "retire":
            s = state.get(rid)
            if s is None:
                findings.append(f"rid {rid}: retire without admit")
                continue
            s["finished"] = True
            s["status"] = r.get("status", "retired")
            if r.get("status") == "error":
                s["error"] = r.get("error") or "error"
        else:
            findings.append(f"unknown record type {kind!r}")
    out_recs: List[Dict] = []
    for rid in sorted(state):
        s = state[rid]
        new_out = len(s["out_tokens"]) - s.pop("_base_out", 0)
        if "_base_remaining" in s:
            s["remaining"] = max(0, s.pop("_base_remaining") - new_out)
        else:
            s["remaining"] = max(0, s.get("max_new", 0)
                                 - len(s["out_tokens"]))
        # penalty ring history: prime + every generated token (base
        # records already fold their pre-snapshot history into
        # penalty_context; journal admits carry prime explicitly)
        if s.get("penalty_context") is not None:
            pc = list(s["penalty_context"]) + s["out_tokens"][
                len(s["out_tokens"]) - new_out:]
        else:
            pc = list(s.get("prime", ())) + list(s.get("replayed", ())) \
                + list(s["out_tokens"])
        s["penalty_context"] = pc
        out_recs.append(s)
    return out_recs, findings, header


def recover(engine, checkpoint_path: Optional[str] = None,
            strict: bool = True) -> Tuple[List, List[Dict]]:
    """Cold-restart recovery: checkpoint.restore + journal replay.

    Reads the engine's armed journal (plus the checkpoint base when
    `checkpoint_path` names one), reconstructs every non-retired
    request, sidelines the journal to ``<path>.replaying``, resubmits
    the survivors through checkpoint.resume (fold-tokens-into-prompt;
    seniority class / preempt budget / penalty ring / idempotency key
    preserved; each resubmission re-journals itself into the fresh
    file), seeds retired-but-keyed records into the engine's
    idempotency registry, then removes the sideline. Crash-safe: a
    death mid-recovery leaves ``.replaying`` behind, and the next
    startup replays from it, discarding the partial re-seed.

    Returns (handles, finished_records) like checkpoint.restore.
    """
    from cake_tpu_torch.serve import checkpoint

    j = getattr(engine, "_journal", None)
    if j is None:
        if checkpoint_path and os.path.exists(checkpoint_path):
            return checkpoint.restore(engine, checkpoint_path,
                                      strict=strict)
        return [], []
    if j.faults is not None:
        j.faults.check("journal.replay")
    t0 = time.perf_counter()
    replay_path = j.path + ".replaying"
    if os.path.exists(replay_path):
        # a leftover sideline is EITHER a recovery that died
        # mid-resubmit (the sideline is the authority; the journal
        # holds only its partial re-seed) OR a consumed one whose
        # removal failed (the journal — which then carries the
        # replay_done marker — is the authority, and truncating it
        # would destroy every post-recovery record)
        consumed = any(r.get("rec") == "replay_done"
                       for r in read_records(j.path)[0])
        if consumed:
            log.warning("journal: stale consumed sideline %s (its "
                        "removal failed last time); discarding it",
                        replay_path)
            try:
                os.remove(replay_path)
            except OSError:
                pass   # os.replace below overwrites it anyway
            if os.path.exists(j.path) and os.path.getsize(j.path) > 0:
                os.replace(j.path, replay_path)
        else:
            log.warning("journal: found %s — a previous replay was "
                        "interrupted; replaying from it", replay_path)
            j.truncate(reason="interrupted_replay")
    elif os.path.exists(j.path) and os.path.getsize(j.path) > 0:
        os.replace(j.path, replay_path)
    records, bad, torn = read_records(replay_path)
    if torn:
        log.warning("journal: torn final record in %s (killed "
                    "mid-write) — tolerated", replay_path)
    if bad:
        log.warning("journal: %d corrupt mid-file record(s) in %s "
                    "skipped", bad, replay_path)

    base: Optional[List[Dict]] = None
    base_fp: Optional[Dict] = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        snap = checkpoint.load(checkpoint_path)
        if snap is not None:
            base = snap.get("requests", [])
            base_fp = snap.get("engine")

    recs, findings, header = replay_state(records, base=base)
    for f in findings:
        log.warning("journal replay: %s", f)
    fp = (header or {}).get("fp") or base_fp
    if fp is None:
        # no fingerprint evidence (empty/headerless journal): use the
        # engine's own — replay proceeds, nothing to compare against
        fp = checkpoint._fingerprint(engine)
    snap2 = {"version": checkpoint.SNAPSHOT_VERSION, "engine": fp,
             "requests": recs}
    handles, finished = checkpoint.resume(engine, snap2, strict=strict)
    # retired-but-keyed records: a client retrying with the same
    # idempotency key attaches to the COMPLETED stream instead of
    # re-running it
    seeded = 0
    seed = getattr(engine, "seed_finished_idempotent", None)
    if seed is not None:
        for rec in finished:
            if rec.get("idempotency_key"):
                seed(rec)
                seeded += 1
    # mark the replay consumed IN the fresh journal (after the
    # resubmits re-seeded it): if the sideline removal below fails,
    # the next startup can tell this consumed sideline from a
    # crashed-mid-recovery one and must NOT truncate the live journal
    if os.path.exists(replay_path):
        with j._lock:
            j._append({"rec": "replay_done", "t": time.time()})
            j._sync()
            j._replay_done = True
    resumable = sum(1 for r in recs if checkpoint.is_resumable(r))
    dropped = max(0, resumable - len(handles))
    _REPLAYED.inc(len(handles))
    if dropped:
        _DROPPED.inc(dropped)
    dt = time.perf_counter() - t0
    _REPLAY_SECONDS.observe(dt)
    j.last_replay = {
        "replayed": len(handles), "dropped": dropped,
        "finished": len(finished), "seconds": round(dt, 4),
        "records": len(records), "corrupt_lines": bad,
        "torn_tail": torn, "findings": len(findings),
        "idempotent_seeded": seeded,
    }
    try:
        os.remove(replay_path)
    except FileNotFoundError:
        pass   # fresh startup: no sideline was ever created
    except OSError:
        # sideline it out of the startup path instead; if even that
        # fails, the replay_done marker above keeps the next startup
        # from mis-truncating the live journal
        try:
            os.replace(replay_path, replay_path + ".invalid")
        except OSError:
            log.error("journal: could not remove consumed sideline %s "
                      "(the replay_done marker guards the next "
                      "startup)", replay_path, exc_info=True)
    log.info("journal replay: %d resubmitted, %d finished, %d dropped "
             "in %.3fs (%s)", len(handles), len(finished), dropped, dt,
             j.path)
    return handles, finished
