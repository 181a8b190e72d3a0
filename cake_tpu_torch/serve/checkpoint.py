"""Runtime checkpoint and resume for the serving engine.

Counterpart of `cake_tpu/serve/checkpoint.py`, with the same record
format:

  * `snapshot(engine)` captures every queued, in-flight and finished
    request as a JSON-serializable record (prompt ids, tokens generated
    so far, remaining budget, sampling options, class, idempotency key,
    replayed tokens) beside an engine compatibility fingerprint;
  * `save` / `write` / `load` persist it (atomic: tmp + fsync + rename);
  * `resume(engine, snap)` resubmits unfinished requests with prompt =
    original prompt + tokens generated so far, and their generated
    history as `prime_penalty_tokens`, so greedy streams, with a repeat
    penalty or without, continue with the tokens an uninterrupted run
    emits; `restore` is load + resume. Over a windowed engine (the sp
    engine's prompt window and decode tail) a transcript past the
    window is refused, and a remaining budget past the tail warns that
    the resumed generation will be truncated.

The fingerprint is the port's own: its params digest samples the port's
leaves (in the dict's key order), and it carries ``"framework":
"torch"``. A JAX snapshot has no such mark and a digest of other bytes;
`resume` refuses it with an explicit framework error instead of
reporting a weights mismatch (the JAX module's reason for versioning its
digest). The fingerprint is computed once, at startup
(`warm_fingerprint`), so the failure path reads nothing from a card a
sticky CUDA error may have poisoned.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import logging
import os
import uuid
from typing import Dict, List, Optional, Tuple

import torch

from cake_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

# the record format is JAX's (cake_tpu/serve/checkpoint.py); the
# fingerprint tells the two packages apart
SNAPSHOT_VERSION = 3
FRAMEWORK = "torch"

_RESUMED = obs_metrics.counter(
    "cake_checkpoint_resumed_requests_total",
    "Snapshot requests resubmitted into a restarted engine")
_DROPPED = obs_metrics.counter(
    "cake_checkpoint_dropped_requests_total",
    "Snapshot requests that could not be resubmitted")


def _leaves(tree) -> List[torch.Tensor]:
    """The params' tensors in the dict's key order, a quantized node's
    q before its scale."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return _leaves(tree.q) + _leaves(tree.scale)
    return [tree]


def _params_digest(params) -> str:
    """Weight-sensitive model identity: sha256 over the shapes and the
    first 256 values of the first and last four leaves (sliced on the
    device before the copy to the host; of a placed leaf, the first
    mesh position's slice this process holds)."""
    from cake_tpu_torch.parallel.sharding import Sharded

    h = hashlib.sha256()
    leaves = _leaves(params)
    for leaf in leaves[:4] + leaves[-4:]:
        h.update(str(tuple(leaf.shape)).encode())
        if isinstance(leaf, Sharded):
            # a placed leaf: its global shape, its first owned
            # position's slice
            leaf = leaf.first()
        sample = leaf.reshape(-1)[:256].to(torch.float32).cpu()
        h.update(sample.numpy().tobytes())
    return h.hexdigest()[:16]


def _fingerprint(engine) -> Dict:
    """The engine's compatibility fingerprint, memoized on the engine
    (weights do not change while serving, and the failure path must not
    touch the device). A deep copy: a caller editing a snapshot must not
    edit the cache."""
    fp = getattr(engine, "_ckpt_fingerprint", None)
    if fp is not None:
        return copy.deepcopy(fp)
    cfg = json.loads(json.dumps(dataclasses.asdict(engine.config)))
    fp = {
        "framework": FRAMEWORK,
        "config": cfg,
        "max_seq_len": engine.max_seq_len,
        # the ring width shapes penalty reconstruction
        "repeat_last_n": engine.defaults.repeat_last_n,
        "params": _params_digest(engine.params),
    }
    engine._ckpt_fingerprint = fp
    return copy.deepcopy(fp)


def warm_fingerprint(engine) -> None:
    """Compute and cache the fingerprint now, while the card is healthy,
    so a later pre-fail snapshot needs no device work."""
    _fingerprint(engine)


def is_resumable(rec: Dict) -> bool:
    """Whether a snapshot record is an interrupted generation that
    resume() would resubmit (shared by resume, the pre-fail writer and
    the shutdown keep-or-save rule)."""
    return (not rec.get("finished") and not rec.get("error")
            and rec.get("remaining", 0) > 0)


def has_resumable(path: Optional[str]) -> bool:
    """True when `path` holds a checkpoint with resumable records."""
    if not path or not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            snap = json.load(f)
        return any(is_resumable(r) for r in snap.get("requests", []))
    except (OSError, ValueError):
        return False


def snapshot_requests(engine) -> List[Dict]:
    """The request records alone: pure Python, no device work, so the
    engine loop's failure path can capture them before failing the
    clients and write them after."""
    requests: List[Dict] = []
    for rid, req in sorted(dict(engine._requests).items()):
        requests.append({
            "rid": rid,
            "prompt_ids": list(req.prompt_ids),
            "out_tokens": list(req.out_tokens),
            # the whole generated history, earlier resumes included, so
            # a request interrupted twice rebuilds its penalty ring over
            # its whole transcript
            "penalty_context": list(req.prime_tokens) + list(req.out_tokens),
            "remaining": max(0, req.max_new_tokens - len(req.out_tokens)),
            "priority": req.priority,
            "temperature": req.temperature,
            "top_p": req.top_p,
            "repeat_penalty": req.repeat_penalty,
            "finished": req.done.is_set(),
            "error": str(req.error) if req.error else None,
            # durable serving (serve/journal.py): the idempotency key,
            # and the tokens of earlier process generations already
            # folded into prompt_ids (the absolute stream coordinate)
            "idempotency_key": req.idempotency_key,
            "replayed": list(req.replayed_tokens),
        })
    return requests


def snapshot(engine, requests: Optional[List[Dict]] = None) -> Dict:
    """Capture the engine's request state (stopped, or quiesced: the
    engine thread mutates requests every step). requests: records
    captured earlier with snapshot_requests (the pre-fail path).

    Beside the records, outside the fingerprint (informational, as in
    JAX): the live engine config and its autotune epoch (a snapshot
    restores into a DIFFERENT config token-identically, so the config
    never gates a resume), and the sentinel's calibrated baselines (a
    restart adopts them instead of re-learning what normal looks
    like)."""
    snap = {
        "version": SNAPSHOT_VERSION,
        "engine": _fingerprint(engine),
        "requests": (snapshot_requests(engine) if requests is None
                     else requests),
    }
    cfg_fn = getattr(engine, "current_config", None)
    if cfg_fn is not None:
        try:
            snap["engine_config"] = cfg_fn().to_dict()
            snap["config_epoch"] = getattr(engine, "config_epoch", 0)
        except Exception:  # noqa: BLE001 — metadata, never the save
            log.debug("snapshot: engine config capture failed",
                      exc_info=True)
    sen = getattr(engine, "sentinel", None)
    if sen is not None:
        try:
            baselines = sen.export_baselines()
            if baselines:
                snap["sentinel_baselines"] = baselines
        except Exception:  # noqa: BLE001 — metadata, never the save
            log.debug("snapshot: sentinel baseline capture failed",
                      exc_info=True)
    return snap


def write(snap: Dict, path: str) -> None:
    """Write a snapshot to `path` atomically: tmp, fsync, rename. A
    crash at any point leaves the previous good file or the new one.
    The tmp name is unique per call (a pre-fail and a shutdown save may
    overlap)."""
    tmp = f"{path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(snap, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    log.info("checkpoint: %d request(s) -> %s", len(snap["requests"]), path)


def save(engine, path: str) -> Dict:
    """Snapshot the engine and write it to `path`."""
    snap = snapshot(engine)
    write(snap, path)
    return snap


def load(path: str) -> Optional[Dict]:
    """Load a snapshot. A corrupt or truncated file degrades to None
    ("no checkpoint") with a warning, so a bad file never crash-loops a
    startup; a version mismatch raises."""
    try:
        with open(path) as f:
            snap = json.load(f)
    except (OSError, ValueError) as e:
        log.warning("checkpoint %s is unreadable/corrupt (%s); starting "
                    "with no checkpoint", path, e)
        return None
    if not isinstance(snap, dict):
        log.warning("checkpoint %s is not a snapshot object; starting "
                    "with no checkpoint", path)
        return None
    if snap.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported snapshot version {snap.get('version')!r}")
    return snap


def check_framework(fp: Optional[Dict]) -> None:
    """Refuse a fingerprint another package wrote (the JAX package's
    carries no framework mark): its digest samples other bytes, so a
    comparison would report a weights mismatch for the same weights."""
    got = (fp or {}).get("framework")
    if got != FRAMEWORK:
        raise ValueError(
            f"snapshot written by framework {got or 'jax (cake_tpu)'!r}, "
            f"not by this package ({FRAMEWORK!r}, cake_tpu_torch): "
            "a snapshot resumes only into the package that wrote it")


def resume(engine, snap: Dict, strict: bool = True) -> Tuple[List, List[Dict]]:
    """Resubmit a snapshot's unfinished requests into `engine`.

    Returns (handles, finished_records): a RequestHandle per resumed
    request in snapshot order, and the records of requests that had
    finished (or failed to resubmit). strict: a fingerprint mismatch
    raises instead of warning; another framework's snapshot always
    raises."""
    want = snap.get("engine", {})
    check_framework(want)
    fp = _fingerprint(engine)
    if fp != want:
        msg = f"snapshot fingerprint {want} != engine {fp}"
        if strict:
            raise ValueError(msg)
        log.warning("%s (resuming anyway)", msg)
    # the sentinel adopts the saved baselines BEFORE the load comes back:
    # a restored detector must not calibrate on resume-storm traffic
    # (best-effort: telemetry never gates a resume)
    sen = getattr(engine, "sentinel", None)
    if sen is not None:
        try:
            sen.restore_baselines(snap.get("sentinel_baselines"))
        except Exception:  # noqa: BLE001
            log.debug("resume: sentinel baseline restore failed",
                      exc_info=True)
    handles, finished = [], []
    for rec in snap["requests"]:
        try:
            # field reads inside the try: one malformed record must not
            # abort the loop after earlier requests were resubmitted
            if not is_resumable(rec):
                finished.append(rec)
                continue
            ids = rec["prompt_ids"] + rec["out_tokens"]
            limit = getattr(engine, "prompt_limit", None)
            if limit is not None and len(ids) > limit:
                # a windowed serving mode (the sp engine's context and
                # tail) re-prefills the whole transcript into its prompt
                # window; a longer one has no replay path
                raise ValueError(
                    f"resumed context {len(ids)} exceeds this serving "
                    f"mode's prompt window {limit}")
            budget = getattr(engine, "decode_budget", None)
            if budget is not None and rec["remaining"] > budget:
                # submit clamps max_new_tokens to the tail: say so, since
                # it shortens the client's resumed generation
                log.warning(
                    "resume: rid=%s has %d tokens remaining but this "
                    "serving mode's decode budget is %d; the resumed "
                    "generation will be truncated",
                    rec.get("rid"), rec["remaining"], budget)
            h = engine.submit(
                ids,
                max_new_tokens=rec["remaining"],
                temperature=rec["temperature"],
                top_p=rec["top_p"],
                repeat_penalty=rec["repeat_penalty"],
                prime_penalty_tokens=rec.get("penalty_context",
                                             rec["out_tokens"]),
                priority=rec.get("priority"),
                idempotency_key=rec.get("idempotency_key"),
                replay_tokens=(list(rec.get("replayed") or ())
                               + list(rec["out_tokens"])),
            )
            engine.tracer.annotate(h._req.rid, resumed=True)
            if rec["out_tokens"] or rec.get("replayed"):
                engine.tracer.span(
                    h._req.rid, "replayed", journal_rid=rec.get("rid"),
                    generated=(len(rec["out_tokens"])
                               + len(rec.get("replayed") or ())))
            _RESUMED.inc()
            handles.append(h)
        except Exception as e:  # noqa: BLE001 — one bad record must not
            # crash-loop a startup (a full queue, a shrunk max_seq_len)
            log.warning("resume: dropping request rid=%s: %s",
                        rec.get("rid"), e)
            _DROPPED.inc()
            finished.append(dict(rec, error=f"resume failed: {e}"))
    log.info("resume: %d request(s) resubmitted, %d already finished",
             len(handles), len(finished))
    return handles, finished


def restore(engine, path: str, strict: bool = True) -> Tuple[List, List[Dict]]:
    """load + resume; a corrupt or unreadable snapshot restores
    nothing."""
    snap = load(path)
    if snap is None:
        return [], []
    return resume(engine, snap, strict=strict)
