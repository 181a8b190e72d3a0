"""Per-request explain: one merged, time-ordered request timeline.

Counterpart of `cake_tpu/obs/timeline.py`: `build_timeline` and the
router's federated merge, `merge_router_timeline`.
``GET /api/v1/requests/{rid}/timeline`` answers "why was this request's
TTFT 400ms?" from one call, by stitching the three telemetry streams the
engine already keeps into a single chronology:

  * the tracer's lifecycle spans (obs/tracing.py: admitted, queued,
    prefill, first_token, decode, preempted, requeued, kv_restored,
    crash_recovered, reconfigured, retired/error/cancelled) — the
    request's own state machine;
  * the event bus (obs/events.py: preempted, kv_spill, kv_restore,
    prefix_hit, recovered, poisoned, reconfigured, shed, ...) — what
    the other subsystems DID to it, with their context fields;
  * the step flight recorder (obs/steps.py): the engine steps whose
    dispatched batch contained the request (records carry the rids of
    their rows), so stalls between spans are attributable to what the
    card was running — or capturing (``compiled: true``).

Everything here is a pure function over the three dumps, so tests drive
it on synthetic records; the engine method
(serve/engine.request_timeline) only gathers the inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# event types that explain latency (the "causes" summary counts these
# between admission and first token — the TTFT attribution — and over
# the whole life for the e2e view)
ROUTER_CAUSE_TYPES = ("affinity_miss", "spill_to_secondary",
                      "failover_resume", "shed_by_router")
CAUSE_TYPES = ("preempted", "resident_spilled", "kv_spill",
               "kv_restore", "prefix_hit", "recovered", "poisoned",
               "reconfigured", "shed", "fault_injected",
               "recompile") + ROUTER_CAUSE_TYPES


def build_timeline(trace: Dict, events: List[Dict],
                   steps: Optional[List[Dict]] = None,
                   local_host: Optional[str] = None) -> Dict:
    """Merge one request's trace record (RequestTracer dump entry),
    its bus events (EventBus.dump(rid=...), plus any collector-held
    REMOTE events — the fleet collector, obs/federation.py, tags those with
    their origin ``host`` and corrects their timestamps by the per-host
    clock offset) and the step records whose batch contained it
    (StepTelemetry.records_for(rid)) into one time-ordered view with a
    cause summary.

    All inputs carry wall-clock timestamps (the tracer's spans are
    exported anchored to wall time; remote events arrive offset-
    corrected), so a plain sort merges them — one chronology even when
    the request's events span hosts; ties break trace-first (a span
    and the event it caused share a timestamp, and the state change
    reads better first). local_host names this process in the
    ``hosts`` summary when remote-origin events are present."""
    entries: List[Dict] = []
    for sp in trace.get("spans", ()):
        entries.append({"t": sp["t"], "source": "trace",
                        "event": sp["name"],
                        "offset_s": sp.get("offset_s")})
    for ev in events:
        e = {"t": ev.get("ts"), "source": "events",
             "event": ev.get("type")}
        e.update({k: v for k, v in ev.items()
                  if k not in ("ts", "type", "rid", "seq")})
        entries.append(e)
    for rec in steps or ():
        entries.append({
            "t": rec.get("ts"), "source": "steps",
            "event": f"step:{rec.get('kind')}",
            "step": rec.get("step"),
            "rows": rec.get("rows"),
            "wall_s": rec.get("wall_s"),
            "compiled": rec.get("compiled", False),
        })
    order = {"trace": 0, "events": 1, "steps": 2}
    entries.sort(key=lambda e: (e.get("t") or 0.0,
                                order.get(e["source"], 3)))

    first_token_t = next((sp["t"] for sp in trace.get("spans", ())
                          if sp["name"] == "first_token"), None)
    causes: Dict[str, int] = {}
    ttft_causes: Dict[str, int] = {}
    for ev in events:
        t = ev.get("type")
        if t not in CAUSE_TYPES:
            continue
        causes[t] = causes.get(t, 0) + 1
        if first_token_t is None or (ev.get("ts") or 0.0) <= first_token_t:
            ttft_causes[t] = ttft_causes.get(t, 0) + 1
    compile_steps = sum(1 for rec in steps or ()
                        if rec.get("compiled"))
    if compile_steps:
        causes["compiled_steps"] = compile_steps

    # fleet-scope requests: name every host that contributed events —
    # the local process first, then remote origins in name order
    remote_hosts = sorted({ev["host"] for ev in events
                           if ev.get("host")})
    hosts = None
    if remote_hosts:
        hosts = ([local_host] if local_host
                 and local_host not in remote_hosts else [])
        hosts += remote_hosts

    return {
        "rid": trace.get("rid"),
        "status": trace.get("status"),
        "priority": trace.get("priority"),
        "config_epoch": trace.get("config_epoch"),
        "summary": {
            "prompt_tokens": trace.get("prompt_tokens"),
            "output_tokens": trace.get("output_tokens"),
            "queue_wait_s": trace.get("queue_wait_s"),
            "ttft_s": trace.get("ttft_s"),
            "e2e_s": trace.get("e2e_s"),
            # what happened to this request, total and inside the
            # TTFT window — the one-glance attribution ("preempted
            # twice, prefix spilled then restored, folded by a
            # config switch")
            "causes": causes,
            "ttft_causes": ttft_causes,
            **({"hosts": hosts} if hosts else {}),
        },
        "timeline": entries,
    }


def merge_router_timeline(hop: Dict, router_events: List[Dict],
                          replicas: List[tuple]) -> Dict:
    """Merge one request's ROUTER-tier view — the front door's hop
    record (router/tracing.HopTracer dump entry: admit, pick + affinity
    verdict, connect, first byte, failover resume, retire) and its
    router event-ring events (selected by trace id) — with the owning
    replica(s)' merged timelines into ONE wall-clock-ordered chronology.

    `replicas` is [(name, clock_offset_s, rid, timeline_doc_or_None)]:
    one entry per replica that admitted this trace (BOTH replicas after
    a drain/kill failover). Each replica entry's timestamps are
    corrected by that replica's clock offset (the federation
    rule: offset = min over health polls of receive-wall minus the
    replica's reported wall — skew plus the smallest observed transit)
    and tagged with its replica name. A replica whose timeline fetch
    failed (e.g. the killed home of a failover) contributes no spans
    but is still NAMED, with unreachable=true — the router hops cover
    its attempt either way.

    Pure function over dumps, like build_timeline: tests drive it on
    synthetic records; RouterServer.request_timeline only gathers the
    inputs."""
    entries: List[Dict] = []
    for sp in hop.get("spans", ()):
        e = {"t": sp.get("t"), "source": "router",
             "event": sp.get("name")}
        e.update({k: v for k, v in sp.items()
                  if k not in ("t", "name")})
        entries.append(e)
    for ev in router_events:
        e = {"t": ev.get("ts"), "source": "router-events",
             "event": ev.get("type")}
        e.update({k: v for k, v in ev.items()
                  if k not in ("ts", "type", "rid", "seq")})
        entries.append(e)

    causes: Dict[str, int] = {}
    replica_rows = []
    for name, offset_s, rid, doc in replicas:
        row: Dict = {"replica": name, "rid": rid,
                     "clock_offset_s": (round(offset_s, 6)
                                        if offset_s else 0.0)}
        if doc is None:
            # the replica is gone (killed home) or refused the fetch:
            # its attempt still reads from the router hops above
            row["unreachable"] = True
            replica_rows.append(row)
            continue
        row["status"] = doc.get("status")
        replica_rows.append(row)
        for e in doc.get("timeline", ()):
            e2 = dict(e)
            if e2.get("t") is not None:
                e2["t"] = e2["t"] + (offset_s or 0.0)
            e2["replica"] = name
            entries.append(e2)
        for k, v in (doc.get("summary", {}).get("causes") or {}).items():
            causes[k] = causes.get(k, 0) + int(v)
    for ev in router_events:
        t = ev.get("type")
        if t in ROUTER_CAUSE_TYPES:
            causes[t] = causes.get(t, 0) + 1

    # one chronology: wall-clock order; ties read router-first (the
    # front door observed the request before any replica did)
    order = {"router": 0, "router-events": 1, "trace": 2, "events": 3,
             "steps": 4}
    entries.sort(key=lambda e: (e.get("t") or 0.0,
                                order.get(e.get("source"), 5)))
    return {
        "trace": hop.get("trace"),
        "status": hop.get("status"),
        "priority": hop.get("class"),
        "hop": hop.get("hop"),
        "replicas": replica_rows,
        "summary": {
            "causes": causes,
            "attempts": len(hop.get("attempts", ()) or ()),
        },
        "timeline": entries,
    }
