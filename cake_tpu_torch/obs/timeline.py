"""Per-request explain: one merged, time-ordered request timeline.

Counterpart of `cake_tpu/obs/timeline.py` (`build_timeline`; the
router's merge waits for the router, ROADMAP A15).
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

