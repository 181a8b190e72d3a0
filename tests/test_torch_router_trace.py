"""The port's router-tier tracing (`cake_tpu_torch/router/tracing.py`)
and its federated timeline merge (`obs/timeline.merge_router_timeline`),
held against the JAX package's on the same inputs:

  * the hop records of a lifecycle, a failover's reactivation, a bounded
    ring and the sentinel's windowed samples equal JAX's HopTracer's,
    and the JSONL sink writes JAX's lines;
  * `merge_router_timeline`'s document equals JAX's on the same hop,
    router events and replica timelines (clock offsets, an unreachable
    replica);
  * the router's sentinel has JAX's detector set and reads the same
    values; the router's anomaly actuator de-weights and re-weights as
    JAX's; the postmortem sink's router bundle has JAX's sections.
"""

import json

import pytest

from cake_tpu.obs.timeline import merge_router_timeline as j_merge
from cake_tpu.router.tracing import HopTracer as JHop
from cake_tpu_torch.obs.timeline import merge_router_timeline as t_merge
from cake_tpu_torch.router.tracing import HopTracer as THop


def _strip_t(rec):
    """A hop record with its wall-clock stamps replaced by their order."""
    rec = json.loads(json.dumps(rec))
    for i, sp in enumerate(rec.get("spans", ())):
        sp["t"] = i
    for k in [k for k in rec if k.endswith("_at")]:
        rec[k] = "<wall>"
    return rec


def _lifecycle(Hop, now):
    h = Hop(capacity=2, mono=lambda: now[0])
    h.begin("t1", cls="interactive", stream=True, hop=1)
    h.attempt("t1", "a:1", "hit")
    h.span("t1", "pick", replica="a:1", outcome="hit", sticky=False)
    h.span("t1", "connect", replica="a:1")
    h.admitted("t1", "a:1", 42)
    h.span("t1", "first_byte", replica="a:1", ttft_s=0.05)
    h.finish("t1", "midstream", replica="a:1", error="died")
    now[0] = 150.0
    h.begin("t1")                       # the failover's reconnect leg
    h.span("t1", "failover_resume", replica="b:1")
    h.attempt("t1", "b:1", "none")
    h.span("t1", "pick", replica="b:1", outcome="spill")
    h.admitted("t1", "b:1", 9)
    h.span("t1", "first_byte", replica="b:1", ttft_s=0.4)
    h.finish("t1", "retire", replica="b:1")
    out = [_strip_t(h.get("t1")), _strip_t(h.find_by_rid(42)),
           h.find_by_rid(43), h.active_count,
           h.ttft_by_replica(30.0), h.outcome_counts(30.0),
           h.ttft_by_replica(100.0), h.outcome_counts(100.0)]
    for i in range(3):                  # the ring's bound
        h.begin(f"x{i}")
        h.finish(f"x{i}", "retire")
    h.span("missing", "pick", replica="x")
    h.admitted("missing", "x", 1)
    h.finish("missing", "retire")
    out.append([r["trace"] for r in h.dump()])
    h.begin("t9")
    with pytest.raises(ValueError):
        h.finish("t9", "not-a-status")
    return out


def test_hop_records_equal_jaxs():
    port, jax_ = _lifecycle(THop, [100.0]), _lifecycle(JHop, [100.0])
    assert port == jax_
    rec = port[0]
    assert [a["rid"] for a in rec["attempts"]] == [42, 9]
    assert "failover_resume" in [sp["name"] for sp in rec["spans"]]


def test_hop_jsonl_lines_equal_jaxs(tmp_path):
    from cake_tpu_torch.obs.jsonl import read_jsonl
    lines = {}
    for name, Hop in (("port", THop), ("jax", JHop)):
        path = tmp_path / f"{name}.jsonl"
        h = Hop(capacity=4, events_path=str(path))
        h.begin("t1", cls="standard")
        h.span("t1", "pick", replica="a:1", outcome="hit")
        h.finish("t1", "retire", replica="a:1")
        h.close()
        lines[name] = [{k: v for k, v in ln.items() if k not in ("t", "ts")}
                       for ln in read_jsonl(str(path))]
    assert lines["port"] == lines["jax"]
    assert [ln["event"] for ln in lines["port"]] == ["admit", "pick",
                                                     "retire"]


def _hop_doc():
    return {
        "trace": "tr-1", "class": "standard", "hop": 1,
        "status": "retire", "stream": True,
        "attempts": [{"replica": "a:1", "outcome": "sticky", "rid": 5},
                     {"replica": "b:1", "outcome": "none", "rid": 9}],
        "spans": [
            {"name": "admit", "t": 100.0},
            {"name": "pick", "t": 100.001, "replica": "a:1"},
            {"name": "first_byte", "t": 100.2, "replica": "a:1"},
            {"name": "failover_resume", "t": 101.0, "replica": "b:1"},
            {"name": "pick", "t": 101.001, "replica": "b:1"},
            {"name": "retire", "t": 102.0, "replica": "b:1"},
        ],
    }


def _replica_doc(base, causes):
    return {"rid": 5, "status": "retired", "summary": {"causes": causes},
            "timeline": [
                {"t": base + 0.01, "source": "trace", "event": "admitted"},
                {"t": base + 0.15, "source": "events",
                 "event": "prefix_hit"},
                {"t": base + 0.16, "source": "steps", "event": "step"},
                {"t": base + 0.2, "source": "trace",
                 "event": "first_token"}]}


@pytest.mark.parametrize("case", ["offsets", "unreachable", "no_events"])
def test_merge_router_timeline_equals_jaxs(case):
    router_events = [
        {"seq": 1, "ts": 101.0005, "type": "failover_resume",
         "trace": "tr-1", "replica": "b:1"},
        {"seq": 2, "ts": 100.0001, "type": "affinity_miss",
         "trace": "tr-1", "replica": "a:1"},
    ]
    replicas = [("a:1", 5.0, 5, _replica_doc(95.0, {"prefix_hit": 1})),
                ("b:1", 0.0, 9, _replica_doc(101.1, {"recovered": 2}))]
    if case == "unreachable":
        replicas[0] = ("a:1", 0.0, 5, None)
    if case == "no_events":
        router_events = []
    port = t_merge(_hop_doc(), router_events, replicas)
    assert port == j_merge(_hop_doc(), router_events, replicas)
    ts = [e["t"] for e in port["timeline"]]
    assert ts == sorted(ts)
    if case == "unreachable":
        assert {r["replica"]: r.get("unreachable") for r in
                port["replicas"]} == {"a:1": True, "b:1": None}


class _FakeRouter:
    """What the router's sentinel and actuator read: the hop tracer,
    the event ring and the policy's weights."""

    def __init__(self, pkg, now):
        if pkg == "jax":
            from cake_tpu.obs.events import EventBus
            from cake_tpu.router.policy import RoutingPolicy
            from cake_tpu.router.replicas import ReplicaTracker
            Hop = JHop
        else:
            from cake_tpu_torch.obs.events import EventBus
            from cake_tpu_torch.router.policy import RoutingPolicy
            from cake_tpu_torch.router.replicas import ReplicaTracker
            Hop = THop
        self.hops = Hop(capacity=64, mono=lambda: now[0])
        self.events = EventBus(capacity=64, observe_metrics=False)
        docs = {n: {"status": "ok", "queue_depth": 0,
                    "active_requests": 0} for n in ("a:1", "b:1")}
        self.tracker = ReplicaTracker(list(docs),
                                      fetch=lambda n: dict(docs[n]))
        self.tracker.poll_once()
        self.policy = RoutingPolicy(self.tracker)


def _router_loop(pkg):
    if pkg == "jax":
        from cake_tpu.obs.actions import ActionPlane, RouterAnomalyActuator
        from cake_tpu.obs.sentinel import attach_router_sentinel
    else:
        from cake_tpu_torch.obs.actions import (
            ActionPlane, RouterAnomalyActuator,
        )
        from cake_tpu_torch.obs.sentinel import attach_router_sentinel
    now = [100.0]
    router = _FakeRouter(pkg, now)
    sen = attach_router_sentinel(router, min_samples=2, fire_after=1,
                                 clear_after=1)
    plane = ActionPlane(events=router.events)
    act = RouterAnomalyActuator(router, plane).attach(sen)
    h = router.hops
    for i, (rep, ttft, outcome) in enumerate(
            [("a:1", 0.1, "hit"), ("a:1", 0.1, "hit"), ("b:1", 2.0, "hit"),
             ("b:1", 2.0, "spill")]):
        h.begin(f"t{i}")
        h.span(f"t{i}", "pick", replica=rep, outcome=outcome)
        h.span(f"t{i}", "first_byte", replica=rep, ttft_s=ttft)
        h.finish(f"t{i}", "retire", replica=rep)
    sen.tick()
    state = sen.state()
    out = [sorted(d["kind"] for d in state["detectors"]),
           sorted(a["kind"] for a in state["active"]),
           router.policy.weight_provenance("b:1")["factors"],
           [(a["kind"], a["action"], a["outcome"])
            for a in plane.history(None)]]
    now[0] = 200.0                      # the window empties: clear
    sen.tick()
    out.append(router.policy.weight_provenance("b:1")["factors"])
    del act
    return out


def test_router_sentinel_and_actuator_act_as_jaxs():
    port = _router_loop("port")
    assert port == _router_loop("jax")
    assert "replica_ttft_skew" in port[0]


def test_postmortem_router_bundle_has_jaxs_sections(tmp_path):
    from cake_tpu.obs.actions import PostmortemSink as JSink
    from cake_tpu_torch.obs.actions import PostmortemSink as TSink
    keys = {}
    for name, Sink in (("port", TSink), ("jax", JSink)):
        router = _FakeRouter(name, [100.0])
        router.hops.begin("t1")
        router.hops.finish("t1", "retire")
        d = tmp_path / name
        path = Sink(str(d)).dump("sigterm", router=router, force=True)
        bundle = json.loads(open(path).read())
        keys[name] = sorted(bundle)
        assert bundle["hops"][0]["trace"] == "t1"
    assert keys["port"] == keys["jax"]
