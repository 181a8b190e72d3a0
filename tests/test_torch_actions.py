"""The port's action plane and postmortem sink
(`cake_tpu_torch/obs/actions.py`) against the JAX package's
(`cake_tpu/obs/actions.py`), its engine side.

  * `ActionPlane` and `EngineAnomalyActuator`, fed the same sentinel
    transitions over each package's autotune controller on fake clocks,
    record the same actions with the same outcomes (hold, rollback,
    resume, rate_limited, skipped) and leave the same decision logs;
  * a `PostmortemSink` bundle of a port engine stopped by the storm
    breaker (with --journal, --sentinel and --sentinel-act) holds the
    keys JAX's sink collects from the same engine: steps, events, traces,
    anomalies, actions, stats, metrics and journal_tail; a poison
    quarantine's dump is interval-bounded, the terminal one forced;
  * `tools/postmortem.py` (stdlib only) renders the bundle (exit 0).
"""

import importlib.util
import json
import os
import pathlib

import torch

from cake_tpu_torch.obs import actions as ours

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def _theirs():
    from cake_tpu.obs import actions
    return actions


class _Engine:
    """What the actuator reads of an engine: its autotune controller."""

    def __init__(self, autotuner):
        self._autotuner = autotuner


def _controller(auto):
    cfgs = [auto.EngineConfig(slots=8, kv_pages=64),
            auto.EngineConfig(slots=32, kv_pages=64)]
    pol = auto.PolicyTable(regimes=[
        {"max_offered_rps": 5.0, "config": cfgs[0]},
        {"max_offered_rps": None, "config": cfgs[1]}]).validate()
    clock = [0.0]
    ctl = auto.AutotuneController(
        pol, cfgs[0], config=auto.ControllerConfig(
            interval_s=1.0, window=2, hold=1, cooldown_s=0.0,
            rollback_window=5),
        now_fn=lambda: clock[0])
    return ctl, cfgs


CAUSE = {"kind": "x", "value": 3.0, "threshold": 2.0,
         "comparison": "above", "evidence": [1, 2]}
TRANSITIONS = [
    ("shed_storm", "fired"),                 # not actionable: no record
    ("recompile_storm", "fired"),            # hold
    ("recompile_storm", "cleared"),          # resume
    "switch",                                # an autonomous switch: guard
    ("step_time:decode", "fired"),           # rollback, spends budget
    ("step_time:mixed", "fired"),            # guard armed: rate_limited
    ("step_time:mixed", "cleared"),
    ("step_time:decode", "cleared"),         # resume
]


def _actuate(port: bool):
    if port:
        import cake_tpu_torch.autotune as auto
        mod = ours
    else:
        import cake_tpu.autotune as auto
        mod = _theirs()
    ctl, (lo, hi) = _controller(auto)
    now = [100.0]
    plane = mod.ActionPlane(max_per_min=1, clock=lambda: now[0],
                            wall=lambda: 5.0, observe_metrics=False)
    act = mod.EngineAnomalyActuator(_Engine(ctl), plane)
    for tr in TRANSITIONS:
        if tr == "switch":
            ctl.on_switched(hi, lo, 100.0, "auto")
            continue
        now[0] += 1.0
        act.on_transition(tr[0], tr[1], dict(CAUSE, kind=tr[0]))
    # no autotuner: every actionable transition is recorded as skipped
    off = mod.EngineAnomalyActuator(_Engine(None), plane)
    off.on_transition("recompile_storm", "fired", CAUSE)
    off.on_transition("recompile_storm", "cleared", CAUSE)
    logs = [{k: v for k, v in e.items() if k != "t"}
            for e in ctl.decision_log()]
    return plane.state(), logs, ctl.state()["anomaly_hold"]


def test_actuator_outcomes_equal_jax():
    mine, theirs = _actuate(True), _actuate(False)
    assert mine == theirs
    outcomes = [(a["kind"], a["action"], a["outcome"])
                for a in reversed(mine[0]["actions"])]
    assert outcomes == [
        ("recompile_storm", "hold", "applied"),
        ("recompile_storm", "resume", "applied"),
        ("step_time:decode", "rollback", "applied"),
        ("step_time:mixed", "hold", "rate_limited"),
        ("step_time:decode", "resume", "applied"),
        ("recompile_storm", "hold", "skipped"),
        ("recompile_storm", "resume", "skipped"),
    ]


def test_plane_publishes_typed_events_and_bounds_its_budget():
    from cake_tpu_torch.obs.events import EventBus
    bus = EventBus(observe_metrics=False)
    now = [0.0]
    plane = ours.ActionPlane(events=bus, max_per_min=2,
                             clock=lambda: now[0], observe_metrics=False)
    assert plane.allow()
    plane.record("k", "rollback", "applied", cause_value=1.0, extra=None)
    plane.record("k", "rollback", "applied")
    assert not plane.allow()
    now[0] = 61.0
    assert plane.allow()
    evs = bus.dump(type="anomaly_action")
    assert len(evs) == 2 and evs[0]["cause_value"] == 1.0
    assert "extra" not in plane.history()[1]


def _port_engine(tmp_path, **kw):
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.serve.engine import InferenceEngine
    from cake_tpu_torch.serve.errors import RecoveryConfig

    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device="cpu",
        max_slots=2, max_seq_len=64, kv_pages=8, kv_page_size=16,
        cache_dtype=torch.float32, recovery=True,
        recovery_config=RecoveryConfig(backoff_base_s=0.0,
                                       backoff_cap_s=0.0, storm_resets=3),
        postmortem_dir=str(tmp_path / "pm"),
        journal=str(tmp_path / "j.jsonl"), sentinel=True,
        sentinel_act=True, **kw)


def _bundles(tmp_path):
    d = tmp_path / "pm"
    return sorted(p for p in os.listdir(d) if p.endswith(".json"))


def test_breaker_stop_bundle_has_the_jax_keys_and_renders(tmp_path,
                                                          capsys):
    eng = _port_engine(
        tmp_path, fault_plan="seed=5;engine.step:step=4:transient:times=50")
    hs = [eng.submit([3 + i] * 7, max_new_tokens=6) for i in range(2)]
    with eng:
        assert all(h.wait(60) for h in hs)
        eng._thread.join(timeout=60)
    assert eng.stopped and eng._breaker_tripped
    names = _bundles(tmp_path)
    assert len(names) == 1 and names[0].endswith("-breaker_stop.json")
    with open(tmp_path / "pm" / names[0]) as f:
        bundle = json.load(f)
    assert bundle["trigger"] == "breaker_stop"
    want = {"steps", "events", "traces", "anomalies", "actions", "stats",
            "metrics", "journal_tail"}
    assert want <= set(bundle)
    assert bundle["journal_tail"] and bundle["stats"]["recoveries"] == 2
    assert any(e["type"] == "fault_injected" for e in bundle["events"])
    # JAX's sink collects the same keys from the same engine
    theirs = _theirs().PostmortemSink(str(tmp_path / "jax"))._collect(
        "breaker_stop", engine=eng, reason="x")
    mine = ours.PostmortemSink(str(tmp_path / "mine"))._collect(
        "breaker_stop", engine=eng, reason="x")
    assert set(mine) == set(theirs)
    # the stdlib-only renderer reads it
    spec = importlib.util.spec_from_file_location(
        "postmortem", TOOLS / "postmortem.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main([str(tmp_path / "pm")]) == 0
    out = capsys.readouterr().out
    assert "breaker_stop" in out


def test_poison_dumps_are_interval_bounded(tmp_path):
    from cake_tpu_torch.serve.errors import PoisonRequestError

    eng = _port_engine(tmp_path)
    sink = eng._postmortem
    reqs = [eng.submit([4] * 5, max_new_tokens=3)._req for _ in range(3)]
    for r in reqs:
        eng._drop_request(r, PoisonRequestError(r.rid, 2, "x"),
                          poison_reason="implicated")
    names = _bundles(tmp_path)
    assert len(names) == 1 and names[0].endswith("-poison.json")
    # a terminal trigger is forced through the interval bound
    assert sink.dump("sigterm", engine=eng, force=True) is not None
    assert len(_bundles(tmp_path)) == 2
    assert sink.dump("poison", engine=eng) is None
