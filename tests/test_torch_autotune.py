"""The port's autotune package (`cake_tpu_torch/autotune/`) against the
JAX package's (`cake_tpu/autotune/`): host-only logic, copied, so the
same inputs must give the same answers.

  * the config space: over random configs (hypothesis), `config_key`,
    `validate_config` and `switch_guard` agree with JAX's, the
    attention impls compared after the name mapping (JAX's fold/pallas
    are the port's plain/kernel); a dense point and JAX's impl names are
    refused by the port, naming A11 and the port's names;
  * `fit` on the same observations gives the same policy dict;
  * `observations_from_step_log` over a step log written by the port's
    engine reads as JAX's reading of the same file;
  * the port's fitter CLI (`python -m cake_tpu_torch.tools.autotune_fit`)
    writes the same policy file as `tools/autotune_fit.py` from the same
    inputs, with the same exit codes;
  * the same signal sequence on a fake clock through both controllers
    gives equal decision logs (hysteresis, cooldown, rollback once then
    pin, an accepted switch, a manual switch, the int8 -> int4
    page-pressure escalation, note_anomaly's hold and rollback).
"""

import importlib.util
import json
import pathlib

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch

from cake_tpu_torch.autotune import (
    AutotuneController, AutotuneSignals, ControllerConfig, EngineConfig,
    Observation, PolicyTable, config_key, extract_observations, fit,
    observations_from_step_log, switch_guard, validate_config,
)

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
TO_PORT = {"fold": "plain", "pallas": "kernel"}


def _jax():
    import cake_tpu.autotune as ja
    return ja


def _port_cfg(d: dict) -> EngineConfig:
    d = dict(d)
    if d.get("paged_attn") in TO_PORT:
        d["paged_attn"] = TO_PORT[d["paged_attn"]]
    return EngineConfig.from_dict(d)


def _port_key(key: tuple) -> tuple:
    return tuple(TO_PORT.get(k, k) if isinstance(k, str) else k
                 for k in key)


def _outcome(fn):
    try:
        fn()
    except ValueError:
        return "refused"
    return "ok"


configs = st.fixed_dictionaries({
    "slots": st.integers(0, 40),
    "decode_scan": st.integers(0, 8),
    "kv_pages": st.one_of(st.none(), st.integers(0, 300)),
    "kv_page_size": st.sampled_from([0, 1, 15, 16, 64, 128, 256]),
    "kv_dtype": st.sampled_from([None, "f32", "float32", "bf16",
                                 "bfloat16", "f16", "int8", "int4",
                                 "f8_e4m3", "f8_e5m2", "bogus"]),
    "mixed_batch": st.sampled_from(["auto", "on", "off", "sometimes"]),
    "paged_attn": st.sampled_from(["auto", "fold", "pallas", "nope"]),
})


@settings(max_examples=150, deadline=None)
@given(configs, configs)
def test_space_agrees_with_jax(a, b):
    ja = _jax()
    ja_a, ja_b = ja.EngineConfig.from_dict(a), ja.EngineConfig.from_dict(b)
    pa, pb = _port_cfg(a), _port_cfg(b)
    # the key, "auto" resolved on the CPU on both sides
    assert (_port_key(ja.config_key(ja_a, default_kv_dtype="bf16"))
            == config_key(pa, default_kv_dtype="bf16", device="cpu"))
    assert _port_key(ja.config_key(ja_a)) == config_key(pa, device="cpu")
    # the live-switch guard, reason text included
    assert ja.switch_guard(ja_a, ja_b) == switch_guard(pa, pb)
    # validity: every point, dense (kv_pages null) or paged, is legal in
    # the port exactly when it is in JAX; the port's dtype table also
    # takes numpy's spellings (utils/devices.resolve_kv_dtype), which
    # JAX's rejects
    port = _outcome(lambda: validate_config(pa))
    spelled = ja.EngineConfig.from_dict(dict(a, kv_dtype={
        "float32": "f32", "bfloat16": "bf16"}.get(a["kv_dtype"],
                                                  a["kv_dtype"])))
    assert port == _outcome(lambda: ja.validate_config(spelled))


def test_divergences_dense_point_and_jax_impl_names():
    # a dense point is legal, as in JAX; its mixed step is not
    assert validate_config(EngineConfig(slots=8)).kv_pages is None
    with pytest.raises(ValueError, match="mixed_batch=on requires"):
        validate_config(EngineConfig(slots=8, mixed_batch="on"))
    assert (config_key(EngineConfig(slots=8, kv_page_size=64), device="cpu")
            == config_key(EngineConfig(slots=8), device="cpu")
            == ("dense", 8, 1))
    for jax_name, ours in TO_PORT.items():
        with pytest.raises(ValueError, match=repr(ours)):
            validate_config(EngineConfig(kv_pages=16, paged_attn=jax_name))
    # the resolved names key alike: auto is the device's impl
    assert (config_key(EngineConfig(kv_pages=16), device="cpu")
            == config_key(EngineConfig(kv_pages=16, paged_attn="plain"),
                          device="cpu"))
    assert (config_key(EngineConfig(kv_pages=16), device="cuda")
            == config_key(EngineConfig(kv_pages=16, paged_attn="kernel"),
                          device="cpu"))
    # fp8 ranks as float: float -> fp8 is a narrowing nobody gates, and
    # fp8 -> f32 is not a widening out of a quantized pool
    f8 = EngineConfig(kv_pages=16, kv_dtype="f8_e4m3")
    assert switch_guard(EngineConfig(kv_pages=16), f8) is None
    assert switch_guard(f8, EngineConfig(kv_pages=16)) is None
    assert "int8-pool -> float-pool" in switch_guard(
        EngineConfig(kv_pages=16, kv_dtype="int8"), f8)


def _obs_rows():
    rows = []
    for i, (slots, rps, tps, ttft, att) in enumerate([
            (8, 1.0, 200, 0.05, 0.99), (32, 1.0, 120, 0.4, 0.5),
            (8, 3.0, 220, None, None), (16, 3.0, 400, 0.2, 0.9),
            (8, 20.0, 300, None, None), (32, 20.0, 1200, 0.3, 0.97),
            (16, 9.0, 500, 0.1, None), (32, 9.0, 480, None, 0.8)]):
        rows.append(dict(config={"slots": slots, "kv_pages": 64 + i % 2,
                                 "kv_dtype": "int8" if i % 3 == 0
                                 else None},
                         offered_rps=rps, tok_s=tps, ttft_p99_s=ttft,
                         attainment=att))
    return rows * 2


@pytest.mark.parametrize("kw", [dict(), dict(max_regimes=2),
                                dict(emit_guards=False),
                                dict(ttft_headroom=3.0,
                                     attainment_margin=0.5)])
def test_fit_gives_jax_policy(kw):
    ja = _jax()
    rows = _obs_rows()
    ours = fit([Observation(config=EngineConfig.from_dict(r["config"]),
                            **{k: v for k, v in r.items()
                               if k != "config"}) for r in rows], **kw)
    theirs = ja.fit([ja.Observation(
        config=ja.EngineConfig.from_dict(r["config"]),
        **{k: v for k, v in r.items() if k != "config"}) for r in rows],
        **kw)
    assert ours.to_dict() == theirs.to_dict()
    for load in (0.5, 2.0, 5.0, 50.0):
        assert ours.lookup(load).to_dict() == theirs.lookup(load).to_dict()
    # extraction of the same document
    doc = {"lines": rows + [{"config": {"bogus": 1}, "tok_s": 1.0}]}
    assert ([o.to_dict() for o in extract_observations(doc)]
            == [o.to_dict() for o in ja.extract_observations(doc)])


def _port_step_log(path: str) -> None:
    """A step log written by the port's engine: a few waves of the tiny
    model on the CPU, mixed and phase-split."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    for mixed in ("auto", "off"):
        with InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                             device="cpu", max_slots=2, max_seq_len=64,
                             kv_pages=8, kv_page_size=16,
                             cache_dtype=torch.float32, mixed_batch=mixed,
                             step_log=path) as eng:
            hs = [eng.submit([3 + i] * (5 + i), max_new_tokens=6)
                  for i in range(3)]
            assert all(h.wait(60) for h in hs)


def test_step_log_reads_as_jax_reads_it(tmp_path):
    ja = _jax()
    path = str(tmp_path / "steps.jsonl")
    _port_step_log(path)
    for window in (0.01, 0.05, 10.0):
        ours = observations_from_step_log(
            path, EngineConfig(slots=2, kv_pages=8), window_s=window)
        theirs = ja.observations_from_step_log(
            path, ja.EngineConfig(slots=2, kv_pages=8), window_s=window)
        assert ours and [o.to_dict() for o in ours] == [
            o.to_dict() for o in theirs]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "autotune_fit", TOOLS / "autotune_fit.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_fitter_cli_writes_the_jax_tools_policy(tmp_path, capsys):
    from cake_tpu_torch.tools import autotune_fit as ours
    theirs = _jax_tool()
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps({"autotune_observations": _obs_rows()}))
    log = str(tmp_path / "steps.jsonl")
    _port_step_log(log)
    cases = [
        ["--bench", str(bench)],
        ["--bench", str(bench), "--regimes", "2", "--no-guards"],
        ["--step-log", log, "--step-config",
         '{"slots": 2, "kv_pages": 8}', "--step-log", log,
         "--step-config", '{"slots": 4, "kv_pages": 8}', "--window",
         "0.02"],
    ]
    for i, argv in enumerate(cases):
        a, b = tmp_path / f"ours{i}.json", tmp_path / f"theirs{i}.json"
        assert ours.main(argv + ["--out", str(a)]) == 0
        assert theirs.main(argv + ["--out", str(b)]) == 0
        assert a.read_text() == b.read_text()
        PolicyTable.load(str(a))     # and it validates in the port
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    out = str(tmp_path / "x.json")
    for argv, code in (
            (["--bench", str(empty)], 1),                    # fit failed
            (["--step-log", log], 2),                        # no config
            (["--bench", str(tmp_path / "missing.json")], 2),
            (["--step-log", log, "--step-config", "{bad"], 2)):
        assert ours.main(argv + ["--out", out]) == code
        assert theirs.main(argv + ["--out", out]) == code
    capsys.readouterr()


# -- the controller, on a fake clock --------------------------------------

LO = dict(slots=8, kv_pages=64)
HI = dict(slots=32, kv_pages=64)
I8 = dict(slots=8, kv_pages=64, kv_dtype="int8")


def _pair(regimes, current, **kw):
    """The port's and JAX's controller over the same policy and config,
    each on its own fake clock."""
    ja = _jax()
    cfg = dict(interval_s=1.0, window=2, hold=2, cooldown_s=10.0,
               rollback_window=2, rollback_frac=0.7)
    cfg.update(kw)
    out = []
    for mod in (None, ja):
        E = EngineConfig if mod is None else mod.EngineConfig
        P = PolicyTable if mod is None else mod.PolicyTable
        C = AutotuneController if mod is None else mod.AutotuneController
        CC = ControllerConfig if mod is None else mod.ControllerConfig
        clock = [0.0]
        pol = P(regimes=[{"max_offered_rps": b, "config": E(**c)}
                         for b, c in regimes]).validate()
        out.append((C(pol, E(**current), config=CC(**cfg),
                      now_fn=lambda clock=clock: clock[0]), clock, mod))
    return out


def _drive(pair, script):
    """Run `script` (a list of ops) through both controllers; return
    their decision logs without wall-clock stamps and the decisions."""
    logs, decisions = [], []
    for ctl, clock, mod in pair:
        E = EngineConfig if mod is None else mod.EngineConfig
        S = AutotuneSignals if mod is None else mod.AutotuneSignals
        got = []
        for op in script:
            kind = op[0]
            if kind == "sig":
                _, t, kw = op
                clock[0] = t
                d = ctl.decide(S(t=t, **kw))
                got.append(None if d is None else (d[0].to_dict(), d[1]))
            elif kind == "switched":
                _, t, new, old, rate, reason = op
                clock[0] = t
                ctl.on_switched(E(**new), E(**old), rate, reason)
            elif kind == "pin":
                ctl.pin(E(**op[1]), why="refused")
            elif kind == "anomaly":
                _, k, state, allow = op
                got.append(ctl.note_anomaly(k, state, {"value": 1.0},
                                            allow_switch=allow))
        logs.append([{k: v for k, v in e.items() if k != "t"}
                     for e in ctl.decision_log()])
        st = ctl.state()
        st.pop("decisions")
        got.append(st)
        decisions.append(got)
    return logs, decisions


def _sig(t, rps, tps=100.0, **kw):
    return ("sig", float(t), dict(offered_rps=rps, service_tps=tps, **kw))


SCRIPTS = {
    # a one-window spike does not switch; sustained load does, once the
    # hold streak is met; then the cooldown holds every later proposal
    "hysteresis_cooldown": ([(5.0, LO), (None, HI)], LO, {}, [
        _sig(0, 1), _sig(1, 1), _sig(2, 50), _sig(3, 1), _sig(4, 50),
        _sig(5, 50), _sig(6, 50),
        ("switched", 6.5, HI, LO, 100.0, "auto"),
        _sig(7, 1, 300.0), _sig(8, 1, 300.0), _sig(9, 1, 300.0),
        _sig(17, 1, 300.0), _sig(18, 1, 300.0)]),
    # the guard reverts once after a collapse, pins HI, and never again
    "rollback_once_then_pin": ([(5.0, LO), (None, HI)], LO,
                               dict(hold=1, cooldown_s=0.0), [
        _sig(0, 50), ("switched", 0.1, HI, LO, 100.0, "auto"),
        _sig(1, 50, 10.0), _sig(2, 50, 10.0),
        ("switched", 2.1, LO, HI, 10.0, "rollback"),
        *[_sig(t, 50, 10.0) for t in range(3, 9)]]),
    # an improved rate: the guard accepts the switch
    "accepted": ([(5.0, LO), (None, HI)], LO,
                 dict(hold=1, cooldown_s=0.0), [
        _sig(0, 50), ("switched", 0.1, HI, LO, 100.0, "auto"),
        _sig(1, 50, 300.0), _sig(2, 50, 300.0), _sig(3, 50, 300.0)]),
    # an operator's switch arms no guard; a pinned target is never
    # proposed
    "manual_and_pin": ([(5.0, LO), (None, HI)], LO,
                       dict(hold=1, cooldown_s=0.0), [
        ("switched", 0.0, HI, LO, 100.0, "manual"),
        *[_sig(t, 50, 1.0) for t in range(1, 4)],
        _sig(4, 1), ("pin", LO), _sig(5, 1), _sig(6, 1)]),
    # a saturated int8 pool escalates to int4 through the hold streak
    "page_pressure": ([(None, I8)], I8,
                      dict(cooldown_s=0.0, rollback_frac=0.0), [
        *[("sig", float(t), dict(offered_rps=1.0, service_tps=100.0,
                                 pages_in_use_frac=f))
          for t, f in enumerate((0.5, 0.5, 1.0, 0.2, 0.99, 0.99, 0.99))],
        ("switched", 7.0, dict(I8, kv_dtype="int4"), I8, 100.0, "auto"),
        ("sig", 8.0, dict(offered_rps=1.0, service_tps=100.0,
                          pages_in_use_frac=0.99))]),
    # sentinel fusion: an anomaly holds new moves, a firing with the
    # guard armed pins the rollback, a rate-limited one only holds
    "note_anomaly": ([(5.0, LO), (None, HI)], LO,
                     dict(hold=1, cooldown_s=0.0, rollback_window=5), [
        ("anomaly", "recompile_storm", "fired", True),
        _sig(0, 50), _sig(1, 50),
        ("anomaly", "recompile_storm", "cleared", True),
        _sig(2, 50), ("switched", 2.5, HI, LO, 100.0, "auto"),
        ("anomaly", "step_time:decode", "fired", False),
        ("anomaly", "step_time:decode", "cleared", True),
        ("anomaly", "step_time:mixed", "fired", True),
        _sig(3, 50), ("switched", 3.5, LO, HI, 100.0, "rollback"),
        ("anomaly", "step_time:mixed", "cleared", True),
        _sig(4, 50), _sig(5, 50)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_controller_decisions_equal_jax(name):
    regimes, current, kw, script = SCRIPTS[name]
    logs, decisions = _drive(_pair(regimes, current, **kw), script)
    assert logs[0] == logs[1]
    assert decisions[0] == decisions[1]
    assert logs[0], "the script took no decision"


def test_config_info_gauge_tracks_the_live_config():
    from cake_tpu_torch.autotune import CONFIG_INFO, set_config_info
    set_config_info(EngineConfig(**LO))
    assert CONFIG_INFO.samples()[("slots=8",)] == 1.0
    set_config_info(EngineConfig(**HI))
    now = CONFIG_INFO.samples()
    assert now[("slots=32",)] == 1.0 and now[("slots=8",)] == 0.0
