"""The port's anomaly sentinel (`cake_tpu_torch/obs/sentinel.py`) against
the JAX package's (`cake_tpu/obs/sentinel.py`), its engine side.

  * each detector kind, fed the same synthetic windows, fires and clears
    at the same ticks as JAX's, with the same cause blocks;
  * `attach_engine_sentinel` builds JAX's detector set, and over
    identical synthetic flight records, bus events and SLO outcomes the
    two sets take the same transitions (recompile storm, shed storm,
    attainment collapse, step-time regression after calibration);
  * over a port engine: the detectors read its rings (its graph
    captures count as recompiles) with no new instrumentation, and the
    sentinel ticks on its thread between start() and stop();
  * the calibrated baselines go through the checkpoint snapshot and a
    resume into a fresh engine, which adopts them.
"""

import time

import pytest

import torch

from cake_tpu_torch.obs import sentinel as ours


def _theirs():
    from cake_tpu.obs import sentinel
    return sentinel


def _strip(trs):
    return [(t["kind"], t["state"], t["cause"]) for t in trs]


DETECTORS = {
    "threshold_above": (lambda m: m.ThresholdDetector(
        "shed_storm", 5.0, fire_after=2, clear_after=3),
        [9, 9, 9, 0, 9, 0, 0, 0, 9, 0, 9, 9]),
    "threshold_below": (lambda m: m.ThresholdDetector(
        "attainment:interactive", 0.5, mode="below", fire_after=1,
        clear_after=2), [0.9, 0.2, 0.6, 0.1, 0.7, 0.8, 0.9]),
    "baseline_above": (lambda m: m.BaselineDetector(
        "step_time:decode", ratio=3.0, calibrate_n=4, min_baseline=1e-4),
        [0.01, 0.012, 0.011, 0.01, 0.02, 0.05, 0.06, 0.01, 0.01, 0.01]),
    "baseline_below": (lambda m: m.BaselineDetector(
        "affinity", ratio=0.5, calibrate_n=3, mode="below",
        fire_after=1), [0.9, 0.8, 0.85, 0.3, 0.2, 0.9, 0.9, 0.9]),
    "baseline_floor": (lambda m: m.BaselineDetector(
        "step_time:mixed", ratio=3.0, calibrate_n=3, min_baseline=0.01),
        [1e-6, 1e-6, 1e-6, 0.02, 0.02, 0.05, 0.05]),
}


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detectors_fire_and_clear_as_jax_does(name):
    make, values = DETECTORS[name]
    runs = []
    for mod in (ours, _theirs()):
        det = make(mod)
        got = [det.observe(float(v), float(i))
               for i, v in enumerate(values)]
        runs.append((got, det.state(), det.evidence_window()))
    assert runs[0] == runs[1]
    assert any(g is not None for g in runs[0][0])


class _FakeEngine:
    """The three seams attach_engine_sentinel reads, of one package."""

    def __init__(self, port: bool):
        if port:
            from cake_tpu_torch.obs.events import EventBus
            from cake_tpu_torch.obs.slo import SLOAccountant
            from cake_tpu_torch.obs.steps import StepTelemetry
            self.flight = StepTelemetry(impl="fake", capacity=256)
        else:
            from cake_tpu.obs.events import EventBus
            from cake_tpu.obs.slo import SLOAccountant
            from cake_tpu.obs.steps import StepTelemetry
            self.flight = StepTelemetry(impl="fake", capacity=256,
                                        key_prefix=("sentinel-test",))
        self.events = EventBus(observe_metrics=False)
        self.slo = SLOAccountant(observe_metrics=False)


def _window(eng, i: int) -> None:
    """Window i of a scripted run: calm decode steps, then a capture
    storm, a shed burst with collapsing interactive attainment, a 5x
    decode slowdown, then calm again."""
    slow = 0.05 if 8 <= i < 11 else 0.01
    for _ in range(6):
        eng.flight.record("decode", rows=2, tokens=2, wall_s=slow)
        eng.flight.record("mixed", rows=2, tokens=1, wall_s=0.02)
    if 3 <= i < 5:
        for _ in range(4):
            eng.flight.record("mixed", rows=1, tokens=1, wall_s=0.4,
                              compiled=True)
    if 5 <= i < 7:
        for r in range(6):
            eng.events.publish("shed", rid=100 * i + r, priority="batch")
        for _ in range(4):
            eng.slo.observe("interactive", ttft_s=10.0, e2e_s=100.0,
                            tokens=4)
    elif i >= 7:
        for _ in range(12):
            eng.slo.observe("interactive", ttft_s=0.01, e2e_s=0.1,
                            tokens=4)


def test_engine_detector_sets_take_jax_transitions():
    runs = []
    for port, mod in ((True, ours), (False, _theirs())):
        eng = _FakeEngine(port)
        sen = mod.attach_engine_sentinel(eng, interval_s=1.0)
        trs = []
        for i in range(16):
            _window(eng, i)
            trs.append(_strip(sen.tick(now=float(i))))
        st = sen.state()
        runs.append((trs, [d["kind"] for d in st["detectors"]],
                     sen.export_baselines()))
    assert runs[0] == runs[1]
    fired = {k for w in runs[0][0] for k, s, _ in w if s == "fired"}
    assert {"recompile_storm", "shed_storm", "attainment:interactive",
            "step_time:decode"} <= fired


def _port_engine(**kw):
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                           device="cpu", max_slots=2, max_seq_len=64,
                           kv_pages=8, kv_page_size=16,
                           cache_dtype=torch.float32, **kw)


def test_attach_over_a_port_engine():
    eng = _port_engine(sentinel=True, sentinel_interval=0.05)
    sen = eng.sentinel
    assert isinstance(sen, ours.Sentinel) and sen.interval_s == 0.05
    with eng:
        assert sen._thread is not None
        hs = [eng.submit([3 + i] * 7, max_new_tokens=5) for i in range(3)]
        assert all(h.wait(60) for h in hs)
        deadline = time.monotonic() + 10
        while sen.state()["ticks"] < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
    assert sen._thread is None          # stop() closed it
    assert sen.active_count == 0
    # the engine's captures are the recompile source's input: three
    # capture records in each of two windows fire the storm
    for _ in range(2):
        for _ in range(3):
            eng.flight.record("decode", rows=1, tokens=1, wall_s=0.3,
                              compiled=True)
        sen.tick()
    st = sen.state()
    assert st["ticks"] >= 5
    assert [a["kind"] for a in st["active"]] == ["recompile_storm"]
    assert sen.fired_total == 1
    evs = eng.events.dump(type="anomaly")
    assert evs and evs[-1]["state"] == "fired"


def test_baselines_go_through_a_snapshot_and_a_resume():
    from cake_tpu_torch.serve import checkpoint

    eng = _port_engine(sentinel=True)
    sen = eng.sentinel
    for _ in range(6):
        for _ in range(6):
            eng.flight.record("decode", rows=1, tokens=1, wall_s=0.02)
        sen.tick()
    base = sen.export_baselines()
    assert base["step_time:decode"]["baseline"] == pytest.approx(0.02)
    snap = checkpoint.snapshot(eng)
    assert snap["sentinel_baselines"] == base
    assert snap["engine_config"]["kv_pages"] == 8
    assert snap["config_epoch"] == 0
    fresh = _port_engine(sentinel=True)
    assert fresh.sentinel.export_baselines() == {}
    with fresh:
        checkpoint.resume(fresh, snap)
    assert fresh.sentinel.export_baselines() == base
    # a mismatched mode or a non-positive value is not adopted
    other = _port_engine(sentinel=True)
    assert other.sentinel.restore_baselines({
        "step_time:decode": {"baseline": 0.02, "mode": "below"},
        "step_time:mixed": {"baseline": 0.0, "mode": "above"}}) == 0
