"""The port's fault plane (`cake_tpu_torch/faults`) against the JAX
package's (`cake_tpu/faults`).

  * `FaultPlan.parse` gives JAX's rules (and their `describe()` echo) for
    a list of valid specs, and raises the same error classes for the
    invalid ones; the sites, triggers, error kinds and the abort exit
    code are JAX's.
  * For the same plan and seed, both injectors fire on the same calls,
    with the same kinds, over 1000 seeded calls at every site with
    `step` and `n_tokens` contexts; `describe()` is JAX's.
  * `abort` ends the process with ABORT_EXIT_CODE (in a subprocess).
  * `cake_fault_injections_total{site}` renders JAX's text after the
    same firings; a firing publishes `fault_injected` on the port's bus.
  * A plan naming a site the engine under test does not reach
    (control.publish: a paged engine takes no control channel; kv.ship,
    spec.verify) parses and never fires in the engine.
"""

import random
import subprocess
import sys
import time

import pytest

import torch

from cake_tpu_torch import faults as tfaults
from cake_tpu_torch.args import Args
from cake_tpu_torch.faults import injector as tinjector

VALID = [
    "seed=42;engine.decode:nth=12:transient",
    "engine.step:always:oom",
    "seed=7;engine.mixed:p=0.25:transient:times=5;pager.alloc:nth=3:oom",
    "engine.prefill:match_len=5:always:transient:times=9",
    "engine.decode:nth=2:wedge:secs=0.5",
    "engine.step:step=40:abort",
    "  seed=3 ; host_tier.fetch:p=1:transient ; host_tier.install:nth=1:oom",
    "journal.append:nth=4:transient;journal.fsync:always:oom:times=2",
    "journal.replay:nth=1:transient",
    "control.publish:p=0.01:oom;kv.ship:always:transient;spec.verify:"
    "always:transient:times=12",
    "",
    None,
]

INVALID = [
    "seed=1",
    "engine.step",
    "engine.nowhere:always:transient",
    "engine.step:always",
    "engine.step:transient",
    "engine.step:nth=0:transient",
    "engine.step:nth=x:transient",
    "engine.step:p=0:transient",
    "engine.step:p=1.5:transient",
    "engine.step:always=3:transient",
    "engine.step:always:nth=2:transient",
    "engine.step:always:transient:oom",
    "engine.step:always:transient=1",
    "engine.step:always:transient:times=0",
    "engine.step:always:transient:match_len=3",
    "engine.prefill:always:transient:match_len=-1",
    "engine.step:always:wedge:secs=-1",
    "engine.step:always:transient:bogus=1",
    "journal.append:step=3:transient",
    "seed=abc;engine.step:always:oom",
]


def _parse(mod, spec):
    try:
        plan = mod.FaultPlan.parse(spec)
    except Exception as e:  # noqa: BLE001
        return ("error", type(e).__name__)
    if plan is None:
        return None
    return (plan.seed, [tuple(vars(r).items()) for r in plan.rules],
            plan.describe())


@pytest.mark.parametrize("spec", VALID + INVALID)
def test_plan_parses_like_jax(spec):
    from cake_tpu import faults as jfaults
    want, got = _parse(jfaults, spec), _parse(tfaults, spec)
    assert got == want
    if spec in INVALID:
        assert got[0] == "error"


def test_plan_constants_are_jax():
    from cake_tpu import faults as jfaults
    from cake_tpu.faults import plan as jplan
    from cake_tpu_torch.faults import plan as tplan
    for name in ("SITES", "TRIGGERS", "ERRORS", "ABORT_EXIT_CODE"):
        assert getattr(tfaults, name) == getattr(jfaults, name), name
    assert tplan.NO_STEP_SITES == jplan.NO_STEP_SITES
    assert tplan.MATCH_LEN_SITES == jplan.MATCH_LEN_SITES
    for cls in ("InjectedFault", "InjectedTransient", "InjectedOOM",
                "InjectedWedge"):
        assert getattr(tfaults, cls).kind == getattr(jfaults, cls).kind
        assert issubclass(getattr(tfaults, cls), RuntimeError)


def _fire_trace(mod, spec, seed, n=1000):
    """n seeded calls at random sites with step and n_tokens contexts:
    the (call index, site, error class, message) of every firing, and the
    injector's describe()."""
    inj = mod.build_injector(spec)
    rng = random.Random(seed)
    sites = sorted(mod.SITES)
    out = []
    for i in range(n):
        site = rng.choice(sites)
        step = i // 3
        n_tok = rng.choice([3, 5, 8, 13])
        try:
            inj.check(site, step=step, n_tokens=n_tok)
        except mod.InjectedFault as e:
            out.append((i, site, type(e).__name__, str(e)))
    return out, inj.describe()


PLANS = [
    "seed=11;engine.decode:p=0.05:transient:times=20;"
    "engine.mixed:p=0.1:oom:times=7;pager.alloc:nth=5:transient",
    "seed=4;engine.prefill:match_len=5:p=0.5:transient:times=30;"
    "engine.step:step=100:oom:times=3;engine.step:nth=4:transient",
    "seed=99;host_tier.fetch:always:transient:times=9;"
    "journal.append:p=0.3:oom:times=40;engine.decode:nth=7:oom;"
    "engine.decode:nth=7:transient",
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_injectors_fire_on_the_same_calls(i):
    from cake_tpu import faults as jfaults
    want = _fire_trace(jfaults, PLANS[i], seed=i)
    got = _fire_trace(tfaults, PLANS[i], seed=i)
    assert got == want
    assert len(got[0]) >= 5


def test_wedge_holds_then_raises():
    from cake_tpu import faults as jfaults
    for mod in (jfaults, tfaults):
        inj = mod.build_injector("engine.decode:nth=2:wedge:secs=0.05")
        inj.check("engine.decode", step=0)
        t0 = time.perf_counter()
        with pytest.raises(mod.InjectedWedge, match="held 0.05s"):
            inj.check("engine.decode", step=1)
        assert time.perf_counter() - t0 >= 0.05
        inj.check("engine.decode", step=2)       # times=1: spent


def test_abort_exits_with_the_abort_code():
    code = ("from cake_tpu_torch.faults import build_injector; "
            "build_injector('engine.step:nth=2:abort')"
            ".check('engine.step', step=0); print('first', flush=True); "
            "build_injector('engine.step:nth=1:abort')"
            ".check('engine.step', step=0); print('never')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=str(__import__("pathlib").Path(__file__)
                               .resolve().parent.parent))
    assert r.returncode == tfaults.ABORT_EXIT_CODE == 86
    assert "first" in r.stdout and "never" not in r.stdout


def test_injection_family_renders_jax_text(monkeypatch):
    from cake_tpu import faults as jfaults
    from cake_tpu.faults import injector as jinjector
    from cake_tpu.obs import metrics as jmetrics
    from cake_tpu_torch.obs import metrics as tmetrics

    regs = []
    for mod, m in ((jinjector, jmetrics), (tinjector, tmetrics)):
        reg = m.Registry()
        fam = mod._INJECTIONS
        monkeypatch.setattr(mod, "_INJECTIONS", m.counter(
            fam.name, fam.help, fam.labelnames, registry=reg))
        regs.append(reg)
    for mod in (jfaults, tfaults):
        _fire_trace(mod, PLANS[0], seed=0, n=300)
    text = regs[1].render()
    assert text == regs[0].render()
    assert 'cake_fault_injections_total{site="engine.decode"}' in text


def test_firing_publishes_on_the_ports_bus():
    from cake_tpu_torch.obs.events import EventBus
    inj = tfaults.build_injector("seed=1;pager.alloc:nth=2:oom")
    inj.events = EventBus(capacity=16)
    inj.check("pager.alloc", step=3)
    with pytest.raises(tfaults.InjectedOOM, match="RESOURCE_EXHAUSTED"):
        inj.check("pager.alloc", step=4)
    (ev,) = inj.events.dump(type="fault_injected")
    assert (ev["site"], ev["kind"], ev["call"], ev["step"]) == \
        ("pager.alloc", "oom", 2, 4)
    assert inj.describe() == {"plan": "seed=1;pager.alloc:nth=2:oom:times=1",
                              "injections_total": 1,
                              "injections_by_site": {"pager.alloc": 1}}
    assert tfaults.build_injector(None) is None
    assert tfaults.build_injector(" ") is None


def test_args_validate_the_plan_and_the_fsync_mode():
    Args(fault_plan="seed=1;engine.step:always:oom",
         journal_fsync="always").validate()
    with pytest.raises(ValueError, match="unknown site"):
        Args(fault_plan="engine.nowhere:always:oom").validate()
    with pytest.raises(ValueError, match="journal_fsync"):
        Args(journal_fsync="sometimes").validate()


def test_sites_without_port_code_parse_and_never_fire():
    """control.*, kv.* and spec.verify rules (code the port does not have
    yet) are accepted by the engine's plan and never fire: the stream is
    the one an engine without a plan gives."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    outs = []
    for plan in (None, "seed=1;control.publish:always:transient;"
                 "control.recv:always:oom;kv.ship:always:transient;"
                 "kv.adopt:always:oom;spec.verify:always:transient"):
        eng = InferenceEngine(
            cfg, params, ByteTokenizer(cfg.vocab_size), device="cpu",
            max_slots=2, max_seq_len=64, kv_pages=8, kv_page_size=16,
            sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
            cache_dtype=torch.float32, fault_plan=plan, recovery=True)
        with eng:
            h = eng.submit([3, 1, 4, 1, 5], max_new_tokens=6)
            assert h.wait(timeout=120)
        outs.append(list(h._req.out_tokens))
        assert eng.stats.recoveries == 0 and h._req.error is None
        if plan is not None:
            assert eng._faults.describe()["injections_total"] == 0
    assert outs[0] == outs[1]
