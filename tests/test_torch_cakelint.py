"""The port's cakelint (`cake_tpu_torch/analysis`,
`python -m cake_tpu_torch.tools.cakelint`) against JAX's, and as the
port's own tree gate.

  * Over `cake_tpu/`, the port's analyzer gives JAX's report for the
    three shared rules (affinity, guards, locks): findings, sites,
    suppressed counts and fingerprints, on the tree as it stands and on
    a copy whose suppressions are stripped (so there are findings to
    fingerprint). The one meta finding that differs is named below: a
    `skip[jit-purity]` is an unknown rule to the port, whose fourth rule
    is `capture-purity`.
  * JAX's checker matrix, suppression and baseline cases give JAX's
    results through the port's analyzer and command line.
  * A `capture-purity` matrix over `_Graphs` runners.
  * THE tree gate: `python -m cake_tpu_torch.tools.cakelint
    cake_tpu_torch/ --json` exits 0 with more than 0 sites for each of
    the four rules.
  * The runtime backstop: with CAKE_THREAD_ASSERTS armed (conftest), a
    cross-thread call to a decorated port engine method raises
    WrongThreadError.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("affinity", "guards", "locks")


def _port(paths, rules=None, baseline=None):
    from cake_tpu_torch.analysis import core
    return core.analyze([str(p) for p in paths], rules=rules,
                        baseline=baseline)


def _jax(paths, rules=None, baseline=None):
    from cake_tpu.analysis import core
    return core.analyze([str(p) for p in paths], rules=rules,
                        baseline=baseline)


def _fixtures():
    """JAX's fixture snippets (tests/test_cakelint.py)."""
    import test_cakelint as jt
    return jt


@pytest.fixture(scope="module")
def jax_tree_reports(tmp_path_factory):
    """Both analyzers over cake_tpu/ and over a copy of it whose
    `cakelint: skip` comments are stripped, the three shared rules."""
    stripped = tmp_path_factory.mktemp("strip") / "cake_tpu"
    shutil.copytree(os.path.join(REPO, "cake_tpu"), stripped,
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "*.so", "*.cpp"))
    for root, _, files in os.walk(stripped):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(root, f)
                src = open(p).read()
                open(p, "w").write(src.replace("# cakelint: skip[",
                                               "# was: skip["))
    out = {}
    for name, tree in (("tree", os.path.join(REPO, "cake_tpu")),
                       ("stripped", stripped)):
        out[name] = (_jax([tree], rules=list(SHARED)),
                     _port([tree], rules=list(SHARED)))
    return out


@pytest.mark.parametrize("which", ["tree", "stripped"])
@pytest.mark.parametrize("rule", SHARED)
def test_port_gives_jaxs_report_over_cake_tpu(jax_tree_reports, which,
                                              rule):
    j, p = jax_tree_reports[which]
    assert p["sites"][rule] == j["sites"][rule] > 0
    assert p["files"] == j["files"]
    jf = [(f.to_dict(), fp) for f, fp in zip(j["findings"],
                                              j["fingerprints"])
          if f.rule == rule]
    pf = [(f.to_dict(), fp) for f, fp in zip(p["findings"],
                                              p["fingerprints"])
          if f.rule == rule]
    assert pf == jf
    assert p["counts"].get(rule) == j["counts"].get(rule)
    assert p["suppressed"] == j["suppressed"]
    # no meta finding (parse, bad-suppression) on either side
    assert [f for f in p["findings"] if f.rule not in SHARED] == \
        [f for f in j["findings"] if f.rule not in SHARED] == []
    if which == "tree":
        assert j["findings"] == [] and j["suppressed"] >= 9
    elif rule == "affinity":
        # every skip the tree honours is a finding again once stripped,
        # fingerprinted alike
        assert len(pf) == jax_tree_reports["tree"][0]["suppressed"] >= 9
        assert p["suppressed"] == 0


def test_the_fourth_rules_name_is_the_one_meta_difference(tmp_path):
    """A `skip[jit-purity]` JAX honours is an unknown rule to the port
    (its fourth rule is `capture-purity`), and the reverse."""
    p = tmp_path / "s.py"
    p.write_text("x = 1  # cakelint: skip[jit-purity] a reason\n"
                 "y = 2  # cakelint: skip[capture-purity] a reason\n")
    j, q = _jax([p]), _port([p])
    jbad = [f.message for f in j["findings"] if f.rule == "bad-suppression"]
    qbad = [f.message for f in q["findings"] if f.rule == "bad-suppression"]
    assert len(jbad) == len(qbad) == 1
    assert "capture-purity" in jbad[0] and "jit-purity" in qbad[0]


# -- JAX's checker matrix and core contracts, through the port ---------------


@pytest.mark.parametrize("rule,n_bad", [("affinity", 3), ("guards", 1),
                                        ("locks", 3)])
def test_checker_matrix_is_jaxs(tmp_path, rule, n_bad):
    jt = _fixtures()
    clean, bad = {"affinity": (jt.AFFINITY_CLEAN, jt.AFFINITY_BAD),
                  "guards": (jt.GUARDS_CLEAN, jt.GUARDS_BAD),
                  "locks": (jt.LOCKS_CLEAN, jt.LOCKS_BAD)}[rule]
    p = tmp_path / "clean.py"
    p.write_text(clean)
    rep, jrep = _port([p], rules=[rule]), _jax([p], rules=[rule])
    assert rep["findings"] == [] and rep["sites"] == jrep["sites"]
    assert rep["sites"][rule] > 0

    p = tmp_path / "bad.py"
    p.write_text(bad)
    rep, jrep = _port([p], rules=[rule]), _jax([p], rules=[rule])
    assert len(rep["findings"]) == n_bad
    assert [f.to_dict() for f in rep["findings"]] == \
        [f.to_dict() for f in jrep["findings"]]
    assert rep["fingerprints"] == jrep["fingerprints"]

    lines = bad.splitlines()
    for f in sorted(rep["findings"], key=lambda f: -f.line):
        lines[f.line - 1] += f"  # cakelint: skip[{rule}] test reason"
    p = tmp_path / "suppressed.py"
    p.write_text("\n".join(lines))
    rep = _port([p], rules=[rule])
    assert rep["findings"] == [] and rep["suppressed"] == n_bad


@pytest.mark.parametrize("case", [
    "closure", "foreign", "reasonless", "unknown_rule", "previous_line",
    "parse_error"])
def test_core_cases_are_jaxs(tmp_path, case):
    jt = _fixtures()
    rules = None
    if case == "closure":
        src = {"c.py": '''
class Eng:
    ENGINE_THREAD_ATTRS = {"_pager": "_switch_lock"}
    HANDLER_THREAD_METHODS = ("submit",)

    def submit(self):
        with self._switch_lock:
            cb = lambda: self._pager.free_pages
        def later():
            return self._pager.free_pages
        with self._switch_lock:
            return cb, later
'''}
        rules = ["affinity"]
    elif case == "foreign":
        src = {"eng.py": jt.AFFINITY_CLEAN, "scrape.py": jt.AFFINITY_FOREIGN}
        rules = ["affinity"]
    elif case == "reasonless":
        src = {"s.py": jt.GUARDS_BAD.replace(
            'self._bus.publish("x")',
            'self._bus.publish("x")  # cakelint: skip[guards]')}
    elif case == "unknown_rule":
        src = {"s.py": "x = 1  # cakelint: skip[bogus-rule] because\n"}
    elif case == "previous_line":
        src = {"s.py": jt.GUARDS_BAD.replace(
            '        self._bus.publish("x")',
            '        # cakelint: skip[guards] long reason on its own line\n'
            '        self._bus.publish("x")')}
        rules = ["guards"]
    else:
        src = {"broken.py": "def f(:\n"}
    for name, text in src.items():
        (tmp_path / name).write_text(text)
    rep, jrep = _port([tmp_path], rules=rules), _jax([tmp_path], rules=rules)
    got = [f.to_dict() for f in rep["findings"]]
    want = [f.to_dict() for f in jrep["findings"]]
    if case == "unknown_rule":
        # the meta finding that differs only by the fourth rule's name:
        # its message lists the known rules
        for f in want:
            f["message"] = f["message"].replace("jit-purity",
                                                "capture-purity")
        assert len(got) == 1 and got[0]["rule"] == "bad-suppression"
    assert got == want
    assert rep["fingerprints"] == jrep["fingerprints"]
    assert rep["suppressed"] == jrep["suppressed"]
    assert rep["findings"] or rep["suppressed"]


def test_baselines_are_jaxs(tmp_path, monkeypatch):
    """A baseline is content-addressed: one written by JAX's analyzer
    masks the port's findings and the reverse, from any path spelling;
    a new finding is not masked."""
    from cake_tpu.analysis import core as jcore
    from cake_tpu_torch.analysis import core
    jt = _fixtures()
    d = tmp_path / "pkg"
    d.mkdir()
    (d / "bad.py").write_text(jt.GUARDS_BAD)
    monkeypatch.chdir(tmp_path)
    rep = _port(["pkg"], rules=["guards"])
    assert len(rep["findings"]) == 1
    core.write_baseline("p.json", rep["fingerprints"])
    jcore.write_baseline("j.json", _jax(["pkg"], rules=["guards"])[
        "fingerprints"])
    assert open("p.json").read() == open("j.json").read()
    for spelling in ("./pkg", str(d), "pkg/bad.py"):
        for load in (core.load_baseline, jcore.load_baseline):
            rep2 = _port([spelling], rules=["guards"],
                         baseline=load("j.json"))
            assert rep2["findings"] == [] and rep2["baselined"] == 1
    (d / "bad.py").write_text(jt.GUARDS_BAD + "\n    def bad2(self):\n"
                              "        self._bus.close()\n")
    rep3 = _port(["pkg"], rules=["guards"],
                 baseline=core.load_baseline("p.json"))
    assert len(rep3["findings"]) == 1
    assert rep3["findings"][0].symbol.endswith("bad2")


def test_cli_json_schema_and_exit_codes_are_jaxs(tmp_path, capsys):
    from cake_tpu_torch.tools import cakelint as cli
    jt = _fixtures()
    jcli = jt._cli()
    bad = tmp_path / "bad.py"
    bad.write_text(jt.GUARDS_BAD)
    assert cli.main([str(bad), "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert jcli.main([str(bad), "--json"]) == 1
    jout = json.loads(capsys.readouterr().out)
    assert set(out) == set(jout)
    assert set(out["sites"]) == {"affinity", "guards", "locks",
                                 "capture-purity"}
    out["sites"].pop("capture-purity")
    jout["sites"].pop("jit-purity")
    assert out == jout
    clean = tmp_path / "clean.py"
    clean.write_text(jt.GUARDS_CLEAN)
    assert cli.main([str(clean)]) == 0
    assert cli.main([str(clean), "--rules", "nonsense"]) == 2
    assert cli.main([str(tmp_path / "missing.py")]) == 2
    base = tmp_path / "b.json"
    assert cli.main([str(bad), "--write-baseline", str(base)]) == 0
    assert cli.main([str(bad), "--baseline", str(base)]) == 0
    capsys.readouterr()


# -- capture-purity ---------------------------------------------------------

PURITY_CLEAN = '''
import torch

class _Graphs:
    pass

class Runner(_Graphs):
    def step(self, x, out):
        on_replay(lambda: print(out.item()))
        def cut():
            return x.cpu()
        segment_cut(cut)
        out.copy_(torch.softmax(x, -1))
        self.out = out
        return out

    def _idle(self):
        self.buf.zero_()

    def fetch(self):
        return self.out.tolist()

class NotARunner:
    def step(self, x):
        return x.item()
'''

PURITY_BAD = '''
import random
import time
import numpy as np
import torch
from serve.graphs import _Graphs

class Runner(_Graphs):
    def step(self, x):
        n = x.sum().item()
        torch.cuda.synchronize()
        print(n)
        t = time.perf_counter()
        return x.cpu(), x.tolist(), x.numpy()

class Derived(Runner):
    def _idle(self):
        global COUNT
        self.s = np.random.rand(3)
        return random.random()
'''


def test_capture_purity_matrix(tmp_path):
    p = tmp_path / "clean.py"
    p.write_text(PURITY_CLEAN)
    rep = _port([p], rules=["capture-purity"])
    assert rep["findings"] == [], [f.message for f in rep["findings"]]
    assert rep["sites"]["capture-purity"] == 2

    p = tmp_path / "bad.py"
    p.write_text(PURITY_BAD)
    rep = _port([p], rules=["capture-purity"])
    msgs = [f"{f.line}: {f.message}" for f in rep["findings"]]
    assert len(msgs) == 10, msgs
    assert rep["sites"]["capture-purity"] == 2
    for what in (".item()", "synchronize()", "print()", "time.perf_counter",
                 ".cpu()", ".tolist()", ".numpy()", "global COUNT",
                 "np.random.rand", "random.random"):
        assert any(what in m for m in msgs), what
    assert {f.symbol for f in rep["findings"]} == {"Runner.step",
                                                   "Derived._idle"}
    lines = PURITY_BAD.splitlines()
    for f in sorted(rep["findings"], key=lambda f: -f.line):
        if "skip[" not in lines[f.line - 1]:
            lines[f.line - 1] += "  # cakelint: skip[capture-purity] test"
    p.write_text("\n".join(lines))
    rep = _port([p], rules=["capture-purity"])
    assert rep["findings"] == [] and rep["suppressed"] == 10


# -- THE tree gate -------------------------------------------------------------


def test_cakelint_tree_gate():
    """`python -m cake_tpu_torch.tools.cakelint cake_tpu_torch/ --json`
    exits 0, with every one of the four rules live (more than 0 sites)
    over the port's declarations and runners."""
    proc = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.tools.cakelint",
         "cake_tpu_torch/", "--json"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    out = json.loads(proc.stdout)
    print(json.dumps({"cakelint": {k: out[k] for k in (
        "files", "sites", "counts", "suppressed")}}))
    assert proc.returncode == 0, out["findings"]
    assert set(out["sites"]) == {"affinity", "guards", "locks",
                                 "capture-purity"}
    for rule, n in out["sites"].items():
        assert n > 0, f"{rule} saw zero sites on cake_tpu_torch/"
    assert out["suppressed"] >= 5


# -- the runtime backstop ------------------------------------------------------


def _engine(**kw):
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq_len", 32)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, **kw)


def test_cross_thread_touch_raises():
    """JAX's test_cross_thread_touch_raises over the port's engine: with
    the asserts armed a cross-thread call into an @engine_thread_only
    method raises while the engine thread is alive, passes when routed
    through _run_on_engine_thread, and passes again once the thread is
    gone (the inline teardown of stop()/cancel())."""
    from cake_tpu_torch.analysis import (
        WrongThreadError, thread_asserts_enabled,
    )
    from cake_tpu_torch.analysis.annotations import MARKER
    from cake_tpu_torch.serve.engine import InferenceEngine
    assert thread_asserts_enabled(), \
        "tier-1 must run with CAKE_THREAD_ASSERTS armed (conftest)"
    for name in ("_register_prefix_paged", "_drain_commands",
                 "_unregister_paged_sync", "_drain_cancellations",
                 "_reconfigure_sync", "_autotune_tick", "_maybe_preempt",
                 "_spill_resident_stream", "_do_prefill_batch", "_do_mixed",
                 "_do_decode_spec", "_do_spec_paged", "_do_decode"):
        assert getattr(getattr(InferenceEngine, name), MARKER, False), name
    eng = _engine(kv_pages=8, kv_page_size=8)
    eng.start()
    try:
        with pytest.raises(WrongThreadError):
            eng._drain_commands()
        with pytest.raises(WrongThreadError):
            eng._maybe_preempt()
        assert eng._run_on_engine_thread(
            lambda: (eng._drain_commands(), "ran")[1]) == "ran"
    finally:
        eng.stop()
    eng._drain_commands()


def test_scrape_page_gauges_respect_admit_lock_nonblocking():
    """refresh_page_gauges reads the pager under the engine's _admit_lock
    (the lock a live switch holds) through a non-blocking acquire: a
    held lock leaves the gauges as they were instead of hanging."""
    from cake_tpu_torch.obs import metrics as m
    from cake_tpu_torch.obs import steps as obs_steps
    eng = _engine(kv_pages=8, kv_page_size=8)
    free_g = m.gauge("cake_engine_kv_pages_free", "KV pages currently free")
    obs_steps.refresh_page_gauges(eng)
    real_free = free_g.value
    free_g.set(-1)
    with eng._admit_lock:
        done = threading.Event()
        t = threading.Thread(target=lambda: (
            obs_steps.refresh_page_gauges(eng), done.set()), daemon=True)
        t.start()
        assert done.wait(5.0), "refresh_page_gauges hung on _admit_lock"
        assert free_g.value == -1
    obs_steps.refresh_page_gauges(eng)
    assert free_g.value == real_free


def test_register_prefix_validates_page_size_under_admit_lock():
    eng = _engine(kv_pages=8, kv_page_size=8)
    done = threading.Event()
    out = {}

    def register():
        out["pid"] = eng.register_prefix(list(range(1, 17)))
        done.set()

    t = threading.Thread(target=register, daemon=True)
    with eng._admit_lock:
        t.start()
        time.sleep(0.15)
        assert not done.is_set(), \
            "register_prefix read the pager during a switch"
    assert done.wait(10.0), "registration never completed"
    assert out["pid"] >= 1
