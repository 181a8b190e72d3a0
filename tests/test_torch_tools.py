"""The port's host-only tools and debug helpers against the JAX
package's.

  * `cake_tpu_torch.tools.split_model` writes JAX's `cake-split-model`
    bundles byte for byte on the same checkpoint and topology, and
    refuses a node whose layers match nothing as JAX does.
  * `cake_tpu_torch.tools.journal_check` gives the JAX tool's rc, text
    and `--json` document on a journal from each package's engine, and
    on a torn and a corrupt one.
  * `utils/debug`: `panic_on_nan` and `checked` raise on a NaN and pass
    a clean tensor through; `checked` refuses inside a CUDA-graph
    capture (a `cuda` case).
  * `utils/profiling`: `annotate` is a named span of a torch.profiler
    trace; `log_memory` runs at "model loaded" and "engine start" and
    logs nothing on the CPU.
"""

import importlib.util
import io
import json
import logging
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY = """\
front:
  host: 10.0.0.1:10128
  description: first half
  layers:
    - model.layers.0-1
back:
  host: 10.0.0.2:10128
  description: second half
  layers:
    - model.layers.2-3
"""


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- split_model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A 4-layer HF-style checkpoint over two files (bf16 blocks, f32
    embeddings and norms), with its config and tokenizer files."""
    from cake_tpu_torch.utils.loading import save_safetensors
    d = tmp_path_factory.mktemp("ckpt")
    g = torch.Generator().manual_seed(5)
    first, second = {}, {}
    for i in range(4):
        dst = first if i < 2 else second
        dst[f"model.layers.{i}.self_attn.q_proj.weight"] = torch.randn(
            16, 16, generator=g).to(torch.bfloat16)
        dst[f"model.layers.{i}.mlp.up_proj.weight"] = torch.randn(
            24, 16, generator=g).to(torch.bfloat16)
        dst[f"model.layers.{i}.input_layernorm.weight"] = np.ones(
            16, np.float32)
    first["model.embed_tokens.weight"] = np.arange(
        64 * 16, dtype=np.float32).reshape(64, 16)
    second["model.norm.weight"] = np.ones(16, np.float32)
    second["lm_head.weight"] = np.full((64, 16), 0.5, np.float16)
    save_safetensors(str(d / "model-00001-of-00002.safetensors"), first)
    save_safetensors(str(d / "model-00002-of-00002.safetensors"), second)
    wm = {k: "model-00001-of-00002.safetensors" for k in first}
    wm.update({k: "model-00002-of-00002.safetensors" for k in second})
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": wm}))
    (d / "config.json").write_text('{"num_hidden_layers": 4}')
    (d / "tokenizer.json").write_text('{"model": {}}')
    topo = d / "topology.yml"
    topo.write_text(TOPOLOGY)
    return str(d), str(topo)


def _tree_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_split_model_bundles_are_jaxs(checkpoint, tmp_path):
    from cake_tpu.tools.split_model import split_model as j_split
    from cake_tpu_torch.tools.split_model import main, split_model

    d, topo = checkpoint
    got = split_model(d, topo, str(tmp_path / "port"))
    want = j_split(d, topo, str(tmp_path / "jax"))
    assert [(n, c) for n, _, c in got] == [(n, c) for n, _, c in want] == \
        [("front", 9), ("back", 6)]
    port, jax_ = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(port) == sorted(jax_)
    assert "front-node/model/reduced.safetensors" in port
    assert "back-node/topology.yml" in port
    for k in port:
        assert port[k] == jax_[k], k
    # the command line writes the same bundles
    assert main(["--model-path", d, "--topology", topo,
                 "--output", str(tmp_path / "cli")]) == 0
    assert _tree_bytes(tmp_path / "cli") == port


def test_split_model_unknown_layers_raise_as_in_jax(checkpoint, tmp_path):
    from cake_tpu.tools.split_model import split_model as j_split
    from cake_tpu_torch.tools.split_model import split_model

    d, _ = checkpoint
    topo = tmp_path / "t.yml"
    # the first node also takes the shared tensors: the second one
    # matches nothing
    topo.write_text(TOPOLOGY.split("back:")[0]
                    + "ghost:\n  host: h:1\n  description: none\n"
                    "  layers:\n    - model.layers.7-9\n")
    with pytest.raises(ValueError) as want:
        j_split(d, str(topo), str(tmp_path / "jax"))
    with pytest.raises(ValueError) as got:
        split_model(d, str(topo), str(tmp_path / "port"))
    assert str(got.value) == str(want.value)


# -- journal_check --------------------------------------------------------------


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """A journal written by each package's engine (two retired requests
    and one cancelled), plus a torn and a corrupt copy of the port's."""
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine
    import jax

    d = tmp_path_factory.mktemp("journals")
    jc = JConfig.tiny(num_hidden_layers=1)
    tc = LlamaConfig.tiny(num_hidden_layers=1)

    def drive(eng):
        with eng:
            a = eng.submit([5] * 7, max_new_tokens=4, temperature=0.0)
            b = eng.submit([3, 4, 5], max_new_tokens=3, temperature=0.0,
                           idempotency_key="key-b")
            assert a.wait(120) and b.wait(120)
            c = eng.submit([9] * 5, max_new_tokens=40, temperature=0.0)
            eng.cancel(c)
            assert c.wait(120)

    out = {}
    out["jax"] = str(d / "jax.journal")
    drive(JEngine(jc, j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32),
                  JTok(jc.vocab_size), max_slots=2, max_seq_len=64,
                  sampling=JSampling(temperature=0.0), kv_pages=8,
                  kv_page_size=16, paged_attn="fold",
                  cache_dtype=jnp.float32, journal=out["jax"]))
    out["port"] = str(d / "port.journal")
    drive(InferenceEngine(
        tc, init_params(tc, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32),
        ByteTokenizer(tc.vocab_size), device="cpu", max_slots=2,
        max_seq_len=64, kv_pages=8, kv_page_size=16,
        sampling=SamplingConfig(temperature=0.0),
        cache_dtype=torch.float32, journal=out["port"]))
    lines = open(out["port"]).read().splitlines(keepends=True)
    assert len(lines) >= 4
    out["torn"] = str(d / "torn.journal")
    open(out["torn"], "w").write("".join(lines) + lines[-1][:7])
    out["corrupt"] = str(d / "corrupt.journal")
    open(out["corrupt"], "w").write(
        "".join(lines[:2]) + "{not json\n" + "".join(lines[2:]))
    out["gap"] = str(d / "gap.journal")
    open(out["gap"], "w").write("".join(
        ln for ln in lines if '"emit"' not in ln or '"n": 1' in ln
        or '"n":1' in ln))
    return out


@pytest.mark.parametrize("which", ["jax", "port", "torn", "corrupt", "gap"])
def test_journal_check_is_the_jax_tools(journals, which, capsys):
    from cake_tpu_torch.tools import journal_check as port_tool

    jtool = _tool("journal_check")
    path = journals[which]
    for as_json in (True, False):
        jbuf, pbuf = io.StringIO(), io.StringIO()
        jrc = jtool.check(path, as_json=as_json, out=jbuf)
        prc = port_tool.check(path, as_json=as_json, out=pbuf)
        assert prc == jrc
        assert pbuf.getvalue() == jbuf.getvalue()
    buf = io.StringIO()
    port_tool.check(path, as_json=True, out=buf)
    doc = json.loads(buf.getvalue())
    want_rc = {"jax": 0, "port": 0, "torn": 0, "corrupt": 1}
    if which in want_rc:
        assert doc["rc"] == want_rc[which]
    assert doc["torn_tail"] is (which == "torn")
    assert len(doc["requests"]) == 3
    assert port_tool.main([path, "--json"]) == doc["rc"]
    assert json.loads(capsys.readouterr().out) == doc
    assert port_tool.main([path + ".missing"]) == 2


# -- debug ----------------------------------------------------------------------


def test_panic_on_nan_and_checked():
    from cake_tpu_torch.utils.debug import checked, panic_on_nan
    x = torch.randn(4, 3)
    assert panic_on_nan(x) is x and checked(x, "x") is x
    ints = torch.arange(5)
    assert panic_on_nan(ints) is ints
    y = x.clone()
    y[2, 1] = float("nan")
    for fn in (panic_on_nan, checked):
        with pytest.raises(FloatingPointError, match="NaN detected in y"):
            fn(y, "y")
    with pytest.raises(FloatingPointError):
        panic_on_nan(np.array([1.0, np.nan]))


@pytest.mark.cuda
def test_cuda_checked_refuses_inside_a_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA-graph capture")
    from cake_tpu_torch.utils.debug import checked
    x = torch.ones(8, device="cuda")
    assert checked(x) is x
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        with pytest.raises(RuntimeError, match="CUDA-graph capture"):
            with torch.cuda.graph(g):
                checked(x * 2, "x2")


# -- profiling --------------------------------------------------------------------


def test_annotate_is_a_named_profiler_span():
    from cake_tpu_torch.utils.profiling import annotate
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("cake_span_under_test"):
            torch.randn(8, 8) @ torch.randn(8, 8)

        @annotate("cake_decorated_span")
        def f():
            return torch.ones(3).sum()
        f()
    names = {e.key for e in prof.key_averages()}
    assert {"cake_span_under_test", "cake_decorated_span"} <= names


def test_log_memory_at_model_load_and_engine_start(monkeypatch, caplog):
    import cake_tpu_torch.utils.profiling as prof
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.context import Context
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.serve.engine import InferenceEngine

    # on the CPU it logs nothing
    with caplog.at_level(logging.DEBUG, logger=prof.__name__):
        prof.log_memory("anything")
    assert [r for r in caplog.records if r.name == prof.__name__] == []

    tags = []
    real = prof.log_memory
    monkeypatch.setattr(prof, "log_memory",
                        lambda tag: (tags.append(tag), real(tag))[1])
    Context.from_args(Args(cpu=True, max_seq_len=32)).load_text_model()
    assert tags == ["model loaded"]
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    eng = InferenceEngine(
        cfg, init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32),
        ByteTokenizer(cfg.vocab_size), device="cpu", max_slots=1,
        max_seq_len=32)
    with eng:
        pass
    assert tags == ["model loaded", "engine start"]


# -- no JAX on the card's machine -------------------------------------------------


def test_host_pieces_import_without_jax():
    """The native runtime, the analyzer and every tool import in a
    process where `jax` and `cake_tpu` cannot be imported (the card's
    machine has neither), and the native pieces build and run there."""
    import subprocess
    import sys
    code = """
import pkgutil, sys
for blocked in ("jax", "jaxlib", "cake_tpu"):
    sys.modules[blocked] = None
import cake_tpu_torch.analysis, cake_tpu_torch.analysis.core
import cake_tpu_torch.native, cake_tpu_torch.native.embed
import cake_tpu_torch.native.safetensors, cake_tpu_torch.native.scheduler
import cake_tpu_torch.utils.debug, cake_tpu_torch.utils.profiling
import cake_tpu_torch.tools as tools
names = [m.name for m in pkgutil.iter_modules(tools.__path__)]
for n in names:
    __import__("cake_tpu_torch.tools." + n)
from cake_tpu_torch.analysis import core
core.analyze(["cake_tpu_torch/native"])
from cake_tpu_torch.native.scheduler import make_scheduler
print(type(make_scheduler(2)).__name__, sorted(names))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "cake_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    kind, names = proc.stdout.split(" ", 1)
    assert kind == "NativeScheduler"
    assert {"cakelint", "split_model", "journal_check",
            "autotune_fit"} <= set(eval(names))
