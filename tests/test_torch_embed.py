"""The port's C-ABI embed library (`cake_tpu_torch/native/embed.py`,
csrc/embed.cpp): it builds, exports the JAX library's four functions,
round-trips the version through ctypes, generates `Master`'s text in
process when the CPU is asked for, and in a fresh C host built from
examples/embed_host/main.c reports its version and refuses to generate
without a card, naming CUDA, through `cake_tpu_last_error`.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import sysconfig

import pytest

_LIBPY = os.path.join(sysconfig.get_config_var("LIBDIR") or "",
                      sysconfig.get_config_var("LDLIBRARY") or "")
pytestmark = [
    pytest.mark.skipif(shutil.which("g++") is None,
                       reason="no C++ toolchain"),
    pytest.mark.skipif(not os.path.exists(_LIBPY),
                       reason="no shared libpython to embed"),
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTS = ("cake_tpu_version", "cake_tpu_generate", "cake_tpu_start_worker",
           "cake_tpu_last_error")


@pytest.fixture(scope="module")
def lib_path():
    from cake_tpu_torch.native.embed import build_embed_library
    return build_embed_library()


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    """A config-only checkpoint: the Master draws its weights from the
    seed."""
    d = tmp_path_factory.mktemp("tiny_model")
    cfg = {
        "model_type": "llama", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "max_position_embeddings": 256, "bos_token_id": 1,
        "eos_token_id": 2,
    }
    (d / "config.json").write_text(json.dumps(cfg))
    return str(d)


def _load(lib_path):
    lib = ctypes.CDLL(lib_path)
    for fn in ("cake_tpu_version", "cake_tpu_generate",
               "cake_tpu_last_error"):
        getattr(lib, fn).restype = ctypes.c_long
    return lib


def test_exports_jaxs_four_functions(lib_path):
    assert "/cake_tpu_torch/_build/libcake_embed_" in lib_path
    nm = subprocess.run(["nm", "-D", "--defined-only", lib_path],
                        capture_output=True, text=True, check=True).stdout
    syms = {line.split()[-1] for line in nm.splitlines() if line.strip()}
    assert set(EXPORTS) <= syms
    assert {s for s in syms if s.startswith("cake_tpu_")} == set(EXPORTS)


def test_version_roundtrip_in_process(lib_path):
    import cake_tpu_torch

    lib = _load(lib_path)
    buf = ctypes.create_string_buffer(64)
    assert lib.cake_tpu_version(buf, ctypes.c_long(64)) == 0
    assert buf.value.decode() == cake_tpu_torch.__version__
    # snprintf convention: a too-small buffer gives the capacity needed
    small = ctypes.create_string_buffer(3)
    rc = lib.cake_tpu_version(small, ctypes.c_long(3))
    assert rc == len(cake_tpu_torch.__version__) + 1
    assert len(small.value) < 3


def test_generate_in_process_on_the_cpu_is_masters_text(lib_path,
                                                        tiny_model_dir):
    from cake_tpu_torch.args import parse_all_args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.native import embed

    args, sd_args, _ = parse_all_args([
        "--model", tiny_model_dir, "--prompt", "hi", "--sample-len", "4",
        "--cpu"])
    m = Master.from_args(args, sd_args)
    m.add_message(Message.system(args.system_prompt))
    m.add_message(Message.user("hi"))
    want = m.generate_text(lambda t: None, sample_len=4)

    lib = _load(lib_path)
    buf = ctypes.create_string_buffer(4096)
    embed.set_device("cpu")
    try:
        rc = lib.cake_tpu_generate(tiny_model_dir.encode(), b"hi",
                                   ctypes.c_int(4), buf, ctypes.c_long(4096))
    finally:
        embed.set_device("cuda")
    if rc != 0:
        err = ctypes.create_string_buffer(1024)
        lib.cake_tpu_last_error(err, ctypes.c_long(1024))
        pytest.fail(f"cake_tpu_generate rc={rc}: {err.value.decode()}")
    assert buf.value.decode() == want
    assert (tiny_model_dir, "cpu") in embed._masters


def test_c_host_reports_version_and_needs_the_card(lib_path, tiny_model_dir,
                                                   tmp_path):
    """examples/embed_host/main.c, compiled here, in a fresh process with
    no Python on its stack: the version through the C ABI, then a
    generate that fails naming CUDA (never a quiet CPU run)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the refusal is what a host without a card gets")
    exe = tmp_path / "embed_host"
    subprocess.run(
        ["gcc", "-O2", "-o", str(exe),
         os.path.join(REPO, "examples", "embed_host", "main.c"), lib_path,
         f"-Wl,-rpath,{os.path.dirname(lib_path)}",
         f"-Wl,-rpath,{sysconfig.get_config_var('LIBDIR')}"],
        check=True, capture_output=True, text=True)
    base = tmp_path / "node"
    base.mkdir()
    shutil.copytree(tiny_model_dir, base / "model")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, sysconfig.get_path("purelib")]
        + [p for p in sys.path if p.endswith("site-packages")])
    proc = subprocess.run([str(exe), str(base), "--prompt", "hello",
                           "--n", "2"], env=env, capture_output=True,
                          text=True, timeout=300)
    import cake_tpu_torch
    assert f"library v{cake_tpu_torch.__version__}" in proc.stdout, \
        proc.stdout + proc.stderr
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "generate failed" in proc.stderr
    assert "CUDA is not available" in proc.stderr
