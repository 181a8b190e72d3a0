"""Embeddable C-ABI bindings of the port (the analog of `cake-ios`).

Counterpart of `cake_tpu/native/embed.py`. `csrc/embed.cpp` is a C-ABI
shared library that embeds CPython and calls the Python functions of
this module; it exports the JAX package's four functions under their
names and signatures, so a host such as examples/embed_host/main.c
builds against either library unchanged:

  cake_tpu_version(out_buf, cap)             -> package version string
  cake_tpu_generate(model_dir, prompt, n,
                    out_buf, cap)            -> one-shot text generation
  cake_tpu_start_worker(name, model_path,
                        topology_path,
                        model_type, address) -> blocking serve loop
  cake_tpu_last_error(out_buf, cap)          -> the last failure's text

String-returning calls follow the snprintf convention: 0 on success, a
positive required-capacity value when the buffer is too small (truncated
at a UTF-8 boundary), negative on failure (see cake_tpu_last_error).

The device. The C signatures carry no device, and every call through
them runs on the card (`cuda`, the port's entry-point default): a host
process without one gets the port's "CUDA is not available" error
through cake_tpu_last_error, never a quiet fallback to the CPU. A Python
caller that wants the CPU asks for it explicitly: either through the
`device=` argument of `generate` / `start_worker`, or, for calls that
come in through the C ABI within its own interpreter, with
`set_device("cpu")` before them (`set_device("cuda")` restores the
default).

`build_embed_library()` compiles the library on demand with g++ and
libpython's flags into `cake_tpu_torch/_build/libcake_embed_<hash>.so`.
"""

from __future__ import annotations

import logging
import subprocess
import sysconfig
import threading

log = logging.getLogger(__name__)

_SOURCE = "embed.cpp"

# the device of calls that come in through the C ABI (set_device)
_device = "cuda"


def set_device(device: str) -> None:
    """The device the C ABI's calls run on in this process: "cuda" (the
    default), "cuda:N" or "cpu"."""
    global _device
    _device = str(device)


def build_embed_library() -> str:
    """Compile libcake_embed (idempotent, hash-keyed). Returns the .so
    path."""
    from cake_tpu_torch.native import build_shared

    include = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    try:
        return build_shared("cake_embed", (_SOURCE,), extra_flags=(
            f"-I{include}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{ver}", "-lpthread", "-ldl"))
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"embed library build failed (is the python dev package "
            f"installed?):\n{e.stderr}") from e


# -- Python-side implementations called from the C shims ---------------------

def version() -> str:
    import cake_tpu_torch
    return cake_tpu_torch.__version__


def _device_argv(device: str) -> list:
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return ["--cpu"]
    return ["--device-idx", str(dev.index or 0)]


_masters: dict = {}
_masters_lock = threading.Lock()


def generate(model_dir: str, prompt: str, sample_len: int = 16,
             device: str | None = None) -> str:
    """One-shot generation for embedded hosts; returns the generated text.

    device: None takes the process's C-ABI device (`set_device`, "cuda"
    unless changed). The Master (weights and captured steps) is cached
    per (model_dir, device), so repeat calls pay token cost only, and
    calls are serialised under a lock: a Master holds mutable chat and
    decode state, and multithreaded C hosts are an expected caller."""
    from cake_tpu_torch.args import parse_all_args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.chat import Message

    device = device or _device
    args, sd_args, _ = parse_all_args([
        "--model", model_dir, "--prompt", prompt,
        "--sample-len", str(sample_len), *_device_argv(device),
    ])
    with _masters_lock:
        master = _masters.get((model_dir, device))
        if master is None:
            master = _masters[(model_dir, device)] = Master.from_args(
                args, sd_args)
        else:
            master.reset()
        master.add_message(Message.system(args.system_prompt))
        master.add_message(Message.user(prompt))
        return master.generate_text(lambda t: None, sample_len=sample_len)


def start_worker(name: str, model_path: str, topology_path: str,
                 model_type: str = "text",
                 address: str = "127.0.0.1:10128",
                 device: str | None = None) -> int:
    """Blocking node loop: signature parity with the reference's uniffi
    export (cake-ios/src/lib.rs:20-28), plus an explicit bind address.
    It serves the API through the port's command line until killed.
    device: as for `generate`."""
    from cake_tpu_torch.cli import main

    argv = ["--name", name, "--model", model_path,
            "--model-type", model_type, "--api", address,
            *_device_argv(device or _device)]
    if topology_path:
        argv += ["--topology", topology_path]
    return main(argv)
