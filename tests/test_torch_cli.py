"""The port's command line: `python -m cake_tpu_torch.cli`.

One-shot generation runs on the CPU with --cpu (the tiny config with
random weights when there is no --model); without --cpu and without a
card it raises instead of running on the CPU. The flags it has keep the
JAX package's names and defaults, and a flag it does not implement is
rejected.
"""

import dataclasses
import json

import pytest

import torch

from cake_tpu.args import Args as JArgs
from cake_tpu_torch import cli
from cake_tpu_torch.args import Args, parse_args
from cake_tpu_torch.master import Master
from cake_tpu_torch.ops import flash_attention as fa


def test_cli_generates_on_the_cpu(capsys):
    assert cli.main(["--cpu", "--prompt", "hi", "--sample-len", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[You are a helpful AI assistant.] hi\n")


def test_cli_without_a_card_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--prompt", "hi", "--sample-len", "4"])


def test_cli_api_serves_the_masters_engine(monkeypatch):
    """--api hands the master to the HTTP server at that address (the
    server itself is covered by tests/test_torch_engine.py)."""
    import cake_tpu_torch.api.server as server

    calls = []
    monkeypatch.setattr(server, "start",
                        lambda master, address: calls.append(
                            (master, address)))
    assert cli.main(["--cpu", "--api", "127.0.0.1:0"]) == 0
    (master, address), = calls
    assert address == "127.0.0.1:0"
    assert master.llm.device.type == "cpu"


def test_flash_follows_the_device_unless_asked(capsys):
    """On the CPU flash is off by default; --flash-attention turns it on,
    and the prompt's prefill then runs the fresh-window plain version
    once per layer."""
    gen = Master.from_args(Args(cpu=True)).llm
    assert gen.config.use_flash_attention is False
    assert gen.device.type == "cpu"
    fa.reset_launch_counts()
    assert cli.main(["--cpu", "--flash-attention", "--sample-len", "2"]) == 0
    assert fa.LAUNCHES["flash_attn_plain"] == gen.config.num_hidden_layers
    assert parse_args(["--no-flash-attention"]).flash_attention is False


def test_flags_keep_the_jax_names_and_defaults():
    theirs = {f.name: f.default for f in dataclasses.fields(JArgs)}
    ours = dataclasses.fields(Args)
    for f in ours:
        if f.name == "kv_pages":     # the port's engine is paged only
            continue
        assert theirs[f.name] == f.default, f.name
    assert parse_args([]) == Args()
    a = parse_args(["--max-seq-len", "128", "--top-p", "0.9",
                    "--kv-dtype", "f32", "--device-idx", "1"])
    assert (a.max_seq_len, a.top_p, a.kv_dtype, a.device_idx) == (
        128, 0.9, "f32", 1)
    with pytest.raises(SystemExit):
        parse_args(["--quant", "int8"])      # not ported: rejected


def test_model_dir_config_without_weights_uses_random_init(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(dict(
        vocab_size=300, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128)))
    master = Master.from_args(Args(cpu=True, model=str(tmp_path),
                                   dtype="f32", max_slots=2, kv_pages=8))
    gen = master.llm
    assert (gen.config.hidden_size, gen.max_seq_len) == (32, 128)
    assert gen.params["embed"].shape == (300, 32)
    assert gen.params["embed"].dtype == torch.float32
    engine = master.make_engine()
    assert engine.device.type == "cpu"
    assert engine.cache.k.dtype == torch.float32
