"""The port's command line: `python -m cake_tpu_torch.cli`.

One-shot generation runs on the CPU with --cpu (the tiny config with
random weights when there is no --model); without --cpu and without a
card it raises instead of running on the CPU. The flags it has keep the
JAX package's names and defaults, and a flag it does not implement is
rejected. `--quant int8|int4` quantizes the loaded weights in the
context; on the CPU the int4 decode products run int4_matmul's plain
version.
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
from cake_tpu_torch.ops import int4_matmul as i4
from cake_tpu_torch.ops.quant import QTensor, is_groupwise


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
    assert parse_args(["--quant", "int8"]).quant == "int8"
    with pytest.raises(SystemExit):
        parse_args(["--spec-draft", "dir"])  # not ported: rejected


@pytest.mark.parametrize("quant", ["int4", "int8"])
def test_cli_quant_generates_on_the_cpu(capsys, quant):
    """--quant through args -> context -> generator: the block weights
    and the lm_head are QTensors (the lm_head int8 at both settings), and
    each int4 decode step runs seven plain int4 products per layer."""
    i4.reset_launch_counts()
    assert cli.main(["--cpu", "--quant", quant, "--prompt", "hi",
                     "--sample-len", "4"]) == 0
    assert capsys.readouterr().out.startswith(
        "[You are a helpful AI assistant.] hi\n")
    gen = Master.from_args(Args(cpu=True, quant=quant)).llm
    blocks = gen.params["blocks"]
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert isinstance(blocks[k], QTensor)
        assert is_groupwise(blocks[k]) == (quant == "int4")
    assert isinstance(gen.params["lm_head"], QTensor)
    assert not is_groupwise(gen.params["lm_head"])
    assert isinstance(gen.params["embed"], torch.Tensor)
    assert isinstance(blocks["attn_norm"], torch.Tensor)
    L = gen.config.num_hidden_layers
    # 4 tokens: one from the prefill (a 128-token bucket, M > 64), three
    # from decode steps, unless the random model stops early
    n = i4.LAUNCHES["int4_matmul_plain"]
    if quant == "int4":
        assert n > 0 and n % (7 * L) == 0 and n <= 3 * 7 * L
    else:
        assert n == 0
    assert i4.LAUNCHES["int4_matmul"] == 0


def test_quant_rule_matches_the_jax_args():
    for name in ("none", "int8", "int4"):
        assert Args(quant=name).validate().quant == name
        assert JArgs(quant=name).validate().quant == name
    for name in ("int3", "int2", "fp8"):
        with pytest.raises(ValueError) as theirs:
            JArgs(quant=name).validate()
        with pytest.raises(ValueError) as ours:
            Args(quant=name).validate()
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unsupported quant"):
        cli.main(["--cpu", "--quant", "int3"])


def test_quant_engine_serves_from_the_masters_quantized_params():
    master = Master.from_args(Args(cpu=True, quant="int4", max_seq_len=128,
                                   kv_pages=8, kv_page_size=16))
    engine = master.make_engine(max_slots=2)
    assert engine.params is master.llm.params
    i4.reset_launch_counts()
    with engine:
        h = engine.submit([3] * 12, max_new_tokens=3, temperature=0.0)
        assert h.wait(timeout=120) and h._req.error is None
    assert engine._pager.free_pages == 8
    assert i4.LAUNCHES["int4_matmul_plain"] > 0


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


def test_kv_dtype_rules_match_the_jax_args():
    """int8/int4 need the paged pool, int4 an even page size (with the
    JAX package's message); another name must be a dtype."""
    for name in ("int8", "int4", "f32", "bf16"):
        assert parse_args(["--kv-dtype", name]).kv_dtype == name
    bad = [dict(kv_dtype="int4", kv_pages=8, kv_page_size=7),
           dict(kv_dtype="int8", kv_pages=None),
           dict(kv_dtype="int4", kv_pages=0)]
    for kw in bad:
        with pytest.raises(ValueError) as theirs:
            JArgs(**kw).validate()
        with pytest.raises(ValueError) as ours:
            Args(**kw).validate()
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown dtype"):
        parse_args(["--kv-dtype", "int3"])
    with pytest.raises(ValueError, match="even --kv-page-size"):
        cli.main(["--cpu", "--kv-dtype", "int4", "--kv-page-size", "9"])


def test_int4_kv_keeps_the_generators_compute_dtype():
    """Deliberate divergence: under --kv-dtype int8 or int4 the
    generator's dense cache keeps the compute dtype (the quantized pool
    is the engine's). The JAX context special-cases int8 only, so its
    int4 reaches resolve_kv_dtype, which raises."""
    from cake_tpu.utils.devices import resolve_kv_dtype
    with pytest.raises(ValueError):
        resolve_kv_dtype("int4")
    for name in ("int8", "int4"):
        gen = Master.from_args(Args(cpu=True, kv_dtype=name)).llm
        assert gen.cache.k.dtype == torch.bfloat16


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_make_engine_passes_the_kv_dtype(kv_dtype):
    from cake_tpu_torch.kv.quantized_pool import (
        Int4PagedKVCache, QuantizedPagedKVCache,
    )
    master = Master.from_args(Args(cpu=True, kv_dtype=kv_dtype,
                                   max_seq_len=128, kv_pages=8,
                                   kv_page_size=16))
    engine = master.make_engine(max_slots=2)
    want = Int4PagedKVCache if kv_dtype == "int4" else \
        QuantizedPagedKVCache
    assert type(engine.cache) is want and engine.kv_quant
    assert engine.cache.page_size == 16 and engine.cache.n_pages == 8
    with engine:
        h = engine.submit([3] * 12, max_new_tokens=3, temperature=0.0)
        assert h.wait(timeout=120) and h._req.error is None
    assert engine._pager.free_pages == 8
