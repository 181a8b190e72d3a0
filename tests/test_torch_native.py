"""The port's native host runtime (`cake_tpu_torch/native`) against its
Python fallbacks and the JAX package's native runtime.

  * The library builds here from csrc/ with the system g++ (a silent
    fallback would hide a regression, as tests/test_native.py says).
  * The FIFO scheduler: over seeded sequences of submit (duplicates and
    a full queue among them), cancel (queued and active), plan and
    report (EOS and max-tokens), the port's `NativeScheduler` gives the
    plans and counters of its `PyScheduler` and of JAX's two.
  * The safetensors reader: byte-identical arrays to the port's memmap
    path, to JAX's `read_file` and to the file's raw bytes over F32,
    F16, BF16, I8, U8 and I64; a view outlives its handle; garbage is
    refused with JAX's error class; `prefetch=False` reads the same.
  * `load_params_from_hf` through the native reader equals the one
    through the memmap, and a paged engine under `make_scheduler` runs
    on the native FIFO with the Python FIFO's greedy f32 tokens.
"""

import gc
import json
import random

import numpy as np
import pytest
import torch

from cake_tpu_torch.native import get_library, is_available
from cake_tpu_torch.native.scheduler import (
    NativeScheduler, PyScheduler, make_scheduler,
)


def test_native_library_builds():
    assert is_available(), "native library failed to build"
    from cake_tpu_torch.native import BUILD_INFO
    assert BUILD_INFO["path"].endswith(".so")
    assert "/cake_tpu_torch/_build/" in BUILD_INFO["path"]


# -- the FIFO scheduler, op for op ---------------------------------------------


def _schedulers(slots, max_queue):
    from cake_tpu.native.scheduler import NativeScheduler as JNative
    from cake_tpu.native.scheduler import PyScheduler as JPy
    return {"port native": NativeScheduler(slots, max_queue),
            "port python": PyScheduler(slots, max_queue),
            "jax native": JNative(slots, max_queue),
            "jax python": JPy(slots, max_queue)}


def _run_ops(seed: int, n_ops: int = 300):
    """One seeded op sequence on all four schedulers; returns each one's
    log of (op, result, counters)."""
    rng = random.Random(seed)
    slots, max_queue = rng.choice([1, 2, 4]), rng.choice([2, 5])
    scheds = _schedulers(slots, max_queue)
    logs = {k: [] for k in scheds}
    next_rid, known, active = 1, [], []
    seen = set()
    for _ in range(n_ops):
        op = rng.choice(["submit", "submit", "submit", "plan", "plan",
                         "report", "report", "cancel"])
        if op == "submit":
            # a duplicate now and then; a full queue comes on its own
            rid = next_rid if rng.random() < 0.85 or not known else \
                rng.choice(known)
            kind = "duplicate" if rid != next_rid else "fresh"
            if rid == next_rid:
                next_rid += 1
                known.append(rid)
            args = (rid, rng.randint(1, 40), rng.randint(1, 6))
        elif op == "cancel":
            # an active request, a recent one (likely queued) or any
            pick = rng.random()
            args = (rng.choice(active) if active and pick < 0.4 else
                    rng.choice(known[-4:]) if known and pick < 0.8 else
                    rng.choice(known + [10 ** 6]) if known else 1,)
        elif op == "report":
            rid = rng.choice(active) if active and rng.random() < 0.9 \
                else rng.choice(known + [10 ** 6]) if known else 1
            args = (rid, rng.randint(1, 3), rng.random() < 0.2)
        else:
            args = ()
        was_active = op == "cancel" and args[0] in active
        for k, s in scheds.items():
            got = getattr(s, op)(*args)
            logs[k].append((op, args, got, s.queue_depth, s.active,
                            s.completed))
        got = logs["port python"][-1][2]
        if op == "plan":
            pf, dc = got
            active = [rid for rid, _ in pf + dc]
        elif op == "submit" and not got:
            seen.add("refused " + kind)
        elif op == "cancel" and got:
            seen.add("cancelled " + ("active" if was_active else "queued"))
        elif op == "report" and got:
            seen.add("retired at eos" if args[2] else "retired")
    return logs, seen


@pytest.mark.parametrize("seed", range(6))
def test_native_scheduler_matches_python_and_jax(seed):
    logs, seen = _run_ops(seed)
    ref = logs["port python"]
    # the sequence reaches each case it is meant to
    assert seen == {"refused duplicate", "refused fresh", "cancelled active",
                    "cancelled queued", "retired", "retired at eos"}, seen
    for k, log in logs.items():
        assert log == ref, k


def test_make_scheduler_takes_the_native_fifo():
    assert isinstance(make_scheduler(2), NativeScheduler)
    s = make_scheduler(2)
    assert s.submit(1, 4, 10) and s.submit(2, 4, 10) and s.submit(3, 4, 10)
    prefill, _ = s.plan()
    assert prefill == [(1, 0), (2, 1)]
    assert s.cancel(3) and s.cancel(1)
    assert s.active == 1
    assert s.plan() == ([], [(2, 1)])
    assert not s.cancel(99)
    del s
    gc.collect()   # __del__ frees the C++ side


# -- the safetensors reader ----------------------------------------------------


@pytest.fixture(scope="module")
def st_file(tmp_path_factory):
    """A file of every dtype the tests cover, written by the port."""
    from cake_tpu_torch.utils.loading import save_safetensors
    rng = np.random.default_rng(0)
    tensors = {
        "f32": rng.normal(size=(16, 32)).astype(np.float32),
        "f16": rng.normal(size=(8,)).astype(np.float16),
        "bf16": torch.from_numpy(rng.normal(size=(4, 6)).astype(
            np.float32)).to(torch.bfloat16),
        "i8": rng.integers(-128, 127, size=(3, 5), dtype=np.int8),
        "u8": rng.integers(0, 255, size=(7,), dtype=np.uint8),
        "i64": np.arange(11, dtype=np.int64) * (1 << 40),
    }
    path = str(tmp_path_factory.mktemp("st") / "model.safetensors")
    save_safetensors(path, tensors)
    return path


def _raw(path):
    """name -> (dtype, shape, the bytes) straight from the file."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    out = {}
    for name, meta in header.items():
        b, e = meta["data_offsets"]
        out[name] = (meta["dtype"], tuple(meta["shape"]),
                     data[8 + n + b:8 + n + e])
    return out


def test_reader_is_byte_identical_to_memmap_jax_and_the_file(st_file):
    from cake_tpu.native.safetensors import read_file as j_read
    from cake_tpu_torch.native.safetensors import StFile, read_file
    from cake_tpu_torch.utils.loading import _st_load_file

    raw = _raw(st_file)
    assert {d for d, _, _ in raw.values()} == {
        "F32", "F16", "BF16", "I8", "U8", "I64"}
    native, handle = read_file(st_file)
    assert isinstance(handle, StFile)
    pure = _st_load_file(st_file)
    jax_arrays, _ = j_read(st_file)
    assert sorted(native) == sorted(pure) == sorted(jax_arrays) == \
        sorted(raw)
    for name, (dtype, shape, blob) in raw.items():
        t = native[name]
        assert t.st_dtype == dtype == pure[name].st_dtype
        assert t.shape == shape == pure[name].shape
        assert t.raw.tobytes() == blob
        assert pure[name].raw.tobytes() == blob
        assert np.asarray(jax_arrays[name]).tobytes() == blob
        assert t.to_torch().view(torch.uint8).numpy().tobytes() == blob
    # prefetch=False reads the same bytes; a subset is a subset
    sub, _ = read_file(st_file, ["bf16", "u8"], prefetch=False)
    assert sorted(sub) == ["bf16", "u8"]
    assert sub["bf16"].raw.tobytes() == raw["bf16"][2]


def test_view_outlives_its_handle(st_file):
    from cake_tpu_torch.native.safetensors import read_file
    tensors, handle = read_file(st_file)
    t = tensors["f32"]
    want = _raw(st_file)["f32"][2]
    del tensors, handle
    gc.collect()
    assert t.raw.tobytes() == want
    assert not t.raw.flags.writeable


@pytest.mark.parametrize("blob", [b"\xff" * 64, b"\x04" + b"\x00" * 7
                                  + b"{bad", b""])
def test_garbage_is_refused_with_jaxs_error_class(tmp_path, blob):
    from cake_tpu.native.safetensors import StFile as JStFile
    from cake_tpu_torch.native.safetensors import StFile
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(blob)
    with pytest.raises(Exception) as want:
        JStFile(str(bad))
    with pytest.raises(Exception) as got:
        StFile(str(bad))
    assert type(got.value) is type(want.value) is OSError


# -- the loader and the engine on the native pieces -----------------------------


def _hf_checkpoint(path, cfg, dtype):
    from cake_tpu_torch.models.llama.params import hf_param_layout
    from cake_tpu_torch.utils.loading import save_safetensors
    layout, per_layer, L = hf_param_layout(cfg)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    shapes = {"input_layernorm.weight": (D,),
              "post_attention_layernorm.weight": (D,),
              "self_attn.q_proj.weight": (H * hd, D),
              "self_attn.k_proj.weight": (KV * hd, D),
              "self_attn.v_proj.weight": (KV * hd, D),
              "self_attn.o_proj.weight": (D, H * hd),
              "mlp.gate_proj.weight": (F, D), "mlp.up_proj.weight": (F, D),
              "mlp.down_proj.weight": (D, F),
              "model.embed_tokens.weight": (V, D),
              "model.norm.weight": (D,), "lm_head.weight": (V, D)}
    g = torch.Generator().manual_seed(3)
    names = [n for n, _ in layout.values()] + [
        f"model.layers.{i}.{s}" for i in range(L)
        for s, _ in per_layer.values()]
    tensors = {}
    for n in names:
        shape = shapes[n.split(".", 3)[-1] if n.startswith("model.layers.")
                       else n]
        tensors[n] = (torch.randn(shape, generator=g) * 0.05).to(dtype)
    path.mkdir()
    save_safetensors(str(path / "model.safetensors"), tensors)
    return str(path)


def test_load_params_from_hf_native_equals_memmap(tmp_path, monkeypatch):
    import cake_tpu_torch.native.safetensors as nst
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import load_params_from_hf

    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    d = _hf_checkpoint(tmp_path / "m", cfg, torch.bfloat16)
    reads = []
    real = nst.StFile
    monkeypatch.setattr(nst, "StFile",
                        lambda p: reads.append(p) or real(p))
    native = load_params_from_hf(d, cfg, dtype=torch.float32, device="cpu")
    assert len(reads) == 1, "load_weights did not read through StFile"
    monkeypatch.setattr(nst, "get_library", lambda: None)
    pure = load_params_from_hf(d, cfg, dtype=torch.float32, device="cpu")
    assert len(reads) == 1
    flat_n = torch.utils._pytree.tree_flatten(native)[0]
    flat_p = torch.utils._pytree.tree_flatten(pure)[0]
    assert len(flat_n) == len(flat_p) > 0
    for a, b in zip(flat_n, flat_p):
        assert torch.equal(a, b)


def test_paged_engine_runs_on_the_native_fifo(monkeypatch):
    import cake_tpu_torch.native.scheduler as nsched
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)

    def run():
        eng = InferenceEngine(
            cfg, params, ByteTokenizer(cfg.vocab_size), device="cpu",
            max_slots=2, max_seq_len=64, kv_pages=16, kv_page_size=16,
            sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
            cache_dtype=torch.float32)
        with eng:
            hs = [eng.submit([3 + i] * (5 + 3 * i), max_new_tokens=6 + i)
                  for i in range(3)]
            assert all(h.wait(timeout=120) for h in hs)
        return type(eng.scheduler), [list(h._req.out_tokens) for h in hs]

    kind, native = run()
    assert kind is NativeScheduler
    monkeypatch.setattr(nsched, "get_library", lambda: None)
    kind, py = run()
    assert kind is PyScheduler
    assert native == py
    assert [len(t) for t in native] == [6, 7, 8]
    assert get_library() is not None
