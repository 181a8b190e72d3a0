"""The sequential generator's decode step as a replayed graph
(serve/graphs.GeneratorRunner) against the JAX generator, and the two
flags of its path, `--batch-size` and `--tracing`.

On the CPU the runner's replay runs the captured step's code eagerly:
the dense forward reading its position from a device buffer, then the
counter-based sample. Greedy streams at f32 are the JAX generator's at
batch 1 and 2, flash on and off; `generate_on_device` is
`_generate_scan`'s at batch 1 and 3 (a repeat penalty over the ring).
Sampled streams are the engine's counter-based ones (pinned here by
recomputing them from the seeds), where JAX splits a threefry key.

The `cuda` cases: replayed against eager steps from identical caches,
and `generate_on_device`'s replays under
`torch.cuda.set_sync_debug_mode("error")` (no host round trip between
steps). They skip without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_generator_graph.py
"""

import dataclasses
import glob
import json

import numpy as np
import pytest

import torch

from cake_tpu_torch.args import Args
from cake_tpu_torch.models.chat import Message
from cake_tpu_torch.models.llama import generator as tgen
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops import sampling as tsmp

MAX_SEQ = 256
L = 2
PROMPT = "Why is the sky blue? Answer in one word."


@pytest.fixture(scope="module")
def params():
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jp = j_init(JConfig.tiny(num_hidden_layers=L), jax.random.PRNGKey(0),
                dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _torch_gen(tp, flash=False, batch_size=1, sampling=None, seed=7):
    tc = LlamaConfig.tiny(num_hidden_layers=L, use_flash_attention=flash)
    return tgen.LlamaGenerator(
        tc, tp, tgen.ByteTokenizer(tc.vocab_size), max_seq_len=MAX_SEQ,
        sampling=sampling or tsmp.SamplingConfig(temperature=0.0),
        cache_dtype=torch.float32, batch_size=batch_size, seed=seed,
        device="cpu")


def _jax_gen(jp, flash=False, batch_size=1, penalty=1.1):
    import jax.numpy as jnp
    from cake_tpu.models.llama import generator as jgen
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.ops import sampling as jsmp

    jc = dataclasses.replace(JConfig.tiny(num_hidden_layers=L),
                             use_flash_attention=flash)
    return jgen.LlamaGenerator(
        jc, jp, jgen.ByteTokenizer(jc.vocab_size), max_seq_len=MAX_SEQ,
        sampling=jsmp.SamplingConfig(temperature=0.0,
                                     repeat_penalty=penalty),
        cache_dtype=jnp.float32, batch_size=batch_size)


def _stream(gen, message_cls, n=10):
    gen.add_message(message_cls.system("You are terse."))
    gen.add_message(message_cls.user(PROMPT))
    out = []
    for i in range(n):
        tok = gen.next_token(i)
        out.append((tok.id, tok.text, tok.is_end_of_stream))
        if tok.is_end_of_stream:
            break
    return out


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_greedy_stream_through_the_runner_matches_jax(params, batch, flash):
    from cake_tpu.models.chat import Message as JMessage
    jp, tp = params
    want = _stream(_jax_gen(jp, flash, batch), JMessage)
    t = _torch_gen(tp, flash, batch,
                   tsmp.SamplingConfig(temperature=0.0, repeat_penalty=1.1))
    assert _stream(t, Message) == want
    r = t._decode
    assert r is not None and r.B == batch
    # every row decodes the same prompt: the rows' tokens agree
    assert (r.tok == r.tok[0]).all()
    assert int(r.pos) == t.index_pos and int(r.steps[0]) == len(t.tokens)


@pytest.mark.parametrize("batch", [1, 3])
def test_generate_on_device_matches_generate_scan(params, batch):
    jp, tp = params
    ids = np.random.default_rng(batch).integers(3, 250, size=(batch, 12))
    plen = np.full(batch, 12, np.int32)
    want = _jax_gen(jp, batch_size=batch).generate_on_device(
        ids.astype(np.int32), plen, 9)
    t = _torch_gen(tp, sampling=tsmp.SamplingConfig(temperature=0.0,
                                                     repeat_penalty=1.1))
    got = t.generate_on_device(ids, plen, 9)
    np.testing.assert_array_equal(got, want)
    # the scratch cache is allocated once and zeroed in place, and the
    # session is untouched
    ptr = t._scratch.k.data_ptr()
    np.testing.assert_array_equal(t.generate_on_device(ids, plen, 9), want)
    assert t._scratch.k.data_ptr() == ptr
    assert not t.cache.k.any() and t._decode is None


def test_sampled_stream_is_the_counter_based_one(params):
    """A pinned divergence: the generator samples from the engine's
    counter-based streams (row b seeded seed * 1_000_003 + b, the counter
    advancing once a sample), where JAX splits a threefry key; recomputed
    here step by step from the eager forward, and each token lies in the
    top-k set. reset() keeps the streams going (no draw replayed), and
    generate_on_device draws from streams of its own."""
    from cake_tpu_torch.models.llama.model import forward

    _, tp = params
    smp = tsmp.SamplingConfig(temperature=0.9, top_k=8, top_p=0.95,
                              repeat_penalty=1.1, repeat_last_n=16)
    t = _torch_gen(tp, sampling=smp, batch_size=2, seed=11)
    got = _stream(t, Message, n=8)
    ids = tgen.encode_text(t.tokenizer, t.history.render())

    ref = _torch_gen(tp, sampling=smp, batch_size=2, seed=11)
    ref.add_message(Message.system("You are terse."))
    ref.add_message(Message.user(PROMPT))
    seeds = torch.tensor([11 * 1_000_003 + b for b in range(2)])
    counters = torch.zeros(2, dtype=torch.long)
    ring = torch.full((2, 16), -1, dtype=torch.long)
    opts = [torch.full((2,), v) for v in (0.9, 0.95, 1.1)]
    with torch.inference_mode():
        logits = ref._prefill_prompt()       # the same eager prefill
        want, pos = [], len(ids)
        for step in range(len(got)):
            nxt, counters, ring, _, _, _ = tsmp.masked_sample(
                torch.ones(2, dtype=torch.bool), seeds, counters, logits,
                ring, torch.full((2,), step), *opts, top_k=8)
            want.append(int(nxt[0]))
            logits, _ = forward(ref.params, nxt[:, None].int(), ref.cache,
                                pos, ref.rope, ref.config)
            pos += 1
    assert [g[0] for g in got] == want
    assert t._decode.counters.tolist() == [len(got)] * 2
    t.reset()
    assert t._decode.counters.tolist() == [len(got)] * 2
    t.generate_on_device(np.array([ids[:8]] * 2), np.array([8, 8]), 3)
    assert t._decode.counters.tolist() == [len(got)] * 2
    assert t._scan.seeds.tolist() == [11 * 1_000_003 + 65_537 + b
                                      for b in range(2)]


def test_batch_size_reaches_the_generator(capsys):
    from cake_tpu_torch import cli
    from cake_tpu_torch.args import parse_args
    from cake_tpu_torch.master import Master

    assert parse_args(["--batch-size", "2"]).batch_size == 2
    with pytest.raises(ValueError, match="batch-size"):
        Args(batch_size=0).validate()
    gen = Master.from_args(Args(cpu=True, batch_size=2)).llm
    assert gen.batch_size == 2 and gen.cache.k.shape[1] == 2
    assert cli.main(["--cpu", "--batch-size", "2", "--prompt", "hi",
                     "--sample-len", "3"]) == 0
    assert capsys.readouterr().out.startswith(
        "[You are a helpful AI assistant.] hi\n")


def test_tracing_writes_a_trace_file(tmp_path, capsys):
    """--tracing DIR profiles the one-shot generation (torch.profiler)
    and writes a Chrome / Perfetto trace file into DIR; unset, nothing
    is profiled."""
    from cake_tpu_torch import cli
    from cake_tpu_torch.utils.profiling import trace

    out = tmp_path / "trace"
    assert cli.main(["--cpu", "--tracing", str(out), "--prompt", "hi",
                     "--sample-len", "2"]) == 0
    files = glob.glob(str(out / "trace.*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with trace(None):
        pass
    assert glob.glob(str(out / "trace.*.json")) == files


# -- on the card ------------------------------------------------------------------


def _card_gen(batch=2, bf16=False):
    from cake_tpu_torch.models.llama.params import init_params
    cfg = LlamaConfig.tiny(num_hidden_layers=L, use_flash_attention=True)
    dtype = torch.bfloat16 if bf16 else torch.float32
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=dtype)
    params = {k: ({n: t.cuda() for n, t in v.items()}
                  if isinstance(v, dict) else v.cuda())
              for k, v in params.items()}
    return tgen.LlamaGenerator(
        cfg, params, tgen.ByteTokenizer(cfg.vocab_size), max_seq_len=256,
        sampling=tsmp.SamplingConfig(temperature=0.0), cache_dtype=dtype,
        batch_size=batch, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_replayed_decode_matches_the_eager_step(bf16):
    """From identical caches, 6 replays of the captured step and the same
    6 steps run eagerly: identical tokens and logits, and the captured
    stream equals the CPU generator's at f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = _card_gen(bf16=bf16)
    g.add_message(Message.user(PROMPT))
    g.next_token(0)
    r = g._decode
    saved = [t.clone() for t in (g.cache.k, g.cache.v, r.tok, r.pos,
                                 r.steps, r.col, r.counters, r.ring)]
    eager = []
    for _ in range(6):
        r.step(None)
        eager.append((r.tok.clone(), r.logits.clone()))
    for t, v in zip((g.cache.k, g.cache.v, r.tok, r.pos, r.steps, r.col,
                     r.counters, r.ring), saved):
        t.copy_(v)
    for i in range(6):
        r.replay(None)
        assert torch.equal(r.tok, eager[i][0])
        assert torch.equal(r.logits, eager[i][1])
    assert r.captures == 1
    if not bf16:
        cpu = _torch_gen({k: ({n: t.cpu() for n, t in v.items()}
                              if isinstance(v, dict) else v.cpu())
                          for k, v in g.params.items()}, flash=True,
                         batch_size=2)
        g2 = _card_gen()
        assert _stream(g2, Message) == _stream(cpu, Message)


@pytest.mark.cuda
def test_cuda_generate_on_device_replays_without_a_sync():
    """generate_on_device's num_tokens - 1 replays run under
    set_sync_debug_mode("error") (no host round trip between steps), and
    its tokens are next_token's greedy stream at B = 1 and B = 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from cake_tpu_torch.serve.graphs import GeneratorRunner
    g = _card_gen(batch=1)
    g.add_message(Message.user(PROMPT))
    stream = [g.next_token(i).id for i in range(8)]
    ids = tgen.encode_text(g.tokenizer, g.history.render())
    real = GeneratorRunner.replay
    guarded = []

    def replay(self, variant):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, variant)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            guarded.append(1)

    GeneratorRunner.replay = replay
    try:
        for B in (1, 4):
            out = g.generate_on_device(np.array([ids] * B),
                                       np.full(B, len(ids)), 8)
            assert (out == np.array(stream)[None, :]).all()
    finally:
        GeneratorRunner.replay = real
    assert len(guarded) == 2 * 7
