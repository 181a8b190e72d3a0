"""The port's sequential generator and Master vs the JAX package's.

Greedy `LlamaGenerator` streams at f32 params and an f32 cache are
token-identical to the JAX generator's, for whole-prompt and chunked
(`prefill_chunk`) prompts, with flash on (JAX through its Pallas kernels
in interpret mode, the port through their plain versions) and off;
`generate_on_device`, `bucket_length`, `trim_at_eos`, `sample_tokens`,
`update_ring` and `Master.generate_text` match too. Sampled tokens come
from another random stream (a torch.Generator, not threefry), so they
are held by support: each lies inside the top-k set.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.args import Args as JArgs
from cake_tpu.master import Master as JMaster
from cake_tpu.models.chat import Message as JMessage
from cake_tpu.models.llama import generator as jgen
from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu.models.llama.params import init_params as j_init
from cake_tpu.ops import sampling as jsmp
from cake_tpu.ops.quant import quantize_params as j_quantize_params
from cake_tpu_torch.args import Args
from cake_tpu_torch.master import Master
from cake_tpu_torch.models.chat import Message
from cake_tpu_torch.models.llama import generator as tgen
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.ops import flash_attention as fa
from cake_tpu_torch.ops import int4_matmul as i4
from cake_tpu_torch.ops import sampling as tsmp

MAX_SEQ = 256
L = 2


@pytest.fixture(scope="module")
def params():
    jp = j_init(JConfig.tiny(num_hidden_layers=L), jax.random.PRNGKey(0),
                dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _generators(params, flash, prefill_chunk=None, penalty=1.1,
                batch_size=1):
    jp, tp = params
    jc = dataclasses.replace(JConfig.tiny(num_hidden_layers=L),
                             use_flash_attention=flash)
    tc = LlamaConfig.tiny(num_hidden_layers=L, use_flash_attention=flash)
    j = jgen.LlamaGenerator(
        jc, jp, jgen.ByteTokenizer(jc.vocab_size), max_seq_len=MAX_SEQ,
        sampling=jsmp.SamplingConfig(temperature=0.0,
                                     repeat_penalty=penalty),
        cache_dtype=jnp.float32, prefill_chunk=prefill_chunk,
        batch_size=batch_size)
    t = tgen.LlamaGenerator(
        tc, tp, tgen.ByteTokenizer(tc.vocab_size), max_seq_len=MAX_SEQ,
        sampling=tsmp.SamplingConfig(temperature=0.0,
                                     repeat_penalty=penalty),
        cache_dtype=torch.float32, prefill_chunk=prefill_chunk,
        batch_size=batch_size, device="cpu")
    return j, t


def _stream(gen, message_cls, prompt, n=8):
    gen.add_message(message_cls.system("You are terse."))
    gen.add_message(message_cls.user(prompt))
    out = []
    for i in range(n):
        tok = gen.next_token(i)
        out.append((tok.id, tok.text, tok.is_end_of_stream))
        if tok.is_end_of_stream:
            break
    return out


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_greedy_tokens_identical_to_jax_generator(params, flash,
                                                  prefill_chunk):
    j, t = _generators(params, flash, prefill_chunk)
    prompt = "Why is the sky blue? Answer in one word."
    want = _stream(j, JMessage, prompt)
    fa.reset_launch_counts()
    got = _stream(t, Message, prompt)
    assert got == want
    assert t.index_pos == j.index_pos
    n_windows = -(-t._prompt_len // 16)
    if flash and prefill_chunk:
        assert fa.LAUNCHES["flash_attn_cached_plain"] == L * n_windows
    elif flash:
        assert fa.LAUNCHES["flash_attn_plain"] == L
    else:
        assert sum(fa.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_quantized_greedy_tokens_identical_to_jax_generator(bits,
                                                            prefill_chunk):
    """int4 / int8 weights quantized by the JAX package and carried
    over, f32 activations and cache (hidden 128 and intermediate 256, so
    JAX's decode products reach its Pallas kernel): the same greedy
    stream; the port's int4 decode products run int4_matmul's plain
    version, seven per layer and step."""
    cfg = dict(num_hidden_layers=L, hidden_size=128, intermediate_size=256)
    jc, tc = JConfig.tiny(**cfg), LlamaConfig.tiny(**cfg)
    jp = jax.jit(partial(j_quantize_params, bits=bits))(
        j_init(jc, jax.random.PRNGKey(3), dtype=jnp.float32))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    j = jgen.LlamaGenerator(
        jc, jp, jgen.ByteTokenizer(jc.vocab_size), max_seq_len=MAX_SEQ,
        sampling=jsmp.SamplingConfig(temperature=0.0, repeat_penalty=1.1),
        cache_dtype=jnp.float32, prefill_chunk=prefill_chunk)
    t = tgen.LlamaGenerator(
        tc, tp, tgen.ByteTokenizer(tc.vocab_size), max_seq_len=MAX_SEQ,
        sampling=tsmp.SamplingConfig(temperature=0.0, repeat_penalty=1.1),
        cache_dtype=torch.float32, prefill_chunk=prefill_chunk,
        device="cpu")
    prompt = "Why is the sky blue? Answer in one word."
    want = _stream(j, JMessage, prompt)
    i4.reset_launch_counts()
    got = _stream(t, Message, prompt)
    assert got == want
    decode_steps = len(got) - 1
    windows = -(-t._prompt_len // 16) if prefill_chunk else 0
    if bits == 4:      # a 16-token window is decode-shaped (M <= 64) too
        assert i4.LAUNCHES["int4_matmul_plain"] == 7 * L * (
            decode_steps + windows)
    else:
        assert i4.LAUNCHES["int4_matmul_plain"] == 0


def test_reset_replays_the_same_greedy_stream(params):
    _, t = _generators(params, flash=True)
    first = _stream(t, Message, "hello")
    t.reset()
    assert t.tokens == [] and t.index_pos == 0 and len(t.history) == 0
    assert not t.cache.k.any()
    assert _stream(t, Message, "hello") == first


def test_set_sampling_overrides_only_given_fields(params):
    j, t = _generators(params, flash=False)
    for g in (j, t):
        g.set_sampling(temperature=None, top_k=5)
    assert (t.sampling.temperature, t.sampling.top_k) == (0.0, 5)
    assert (t.sampling.temperature, t.sampling.top_k,
            t.sampling.repeat_penalty) == (j.sampling.temperature,
                                           j.sampling.top_k,
                                           j.sampling.repeat_penalty)


def test_decode_past_the_cache_raises(params):
    _, t = _generators(params, flash=False)
    t.add_message(Message.user("hi"))
    t.next_token(0)
    t.index_pos = t.max_seq_len
    with pytest.raises(ValueError, match="cache is full"):
        t.next_token(1)


def test_generate_on_device_matches_jax(params):
    j, t = _generators(params, flash=True, penalty=1.0, batch_size=2)
    ids = np.random.default_rng(0).integers(3, 250, size=(2, 16))
    plen = np.array([16, 16], np.int32)
    want = j.generate_on_device(ids.astype(np.int32), plen, 6)
    got = t.generate_on_device(ids, plen, 6)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert not t.cache.k.any()       # the session cache is untouched
    with pytest.raises(ValueError, match="uniform"):
        t.generate_on_device(ids, np.array([16, 9]), 2)


@pytest.mark.parametrize("max_seq", [64, 256, 4096, 100])
def test_bucket_length_matches_jax(max_seq):
    for n in (1, 31, 32, 33, 64, 100, 255, 256, 1000, 4096):
        assert tgen.bucket_length(n, max_seq) == jgen.bucket_length(n,
                                                                     max_seq)


def test_trim_at_eos_matches_jax():
    ids = np.array([[5, 6, 2, 7], [8, 9, 10, 11], [2, 1, 1, 1]], np.int32)
    assert tgen.trim_at_eos(ids, (2, 11)) == jgen.trim_at_eos(ids, (2, 11))


def test_sample_tokens_greedy_identical_and_sampled_in_support():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 50)).astype(np.float32) * 3
    ring = np.full((3, 8), -1, np.int32)
    ring[:, :3] = rng.integers(0, 50, size=(3, 3))
    greedy = tsmp.SamplingConfig(temperature=0.0)
    want = jsmp.sample_tokens(jax.random.PRNGKey(0), jnp.asarray(logits),
                              jnp.asarray(ring),
                              jsmp.SamplingConfig(temperature=0.0))
    got = tsmp.sample_tokens(None, torch.from_numpy(logits),
                             torch.from_numpy(ring), greedy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # top-k 3 after the repeat penalty: every draw among those 3
    cfg = tsmp.SamplingConfig(temperature=0.7, top_k=3, top_p=0.95)
    pen = np.asarray(jsmp.apply_repeat_penalty(
        jnp.asarray(logits), jnp.asarray(ring), cfg.repeat_penalty))
    top3 = np.argsort(-pen, axis=-1)[:, :3]
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        ids = tsmp.sample_tokens(g, torch.from_numpy(logits),
                                 torch.from_numpy(ring), cfg).numpy()
        assert all(ids[b] in top3[b] for b in range(3))


def test_update_ring_matches_jax():
    ring = np.full((2, 4), -1, np.int32)
    for step, new in enumerate(([3, 4], [5, 6], [7, 8], [9, 1], [2, 2])):
        want = jsmp.update_ring(jnp.asarray(ring), jnp.asarray(new), step)
        got = tsmp.update_ring(torch.from_numpy(ring), torch.tensor(new),
                               step)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        ring = np.array(want)


def test_master_generate_text_matches_jax(params):
    j, t = _generators(params, flash=True)
    jm = JMaster(JArgs(sample_len=6, system_prompt="sys", prompt="hey"),
                 text_generator=j)
    tm = Master(Args(sample_len=6, system_prompt="sys", prompt="hey"),
                text_generator=t)
    streamed = {"j": [], "t": []}
    for m, msg, key in ((jm, JMessage, "j"), (tm, Message, "t")):
        m.add_message(msg.system("sys"))
        m.add_message(msg.user("hey"))
        text = m.generate_text(lambda tok, k=key: streamed[k].append(tok.id))
        streamed[key].append(text)
    assert streamed["t"] == streamed["j"]
    assert tm.tokens_per_s > 0
    tm.reset()
    assert t.tokens == [] and len(t.history) == 0
