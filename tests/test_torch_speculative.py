"""The port's batch-1 speculative generator (models/llama/speculative.py,
serve/graphs.SpecGeneratorRunner) against the JAX package's
`SpeculativeGenerator` (tests/test_speculative.py's generator cases).

Tiny config, f32 params and caches, the same weights on both sides
(numpy-seeded through the JAX init):

  * greedy streams equal JAX's and the target-only LlamaGenerator's
    with a bad draft (another seed) and a perfect one (the target), and
    JAX's acceptance counts;
  * `spec_scan`'s R = 4 chained rounds equal single rounds, and a
    window too short for R rounds falls back to single ones;
  * the `next_token` session equals JAX's, and again after `reset`;
  * a sampled generator is deterministic for a seed, and two calls on
    one generator differ (each call a stream of its own);
  * the refusals (repeat_penalty, top-k/top-p) and the context's
    wiring: --draft-model builds the generator, --prefill-chunk and
    --batch-size 2 are refused with it, an unset --repeat-penalty is 1.0
    under --draft-model only, and --api over it raises (ROADMAP A11).

The `cuda` cases (the card's captured rounds against the CPU's eager
ones and against greedy LlamaGenerator; R chained replays against R
single rounds) skip without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_speculative.py
"""

import numpy as np
import pytest
import torch

from cake_tpu_torch.models.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.ops.sampling import SamplingConfig

PROMPT = np.full((1, 9), 5, np.int32)
PLEN = np.full((1,), 9, np.int32)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured round replays only "
                    "on CUDA")


@pytest.fixture(scope="module")
def models():
    """(JAX params, port params) of the target (seed 0) and of a bad
    draft (seed 42), f32, tiny config."""
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny()
    out = []
    for seed in (0, 42):
        jp = j_init(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
        out.append((jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu")))
    return jc, out[0], out[1]


def _greedy():
    return SamplingConfig(temperature=0.0, repeat_penalty=1.0)


def _spec(target, draft, device="cpu", gamma=3, max_seq_len=256,
          sampling=None, **kw):
    from cake_tpu_torch.models.llama.speculative import SpeculativeGenerator
    cfg = LlamaConfig.tiny()
    return SpeculativeGenerator(
        cfg, target, cfg, draft, ByteTokenizer(cfg.vocab_size), gamma=gamma,
        max_seq_len=max_seq_len, sampling=sampling or _greedy(),
        cache_dtype=torch.float32, device=device, **kw)


def _jspec(jc, target, draft, gamma=3, max_seq_len=256, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.models.llama.speculative import (
        SpeculativeGenerator as JSpec,
    )
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    return JSpec(jc, target, jc, draft, JTok(jc.vocab_size), gamma=gamma,
                 max_seq_len=max_seq_len,
                 sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                 cache_dtype=jnp.float32, **kw)


def _oracle(target, device="cpu"):
    from cake_tpu_torch.models.llama.generator import LlamaGenerator
    cfg = LlamaConfig.tiny()
    return LlamaGenerator(cfg, target, ByteTokenizer(cfg.vocab_size),
                          max_seq_len=256, sampling=_greedy(),
                          cache_dtype=torch.float32, device=device)


@pytest.fixture(scope="module")
def oracle_stream(models):
    return _oracle(models[1][1]).generate_on_device(PROMPT, PLEN, 20)


@pytest.mark.parametrize("which", ["bad", "perfect"])
def test_greedy_streams_match_jax_and_the_oracle(models, oracle_stream,
                                                 which):
    jc, (jt, tt), (jd, td) = models
    draft_j, draft_t = (jd, td) if which == "bad" else (jt, tt)
    js = _jspec(jc, jt, draft_j)
    want = js.generate_on_device(PROMPT, PLEN, 20)
    spec = _spec(tt, draft_t)
    got = spec.generate_on_device(PROMPT, PLEN, 20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle_stream)
    assert (spec.proposed, spec.accepted) == (js.proposed, js.accepted)
    if which == "perfect":
        assert spec.acceptance_rate == 1.0


def test_spec_scan_rounds_match_single_rounds(models, oracle_stream):
    _, (_, tt), (_, td) = models
    one = _spec(tt, td, spec_rounds=1).generate_on_device(PROMPT, PLEN, 20)
    scan = _spec(tt, td, spec_rounds=4).generate_on_device(PROMPT, PLEN, 20)
    np.testing.assert_array_equal(one, oracle_stream)
    np.testing.assert_array_equal(scan, oracle_stream)


def test_window_edge_falls_back_to_single_rounds(models):
    """Near max_seq_len R rounds do not fit: single rounds, the same
    stream as a spec_rounds=1 generator and as JAX's."""
    jc, (jt, tt), (jd, td) = models
    prompt = np.full((1, 20), 5, np.int32)
    plen = np.full((1,), 20, np.int32)
    want = _spec(tt, td, max_seq_len=48, spec_rounds=1).generate_on_device(
        prompt, plen, 8)
    got = _spec(tt, td, max_seq_len=48, spec_rounds=4).generate_on_device(
        prompt, plen, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jspec(
        jc, jt, jd, max_seq_len=48, spec_rounds=4).generate_on_device(
            prompt, plen, 8))


def test_session_matches_jax_and_again_after_reset(models):
    jc, (jt, tt), (jd, td) = models
    js, spec = _jspec(jc, jt, jd), _spec(tt, td)
    for g in (js, spec):
        g.add_message(Message.user("hi"))
    want = [js.next_token(i).id for i in range(12)]
    assert [spec.next_token(i).id for i in range(12)] == want
    assert (spec.proposed, spec.accepted) == (js.proposed, js.accepted)
    spec.reset()
    spec.add_message(Message.user("hi"))
    assert [spec.next_token(i).id for i in range(12)] == want
    assert spec.generated_tokens() == 12


def test_sampled_generation_is_seeded_and_calls_differ(models):
    _, (_, tt), (_, td) = models
    hot = SamplingConfig(temperature=0.8, repeat_penalty=1.0)
    prompt = np.full((1, 6), 9, np.int32)
    plen = np.full((1,), 6, np.int32)
    a = _spec(tt, td, sampling=hot, seed=7).generate_on_device(prompt, plen,
                                                               10)
    spec = _spec(tt, td, sampling=hot, seed=7)
    b = spec.generate_on_device(prompt, plen, 10)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 10) and (a >= 0).all()
    assert not np.array_equal(b, spec.generate_on_device(prompt, plen, 10))
    # a sampled round draws gamma + 3 times from the stream
    r = spec._scratch
    before = int(r.counters[0])
    r.begin(int(b[0, -1]), 30, 0.8)
    r.run((3, False), 1)
    assert int(r.counters[0]) == before + 6


def test_refusals(models):
    _, (_, tt), (_, td) = models
    with pytest.raises(ValueError, match="repeat_penalty"):
        _spec(tt, td, sampling=SamplingConfig(temperature=0.0,
                                              repeat_penalty=1.1))
    with pytest.raises(ValueError, match="top_k/top_p"):
        _spec(tt, td, sampling=SamplingConfig(temperature=0.8,
                                              repeat_penalty=1.0, top_k=40))
    spec = _spec(tt, td)
    with pytest.raises(ValueError, match="temperature only"):
        spec.set_sampling(top_p=0.9)
    with pytest.raises(ValueError, match="temperature only"):
        spec.set_sampling(top_k=5)
    spec.set_sampling(temperature=0.5)
    assert spec.sampling.temperature == 0.5
    with pytest.raises(ValueError, match="gamma"):
        _spec(tt, td, gamma=0)


def test_the_context_wires_draft_model():
    """--draft-model builds the generator (a random tiny draft without
    weights); --prefill-chunk and --batch-size 2 are refused with it; an
    unset --repeat-penalty is 1.0 under --draft-model and 1.1 otherwise
    (under --spec-draft too, as in JAX); --api over it builds the dense
    spec engine."""
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.context import Context
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.speculative import SpeculativeGenerator

    base = dict(cpu=True, max_seq_len=128, temperature=0.0)
    gen = Context.from_args(Args(draft_model="", spec_gamma=2,
                                 **base).validate()).load_text_model()
    assert isinstance(gen, SpeculativeGenerator) and gen.gamma == 2
    assert gen.sampling.repeat_penalty == 1.0
    gen.add_message(Message.user("hi"))
    assert len([gen.next_token(i).id for i in range(4)]) == 4
    with pytest.raises(ValueError, match="prefill-chunk"):
        Context.from_args(Args(draft_model="", prefill_chunk=32,
                               **base).validate()).load_text_model()
    with pytest.raises(ValueError, match="batch-1"):
        Context.from_args(Args(draft_model="", batch_size=2,
                               **base).validate()).load_text_model()
    plain = Context.from_args(Args(spec_draft="d", kv_pages=16,
                                   **base).validate())
    assert plain.load_text_model().sampling.repeat_penalty == 1.1
    # --api over it: the dense spec engine, with the draft's params
    eng = Master(Args(draft_model="", **base),
                 text_generator=gen).make_engine(max_slots=2)
    assert eng._spec and not eng.paged and eng.spec_gamma == 2
    assert eng.draft_params is gen.draft_params
    assert eng.d_cache.k.shape[1:3] == (2, 128)
    assert eng.flight.impl == "spec"


def test_the_engine_takes_the_spec_draft_from_master(tmp_path):
    """--spec-draft through Master.make_engine: the engine gets the
    draft (a random tiny one without weights), unquantized under
    --quant, and its spec plane."""
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.ops.quant import QTensor

    a = Args(cpu=True, spec_draft=str(tmp_path), spec_gamma=2, quant="int8",
             max_seq_len=128, kv_pages=16, kv_page_size=16).validate()
    eng = Master.from_args(a).make_engine(max_slots=2)
    assert eng._specp is not None and eng._specp.live_gamma == 2
    assert not isinstance(eng._specp.draft_params["blocks"]["wq"], QTensor)
    assert eng.d_cache.n_pages == 16


# -- on the card ----------------------------------------------------------------
#
# The card has no JAX: its cases use the port's own init, made on the
# CPU and copied.


def _port_params():
    from cake_tpu_torch.models.llama.params import init_params
    return [init_params(LlamaConfig.tiny(), torch.Generator().manual_seed(s),
                        device="cpu", dtype=torch.float32) for s in (0, 42)]


def _card(p):
    return {k: _card(v) if isinstance(v, dict) else v.cuda()
            for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["bad", "perfect"])
def test_cuda_captured_rounds_match_the_cpu_and_the_oracle(which):
    """The card's captured rounds (R = 4 chained replays, one fetch)
    give the CPU's eager stream and greedy LlamaGenerator's on the
    card; one capture per (gamma, greedy)."""
    _cuda_or_skip()
    tt, td = _port_params()
    if which == "perfect":
        td = tt
    want = _spec(tt, td).generate_on_device(PROMPT, PLEN, 20)
    card_t, card_d = _card(tt), _card(td)
    spec = _spec(card_t, card_d, device="cuda")
    np.testing.assert_array_equal(spec.generate_on_device(PROMPT, PLEN, 20),
                                  want)
    np.testing.assert_array_equal(
        _oracle(card_t, device="cuda").generate_on_device(PROMPT, PLEN, 20),
        want)
    assert spec._scratch.captures == 1


@pytest.mark.cuda
def test_cuda_chained_replays_equal_single_rounds():
    """One `spec_scan` of R = 4 chained replays equals four single
    rounds, tokens and n, on the card."""
    _cuda_or_skip()
    card_t, card_d = (_card(p) for p in _port_params())
    got = []
    for R, calls in ((4, 1), (1, 4)):
        spec = _spec(card_t, card_d, device="cuda", spec_rounds=R)
        r = spec._runner
        first = spec._prefill_both(r, [5] * 9)
        last, pos, outs = first, 9, []
        for _ in range(calls):
            o, n = spec._rounds(r, last, pos, R)
            for k in range(R):
                outs.append((o[k, :n[k]].tolist(), int(n[k])))
                last, pos = int(o[k, n[k] - 1]), pos + int(n[k])
        got.append(outs)
    assert got[0] == got[1]
