"""The dense spec engine (`--draft-model` behind `--api`:
`InferenceEngine(draft_params=, draft_config=)`, its round
`speculative.spec_round_batched`, serve/graphs.DenseSpecRunner) against
the JAX package's.

At tiny sizes, f32 params and caches:

  * `spec_round_batched` equals JAX's on the same caches: greedy out and
    n_emit exactly, both caches within 1e-5, an inactive row untouched;
    the chained state is each active row's last emitted token at its
    new frontier;
  * a sampled row draws from the counter-based streams at the offsets
    of spec/accept.py (pinned: the dense round gives the paged round's
    tokens, counts and counters on caches holding the same KV), and a
    round advances its counter by gamma + 3 (greedy and inactive rows
    not at all);
  * the engine's greedy streams equal the JAX dense spec engine's and
    the plain dense engine's, with a self-draft and a mismatched 1-layer
    draft, a stream that reaches the window's cap included, and the
    acceptance stats equal JAX's;
  * a sampled wave is reproducible from the seed;
  * JAX's refusals: temperature-only sampling, no logprobs, no prefix,
    no switch, preemption and recovery off with a warning,
    --prefill-chunk and --decode-scan ignored.

The `cuda` cases (the captured round against the same round eagerly, a
sampled row among greedy ones; the card engine against the CPU engine
with a self-draft and a mismatched draft over two waves; a wave whose
rounds' dispatches run under `torch.cuda.set_sync_debug_mode("error")`)
skip without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_dense_spec.py
"""

import logging

import numpy as np
import pytest
import torch

from cake_tpu_torch.models.llama.config import LlamaConfig

T = 64
GAMMA = 3
GEN = 16
PROMPTS = ([5, 6, 7, 8, 9], [11, 12, 13], [(3 * j) % 50 + 3 for j in range(20)])
# a prompt a few tokens short of the window: its stream is finished at
# the cap (a round needs gamma + 1 free positions)
CAPPED = [(7 * j) % 60 + 3 for j in range(T - 9)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured round replays only "
                    "on CUDA")


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params) of the 2-layer
    target, and the same four of a 1-layer draft of another seed."""
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    def pair(layers, seed):
        jc = JConfig.tiny(num_hidden_layers=layers)
        jp = j_init(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        return jc, jp, LlamaConfig.tiny(num_hidden_layers=layers), tp
    return pair(2, 0), pair(1, 42)


def _jax_engine(target, draft, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp, _, _ = target
    return JEngine(jc, jp, JTok(jc.vocab_size), max_slots=2, max_seq_len=T,
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, draft_params=draft[1],
                   draft_config=draft[0], spec_gamma=GAMMA, **kw)


def _engine(target, draft=None, device="cpu", params=None,
            draft_params=None, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    _, _, tc, tp = target
    if draft is not None:
        kw.update(draft_params=(draft_params if draft_params is not None
                                else draft[3]),
                  draft_config=draft[2])
        kw.setdefault("spec_gamma", GAMMA)
    kw.setdefault("max_slots", 2)
    return InferenceEngine(
        tc, params if params is not None else tp,
        ByteTokenizer(tc.vocab_size), device=device, max_seq_len=T,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, **kw)


def _drive(eng, prompts=PROMPTS, gen=GEN, temperature=0.0):
    hs = [eng.submit(list(p), max_new_tokens=gen, temperature=temperature)
          for p in prompts]
    with eng:
        assert all(h.wait(timeout=300) for h in hs)
    assert all(h._req.error is None for h in hs)
    return [list(h._req.out_tokens) for h in hs]


# -- the round ---------------------------------------------------------------------


def _caches(target, draft, B, seed=3):
    """JAX and port target and draft caches holding the same random KV."""
    import jax.numpy as jnp
    from cake_tpu.models.llama.cache import KVCache as JCache
    from cake_tpu_torch.models.llama.cache import KVCache

    out = []
    for (jc, _, tc, _) in (target, draft):
        rng = np.random.default_rng(seed)
        shape = (jc.num_hidden_layers, B, T, jc.num_key_value_heads,
                 jc.head_dim)
        k = rng.standard_normal(shape).astype(np.float32) * 0.5
        v = rng.standard_normal(shape).astype(np.float32) * 0.5
        out.append((JCache(k=jnp.asarray(k), v=jnp.asarray(v)),
                    KVCache(torch.from_numpy(k.copy()),
                            torch.from_numpy(v.copy()))))
    return out


@pytest.mark.parametrize("draft_kind", ["self", "mismatched"])
def test_spec_round_batched_matches_the_jax_round(models, draft_kind):
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.model import RopeTables as JRope
    from cake_tpu.models.llama.speculative import (
        spec_round_batched as j_round,
    )
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.speculative import spec_round_batched

    target = models[0]
    draft = target if draft_kind == "self" else models[1]
    B = 4
    (jt, tt), (jd, td) = _caches(target, draft, B)
    pos = np.array([7, 20, 3, 12], np.int32)
    last = np.array([[9], [100], [3], [77]], np.int32)
    active = np.array([True, True, False, True])
    temp = np.zeros(B, np.float32)
    out_j, n_j, jt2, jd2, _, (last_j, pos_j) = j_round(
        target[1], draft[1], jt, jd, jnp.asarray(last), jnp.asarray(pos),
        jnp.asarray(active), jax.random.split(jax.random.PRNGKey(0), B),
        jnp.asarray(temp), JRope.create(target[0], T),
        JRope.create(draft[0], T), target[0], draft[0], GAMMA)
    ctr = torch.zeros(B, dtype=torch.int64)
    out_t, n_t, ctr2, (last_t, pos_t) = spec_round_batched(
        target[3], draft[3], tt, td, torch.as_tensor(last).long(),
        torch.as_tensor(pos), torch.as_tensor(active), torch.arange(B), ctr,
        torch.as_tensor(temp), RopeTables.create(target[2], T, device="cpu"),
        RopeTables.create(draft[2], T, device="cpu"), target[2], draft[2],
        GAMMA)
    assert out_t.tolist() == np.asarray(out_j).tolist()
    assert n_t.tolist() == np.asarray(n_j).tolist()
    assert last_t.tolist() == np.asarray(last_j).tolist()
    assert pos_t.tolist() == np.asarray(pos_j).tolist()
    assert ctr2.tolist() == [0] * B          # greedy rows draw nothing
    for j, t in ((jt2, tt), (jd2, td)):
        np.testing.assert_allclose(t.k.numpy(), np.asarray(j.k), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), atol=1e-5,
                                   rtol=1e-5)


def test_sampled_rows_draw_the_paged_rounds_tokens(models):
    """The dense round's sampled rows draw what the paged round draws
    from the same streams (spec/accept.py's offsets): on caches holding
    the same KV (row b's pages are rows b's dense positions) the two
    give the same out, n_emit and counters; a sampled row's counter
    moves by gamma + 3, a greedy and an inactive row's not at all."""
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.paged import PagedKVCache
    from cake_tpu_torch.models.llama.speculative import spec_round_batched
    from cake_tpu_torch.spec.accept import round_draws
    from cake_tpu_torch.spec.round import spec_round_paged

    target, draft = models
    B, PAGE = 4, 8
    n = T // PAGE
    pools, dense = [], []
    for m in (target, draft):
        c = PagedKVCache.create(m[2], B, B * n, PAGE, T, dtype=torch.float32,
                                device="cpu")
        g = torch.Generator().manual_seed(5)
        c.k.copy_(0.5 * torch.randn(c.k.shape, generator=g))
        c.v.copy_(0.5 * torch.randn(c.v.shape, generator=g))
        for b in range(B):
            c.table[b, :n] = torch.arange(b * n, (b + 1) * n)
        L = c.k.shape[0]
        rows = lambda t: t[:, :B * n].reshape(L, B, T, *t.shape[3:]).clone()  # noqa: E731
        pools.append(c)
        dense.append(KVCache(rows(c.k), rows(c.v)))
    pos = torch.tensor([7, 20, 3, 12], dtype=torch.int32)
    last = torch.tensor([[9], [100], [3], [77]])
    active = torch.tensor([True, True, False, True])
    temp = torch.tensor([0.9, 0.0, 0.7, 1.3])
    seeds = torch.tensor([11, 12, 13, 14])
    ctr = torch.tensor([0, 5, 9, 40])
    ropes = (RopeTables.create(target[2], T, device="cpu"),
             RopeTables.create(draft[2], T, device="cpu"))
    o_d, n_d, c_d, _ = spec_round_batched(
        target[3], draft[3], dense[0], dense[1], last, pos, active, seeds,
        ctr, temp, *ropes, target[2], draft[2], GAMMA)
    o_p, n_p, c_p = spec_round_paged(
        target[3], draft[3], pools[0], pools[1], last, pos, active, seeds,
        ctr, temp, *ropes, target[2], draft[2], GAMMA, attn="plain")
    assert o_d.tolist() == o_p.tolist() and n_d.tolist() == n_p.tolist()
    assert c_d.tolist() == c_p.tolist() == [
        round_draws(GAMMA), 5, 9, 40 + round_draws(GAMMA)]
    assert n_d[2] == 0 and (o_d[2] == -1).all()


# -- the engine -------------------------------------------------------------------


@pytest.mark.parametrize("draft_kind", ["self", "mismatched"])
def test_engine_matches_jax_and_the_plain_engine(models, draft_kind):
    target = models[0]
    draft = target if draft_kind == "self" else models[1]
    prompts = PROMPTS + (CAPPED,)
    jeng = _jax_engine(target, draft)
    want = _drive(jeng, prompts)
    eng = _engine(target, draft)
    assert eng._spec and eng.flight.impl == "spec"
    got = _drive(eng, prompts)
    assert got == want
    assert (eng.stats.spec_proposed, eng.stats.spec_accepted) == (
        jeng.stats.spec_proposed, jeng.stats.spec_accepted)
    if draft_kind == "self":
        assert eng.stats.spec_accepted == eng.stats.spec_proposed
    # greedy speculation is the target's own greedy stream
    assert got[:len(PROMPTS)] == _drive(_engine(target), PROMPTS)
    # the capped stream stops where a round no longer fits the window
    assert len(got[-1]) < GEN and len(CAPPED) + len(got[-1]) <= T


def test_sampled_wave_is_reproducible_from_the_seed(models):
    target, draft = models
    runs = [_drive(_engine(target, draft, seed=7), temperature=0.8)
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert _drive(_engine(target, draft, seed=8), temperature=0.8) \
        != runs[0]


def test_the_spec_engine_refusals_match_jax(models, caplog):
    target, draft = models
    eng = _engine(target, draft)
    jeng = _jax_engine(target, draft)
    for e in (eng, jeng):
        for kw in (dict(top_p=0.9), dict(repeat_penalty=1.1),
                   dict(want_top_logprobs=True)):
            with pytest.raises(ValueError):
                e.submit([5, 6], **kw)
        with pytest.raises(ValueError, match="speculative serving keeps"):
            e.register_prefix([5] * 9)
        with pytest.raises(ValueError, match="speculative serving has no"):
            e.reconfigure({"slots": 4})
    assert eng._reconfig_refusal() == jeng._reconfig_refusal()
    caplog.set_level(logging.WARNING)
    e = _engine(target, draft, priority_classes=True, preemption=True,
                recovery=True, prefill_chunk=8, decode_scan_steps=4)
    assert not e._preemption and not e._recover
    assert e.prefill_chunk is None and e._decode_scan == 1
    for text in ("preemption disabled", "crash recovery disabled",
                 "prefill_chunk ignored", "decode_scan ignored"):
        assert text in caplog.text
    with pytest.raises(ValueError, match="gamma"):
        _engine(target, draft, spec_gamma=0)


# -- on the card -----------------------------------------------------------------


def _captures(eng) -> list:
    """Every graph capture of the engine from here on, by its JAX
    function's name."""
    seen = []
    real = eng.flight.count_capture

    def count(fn, seconds):
        seen.append(fn)
        real(fn, seconds)
    eng.flight.count_capture = count
    return seen


def _card(device, layers, seed):
    from cake_tpu_torch.models.llama.params import init_params
    cfg = LlamaConfig.tiny(num_hidden_layers=layers)
    p = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu",
                    dtype=torch.float32)
    on = {k: ({n: t.to(device) for n, t in v.items()}
              if isinstance(v, dict) else v.to(device))
          for k, v in p.items()}
    return (None, None, cfg, p), on


@pytest.mark.cuda
def test_cuda_round_replay_matches_the_eager_round():
    """The captured round against the same round eagerly on copies of
    the caches: out, n_emit, counters and the chained carry equal, the
    caches within 1e-5, a sampled row among greedy ones; two chained
    replays against two eager rounds."""
    _cuda_or_skip()
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.speculative import spec_round_batched
    from cake_tpu_torch.serve.graphs import DenseSpecRunner, SpecRunner

    (_, _, tc, _), tp = _card("cuda", 2, 0)
    (_, _, dc, _), dp = _card("cuda", 1, 42)
    B = 3
    caches = []
    for cfg in (tc, dc):
        c = KVCache.create(cfg, B, T, dtype=torch.float32, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        c.k.copy_(0.5 * torch.randn(c.k.shape, generator=g, device="cuda"))
        c.v.copy_(0.5 * torch.randn(c.v.shape, generator=g, device="cuda"))
        caches.append(c)
    eager = [KVCache(c.k.clone(), c.v.clone()) for c in caches]
    rt = RopeTables.create(tc, T, device="cuda")
    rd = RopeTables.create(dc, T, device="cuda")
    seeds = torch.arange(B, device="cuda")
    ctr = torch.zeros(B, dtype=torch.int64, device="cuda")
    ctr_e = ctr.clone()
    runner = DenseSpecRunner(tp, dp, caches[0], caches[1], rt, rd, tc, dc,
                             seeds=seeds, counters=ctr, max_gamma=GAMMA)
    last = np.array([9, 100, 3])
    pos = np.array([7, 20, 3])
    active = np.array([True, True, False])
    temp = np.array([0.0, 0.8, 0.0], np.float32)
    runner.load(last, pos, active, temp)
    last_e = torch.as_tensor(last, device="cuda")[:, None]
    pos_e = torch.as_tensor(pos, device="cuda").int()
    for _ in range(2):
        out, n_emit = SpecRunner.fetch(runner.run(GAMMA))
        o_e, n_e, ctr_e, (last_e, pos_e) = spec_round_batched(
            tp, dp, eager[0], eager[1], last_e, pos_e,
            torch.as_tensor(active, device="cuda"), seeds, ctr_e,
            torch.as_tensor(temp, device="cuda"), rt, rd, tc, dc, GAMMA)
        assert out.tolist() == o_e.tolist()
        assert n_emit.tolist() == n_e.tolist()
        assert ctr.tolist() == ctr_e.tolist()
        assert runner.pos.tolist() == pos_e.tolist()
        for c, e in zip(caches, eager):
            torch.testing.assert_close(c.k, e.k, atol=1e-5, rtol=1e-5)
    assert runner.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("draft_kind", ["self", "mismatched"])
def test_cuda_engine_matches_the_cpu_engine(draft_kind):
    """The card spec engine gives the CPU engine's greedy streams over
    two waves (one round capture a gamma, none in the second wave)."""
    _cuda_or_skip()
    target, tp = _card("cuda", 2, 0)
    draft, dp = ((target, tp) if draft_kind == "self"
                 else _card("cuda", 1, 42))
    streams = {}
    for device in ("cpu", "cuda"):
        eng = _engine(target, draft, device=device,
                      params=tp if device == "cuda" else None,
                      draft_params=dp if device == "cuda" else None)
        waves = []
        caps = _captures(eng)
        with eng:
            for _ in range(2):
                hs = [eng.submit(list(p), max_new_tokens=GEN)
                      for p in PROMPTS]
                assert all(h.wait(timeout=300) for h in hs)
                waves.append(([list(h._req.out_tokens) for h in hs],
                              len(caps)))
        streams[device] = [w[0] for w in waves]
        if device == "cuda":
            assert waves[0][1] == waves[1][1] > 0
            assert eng._spec_runner.captures == 1
    assert streams["cuda"] == streams["cpu"]


@pytest.mark.cuda
def test_cuda_spec_wave_never_waits_for_the_stream():
    """Once every variant is captured, a wave's rounds (load, replay,
    the outputs' copy) run under `torch.cuda.set_sync_debug_mode
    ("error")`; the fetch is excepted."""
    _cuda_or_skip()
    from cake_tpu_torch.serve.graphs import DenseSpecRunner
    target, tp = _card("cuda", 2, 0)
    eng = _engine(target, target, device="cuda", params=tp, draft_params=tp)
    guarded = [0]
    armed = [False]
    run = DenseSpecRunner.run

    def guarded_run(self, gamma):
        if not armed[0]:
            return run(self, gamma)
        torch.cuda.set_sync_debug_mode("error")
        try:
            guarded[0] += 1
            return run(self, gamma)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    DenseSpecRunner.run = guarded_run
    try:
        with eng:
            for wave in range(2):
                armed[0] = wave == 1
                hs = [eng.submit(list(p), max_new_tokens=GEN)
                      for p in PROMPTS]
                assert all(h.wait(timeout=300) for h in hs)
                assert all(h._req.error is None for h in hs)
    finally:
        DenseSpecRunner.run = run
    assert guarded[0] > 0
