"""Paged speculative decoding in the port (spec/, serve/engine.py's spec
plane, serve/graphs.SpecRunner) against the JAX package's
(`cake_tpu/spec`, tests/test_spec_paged.py).

At tiny sizes, f32 params and pools, greedy:

  * the accept arithmetic equals `cake_tpu.spec.accept` on the same
    numpy-seeded inputs (exactly, integers; resid within 1e-6);
  * the rows' draws come from the counter-based streams at fixed
    offsets, pinned here, and a round advances a sampled row's counter
    by gamma + 3 (greedy and inactive rows not at all), where JAX splits
    threefry keys;
  * `spec_round_paged` equals JAX's on the same pools: greedy out and
    n_emit exactly, the pages it writes within 1e-5;
  * the engine's greedy streams equal the JAX spec engine's and the
    plain engine's, with a self-draft, a mismatched 1-layer draft and
    shared-prefix rows, and the pool is conserved after every wave,
    forced rejections and spec.verify storms included;
  * the gamma tuner moves as JAX's over the same acceptance sequence;
  * the incompatible flavors are refused, and a row whose
    repeat_penalty is not 1.0 decodes plain (JAX's rule);
  * /metrics carries the spec lines.

The `cuda` cases (the captured round against its eager call, the card
engine against the CPU engine, the round's host side under
`torch.cuda.set_sync_debug_mode("error")`) skip without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_spec.py
"""

import numpy as np
import pytest
import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.serve.errors import RecoveryConfig

T = 64
PAGE = 8
PAGES = 32
GAMMA = 3
GEN = 16
P1 = [5, 6, 7, 8, 9]
P2 = [11, 12, 13]
PREFIX = [7] * (2 * PAGE)
SUFFIXES = ([3, 9, 4], [8, 2, 6, 1])
FAST = dict(backoff_base_s=0.0, backoff_cap_s=0.0)


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


def _jax_engine(target, draft=None, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine
    from cake_tpu.serve.errors import RecoveryConfig as JRecovery

    jc, jp, _, _ = target
    if draft is not None:
        kw.update(spec_draft_params=draft[1], spec_draft_config=draft[0],
                  spec_gamma=GAMMA)
    return JEngine(jc, jp, JTok(jc.vocab_size), max_slots=2, max_seq_len=T,
                   kv_pages=PAGES, kv_page_size=PAGE,
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32,
                   recovery_config=JRecovery(**FAST), **kw)


def _engine(target, draft=None, device="cpu", **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    _, _, tc, tp = target
    if draft is not None:
        kw.update(spec_draft_params=draft[3], spec_draft_config=draft[2])
        kw.setdefault("spec_gamma", GAMMA)
    kw.setdefault("max_slots", 2)
    return InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device=device, max_seq_len=T,
        kv_pages=PAGES, kv_page_size=PAGE,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, recovery_config=RecoveryConfig(**FAST),
        **kw)


def _wave(eng, prompts=(P1, P2), prefix=None, penalty=1.0):
    with eng:
        if prefix is not None:
            eng.register_prefix(list(prefix))
        hs = [eng.submit(list(p), max_new_tokens=GEN, temperature=0.0,
                         repeat_penalty=penalty) for p in prompts]
        assert all(h.wait(timeout=300) for h in hs), "wave timed out"
        assert all(h._req.error is None for h in hs)
        return [list(h._req.out_tokens) for h in hs]


def _pool_conserved(eng, registry_pages=0):
    pg = eng._pager
    assert pg.free_pages + pg.live_pages == pg.n_pages
    assert pg.live_pages == registry_pages, (
        f"leaked pages: live {pg.live_pages}, registry {registry_pages}")
    if eng._specp is not None:
        assert not eng._specp.spec_streams


@pytest.fixture(scope="module")
def plain(models):
    return _wave(_engine(models[0]))


@pytest.fixture(scope="module")
def jax_self(models):
    eng = _jax_engine(models[0], draft=models[0])
    return _wave(eng), eng.stats.spec_proposed, eng.stats.spec_accepted


# -- the arithmetic ------------------------------------------------------------


def test_accept_arithmetic_matches_the_jax_package():
    import jax.numpy as jnp
    from cake_tpu.spec import accept as ja
    from cake_tpu_torch.spec import accept as ta

    rng = np.random.default_rng(0)
    B, g, V = 6, 4, 32
    d_probs = rng.dirichlet(np.ones(V), size=(B, g)).astype(np.float32)
    t_probs = rng.dirichlet(np.ones(V), size=(B, g + 1)).astype(np.float32)
    drafts = rng.integers(0, V, size=(B, g)).astype(np.int32)
    targets = np.concatenate([drafts[:, :2], rng.integers(
        0, V, size=(B, g - 1))], axis=1).astype(np.int32)
    targets[0, :g] = drafts[0]              # a row accepting everything
    u = rng.random((B, g)).astype(np.float32)
    u[1] = 0.0                              # accepts wherever p_t > 0
    u[2] = 1.0                              # rejects at once
    n_j = np.asarray(ja.greedy_accept(jnp.asarray(drafts),
                                      jnp.asarray(targets)))
    n_t = ta.greedy_accept(torch.as_tensor(drafts).long(),
                           torch.as_tensor(targets).long())
    assert n_t.tolist() == n_j.tolist() and n_j[0] == g
    nj, rj = ja.rejection_accept(jnp.asarray(drafts), jnp.asarray(d_probs),
                                 jnp.asarray(t_probs), jnp.asarray(u), g)
    nt, rt = ta.rejection_accept(torch.as_tensor(drafts).long(),
                                 torch.as_tensor(d_probs),
                                 torch.as_tensor(t_probs),
                                 torch.as_tensor(u), g)
    assert nt.tolist() == np.asarray(nj).tolist()
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)
    corr = rng.integers(0, V, size=B).astype(np.int32)
    oj = ja.assemble_sampled(jnp.asarray(drafts), jnp.asarray(corr), nj, g)
    ot = ta.assemble_sampled(torch.as_tensor(drafts).long(),
                             torch.as_tensor(corr).long(), nt, g)
    assert ot.tolist() == np.asarray(oj).tolist()


def test_round_draws_are_pinned_counter_offsets():
    """A round's draws are the counter-based streams at c..c+gamma+2:
    uniforms are the top 24 bits of `random_bits` (pinned here), a draw
    is the exponential race at its counter, and `advance_counters`
    moves sampled rows by gamma + 3 and no other row."""
    from cake_tpu_torch.ops import sampling as ts
    from cake_tpu_torch.spec import accept as ta

    seeds = torch.tensor([0, 1, 12345, 2**40 + 7])
    ctr = torch.tensor([0, 5, 17, 3])
    u = ta.uniforms(seeds, ctr, 3)
    bits = ts.random_bits(seeds, ctr, 3)
    assert torch.equal(u, ((bits >> 8).float() + 0.5) * 2.0 ** -24)
    np.testing.assert_allclose(u.numpy(), [
        [0.4949832856655121, 0.09411272406578064, 0.8630728721618652],
        [0.5262261629104614, 0.16054388880729675, 0.7371647357940674],
        [0.2738403379917145, 0.43556687235832214, 0.06668522953987122],
        [0.7869243621826172, 0.12377044558525085, 0.19076910614967346]],
        rtol=0, atol=0)
    probs = torch.softmax(torch.arange(50.0).repeat(4, 1) / 10, -1)
    got = ta.categorical(seeds, ctr + 2, probs)
    want = torch.argmax(probs / ts.exponentials(seeds, ctr + 2, 50), -1)
    assert torch.equal(got, want) and got.tolist() == [47, 40, 36, 39]
    mask = torch.tensor([True, False, True, False])
    assert ta.advance_counters(ctr, mask, 4).tolist() == [7, 5, 24, 3]
    assert ta.round_draws(4) == 7


def _pools(target, draft, rows):
    """JAX and port target and draft pools holding the same random KV
    (every position, so the first `ctx` of each row too), rows mapped
    to distinct pages."""
    import jax.numpy as jnp
    from cake_tpu.models.llama.paged import PagedKVCache as JCache
    from cake_tpu_torch.models.llama.paged import PagedKVCache

    out = []
    for (jc, _, tc, _) in (target, draft):
        # one seed a pool: a self-draft's pools hold the same KV
        rng = np.random.default_rng(3)
        jcache = JCache.create(jc, rows, PAGES, PAGE, T, dtype=jnp.float32)
        tcache = PagedKVCache.create(tc, rows, PAGES, PAGE, T,
                                     dtype=torch.float32, device="cpu")
        k = rng.standard_normal(jcache.k.shape).astype(np.float32) * 0.5
        v = rng.standard_normal(jcache.v.shape).astype(np.float32) * 0.5
        table = np.full(jcache.table.shape, -1, np.int32)
        for b in range(rows):
            table[b, :T // PAGE // rows] = np.arange(
                b * (T // PAGE // rows), (b + 1) * (T // PAGE // rows))
        jcache = jcache._replace(k=jnp.asarray(k), v=jnp.asarray(v),
                                 table=jnp.asarray(table))
        tcache.k.copy_(torch.as_tensor(k))
        tcache.v.copy_(torch.as_tensor(v))
        tcache.table.copy_(torch.as_tensor(table))
        out.append((jcache, tcache))
    return out


@pytest.mark.parametrize("draft_kind", ["self", "mismatched"])
def test_spec_round_paged_matches_the_jax_round(models, draft_kind):
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.model import RopeTables as JRope
    from cake_tpu.spec.round import spec_round_paged as j_round
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.spec.round import spec_round_paged

    target = models[0]
    draft = target if draft_kind == "self" else models[1]
    B = 4
    (jt, tt), (jd, td) = _pools(target, draft, B)
    pos = np.array([7, 20, 3, 12], np.int32)
    last = np.array([[9], [100], [3], [77]], np.int32)
    active = np.array([True, True, False, True])
    temp = np.zeros(B, np.float32)
    out_j, n_j, jt2, jd2, _ = j_round(
        target[1], draft[1], jt, jd, jnp.asarray(last), jnp.asarray(pos),
        jnp.asarray(active), jax.random.split(jax.random.PRNGKey(0), B),
        jnp.asarray(temp), JRope.create(target[0], T),
        JRope.create(draft[0], T), target[0], draft[0], GAMMA,
        attn="fold")
    ctr = torch.zeros(B, dtype=torch.int64)
    out_t, n_t, ctr2 = spec_round_paged(
        target[3], draft[3], tt, td, torch.as_tensor(last).long(),
        torch.as_tensor(pos), torch.as_tensor(active),
        torch.arange(B), ctr, torch.as_tensor(temp),
        RopeTables.create(target[2], T, device="cpu"),
        RopeTables.create(draft[2], T, device="cpu"), target[2], draft[2],
        GAMMA)
    assert out_t.tolist() == np.asarray(out_j).tolist()
    assert n_t.tolist() == np.asarray(n_j).tolist()
    assert n_t[2] == 0 and (n_t[active] >= 1).all()
    assert ctr2.tolist() == [0] * B       # greedy rows draw nothing
    for jc, tc in ((jt2, tt), (jd2, td)):
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5)
    if draft_kind == "self":
        assert (n_t[active] == GAMMA + 1).all()


def test_sampled_rows_draw_and_advance_only_their_streams(models):
    """A sampled row's counter moves by gamma + 3 a round whatever it
    accepts, a greedy or inactive row's not at all; the sampled row's
    tokens are a function of its own stream (the same seeds and
    counters give the same round)."""
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.spec.round import spec_round_paged

    target, draft = models
    B = 4
    rope_t = RopeTables.create(target[2], T, device="cpu")
    rope_d = RopeTables.create(draft[2], T, device="cpu")
    pos = torch.tensor([7, 20, 3, 12], dtype=torch.int32)
    last = torch.tensor([[9], [100], [3], [77]])
    active = torch.tensor([True, True, False, True])
    temp = torch.tensor([0.0, 0.8, 0.8, 1.3])
    outs = []
    for _ in range(2):
        (_, tt), (_, td) = _pools(target, draft, B)
        ctr = torch.tensor([4, 9, 2, 0])
        out, n, ctr2 = spec_round_paged(
            target[3], draft[3], tt, td, last, pos, active, torch.arange(B),
            ctr, temp, rope_t, rope_d, target[2], draft[2], GAMMA)
        outs.append((out.tolist(), n.tolist()))
        assert ctr2.tolist() == [4, 9 + GAMMA + 3, 2, GAMMA + 3]
        assert ((out >= 0).sum(1) == n).all()
    assert outs[0] == outs[1]


# -- the engine ------------------------------------------------------------------


def test_self_draft_streams_match_jax_and_plain(models, plain, jax_self):
    eng = _engine(models[0], draft=models[0])
    toks = _wave(eng)
    want, j_prop, j_acc = jax_self
    assert toks == want == plain
    assert (eng.stats.spec_proposed, eng.stats.spec_accepted) == (j_prop,
                                                                   j_acc)
    assert eng.stats.spec_accepted / eng.stats.spec_proposed > 0.5
    _pool_conserved(eng)
    assert eng._spec_runner.captures == 0       # eager on the CPU
    kinds = {r["kind"] for r in eng.flight.dump()}
    assert "spec" in kinds


def test_mismatched_draft_streams_match_jax_and_plain(models, plain):
    jeng = _jax_engine(models[0], draft=models[1])
    want = _wave(jeng)
    eng = _engine(models[0], draft=models[1])
    toks = _wave(eng)
    assert toks == want == plain
    assert eng.stats.spec_proposed == jeng.stats.spec_proposed > 0
    assert eng.stats.spec_accepted == jeng.stats.spec_accepted
    _pool_conserved(eng)


def test_shared_prefix_streams_match_jax(models):
    prompts = [PREFIX + list(s) for s in SUFFIXES]
    want = _wave(_jax_engine(models[0], draft=models[0]), prompts=prompts,
                 prefix=PREFIX)
    eng = _engine(models[0], draft=models[0])
    toks = _wave(eng, prompts=prompts, prefix=PREFIX)
    assert toks == want == _wave(_engine(models[0]), prompts=prompts,
                                 prefix=PREFIX)
    assert eng.stats.prefix_hits == len(prompts)
    assert eng.stats.spec_proposed > 0
    _pool_conserved(eng, registry_pages=len(PREFIX) // PAGE)


def test_forced_rejections_leak_no_pages(models, plain):
    eng = _engine(models[0], draft=models[0],
                  fault_plan="seed=5;spec.verify:p=0.5:transient",
                  recovery=True)
    assert _wave(eng) == plain
    assert eng._faults.total >= 1, "the planned faults never fired"
    assert eng.stats.recoveries == 0
    _pool_conserved(eng)


def test_verify_fault_storm_degrades_with_events(models, plain):
    from cake_tpu_torch.spec.state import DISABLE_AFTER_FAILS
    eng = _engine(models[0], draft=models[0],
                  fault_plan="seed=1;spec.verify:always:transient:times=12")
    assert _wave(eng) == plain
    assert eng._faults.total >= DISABLE_AFTER_FAILS
    deg = eng.events.dump(type="spec_degraded")
    assert deg and all(e["action"] == "disabled" for e in deg)
    assert {e["reason"] for e in deg} == {"verify_faults"}
    assert {e["rid"] for e in deg} == {1, 2}
    faulted = [e for e in eng.events.dump(type="spec_round")
               if e.get("fault")]
    assert len(faulted) >= DISABLE_AFTER_FAILS
    assert all(e["accepted"] == 0 for e in faulted)
    _pool_conserved(eng)


def test_a_real_dispatch_error_goes_to_recovery(models, plain,
                                                monkeypatch):
    """An error inside the round that is not an injected fault resets
    the engine with the round's rows implicated, and the streams still
    finish with the uninterrupted tokens."""
    from cake_tpu_torch.serve import graphs
    eng = _engine(models[0], draft=models[0], recovery=True)
    real = graphs.SpecRunner.step
    calls = {"n": 0}

    def flaky(self, gamma):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("device lost")
        return real(self, gamma)
    monkeypatch.setattr(graphs.SpecRunner, "step", flaky)
    assert _wave(eng) == plain
    assert eng.stats.recoveries == 1
    _pool_conserved(eng)


def test_gamma_tuner_moves_as_the_jax_tuner():
    from cake_tpu.autotune.spec import SpecGammaTuner as JTuner
    from cake_tpu.autotune.spec import SpecTunerConfig as JCfg
    from cake_tpu_torch.autotune.spec import SpecGammaTuner, SpecTunerConfig

    rng = np.random.default_rng(7)
    seq = [None] + list(np.where(rng.random(60) < 0.7, 0.1, 0.9))
    for kw in (dict(), dict(shrink_below=0.3, warmup_rounds=4, hold=2,
                            cooldown_rounds=3)):
        j, t = JTuner(8, JCfg(**kw)), SpecGammaTuner(8, SpecTunerConfig(**kw))
        for ema in seq:
            j.note_round(ema)
            t.note_round(ema)
            assert t.maybe_shrink() == j.maybe_shrink()
            assert (t.gamma, t.shrinks) == (j.gamma, j.shrinks)
        assert t.shrinks >= 1


def test_incompatible_flavors_are_refused(models):
    target = models[0]
    with pytest.raises(ValueError, match="int8|quant"):
        _engine(target, draft=target, kv_dtype="int8")
    with pytest.raises(ValueError, match="int8|quant"):
        _engine(target, draft=target, kv_dtype="int4")
    with pytest.raises(ValueError, match="gamma"):
        _engine(target, draft=target, spec_gamma=0)
    with pytest.raises(ValueError, match="mixed-batch"):
        _engine(target, draft=target, mixed_batch="off")
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(target, draft=target, draft_params=target[3],
                draft_config=target[2])
    # the dense spec engine has no pages: with them it is refused, as
    # in JAX
    with pytest.raises(ValueError, match="kv-pages requires"):
        _engine(target, draft_params=target[3], draft_config=target[2])
    other = LlamaConfig.tiny(num_hidden_layers=1, vocab_size=128)
    with pytest.raises(ValueError, match="vocabulary"):
        _engine(target, draft=(None, None, other, target[3]))
    from cake_tpu_torch.serve.engine import InferenceEngine
    with pytest.raises(ValueError, match="kv-pages"):
        InferenceEngine(target[2], target[3], None, device="cpu",
                        spec_draft_params=target[3],
                        spec_draft_config=target[2])
    # fp8 pages are allowed: the draft pool takes the pool dtype
    eng = _engine(target, draft=target, kv_dtype="f8_e4m3")
    assert eng.d_cache.k.dtype == eng.cache.k.dtype == torch.float8_e4m3fn


def test_a_penalized_row_decodes_plain(models):
    """JAX's rule (`_spec_row_ready`): a row whose repeat_penalty is not
    1.0 never speculates, and its stream is the plain engine's."""
    eng = _engine(models[0], draft=models[0])
    toks = _wave(eng, penalty=1.1)
    assert eng.stats.spec_proposed == 0
    assert toks == _wave(_engine(models[0]), penalty=1.1)
    _pool_conserved(eng)


def test_metrics_carry_the_spec_lines(models):
    from cake_tpu_torch.api.server import ApiServer
    eng = _engine(models[0], draft=models[0])
    _wave(eng)
    text = ApiServer(None, engine=eng).metrics()
    for name in ("cake_engine_spec_proposed_total",
                 "cake_engine_spec_accepted_total",
                 "cake_engine_spec_acceptance", "cake_spec_accept_ratio",
                 "cake_spec_rounds_total"):
        assert name in text, name
    assert 'cake_steps_total{kind="spec"}' in text
    assert ("cake_engine_spec_proposed_total "
            f"{eng.stats.spec_proposed}") in text


# -- on the card ----------------------------------------------------------------
#
# The card's cases import nothing of JAX (the card has none): their
# models are the port's own init, made on the CPU and copied.


@pytest.fixture(scope="module")
def port_models():
    """(None, None, config, CPU params) of the 2-layer target and the
    1-layer draft, the port's init at f32."""
    from cake_tpu_torch.models.llama.params import init_params

    def pair(layers, seed):
        c = LlamaConfig.tiny(num_hidden_layers=layers)
        return None, None, c, init_params(
            c, torch.Generator().manual_seed(seed), device="cpu",
            dtype=torch.float32)
    return pair(2, 0), pair(1, 42)


def _on_card(model):
    def move(t):
        return ({k: move(v) for k, v in t.items()} if isinstance(t, dict)
                else t.cuda())
    return model[:3] + (move(model[3]),)


def _pools_port(target, draft, rows, device):
    """Port target and draft pools with the same random KV (one seed a
    pool), rows mapped to distinct pages."""
    from cake_tpu_torch.models.llama.paged import PagedKVCache
    out = []
    for m in (target, draft):
        c = PagedKVCache.create(m[2], rows, PAGES, PAGE, T,
                                dtype=torch.float32, device=device)
        g = torch.Generator().manual_seed(3)
        c.k.copy_(0.5 * torch.randn(c.k.shape, generator=g))
        c.v.copy_(0.5 * torch.randn(c.v.shape, generator=g))
        n = T // PAGE // rows
        for b in range(rows):
            c.table[b, :n] = torch.arange(b * n, (b + 1) * n)
        out.append(c)
    return out


@pytest.mark.cuda
def test_cuda_captured_round_matches_its_eager_call(port_models):
    """The SpecRunner's replay (one graph per gamma) against the same
    round run eagerly on the card, a sampled row among greedy ones:
    equal tokens, n_emit, counters and pages."""
    _cuda_or_skip()
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.serve.graphs import SpecRunner
    from cake_tpu_torch.spec.round import spec_round_paged

    target, draft = (_on_card(m) for m in port_models)
    B = 4
    pos, last = [7, 20, 3, 12], [9, 100, 3, 77]
    active, temp = [True, True, False, True], [0.0, 0.8, 0.0, 0.0]
    got = []
    for captured in (False, True):
        tt, td = _pools_port(target, draft, B, "cuda")
        rt = RopeTables.create(target[2], T, device="cuda")
        rd = RopeTables.create(draft[2], T, device="cuda")
        seeds = torch.arange(B, device="cuda")
        ctr = torch.zeros(B, dtype=torch.int64, device="cuda")
        if captured:
            r = SpecRunner(target[3], draft[3], tt, td, rt, rd, target[2],
                           draft[2], attn="kernel", seeds=seeds,
                           counters=ctr, max_gamma=GAMMA)
            out, n = SpecRunner.fetch(r.run(GAMMA, last, pos, active, temp))
            assert r.captures == 1
        else:
            o, nn, c2 = spec_round_paged(
                target[3], draft[3], tt, td,
                torch.tensor(last, device="cuda")[:, None],
                torch.tensor(pos, dtype=torch.int32, device="cuda"),
                torch.tensor(active, device="cuda"), seeds, ctr,
                torch.tensor(temp, device="cuda"), rt, rd, target[2],
                draft[2], GAMMA, attn="kernel")
            ctr.copy_(c2)
            out, n = o.cpu().numpy(), nn.cpu().numpy()
        got.append((out.tolist(), n.tolist(), ctr.tolist(),
                    tt.k.cpu(), td.k.cpu()))
    (o1, n1, c1, tk1, dk1), (o2, n2, c2, tk2, dk2) = got
    assert (o1, n1, c1) == (o2, n2, c2)
    assert c1 == [0, GAMMA + 3, 0, 0]
    assert torch.equal(tk1, tk2) and torch.equal(dk1, dk2)


@pytest.mark.cuda
def test_cuda_engine_matches_the_cpu_engine(port_models):
    """The card engine (captured rounds and draft prefills) gives the CPU
    engine's greedy streams with a self-draft and a mismatched draft
    over two waves, one round capture a gamma."""
    _cuda_or_skip()
    target, draft = port_models
    want = _wave(_engine(target))
    card_t = _on_card(target)
    for d in (card_t, _on_card(draft)):
        eng = _engine(card_t, draft=d, device="cuda")
        with eng:
            for _ in range(2):
                hs = [eng.submit(list(p), max_new_tokens=GEN,
                                 temperature=0.0, repeat_penalty=1.0)
                      for p in (P1, P2)]
                assert all(h.wait(timeout=300) for h in hs)
                assert [list(h._req.out_tokens) for h in hs] == want
        # one capture a gamma the round ran at: the tuner's shrinks are
        # new graphs, as JAX compiles per gamma
        assert eng._spec_runner.captures == 1 + eng._specp.tuner.shrinks
        assert eng.stats.spec_proposed > 0
        _pool_conserved(eng)


@pytest.mark.cuda
def test_cuda_round_host_side_waits_for_nothing_but_the_fetch(
        port_models, monkeypatch):
    """The extension, the dispatch and the truncation of a round run
    under torch.cuda.set_sync_debug_mode("error"); only the fetch of
    (out, n_emit) may wait for the stream."""
    _cuda_or_skip()
    from cake_tpu_torch.serve import engine as E
    from cake_tpu_torch.serve.graphs import SpecRunner

    target = _on_card(port_models[0])
    eng = _engine(target, draft=target, device="cuda")
    real_fetch = SpecRunner.fetch

    def fetch(handle):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real_fetch(handle)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    real_round = E.InferenceEngine._do_spec_paged
    seen = {"rounds": 0}

    def guarded(self, plan):
        if self._spec_runner is None or not self._spec_runner.captures:
            return real_round(self, plan)     # the capture's round
        torch.cuda.set_sync_debug_mode("error")
        try:
            rest = real_round(self, plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen["rounds"] += 1
        return rest
    monkeypatch.setattr(SpecRunner, "fetch", staticmethod(fetch))
    monkeypatch.setattr(E.InferenceEngine, "_do_spec_paged", guarded)
    _wave(eng)
    assert seen["rounds"] > 0 and eng.stats.errors == 0
    _pool_conserved(eng)
