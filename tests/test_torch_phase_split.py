"""The port's phase-split loop (`--mixed-batch off`) against the JAX
engine with `mixed_batch="off"`, and the shared-prefix paths on the card.

Greedy streams at f32 params are token-identical to the JAX
`InferenceEngine(kv_pages=16, kv_page_size=16, paged_attn="fold",
mixed_batch="off")` over f32 and int8 pools, with whole-prompt buckets
(no --prefill-chunk) and with 16-token windows (a 40-token prompt in
three, a prefix hit's 20-token suffix in two from pos0 = 32), two prefix
hits among six admissions that arrive as one wave: PREFILL_FLUSH (4)
first tokens a host round trip, so two fetches.

The `cuda` cases run the tiny engine with a registered prefix on the
card at f32 (`paged_attn="kernel"`, the flash kernels in the prefills)
against the CPU engine, mixed on and off. The JAX package is imported
inside the cases that use it, so on the card (which has no jax) the
file collects and its `cuda` cases run:

    python -m pytest --noconftest -m cuda tests/test_torch_phase_split.py
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.llama.params import init_params
from cake_tpu_torch.ops import flash_attention as fa
from cake_tpu_torch.ops import ragged_paged_attention as rpa
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import InferenceEngine

PAGE = 16
T = 64
PREFIX = [5] * 20 + [9] * 12          # 32 tokens = 2 pages
PROMPTS = [PREFIX + [3, 7, 9, 11, 2], [5] * 40, PREFIX + [8] * 20,
           [11] * 14, [3, 7, 9], [9] * 20]


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


def _wave(eng, max_new=6):
    """Register the prefix and submit every prompt before the engine
    starts, so the first plan admits them as one wave."""
    eng.register_prefix(PREFIX)
    hs = [eng.submit(p, max_new_tokens=max_new, temperature=0.0,
                     repeat_penalty=1.0) for p in PROMPTS]
    with eng:
        assert all(h.wait(timeout=300) for h in hs)
    assert all(h._req.error is None for h in hs)
    return [list(h._req.out_tokens) for h in hs]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("chunk,scan", [(None, 1), (16, 4)])
def test_phase_split_streams_token_identical_to_jax(models, kv_dtype,
                                                    chunk, scan):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JByteTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp, tc, tp = models
    common = dict(max_slots=6, max_seq_len=T, kv_pages=16,
                  kv_page_size=PAGE, prefill_chunk=chunk,
                  mixed_batch="off", kv_dtype=kv_dtype,
                  decode_scan_steps=scan)
    jeng = JEngine(jc, jp, JByteTok(jc.vocab_size),
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, paged_attn="fold", **common)
    want = _wave(jeng)
    teng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, paged_attn="auto", **common)
    groups = []
    fetch = teng._fetch_samples

    def counted(devs):
        groups.append(len(devs))
        return fetch(devs)

    teng._fetch_samples = counted
    got = _wave(teng)
    assert got == want
    assert teng.stats.prefix_hits == jeng.stats.prefix_hits == 2
    assert groups == [4, 2]              # one wave: PREFILL_FLUSH, then 2
    assert teng._pager.live_pages == 2 and teng._pager.free_pages == 14
    assert teng._prefix_pages_shared == 0 and not teng._mixed_pending
    assert (teng.cache.table == -1).all()


def test_phase_split_serves_arrivals_while_decoding(models):
    """Requests that arrive one by one while others decode: each wave
    prefills between decode steps, every stream completes, and pages
    return. A cancel mid-decode conserves pages."""
    import time

    _, _, tc, tp = models
    eng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=3,
        max_seq_len=256, kv_pages=20, kv_page_size=PAGE, prefill_chunk=16,
        mixed_batch="off", decode_scan_steps=4,
        sampling=SamplingConfig(temperature=0.0),
        cache_dtype=torch.float32)
    with eng:
        victim = eng.submit([7] * 30, max_new_tokens=200)
        hs = []
        for p in PROMPTS:
            hs.append(eng.submit(p, max_new_tokens=5))
            time.sleep(0.002)
        eng.cancel(victim)
        assert victim.wait(timeout=60)
        assert all(h.wait(timeout=300) for h in hs)
    assert all(h._req.error is None and h._req.out_tokens for h in hs)
    assert eng._pager.free_pages == 20 and eng._pager.live_pages == 0


# -- on the card ------------------------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_cuda_prefix_streams_match_the_cpu(mixed):
    """The tiny engine with a registered prefix at f32 on the card
    (`paged_attn="kernel"`: flash in the prefix registration and the
    phase-split prefills, the ragged kernels in the steps) gives the CPU
    engine's greedy streams; the flash launches are counted and no plain
    version runs on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash and ragged kernels "
                    "run only on CUDA")
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    runs = []
    for device in ("cpu", "cuda"):
        eng = InferenceEngine(
            cfg, _to(params, device), ByteTokenizer(cfg.vocab_size),
            device=device, max_slots=6, max_seq_len=T, kv_pages=16,
            kv_page_size=PAGE, prefill_chunk=16, mixed_batch=mixed,
            paged_attn="kernel" if device == "cuda" else "auto",
            sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
            cache_dtype=torch.float32)
        fa.reset_launch_counts()
        rpa.reset_launch_counts()
        runs.append(_wave(eng))
        assert eng.stats.prefix_hits == 2
        assert eng._pager.live_pages == 2
    L = cfg.num_hidden_layers
    # one flash_attn a layer for the prefix; off: two whole prompts of at
    # most 16 tokens (flash_attn), the 5-token suffix after the prefix
    # (flash_attn_cached), and 16-token windows (flash_attn_cached) for
    # the 40-token prompt (3), the 20-token suffix (2) and the 20-token
    # prompt (2)
    want = ({"flash_attn": 3 * L, "flash_attn_cached": 8 * L}
            if mixed == "off" else {"flash_attn": L, "flash_attn_cached": 0})
    if mixed == "off":
        # the prefills are captured graphs: each variant's warm-up before
        # its capture launches once more (a bucket's flash_attn; the
        # prefixed suffix's and the chunk's flash_attn_cached)
        kinds = [v[0] for v in eng._prefill_runner._bufs]
        want["flash_attn"] += L * kinds.count("slot")
        want["flash_attn_cached"] += L * (len(kinds) - kinds.count("slot"))
    assert {k: fa.LAUNCHES[k] for k in want} == want
    plain = {k: n for c in (fa.LAUNCHES, rpa.LAUNCHES)
             for k, n in c.items() if k.endswith("_plain") and n}
    assert not plain
    assert runs[1] == runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cuda_prefill_group_dispatches_without_a_sync(kv_dtype):
    """On the card a phase-split admission (a whole prompt, 16-token
    windows, a prefix hit) dispatches its page mapping, its prefill and
    its first-token sample with no wait for the stream: every
    `_do_prefill` of a wave runs under
    `torch.cuda.set_sync_debug_mode("error")`, so a PREFILL_FLUSH group
    costs the one host round trip of its fetch. The streams equal those
    of an unguarded engine (which also builds the kernels first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash and ragged kernels "
                    "run only on CUDA")
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = _to(init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32), "cuda")

    def engine():
        return InferenceEngine(
            cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
            max_slots=6, max_seq_len=T, kv_pages=16, kv_page_size=PAGE,
            prefill_chunk=16, mixed_batch="off", kv_dtype=kv_dtype,
            sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
            cache_dtype=torch.float32)

    want = _wave(engine())
    eng = engine()
    dispatch = eng._do_prefill
    guarded = []

    def no_sync(rid, slot):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dispatch(rid, slot)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        guarded.append(rid)
        return out

    eng._do_prefill = no_sync
    assert _wave(eng) == want
    assert len(guarded) == len(PROMPTS)
    assert eng.stats.prefix_hits == 2
