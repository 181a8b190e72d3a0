"""The port's elementwise ops, attention and sampling vs the JAX package.

Inputs come from a numpy seed and go to both packages; JAX runs on the
CPU at "highest" matmul precision (tests/conftest.py). Tolerances at
f32: 1e-5 for elementwise ops, 2e-5 for attention; greedy sampling must
pick identical ids.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.ops import attention as j_attn
from cake_tpu.ops import norms as j_norms
from cake_tpu.ops import rope as j_rope
from cake_tpu.ops import sampling as j_samp
from cake_tpu.parallel import context_parallel as j_cp
from cake_tpu_torch.ops import attention as t_attn
from cake_tpu_torch.ops import norms as t_norms
from cake_tpu_torch.ops import rope as t_rope
from cake_tpu_torch.ops import sampling as t_samp

ELEM = dict(atol=1e-5, rtol=1e-5)
ATTN = dict(atol=2e-5, rtol=2e-5)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    _close(got, want, ELEM)


def test_rope_tables_rows_and_apply_match_jax():
    rng = np.random.default_rng(1)
    jc, js = j_rope.precompute_rope(16, 64, 500000.0)
    tc, ts = t_rope.precompute_rope(16, 64, 500000.0)
    _close(tc, jc, ELEM)
    _close(ts, js, ELEM)
    x = rng.normal(size=(3, 4, 2, 16)).astype(np.float32)
    # shared rows (a window at position 7)
    want = j_rope.apply_rope(jnp.asarray(x), *j_rope.rope_rows(jc, js, 7, 4))
    got = t_rope.apply_rope(torch.from_numpy(x),
                            *t_rope.rope_rows(tc, ts, 7, 4))
    _close(got, want, ELEM)
    # per-row rows (ragged decode)
    pos = np.array([0, 33, 63], np.int32)
    x1 = x[:, :1]
    want = j_rope.apply_rope(jnp.asarray(x1),
                             *j_rope.rope_rows_per_row(jc, js,
                                                       jnp.asarray(pos)))
    got = t_rope.apply_rope(torch.from_numpy(x1),
                            *t_rope.rope_rows_per_row(
                                tc, ts, torch.from_numpy(pos).long()))
    _close(got, want, ELEM)


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_gqa_attention_causal_matches_jax(H, KV):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 6, H, 16)).astype(np.float32)
    k = rng.normal(size=(2, 6, KV, 16)).astype(np.float32)
    v = rng.normal(size=(2, 6, KV, 16)).astype(np.float32)
    want = j_attn.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mask=j_attn.causal_mask(6))
    got = t_attn.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               mask=t_attn.causal_mask(6))
    _close(got, want, ATTN)


def test_attention_stats_merge_matches_jax():
    """The (m, l, o) stats pair the paged folds are built from, with a
    fully-masked query row (merge must give zeros, not NaN)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 3, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 8, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 8, 2, 16)).astype(np.float32)
    valid = np.tril(np.ones((3, 8), bool), k=2)
    valid[2] = False
    valid = valid[None, None, None]
    jm = j_cp.partial_attention_stats(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(valid))
    tm = t_attn.partial_attention_stats(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid))
    for got, want in zip(tm, jm):
        _close(got, want, ATTN)
    want = j_cp.merge_attention_stats([jm])
    got = t_attn.merge_attention_stats([tm])
    _close(got, want, ATTN)
    assert not torch.isnan(got).any()


def test_repeat_penalty_and_masks_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 32)).astype(np.float32) * 3
    ring = np.array([[1, 5, -1, 5], [-1, -1, -1, -1], [0, 31, 7, 2]],
                    np.int32)
    want = j_samp.apply_repeat_penalty(jnp.asarray(logits),
                                       jnp.asarray(ring), 1.3)
    got = t_samp.apply_repeat_penalty(torch.from_numpy(logits),
                                      torch.from_numpy(ring), 1.3)
    _close(got, want, ELEM)
    pen = np.array([1.0, 1.5, 2.0], np.float32)
    want = j_samp._apply_repeat_penalty_per_row(
        jnp.asarray(logits), jnp.asarray(ring), jnp.asarray(pen))
    got = t_samp._apply_repeat_penalty_per_row(
        torch.from_numpy(logits), torch.from_numpy(ring),
        torch.from_numpy(pen))
    _close(got, want, ELEM)
    want = j_samp._mask_top_k(jnp.asarray(logits), 5)
    got = t_samp._mask_top_k(torch.from_numpy(logits), 5)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for p in (0.3, 0.9):
        want = j_samp._mask_top_p(jnp.asarray(logits), p)
        got = t_samp._mask_top_p(torch.from_numpy(logits), p)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_update_ring_per_row_matches_jax():
    ring = np.full((3, 4), -1, np.int32)
    new = np.array([9, 8, 7], np.int32)
    steps = np.array([0, 5, 3], np.int32)
    want = j_samp.update_ring_per_row(jnp.asarray(ring), jnp.asarray(new),
                                      jnp.asarray(steps))
    got = t_samp.update_ring_per_row(torch.from_numpy(ring),
                                     torch.from_numpy(new),
                                     torch.from_numpy(steps))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sample_tokens_ragged_greedy_identical_to_jax():
    """Greedy rows pick identical ids with identical logprobs and top-N;
    a sampled row draws from its own counter-based stream, inside its
    top-p set."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 64)).astype(np.float32) * 4
    ring = rng.integers(-1, 64, size=(4, 8)).astype(np.int32)
    temp = np.array([0.0, 0.0, 0.0, 0.8], np.float32)
    top_p = np.array([1.0, 0.5, 1.0, 0.3], np.float32)
    pen = np.array([1.0, 1.1, 1.3, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    j_ids, j_lp, j_ti, j_tl = j_samp.sample_tokens_ragged(
        keys, jnp.asarray(logits), jnp.asarray(ring), jnp.asarray(temp),
        jnp.asarray(top_p), jnp.asarray(pen), n_top=3)
    seeds, counters = torch.arange(4), torch.zeros(4, dtype=torch.int64)
    t_ids, t_lp, t_ti, t_tl = t_samp.sample_tokens_ragged(
        seeds, counters, torch.from_numpy(logits), torch.from_numpy(ring),
        torch.from_numpy(temp), torch.from_numpy(top_p),
        torch.from_numpy(pen), n_top=3)
    np.testing.assert_array_equal(t_ids[:3].numpy(), np.asarray(j_ids)[:3])
    _close(t_lp[:3], np.asarray(j_lp)[:3], ELEM)
    np.testing.assert_array_equal(t_ti.numpy(), np.asarray(j_ti))
    _close(t_tl, j_tl, ELEM)
    # the sampled row lands inside its nucleus (top_p=0.3 of the
    # temperature-scaled distribution)
    allowed = np.asarray(j_samp._mask_top_p(
        jnp.asarray(logits[3:] / 0.8), 0.3))[0] > -np.inf
    assert allowed[int(t_ids[3])]
