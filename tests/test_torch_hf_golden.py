"""The port's dense model against Hugging Face `transformers`.

A tiny random `LlamaForCausalLM` and a tiny random `Qwen2ForCausalLM`
(the QKV-bias path and the `chatml` template) are built here and saved
with `safe_serialization=True`, as tests/test_model_golden.py does for
the JAX package; the port reads them through `load_config` and
`load_params_from_hf` on the CPU at f32. Its dense `prefill` of the
first tokens and three `decode_step`s after it must give transformers'
logits at the same positions within 2e-3 (absolute and relative: the
JAX golden test's tolerance), and the same greedy tokens.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from cake_tpu_torch.models.llama.cache import KVCache  # noqa: E402
from cake_tpu_torch.models.llama.config import load_config  # noqa: E402
from cake_tpu_torch.models.llama.model import (  # noqa: E402
    RopeTables, decode_step, prefill,
)
from cake_tpu_torch.models.llama.params import (  # noqa: E402
    load_params_from_hf,
)

TOL = 2e-3
BASE = dict(
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10000.0, max_position_embeddings=128,
    bos_token_id=1, eos_token_id=2, tie_word_embeddings=False,
)
TOKENS = [1, 5, 9, 42, 7, 100, 3, 250]
PROMPT = 5        # prefill the first five; decode the last three


def _save(tmp_path_factory, name, cls, cfg_cls, extra, seed):
    d = tmp_path_factory.mktemp(name)
    raw = {**BASE, **extra}
    torch.manual_seed(seed)
    model = cls(cfg_cls(**raw, attn_implementation="eager")).eval()
    model.save_pretrained(str(d), safe_serialization=True)
    (d / "config.json").write_text(json.dumps(raw))
    return str(d), model


@pytest.fixture(scope="module", params=["llama", "qwen2"])
def hf(request, tmp_path_factory):
    if request.param == "llama":
        return request.param, *_save(
            tmp_path_factory, "hf_llama", transformers.LlamaForCausalLM,
            transformers.LlamaConfig, dict(rms_norm_eps=1e-5), seed=0)
    return request.param, *_save(
        tmp_path_factory, "hf_qwen2", transformers.Qwen2ForCausalLM,
        transformers.Qwen2Config,
        dict(rms_norm_eps=1e-6, model_type="qwen2"), seed=1)


def test_prefill_and_decode_steps_match_transformers(hf):
    kind, d, model = hf
    cfg = load_config(d)
    if kind == "qwen2":
        assert cfg.attention_bias and cfg.chat_template == "chatml"
    params = load_params_from_hf(d, cfg, dtype=torch.float32, device="cpu")
    assert ("bq" in params["blocks"]) == (kind == "qwen2")
    with torch.no_grad():
        ref = model(torch.tensor([TOKENS])).logits[0].numpy()

    rope = RopeTables.create(cfg, 64, device="cpu")
    cache = KVCache.create(cfg, 1, 64, dtype=torch.float32, device="cpu")
    # the prompt right-padded to 8, as the generator's buckets pad it
    padded = TOKENS[:PROMPT] + [0] * 3
    logits, cache = prefill(params, torch.tensor([padded], dtype=torch.int32),
                            torch.tensor([PROMPT]), cache, rope, cfg)
    got = [logits[0].numpy()]
    for pos in range(PROMPT, len(TOKENS)):
        logits, cache = decode_step(
            params, torch.tensor([[TOKENS[pos]]], dtype=torch.int32), pos,
            cache, rope, cfg)
        got.append(logits[0].numpy())
    want = ref[PROMPT - 1:]
    np.testing.assert_allclose(np.stack(got), want, atol=TOL, rtol=TOL)
    assert [int(np.argmax(g)) for g in got] == [int(np.argmax(w))
                                                for w in want]
