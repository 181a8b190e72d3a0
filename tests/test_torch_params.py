"""The port's parameter dict vs the JAX pytree.

`params_from_numpy` carries a JAX `init_params` tree across exactly;
`load_params_from_hf` reads a tiny HF checkpoint (built locally with
`transformers`, as tests/test_model_golden.py does) to the same tensors
as the JAX loader; `init_params` builds the same structure and shapes.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

transformers = pytest.importorskip("transformers")

from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu.models.llama.params import init_params as j_init
from cake_tpu.models.llama.params import load_params_from_hf as j_load
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.params import (
    init_params, load_params_from_hf, params_from_numpy,
)

TINY = dict(
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=128,
    bos_token_id=1, eos_token_id=2, tie_word_embeddings=False,
)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("bias", [False, True])
def test_params_from_numpy_round_trip(bias):
    jc = JConfig.tiny(num_hidden_layers=2, attention_bias=bias)
    jp = jax.tree.map(np.asarray, j_init(jc, jax.random.PRNGKey(0),
                                         dtype=jnp.float32))
    tp = params_from_numpy(jp, device="cpu", dtype=torch.float32)
    jl, tl = list(_leaves(jp)), list(_leaves(tp))
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (k, a), (_, t) in zip(jl, tl):
        assert t.dtype == torch.float32 and t.device.type == "cpu", k
        np.testing.assert_array_equal(t.numpy(), a, err_msg=str(k))


@pytest.mark.parametrize("bits", [4, 8])
def test_params_from_numpy_carries_a_quantized_tree(bits):
    """A tree from the JAX package's init_params_quantized: every QTensor
    node becomes the port's, q in its int8 / packed uint8 bytes and scale
    in f32 whatever `dtype` asks of the other leaves."""
    from cake_tpu.models.llama.params import init_params_quantized as j_iq
    from cake_tpu.ops.quant import QTensor as JQTensor
    from cake_tpu_torch.ops.quant import QTensor, is_groupwise

    jc = JConfig.tiny(num_hidden_layers=2, attention_bias=True)
    jp = jax.tree.map(np.asarray, j_iq(jc, jax.random.PRNGKey(0),
                                       dtype=jnp.float32, bits=bits))
    tp = params_from_numpy(jp, device="cpu", dtype=torch.bfloat16)
    for k, v in jp["blocks"].items():
        t = tp["blocks"][k]
        if isinstance(v, JQTensor):
            assert isinstance(t, QTensor) and is_groupwise(t) == (bits == 4)
            assert t.q.dtype == (torch.uint8 if bits == 4 else torch.int8)
            assert t.scale.dtype == torch.float32
            np.testing.assert_array_equal(t.q.numpy(), v.q)
            np.testing.assert_array_equal(t.scale.numpy(), v.scale)
        else:
            assert t.dtype == torch.bfloat16
    lm = tp["lm_head"]
    assert isinstance(lm, QTensor) and lm.q.dtype == torch.int8
    np.testing.assert_array_equal(lm.q.numpy(), jp["lm_head"].q)
    assert tp["embed"].dtype == torch.bfloat16


def test_params_from_numpy_bf16_leaves_cross_by_bits():
    jp = jax.tree.map(np.asarray, j_init(JConfig.tiny(num_hidden_layers=1),
                                         jax.random.PRNGKey(1)))
    tp = params_from_numpy(jp, device="cpu", dtype=torch.bfloat16)
    want = np.asarray(jp["blocks"]["wq"]).astype(np.float32)
    np.testing.assert_array_equal(tp["blocks"]["wq"].float().numpy(), want)


def test_init_params_structure_matches_jax():
    cfg = LlamaConfig.tiny(num_hidden_layers=2, attention_bias=True)
    jc = JConfig.tiny(num_hidden_layers=2, attention_bias=True)
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.float32)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    jl, tl = list(_leaves(jp)), list(_leaves(tp))
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (k, a), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == tuple(a.shape), k
    # 1/sqrt(fan_in) scale, unit norms
    assert abs(tp["blocks"]["wq"].std().item() - 64 ** -0.5) < 0.02
    assert torch.equal(tp["final_norm"], torch.ones(64))


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator())


@pytest.fixture(scope="module")
def hf_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_tiny_port")
    cfg = transformers.LlamaConfig(**TINY, attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.save_pretrained(str(d), safe_serialization=True)
    (d / "config.json").write_text(json.dumps({**TINY}))
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_from_hf_matches_jax_loader(hf_model_dir, dtype):
    cfg = LlamaConfig.from_path(str(hf_model_dir))
    jc = JConfig.from_path(str(hf_model_dir))
    assert dataclasses.asdict(cfg) == {
        k: v for k, v in dataclasses.asdict(jc).items()
        if k in dataclasses.asdict(cfg)}
    jp = jax.tree.map(np.asarray, j_load(str(hf_model_dir), jc,
                                         dtype=getattr(jnp, dtype)))
    tp = load_params_from_hf(str(hf_model_dir), cfg,
                             dtype=getattr(torch, dtype), device="cpu")
    jl, tl = list(_leaves(jp)), list(_leaves(tp))
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (k, a), (_, t) in zip(jl, tl):
        assert t.dtype == getattr(torch, dtype), k
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32), err_msg=str(k))


def test_load_params_from_hf_layer_range(hf_model_dir):
    cfg = LlamaConfig.from_path(str(hf_model_dir))
    full = load_params_from_hf(str(hf_model_dir), cfg,
                               dtype=torch.float32, device="cpu")
    part = load_params_from_hf(str(hf_model_dir), cfg, dtype=torch.float32,
                               device="cpu", layer_range=range(1, 2))
    assert part["blocks"]["wq"].shape[0] == 1
    assert torch.equal(part["blocks"]["wq"][0], full["blocks"]["wq"][1])
