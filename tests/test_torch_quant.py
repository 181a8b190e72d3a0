"""The port's weight quantization vs the JAX package's.

`quantize`, `quantize_group` and `quantize_params` give the bytes and the
scales of the JAX functions under jit (as `cake_tpu/context.py` runs
them), bit for bit; `qmatmul` on a carried-over QTensor gives JAX's
product on both routes (the int4 kernel's plain version for M <= 64 rows,
the dequantize route above and for stacked leaves; the int8 per-channel
product): rtol/atol 2e-4 at f32, the f32 sums running in another order.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu.models.llama.params import init_params as j_init
from cake_tpu.models.llama.params import (
    init_params_quantized as j_init_quantized,
)
from cake_tpu.ops import quant as jq
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.params import (
    init_params, init_params_quantized, params_bytes, params_from_numpy,
)
from cake_tpu_torch.ops import int4_matmul as ti
from cake_tpu_torch.ops import quant as tq

CLOSE = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_qtensor(got, want):
    assert isinstance(got, tq.QTensor)
    assert got.q.dtype == (torch.uint8 if want.q.dtype == jnp.uint8
                           else torch.int8)
    assert got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("shape,dims", [((64, 32), (0,)),
                                        ((3, 64, 48), (1,)),
                                        ((2, 3, 16, 8), (2,))])
def test_quantize_bit_identical_to_jitted_jax(shape, dims):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = jax.jit(lambda v: jq.quantize(v, dims))(w)
    got = tq.quantize(_t(w), dims)
    assert not tq.is_groupwise(got)
    _same_qtensor(got, want)


@pytest.mark.parametrize("shape,group", [((256, 64), 128), ((64, 32), 128),
                                         ((3, 128, 96), 128),
                                         ((96, 16), 128), ((128, 8), 32)])
def test_quantize_group_bit_identical_to_jitted_jax(shape, group):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    cd = len(shape) - 2
    want = jax.jit(lambda v: jq.quantize_group(v, cd, group))(w)
    got = tq.quantize_group(_t(w), cd, group)
    assert tq.is_groupwise(got)
    assert tq.group_size(got) == jq.group_size(want)
    _same_qtensor(got, want)


def test_quantize_group_bf16_weights_bit_identical():
    w = np.random.default_rng(2).normal(size=(2, 64, 32)).astype(np.float32)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = jax.jit(lambda v: jq.quantize_group(v, 1))(wb)
    _same_qtensor(tq.quantize_group(_t(w).bfloat16(), 1), want)


def test_quantize_group_refusals_and_pick_group():
    with pytest.raises(ValueError, match="-2 dim"):
        tq.quantize_group(torch.zeros((4, 8, 8)), 0)
    with pytest.raises(ValueError, match="int4 pairs"):
        tq.quantize_group(torch.zeros((7, 8)), 0)
    for n in (4096, 64, 96, 14336, 7):
        assert tq.pick_group(n) == jq.pick_group(n)


def _jparams(bits, **cfg):
    jc = JConfig.tiny(num_hidden_layers=2, **cfg)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, jax.jit(partial(jq.quantize_params, bits=bits))(jp)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("cfg", [dict(), dict(attention_bias=True),
                                 dict(tie_word_embeddings=True)],
                         ids=["plain", "bias", "tied"])
def test_quantize_params_bit_identical_to_jitted_jax(bits, cfg):
    jp, want = _jparams(bits, **cfg)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    got = tq.quantize_params(tp, bits=bits)
    assert set(got) == set(want) and set(got["blocks"]) == set(want["blocks"])
    for k, v in want["blocks"].items():
        if isinstance(v, jq.QTensor):
            _same_qtensor(got["blocks"][k], v)
            assert tq.is_groupwise(got["blocks"][k]) == (bits == 4)
        else:
            np.testing.assert_array_equal(got["blocks"][k].numpy(),
                                          np.asarray(v))
    _same_qtensor(got["lm_head"], want["lm_head"])
    assert not tq.is_groupwise(got["lm_head"])    # int8 at both settings
    assert got["embed"] is tp["embed"]
    # the caller's tree is left whole
    assert isinstance(tp["blocks"]["wq"], torch.Tensor)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_params_leafwise_consumes_the_callers_tree(bits):
    jp, want = _jparams(bits)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    got = tq.quantize_params_leafwise(tp, bits=bits)
    assert sorted(tp["blocks"]) == ["attn_norm", "mlp_norm"]
    assert "lm_head" not in tp
    for k in tq._BLOCK_CONTRACT:
        if k in want["blocks"]:
            _same_qtensor(got["blocks"][k], want["blocks"][k])
    _same_qtensor(got["lm_head"], want["lm_head"])


def test_carried_over_quantized_tree_keeps_bytes_and_scales():
    _, want = _jparams(4)
    got = params_from_numpy(_np_tree(want), device="cpu",
                            dtype=torch.bfloat16)
    _same_qtensor(got["blocks"]["w_down"], want["blocks"]["w_down"])
    _same_qtensor(got["lm_head"], want["lm_head"])
    assert got["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("bits", [4, 8])
def test_init_params_quantized_has_the_structure_of_quantize_params(bits):
    cfg = LlamaConfig.tiny(num_hidden_layers=2, attention_bias=True)
    gen = torch.Generator().manual_seed(0)
    via = tq.quantize_params(
        init_params(cfg, gen, device="cpu", dtype=torch.float32), bits=bits)
    direct = init_params_quantized(cfg, gen, device="cpu",
                                   dtype=torch.float32, bits=bits)
    assert set(via) == set(direct)
    assert set(via["blocks"]) == set(direct["blocks"])
    nodes = [(via[k], direct[k]) for k in ("embed", "final_norm", "lm_head")]
    nodes += [(via["blocks"][k], direct["blocks"][k]) for k in via["blocks"]]
    for a, b in nodes:
        assert type(a) is type(b)
        if not isinstance(a, tq.QTensor):
            a, b = (a,), (b,)
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype
    assert params_bytes(via) == params_bytes(direct)
    # and JAX's direct init has that structure too
    jd = jax.eval_shape(
        lambda k: j_init_quantized(
            JConfig.tiny(num_hidden_layers=2, attention_bias=True), k,
            dtype=jnp.float32, bits=bits),
        jax.random.PRNGKey(0))
    for k, v in jd["blocks"].items():
        t = direct["blocks"][k]
        if isinstance(v, jq.QTensor):
            assert tuple(t.q.shape) == v.q.shape
            assert tuple(t.scale.shape) == v.scale.shape
        else:
            assert tuple(t.shape) == v.shape


def test_int4_refuses_moe_and_bad_bits():
    params = {"blocks": {"we_gate": torch.zeros((2, 2, 8, 16))},
              "lm_head": torch.zeros((8, 16))}
    for fn in (tq.quantize_params, tq.quantize_params_leafwise):
        with pytest.raises(NotImplementedError, match="int4"):
            fn(params, bits=4)
        with pytest.raises(ValueError, match="bits"):
            fn(params, bits=3)
    with pytest.raises(ValueError, match="bits"):
        init_params_quantized(LlamaConfig.tiny(), torch.Generator(),
                              device="cpu", bits=2)


def test_qeinsum_int8_matches_jax_and_groupwise_raises():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(4, 16, 24)).astype(np.float32)
    x = rng.normal(size=(5, 4, 16)).astype(np.float32)
    jw = jax.jit(lambda v: jq.quantize(v, (1,)))(w)
    tw = params_from_numpy({"w": _np_tree(jw)}, device="cpu")["w"]
    want = jq.qeinsum("bed,edf->bef", jnp.asarray(x), jw)
    got = tq.qeinsum("bed,edf->bef", _t(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    np.testing.assert_allclose(
        tq.qeinsum("bed,edf->bef", _t(x), _t(w)).numpy(),
        np.einsum("bed,edf->bef", x, w), **CLOSE)
    gw = tq.quantize_group(_t(w), 1)
    with pytest.raises(NotImplementedError, match="qmatmul only"):
        tq.qeinsum("bed,edf->bef", _t(x), gw)


# bits, lead shape of x (M = its product), stacked leaf or not (a stacked
# leaf is an int4 case: a per-channel scale [L, Out] does not broadcast
# over a batched product in either package)
QMATMUL_CASES = [(bits, lead, False) for bits in (4, 8)
                 for lead in ((1,), (2, 3), (64,), (65,), (2, 40))]
QMATMUL_CASES += [(4, (3,), True), (4, (70,), True)]


@pytest.mark.parametrize("bits,lead,stacked", QMATMUL_CASES)
def test_qmatmul_matches_jax_on_both_routes(bits, lead, stacked):
    rng = np.random.default_rng(6)
    In, Out = 256, 128
    wshape = (2, In, Out) if stacked else (In, Out)
    w = rng.normal(size=wshape).astype(np.float32)
    xshape = ((2,) if stacked else ()) + lead + (In,)
    x = rng.normal(size=xshape).astype(np.float32)
    cd = len(wshape) - 2
    if bits == 4:
        jw = jax.jit(lambda v: jq.quantize_group(v, cd))(w)
    else:
        jw = jax.jit(lambda v: jq.quantize(v, (cd,)))(w)
    tw = params_from_numpy({"w": _np_tree(jw)}, device="cpu")["w"]
    want = jq.qmatmul(jnp.asarray(x), jw)
    ti.reset_launch_counts()
    got = tq.qmatmul(_t(x), tw)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    M = int(np.prod(lead))
    kernel_route = bits == 4 and not stacked and M <= ti.MAX_KERNEL_M
    assert ti.LAUNCHES["int4_matmul_plain"] == int(kernel_route)
    assert ti.LAUNCHES["int4_matmul"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(256, 64), (3, 128, 32)])
def test_dequantize_group_equals_unpack_times_scale(shape, dtype):
    """The dequantize route's weight, value for value JAX's expression
    `unpack_int4(q).astype(dtype) * scale.astype(dtype)`."""
    w = _t(np.random.default_rng(8).normal(size=shape).astype(np.float32))
    qt = tq.quantize_group(w, len(shape) - 2)
    g = tq.group_size(qt)
    G, Out = qt.scale.shape[-2], shape[-1]
    want = (ti.unpack_int4(qt.q, g).to(dtype).reshape(*shape[:-2], G, g, Out)
            * qt.scale[..., :, None, :].to(dtype)).reshape(shape)
    got = tq.dequantize_group(qt, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_qmatmul_plain_tensor_is_a_matmul():
    x, w = torch.randn(3, 8), torch.randn(8, 4)
    assert torch.equal(tq.qmatmul(x, w), x @ w)


def test_layer_slices_q_and_scale():
    w = torch.randn(3, 64, 16)
    for qt in (tq.quantize_group(w, 1), tq.quantize(w, (1,))):
        one = qt.layer(1)
        assert isinstance(one, tq.QTensor)
        assert torch.equal(one.q, qt.q[1])
        assert torch.equal(one.scale, qt.scale[1])
        assert tq.is_groupwise(one) == tq.is_groupwise(qt)
        assert one.shape[-1] == 16 and one.ndim == 2
