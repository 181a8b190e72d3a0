"""The port's int4 matmul vs the JAX package's.

`pack_int4` / `unpack_int4` give JAX's bytes; `int4_matmul_plain` (what
the wrapper runs for a CPU tensor) gives the Pallas kernel's product, run
in interpret mode as tests/test_quant_int4.py runs it: rtol/atol 2e-4 at
f32 (that file's own tolerance: the f32 sums run in another order), 3e-2
at bf16 (one rounding of the output to bf16, 2^-8 relative, on values up
to ~4). The Hopper gate takes shapes the Mosaic gate refuses. The
`cuda`-marked cases run the CUDA kernel and need the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cake_tpu.ops import int4_matmul as ji
from cake_tpu.ops.quant import quantize_group as j_quantize_group
from cake_tpu_torch.ops import int4_matmul as ti
from cake_tpu_torch.ops.quant import quantize_group


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,g", [((64, 32), 16), ((3, 128, 8), 64),
                                     ((256, 64), 128)])
def test_pack_and_unpack_bytes_equal_jax(shape, g):
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, shape, dtype=np.int8)
    want = np.asarray(ji.pack_int4(jnp.asarray(q), g))
    got = ti.pack_int4(_t(q), g)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = ti.unpack_int4(got, g)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ji.unpack_int4(jnp.asarray(want), g)))


def test_pack_refuses_a_ragged_group():
    with pytest.raises(ValueError, match="groups"):
        ti.pack_int4(torch.zeros((24, 8), dtype=torch.int8), 16)


# (M, In, Out, group): the shapes of tests/test_quant_int4.py:65-98, the
# kernel's M limits, and a g = 64 case
CASES = [(5, 256, 256, 128), (4, 512, 256, 128), (1, 256, 128, 128),
         (8, 256, 256, 128), (64, 256, 128, 128), (3, 128, 256, 64)]


def _case(M, In, Out, g, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(In, Out)).astype(np.float32)
    x = rng.normal(size=(M, In)).astype(np.float32)
    qt = j_quantize_group(jnp.asarray(w), 0, group=g)
    return x, qt


@pytest.mark.parametrize("M,In,Out,g", CASES)
def test_plain_matches_the_interpreted_pallas_kernel(M, In, Out, g):
    x, qt = _case(M, In, Out, g)
    assert ji.kernel_supported(M, In, g, Out)
    want = ji.int4_matmul(jnp.asarray(x), qt.q, qt.scale, g=g,
                          interpret=True)
    ti.reset_launch_counts()
    got = ti.int4_matmul(_t(x), _t(qt.q), _t(qt.scale), g=g)
    assert ti.LAUNCHES == {"int4_matmul": 0, "int4_matmul_plain": 1}
    assert got.shape == (M, Out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # and the dequantized product the JAX tests hold their kernel to
    deq = (ti.unpack_int4(_t(qt.q), g).float().reshape(In // g, g, Out)
           * _t(qt.scale)[:, None, :]).reshape(In, Out)
    np.testing.assert_allclose(got.numpy(), (_t(x) @ deq).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_plain_matches_the_interpreted_pallas_kernel_bf16():
    x, qt = _case(5, 256, 256, 128)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = ji.int4_matmul(xb, qt.q, qt.scale, g=128, interpret=True)
    got = ti.int4_matmul(_t(x).bfloat16(), _t(qt.q), _t(qt.scale), g=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


def test_port_quantizer_feeds_the_same_product():
    """quantize_group of the port -> int4_matmul_plain, against x @ w
    within the quantization error (|err| <= scale / 2 per weight)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))
    qt = quantize_group(w, 0, group=64)
    got = ti.int4_matmul(x, qt.q, qt.scale, g=64)
    bound = (x.abs() @ (qt.scale.repeat_interleave(64, dim=0) * 0.5)) + 1e-4
    assert ((got - x @ w).abs() <= bound).all()


# shapes the Mosaic gate refuses on a TPU (in_dim % 128, (g/2) % 8, Out %
# 128) and the CUDA kernel takes: every product of the tiny config and of
# Llama-3-8B among them
HOPPER_ONLY = [(1, 64, 64, 64), (2, 64, 32, 64), (3, 128, 64, 128),
               (1, 64, 32, 8), (8, 96, 48, 32)]
LLAMA3_8B = [(1, 4096, 128, 4096), (8, 4096, 128, 1024),
             (64, 4096, 128, 14336), (1, 14336, 128, 4096)]


@pytest.mark.parametrize("m,in_dim,out,g", HOPPER_ONLY)
def test_hopper_gate_takes_what_the_mosaic_gate_refuses(m, in_dim, out, g):
    assert ti.kernel_supported(m, in_dim, g, out)
    mosaic = (in_dim % 128 == 0 and (g // 2) % 8 == 0
              and ji._pick_block_out(out) > 0)
    assert not mosaic


@pytest.mark.parametrize("m,in_dim,g,out", LLAMA3_8B)
def test_hopper_gate_takes_llama3_8b(m, in_dim, g, out):
    assert ti.kernel_supported(m, in_dim, g, out)


@pytest.mark.parametrize("m,in_dim,g,out", [
    (65, 256, 128, 256),      # past MAX_KERNEL_M
    (0, 256, 128, 256),
    (1, 200, 128, 256),       # in_dim not whole groups
    (1, 256, 3, 256),         # odd group
    (1, 1024, 512, 256),      # group past MAX_GROUP
    (1, 256, 128, 40),        # Out not a multiple of 16
])
def test_hopper_gate_refuses(m, in_dim, g, out):
    assert not ti.kernel_supported(m, in_dim, g, out)


H100_SMS = 132


@pytest.mark.parametrize("tc", [True, False])
@pytest.mark.parametrize("m,G,out", [(1, 32, 4096), (8, 32, 14336),
                                     (1, 112, 4096), (64, 32, 1024),
                                     (1, 1, 32), (3, 2, 128)])
def test_split_groups_covers_the_group_axis(m, G, out, tc):
    """The split plan's ranges of the group axis (one cluster of at most
    MAX_SPLITS CTAs per output tile) are non-empty and cover every group
    (what the launcher checks before it starts the cluster)."""
    for n_sm in (H100_SMS, 16, 1000):
        s = ti.split_plan(m, G, out, tc, n_sm)
        per = -(-G // s)
        assert 1 <= s <= min(G, ti.MAX_SPLITS)
        assert (s - 1) * per < G <= s * per
        assert [min(G, (r + 1) * per) - r * per for r in range(s)] == \
            [per] * (s - 1) + [G - (s - 1) * per]


@pytest.mark.parametrize("m,g,dtype,tc", [
    (8, 128, torch.bfloat16, True), (64, 64, torch.float16, True),
    (2, 256, torch.float16, True), (33, 16, torch.bfloat16, True),
    (8, 128, torch.float32, False),     # tensor cores would round x to tf32
    (8, 8, torch.bfloat16, False),      # g not a whole number of k16 steps
    (1, 128, torch.bfloat16, False),    # one row: the CUDA-core body
    (1, 32, torch.float32, False),
])
def test_the_body_follows_dtype_and_group(m, g, dtype, tc):
    """bf16/f16 x of two rows or more with g a multiple of 16 take the
    tensor-core body; f32 x, odd groups and one row the CUDA-core body:
    shapes and dtype only."""
    assert ti.takes_tc(m, g, dtype) is tc


def test_split_plan_fills_one_wave_at_llama3_8b_shapes():
    """At decode shapes the output tiles alone are a few dozen CTAs; the
    plan's clusters add ranges of the group axis while every CTA stays
    resident at once (`ctas_per_sm` an SM), up to MAX_SPLITS."""
    n_sm = H100_SMS
    for m in (1, 8, 64):
        for In, Out in ((4096, 14336), (14336, 4096), (4096, 4096),
                        (4096, 1024)):
            for tc in (True, False):
                s = ti.split_plan(m, In // 128, Out, tc, n_sm)
                tiles = -(-Out // ti.COLS_PER_CTA) * (
                    1 if tc else -(-m // ti.M_TILE))
                slots = ti.ctas_per_sm(m, tc) * n_sm
                assert tiles * s <= max(slots, tiles)
                assert s == ti.MAX_SPLITS or tiles * (s + 1) > slots


def test_wrapper_checks_shapes_on_any_device():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="do not agree"):
        ti.int4_matmul(x, torch.zeros((32, 8), dtype=torch.uint8),
                       torch.zeros((2, 8)), g=64)
    with pytest.raises(ValueError, match="takes x"):
        ti.int4_matmul(x[None], torch.zeros((32, 8), dtype=torch.uint8),
                       torch.zeros((1, 8)), g=64)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


# (M, In, Out, g) at the Llama-3-8B weight shapes: every M of the body's
# tiles and their edges, each Out, In and g at least once
LARGE = [(1, 4096, 1024, 64), (2, 4096, 4096, 128), (7, 4096, 14336, 128),
         (8, 14336, 4096, 256), (9, 4096, 14336, 256), (17, 14336, 1024, 64),
         (63, 4096, 4096, 64), (64, 4096, 14336, 128), (64, 14336, 4096, 128)]
# kernel vs plain: at f32 only the order of the f32 sum differs (<= 1e-5 of
# the largest output); at bf16 and f16 one rounding of the output (2^-7,
# 2^-10 relative)
CUDA_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
             torch.float16: 2.0 ** -10}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_kernel_matches_the_plain_version(dtype):
    """Kernel vs plain on the card, one launch a product: the same bits
    twice and from a replayed CUDA graph of the call, within CUDA_RTOL."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, In, Out, g in (CASES + [(m, i, o, g) for m, i, o, g in HOPPER_ONLY]
                          + LARGE):
        w = torch.randn((In, Out), generator=gen, device="cuda")
        x = torch.randn((M, In), generator=gen, device="cuda").to(dtype)
        qt = quantize_group(w, 0, group=g)
        g = 2 * qt.q.shape[0] // qt.scale.shape[0]
        ti.reset_launch_counts()
        got = ti.int4_matmul(x, qt.q, qt.scale, g=g)
        assert ti.LAUNCHES == {"int4_matmul": 1, "int4_matmul_plain": 0}
        again = ti.int4_matmul(x, qt.q, qt.scale, g=g)
        torch.cuda.synchronize()
        assert ti.LAUNCHES == {"int4_matmul": 2, "int4_matmul_plain": 0}
        assert torch.equal(got, again), (M, In, Out, g)   # no atomics
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, stream=side):
            replayed = ti.int4_matmul(x, qt.q, qt.scale, g=g)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, replayed), (M, In, Out, g)
        want = ti.int4_matmul_plain(x, qt.q, qt.scale, g=g)
        atol = 1e-5 * want.float().abs().max().item()
        assert torch.allclose(got.float(), want.float(),
                              rtol=CUDA_RTOL[dtype], atol=atol), \
            (M, In, Out, g, (got.float() - want.float()).abs().max().item())
        del graph


@pytest.mark.cuda
def test_cuda_tensor_outside_the_gate_raises():
    _cuda_or_skip()
    x = torch.zeros((1, 64), device="cuda")
    with pytest.raises(ValueError, match="cannot take"):
        ti.int4_matmul(x, torch.zeros((32, 40), dtype=torch.uint8,
                                      device="cuda"),
                       torch.zeros((1, 40), device="cuda"), g=64)
    with pytest.raises(ValueError, match="dtype"):
        ti.int4_matmul(x.double(), torch.zeros((32, 32), dtype=torch.uint8,
                                               device="cuda"),
                       torch.zeros((1, 32), device="cuda"), g=64)
