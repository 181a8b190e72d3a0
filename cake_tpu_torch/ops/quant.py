"""Weight-only int8/int4 quantization for decode bandwidth.

Counterpart of `cake_tpu/ops/quant.py` (`QTensor`, `quantize`,
`pick_group`, `quantize_group`, `group_size`, `is_groupwise`, `qmatmul`,
`qeinsum`, `quantize_params`, `quantize_params_leafwise`; the sharding
helpers `expand_spec*` come with the parallel package).

Batch-1 decode reads every weight once per token, so its floor is the
weight bytes over the memory rate. int8 with per-output-channel scales
halves the bytes of bf16; int4 with group-wise scales (one scale per
`group` input rows per output channel, the GPTQ/AWQ storage layout)
halves them again. Activations and accumulation keep their dtype
(weight-only).

`QTensor` is a NamedTuple of (q, scale), a node of the parameter dict
like any tensor; `qmatmul` / `qeinsum` dispatch on the leaf type, so the
same model code runs full-precision and quantized weights. The two
layouts are told apart structurally: per-channel scales DROP the
contracted dim (`scale.ndim < q.ndim`); group-wise scales KEEP it,
shrunk by the group size (`scale.ndim == q.ndim`).

Routes of a group-wise product, as in the JAX package: a 2-D leaf with
M <= MAX_KERNEL_M rows of x goes to `ops/int4_matmul.int4_matmul` (on the
card the CUDA kernel, which raises on a shape outside its gate; on the
CPU its plain version); larger M, or a stacked leaf, unpacks, scales in
x's dtype and takes a plain matmul. The int8 product is plain PyTorch,
`(x @ q.to(x.dtype)) * scale`: the JAX package has no kernel for it.

The quantizers give the bytes and scales of the JAX functions under jit,
where XLA turns the division of the amax by the constant qmax into a
multiplication by its f32 reciprocal; so does the code here.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from cake_tpu_torch.ops import int4_matmul as i4


class QTensor(NamedTuple):
    """Quantized weight + scales.

    q:     int8 in the weight's shape (per-channel), or uint8 with the
           contract dim halved (group-wise int4, nibble-packed)
    scale: f32; the weight's shape without the contracted dims
           (per-channel) or with the contract dim shrunk to the number of
           groups (group-wise)
    """

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    def layer(self, i: int) -> "QTensor":
        """Layer i of a stacked leaf (views of q and scale)."""
        return QTensor(self.q[i], self.scale[i])


Weight = Union[torch.Tensor, QTensor]


def _by_layer(fn, w: torch.Tensor, dims: Sequence[int]) -> QTensor:
    """fn(w[i], dims - 1) for each slice of a stacked leaf's leading dim,
    written into whole outputs: the f32 copy, the quotient and the
    rounded copy that eager PyTorch makes exist for one layer at a time,
    not for the stack. The reductions never cross the leading dim, so the
    result is that of one call on the stack."""
    inner = tuple(d - 1 for d in dims)
    first = fn(w[0], inner)
    q = torch.empty((w.shape[0],) + tuple(first.q.shape), dtype=first.q.dtype,
                    device=w.device)
    scale = torch.empty((w.shape[0],) + tuple(first.scale.shape),
                        dtype=first.scale.dtype, device=w.device)
    q[0], scale[0] = first
    del first
    for i in range(1, w.shape[0]):
        q[i], scale[i] = fn(w[i], inner)
    return QTensor(q, scale)


def quantize(w: torch.Tensor, contract_dims: Sequence[int]) -> QTensor:
    """Symmetric per-channel int8: scale = max|w| / 127 over
    contract_dims."""
    dims = tuple(d % w.ndim for d in contract_dims)
    if w.ndim >= 3 and 0 not in dims:
        return _by_layer(quantize, w, dims)
    w32 = w.float()
    amax = w32.abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp(min=1e-8) * (1.0 / 127.0)
    q = (w32 / scale).round().clamp(-127, 127).to(torch.int8)
    for d in sorted(dims, reverse=True):
        scale = scale.squeeze(d)
    return QTensor(q=q, scale=scale)


def pick_group(contract_size: int, group: int = 128) -> int:
    """Largest power-of-two group <= `group` dividing the contract dim
    (tiny test configs have dims < 128)."""
    g = group
    while g > 1 and contract_size % g:
        g //= 2
    return g


def quantize_group(w: torch.Tensor, contract_dim: int,
                   group: int = 128) -> QTensor:
    """Symmetric group-wise int4, nibble-packed: one scale per `group`
    contracted rows per output channel; values packed two per byte in the
    group-halves layout (ops/int4_matmul.pack_int4). `contract_dim`
    indexes w's shape and must be the -2 dim (the matmul input dim); the
    returned q is uint8 with that dim halved, and the scale has it shrunk
    to n_groups (scale.ndim == q.ndim, which is how consumers recognise
    the layout)."""
    contract_dim = contract_dim % w.ndim
    if contract_dim != w.ndim - 2:
        raise ValueError(
            f"group-wise quantization contracts the -2 dim, got "
            f"{contract_dim} of {w.ndim}")
    In = w.shape[contract_dim]
    g = pick_group(In, group)
    if g < 2:
        raise ValueError(f"contract dim {In} cannot form int4 pairs")
    if w.ndim >= 3:
        return _by_layer(lambda v, d: quantize_group(v, d[0], group), w,
                         (contract_dim,))
    Out = w.shape[-1]
    w32 = w.float().reshape(In // g, g, Out)
    amax = w32.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp(min=1e-8) * (1.0 / 7.0)
    q = (w32 / scale).round().clamp(-7, 7).to(torch.int8).reshape(In, Out)
    return QTensor(q=i4.pack_int4(q, g), scale=scale.squeeze(1))


def group_size(w: QTensor) -> int:
    """Group size g of a packed group-wise QTensor."""
    return 2 * w.q.shape[-2] // w.scale.shape[-2]


def _group_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x @ dequant(w) for the packed group-wise layout ([in/2, out] leaf).

    Decode-shaped x goes through `int4_matmul`: the packed bytes unpack
    in registers and the dequantized weight never exists in device
    memory. Larger x (prefill) dequantizes the leaf and takes a plain
    matmul: the copy is amortised by the [S, In] @ [In, Out] compute.
    """
    In = 2 * w.q.shape[-2]
    Out = w.q.shape[-1]
    lead = x.shape[:-1]
    M = 1
    for s in lead:
        M *= s
    if w.q.ndim == 2 and M <= i4.MAX_KERNEL_M:
        out = i4.int4_matmul(x.reshape(M, In), w.q, w.scale,
                             g=group_size(w))
        return out.reshape(*lead, Out)
    return x @ dequantize_group(w, x.dtype)


def dequantize_group(w: QTensor, dtype: torch.dtype) -> torch.Tensor:
    """The weight [.., In, Out] of a packed group-wise QTensor in `dtype`:
    `unpack_int4(q).to(dtype)` times the scale cast to `dtype`, value for
    value (a nibble, and a nibble minus 8, are exact in every float
    dtype), but unpacked in uint8 and `dtype` without the int32 passes of
    `unpack_int4`: eager PyTorch fuses nothing, and this runs for every
    leaf of every prefill-shaped step."""
    g = group_size(w)
    *lead, half, Out = w.q.shape
    G = w.scale.shape[-2]
    p = w.q.reshape(*lead, G, g // 2, Out)
    vals = torch.cat([(p & 0xF).to(dtype), (p >> 4).to(dtype)], dim=-2)
    vals -= 8
    vals *= w.scale[..., :, None, :].to(dtype)
    return vals.reshape(*lead, 2 * half, Out)


def is_groupwise(w: QTensor) -> bool:
    return w.scale.ndim == w.q.ndim


def qmatmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x @ w for a tensor or QTensor ([in, out], contract dim -2)."""
    if isinstance(w, QTensor):
        if is_groupwise(w):
            return _group_matmul(x, w)
        return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
    return x @ w


def qeinsum(spec: str, x: torch.Tensor, w: Weight) -> torch.Tensor:
    """einsum(spec, x, w) with QTensor support.

    The QTensor's scale must broadcast against the einsum output's
    trailing dims (true for the layouts quantize_params produces).
    Group-wise (int4) weights are matmul-only."""
    if isinstance(w, QTensor):
        if is_groupwise(w):
            raise NotImplementedError(
                "group-wise (int4) weights support qmatmul only; "
                "quantize einsum weights per-channel (int8)")
        out = torch.einsum(spec, x, w.q.to(x.dtype))
        return out * w.scale.to(x.dtype)
    return torch.einsum(spec, x, w)


# Per-leaf contracted dims for the stacked [L, ...] block layout: matmul
# weights contract their input dim; expert weights contract D
# (we_gate/we_up) or F (we_down).
_BLOCK_CONTRACT = {
    "wq": (1,), "wk": (1,), "wv": (1,), "wo": (1,),
    "w_gate": (1,), "w_up": (1,), "w_down": (1,),
    "we_gate": (2,), "we_up": (2,), "we_down": (2,),
}


def _check_bits(params: dict, bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if bits == 4 and any(k.startswith("we_") for k in params["blocks"]):
        raise NotImplementedError(
            "int4 is matmul-only; MoE expert weights go through "
            "qeinsum — use --quant int8 for MoE models")


def _quantize_leaf(name: str, w: torch.Tensor, bits: int,
                   group: int) -> QTensor:
    dims = _BLOCK_CONTRACT[name]
    if bits == 4:
        return quantize_group(w, dims[0], group)
    return quantize(w, dims)


@torch.no_grad()
def quantize_params(params: dict, bits: int = 8, group: int = 128) -> dict:
    """Quantize every linear weight of a text-model parameter dict.

    bits=8: per-output-channel int8. bits=4: group-wise int4 (matmul
    weights only; MoE expert trees need the einsum path and stay int8).
    Embedding, norms and biases stay full precision; the lm_head and all
    block matmul weights become QTensors. The lm_head stays per-channel
    int8 even at bits=4, as in the JAX package."""
    _check_bits(params, bits)
    out = dict(params)
    out["blocks"] = {
        k: (_quantize_leaf(k, v, bits, group) if k in _BLOCK_CONTRACT else v)
        for k, v in params["blocks"].items()
    }
    out["lm_head"] = quantize(params["lm_head"], (0,))
    return out


@torch.no_grad()
def quantize_params_leafwise(params: dict, bits: int = 4,
                             group: int = 128) -> dict:
    """quantize_params, dropping each full-precision leaf as its
    quantized copy lands: the peak is the full-precision tree plus one
    quantized leaf (and one layer's f32 temporaries).

    CONSUMES the input: full-precision leaves are popped from the
    caller's `params["blocks"]` dict itself, and `lm_head` from `params`
    — popping a private copy would keep every leaf referenced through
    the caller's tree until return, losing the bound this function
    exists for."""
    _check_bits(params, bits)
    src = params["blocks"]   # shared: pops drop the caller's refs too
    blocks = {}
    for k in list(src):
        if k not in _BLOCK_CONTRACT:
            blocks[k] = src[k]
            continue
        w = src.pop(k)
        blocks[k] = _quantize_leaf(k, w, bits, group)
        del w
    out = dict(params)
    out["blocks"] = blocks
    lm = params.pop("lm_head")
    out["lm_head"] = quantize(lm, (0,))
    del lm
    return out
