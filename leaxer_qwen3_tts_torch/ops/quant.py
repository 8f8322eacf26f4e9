"""Weight-only int8 and int4 quantization for the memory-bound decode path.

Port of ``leaxer_qwen3_tts_tpu/ops/quant.py``: per-output-column symmetric
int8 and group-128 symmetric int4 (``QuantizedLinear4``: two nibbles per
byte, half-split along K, one float32 scale per (K group, output column))
on the same grids (``torch.round`` rounds half to even, like ``jnp.round``),
so both packages hold the same integers and scales and dequantize to
identical values.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Union

import torch


class QuantizedLinear(NamedTuple):
    """int8 weight + per-output-channel scale.

    q:     int8, [..., in, out] (leading axes = layer stack)
    scale: float32, [..., 1, out]
    """

    q: torch.Tensor
    scale: torch.Tensor


INT4_GROUP = 128  # K-rows per int4 scale group


class QuantizedLinear4(NamedTuple):
    """int4 weight (two nibbles per byte) + per-(K-group, out-column) scales.

    q:     int8, [..., in/2, out]: the byte at row k packs weight rows k (low
           nibble) and k + in/2 (high nibble), both two's complement in
           [-8, 7] (the JAX package's half-split packing)
    scale: float32, [..., in/G, out]: group g covers input rows
           [g*G, (g+1)*G), G = INT4_GROUP (smaller where in/2 is not a
           multiple of it)
    """

    q: torch.Tensor
    scale: torch.Tensor


WeightLike = Union[torch.Tensor, QuantizedLinear, QuantizedLinear4]


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Per-output-channel symmetric int8 quantization over the 'in' axis."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # [..., 1, out]
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedLinear(q=q, scale=scale)


def int4_group(K: int, group: int = INT4_GROUP) -> int:
    """The rows per scale group of a K-row int4 weight: ``group`` shrunk to
    a divisor of K/2, so that any even K quantizes (JAX's rule)."""
    return math.gcd(min(group, max(K // 2, 1)), K // 2)


def quantize_int4_values(w: torch.Tensor, group: int = INT4_GROUP):
    """The int4 grid of ``w`` [..., K, N]: (values int32 [..., K, N] in
    [-8, 7], scales float32 [..., K/G, N]), the groups along K."""
    wf = w.float()
    K, N = wf.shape[-2], wf.shape[-1]
    if K % 2 != 0:
        raise ValueError(f"int4 packing needs an even K, got {K}")
    group = int4_group(K, group)
    lead = wf.shape[:-2]
    g = wf.reshape(*lead, K // group, group, N)
    amax = g.abs().amax(dim=-2, keepdim=True)  # [..., G, 1, N]
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale), -8, 7).to(torch.int32).reshape(*lead, K, N)
    return q, scale.reshape(*lead, K // group, N)


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP) -> QuantizedLinear4:
    """Symmetric int4 quantization with per-(K-group, out-column) scales, the
    JAX package's grid and half-split nibble packing."""
    q, scale = quantize_int4_values(w, group)
    K = q.shape[-2]
    lo, hi = q[..., : K // 2, :], q[..., K // 2 :, :]
    packed = ((hi & 0xF) << 4) | (lo & 0xF)  # [..., K/2, N] in [0, 255]
    return QuantizedLinear4(q=packed.to(torch.uint8).view(torch.int8), scale=scale)


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] packed bytes -> [..., K, N] int32 values in [-8, 7]."""
    b = q.to(torch.int32)
    lo = (b << 28) >> 28  # the sign-extended low nibble
    hi = b >> 4  # arithmetic shift: the sign-extended high nibble
    return torch.cat([lo, hi], dim=-2)


def _dense4(x: torch.Tensor, w: QuantizedLinear4) -> torch.Tensor:
    """Group-scaled int4 product: one float32 dot per K group (the lhs kept
    unrounded, as JAX's ``_dense4`` keeps its dtype), its scale applied after
    the dot, the groups summed in float32."""
    if w.q.dim() != 2:
        raise ValueError("int4 dense expects an unstacked [K/2, N] weight")
    K2, N = w.q.shape
    G = w.scale.shape[-2]
    gs = 2 * K2 // G
    wfull = unpack_int4(w.q).float().reshape(G, gs, N)
    xg = x.float().reshape(*x.shape[:-1], G, gs)
    part = torch.einsum("...gk,gkn->...gn", xg, wfull)  # [..., G, N]
    return (part * w.scale).sum(dim=-2)


def dense(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """x [..., in] @ w -> [..., out] in float32.

    The operands are upcast to float32 before the product: for bf16 inputs
    and int8 weights that equals a bf16 dot with float32 accumulation (the
    products are exact in float32)."""
    if isinstance(w, QuantizedLinear4):
        return _dense4(x, w)
    if isinstance(w, QuantizedLinear):
        y = torch.matmul(x.float(), w.q.float())
        return y * w.scale.reshape(w.scale.shape[-1])
    return torch.matmul(x.float(), w.float())


def weight_dtype(w: WeightLike, dtype: torch.dtype = torch.bfloat16) -> torch.dtype:
    """The compute dtype of a weight: bf16 for a quantized one (JAX's), else
    the tensor's own."""
    return dtype if isinstance(w, (QuantizedLinear, QuantizedLinear4)) else w.dtype


def index_weight(w: WeightLike, i: int) -> WeightLike:
    """Entry i along the leading (layer or step) axis of a possibly
    quantized stacked weight."""
    if isinstance(w, (QuantizedLinear, QuantizedLinear4)):
        return type(w)(q=w.q[i], scale=w.scale[i])
    return w[i]


# weight names (leaf keys) that are matmul operands and safe to quantize
_MATMUL_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "wg", "wu", "wd", "lm_head", "heads",
     "head", "wqkv", "wgu"}
)


def fuse_params(params: dict, modules: Sequence[str] = ("talker", "code_predictor")) -> dict:
    """Concatenate per-layer (wq, wk, wv) -> wqkv and (wg, wu) -> wgu."""

    def fuse_layers(layers: dict) -> dict:
        out = dict(layers)
        if all(k in out for k in ("wq", "wk", "wv")):
            out["wqkv"] = torch.cat([out.pop("wq"), out.pop("wk"), out.pop("wv")], dim=-1)
        if all(k in out for k in ("wg", "wu")):
            out["wgu"] = torch.cat([out.pop("wg"), out.pop("wu")], dim=-1)
        return out

    out = {}
    for key, sub in params.items():
        if key in modules and isinstance(sub, dict) and "transformer" in sub:
            tr = dict(sub["transformer"])
            tr["layers"] = fuse_layers(tr["layers"])
            out[key] = {**sub, "transformer": tr}
        else:
            out[key] = sub
    return out


# in int4 mode these keys stay int8: the lm_head and the MTP heads feed the
# sampler directly, and their stacked layouts sit outside the unit packs
_INT8_ONLY_KEYS = frozenset({"lm_head", "heads", "head"})


def quantize_params(
    params: dict,
    modules: Sequence[str] = ("talker", "code_predictor"),
    bits: int = 8,
) -> dict:
    """Quantize the matmul weights of the given top-level modules.

    Embedding tables, norms and the vocoder keep their dtype.  ``bits=4``
    applies group-128 int4 to the transformer products and keeps the output
    heads (lm_head, MTP heads) and odd-K weights int8, as the JAX package."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant_one(k: str, v: torch.Tensor):
        if bits == 4 and k not in _INT8_ONLY_KEYS and v.shape[-2] % 2 == 0:
            return quantize_weight_int4(v)
        return quantize_weight(v)

    def walk(node, quantizing: bool):
        if isinstance(node, dict):
            return {
                k: (
                    quant_one(k, v)
                    if quantizing and k in _MATMUL_KEYS and isinstance(v, torch.Tensor)
                    else walk(v, quantizing)
                )
                for k, v in node.items()
            }
        if hasattr(node, "_fields"):  # already-packed NamedTuple: pass through
            return node
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, quantizing) for v in node)
        return node

    return {key: walk(sub, quantizing=key in modules) for key, sub in params.items()}
