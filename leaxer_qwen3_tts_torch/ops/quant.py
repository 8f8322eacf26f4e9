"""Weight-only int8 quantization for the memory-bound decode path.

Port of ``leaxer_qwen3_tts_tpu/ops/quant.py``: per-output-column symmetric
int8 with the same grid (``torch.round`` rounds half to even, like
``jnp.round``), so both packages dequantize to identical values.  int4
(``QuantizedLinear4``) is not ported yet (ROADMAP item K1v-b / K2v).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch


class QuantizedLinear(NamedTuple):
    """int8 weight + per-output-channel scale.

    q:     int8, [..., in, out] (leading axes = layer stack)
    scale: float32, [..., 1, out]
    """

    q: torch.Tensor
    scale: torch.Tensor


WeightLike = Union[torch.Tensor, QuantizedLinear]


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Per-output-channel symmetric int8 quantization over the 'in' axis."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # [..., 1, out]
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedLinear(q=q, scale=scale)


def dense(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """x [..., in] @ w -> [..., out] in float32.

    The operands are upcast to float32 before the product: for bf16 inputs
    and int8 weights that equals a bf16 dot with float32 accumulation (the
    products are exact in float32)."""
    if isinstance(w, QuantizedLinear):
        y = torch.matmul(x.float(), w.q.float())
        return y * w.scale.reshape(w.scale.shape[-1])
    return torch.matmul(x.float(), w.float())


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


def quantize_params(
    params: dict,
    modules: Sequence[str] = ("talker", "code_predictor"),
    bits: int = 8,
) -> dict:
    """Quantize the matmul weights of the given top-level modules to int8.

    Embedding tables, norms and the vocoder keep their dtype."""
    if bits != 8:
        raise NotImplementedError(
            f"bits={bits}: only int8 is ported (int4: ROADMAP item K1v-b / K2v)"
        )

    def walk(node, quantizing: bool):
        if isinstance(node, dict):
            return {
                k: (
                    quantize_weight(v)
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
