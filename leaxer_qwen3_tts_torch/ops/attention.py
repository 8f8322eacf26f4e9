"""Grouped-query attention over a head-major cache: the dispatch and the
plain-tensor path.

Port of ``leaxer_qwen3_tts_tpu/ops/attention.py``.  :func:`attend` takes the
config's ``attn_impl``: ``"xla"`` runs :func:`attend_xla` (the prefill and
unpacked-decode path, written with explicit products and a softmax rather
than ``scaled_dot_product_attention`` so its numerics stay comparable with
the reference), ``"pallas"`` runs kernel K8
(:func:`~leaxer_qwen3_tts_torch.ops.flash_attention.flash_attend`), and any
other value raises.

An int8 cache comes with float32 scales per (slot, kv head): :func:`attend_xla`
applies them where the reference does, to the scores after the Q.K product
and to the softmax weights before the weights.V product (exact: a slot's
scale is a scalar of both contractions); the ``"pallas"`` arm dequantizes
K/V to q's dtype first, since K8 takes no scales.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free after softmax


def _inv_sqrt(d: int) -> float:
    """1/sqrt(d) rounded as float32 math rounds it (sqrt, then divide)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


def attend_xla(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, Nk, T, D] head-major
    v: torch.Tensor,  # [B, Nk, T, D]
    mask: torch.Tensor,  # [B, S, T] bool (True = attend)
    k_scale: Optional[torch.Tensor] = None,  # float32 [B, Nk, T] when k is int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped-query attention; returns [B, S, Nq, D] in q.dtype."""
    B, S, nq, d = q.shape
    nk, T = k.shape[1], k.shape[2]
    g = nq // nk
    # the products' operand dtype, as the reference picks it: the cache
    # dtype; over an int8 cache bf16, or float32 in a float32 model
    cdt = k.dtype
    if k.dtype == torch.int8:
        cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16

    # group q by kv head: [B, S, Nq, D] -> [B, Nk, g*S, D]
    qh = q.reshape(B, S, nk, g, d).permute(0, 2, 3, 1, 4).reshape(B, nk, g * S, d)
    # the score product runs on q cast to that dtype, as the reference does
    scores = torch.matmul(qh.to(cdt).float(), k.to(cdt).float().transpose(-1, -2))  # [B, Nk, gS, T]
    scores = scores * _inv_sqrt(d)
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    m = mask[:, None, None, :, :].expand(B, nk, g, S, T).reshape(B, nk, g * S, T)
    scores = scores.masked_fill(~m, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        weights = weights * v_scale[:, :, None, :]
    # the weights are cast to that dtype before the product, as the
    # reference does
    out = torch.matmul(weights.to(cdt).float(), v.to(cdt).float())  # [B, Nk, g*S, D]
    out = out.reshape(B, nk, g, S, d).permute(0, 3, 1, 2, 4).reshape(B, S, nq, d)
    return out.to(q.dtype)


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    impl: str = "xla",
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention by ``impl`` ("xla" or "pallas", the config's ``attn_impl``);
    ``k_scale`` / ``v_scale``: the scales of an int8 cache.  "pallas" has no
    gradient: under autograd with q, k or v requiring grad it raises, as
    ``jax.grad`` through the JAX flash kernel does."""
    if impl == "xla":
        return attend_xla(q, k, v, mask, k_scale=k_scale, v_scale=v_scale)
    if impl == "pallas":
        from .flash_attention import flash_attend

        if k_scale is not None:
            # K8 takes no scales: dequantize up front, as the reference does
            k = (k.float() * k_scale[..., None]).to(q.dtype)
            v = (v.float() * v_scale[..., None]).to(q.dtype)
        return flash_attend(q, k, v, mask)
    raise ValueError(f"unknown attention impl {impl!r}")
