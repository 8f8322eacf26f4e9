"""Grouped-query attention over a head-major cache: the dispatch and the
plain-tensor path.

Port of ``leaxer_qwen3_tts_tpu/ops/attention.py``.  :func:`attend` takes the
config's ``attn_impl``: ``"xla"`` runs :func:`attend_xla` (the prefill and
unpacked-decode path, written with explicit products and a softmax rather
than ``scaled_dot_product_attention`` so its numerics stay comparable with
the reference), ``"pallas"`` runs kernel K8
(:func:`~leaxer_qwen3_tts_torch.ops.flash_attention.flash_attend`), and any
other value raises.  int8-KV scales are not ported yet.
"""

from __future__ import annotations

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
) -> torch.Tensor:
    """Grouped-query attention; returns [B, S, Nq, D] in q.dtype."""
    B, S, nq, d = q.shape
    nk, T = k.shape[1], k.shape[2]
    g = nq // nk

    # group q by kv head: [B, S, Nq, D] -> [B, Nk, g*S, D]
    qh = q.reshape(B, S, nk, g, d).permute(0, 2, 3, 1, 4).reshape(B, nk, g * S, d)
    # the score product runs on q cast to the cache dtype, as the reference does
    scores = torch.matmul(qh.to(k.dtype).float(), k.float().transpose(-1, -2))  # [B, Nk, g*S, T]
    scores = scores * _inv_sqrt(d)
    m = mask[:, None, None, :, :].expand(B, nk, g, S, T).reshape(B, nk, g * S, T)
    scores = scores.masked_fill(~m, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    # the weights are cast to the cache dtype before the product, as the
    # reference does
    out = torch.matmul(weights.to(k.dtype).float(), v.float())  # [B, Nk, g*S, D]
    out = out.reshape(B, nk, g, S, d).permute(0, 3, 1, 2, 4).reshape(B, S, nq, d)
    return out.to(q.dtype)


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    impl: str = "xla",
) -> torch.Tensor:
    """Attention by ``impl`` ("xla" or "pallas", the config's ``attn_impl``)."""
    if impl == "xla":
        return attend_xla(q, k, v, mask)
    if impl == "pallas":
        from .flash_attention import flash_attend

        return flash_attend(q, k, v, mask)
    raise ValueError(f"unknown attention impl {impl!r}")
