"""Sampling: temperature / top-k / top-p with caller-supplied Gumbel noise.

Port of ``leaxer_qwen3_tts_tpu/runtime/sampling.py``.  The JAX reference
draws ``jax.random.categorical``, which is ``argmax(logits + Gumbel)``; here
the Gumbel noise is an ARGUMENT, drawn by the caller from the request's
``torch.Generator`` (:func:`gumbel_noise`).  Fed the noise that
``jax.random.categorical`` draws, :func:`sample_token` returns the JAX
package's index.  The knobs are host values (one request per call), so the
greedy / subset / full-vocab choice is made on the host with no device sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CODEC_EOS, DEFAULT_TEMPERATURE, DEFAULT_TOP_K, DEFAULT_TOP_P

NEG_INF = -1e30
K_CAP = 128  # static top-k subset width for the fast sampling path


class SamplingParams(NamedTuple):
    """Per-request sampling knobs (host scalars)."""

    temperature: float
    top_k: int  # <= 0 disables
    top_p: float  # >= 1.0 disables
    forbid_eos: bool  # True masks CODEC_EOS (fixed-length runs)

    @classmethod
    def create(
        cls,
        temperature: float = DEFAULT_TEMPERATURE,
        top_k: int = DEFAULT_TOP_K,
        top_p: float = DEFAULT_TOP_P,
        forbid_eos: bool = False,
    ) -> "SamplingParams":
        return cls(float(temperature), int(top_k), float(top_p), bool(forbid_eos))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def clamp_temperature(temperature: float) -> float:
    """max(temperature, 1e-6) in float32: the divisor every sampler uses."""
    return float(torch.clamp_min(torch.tensor(temperature, dtype=torch.float32), 1e-6))


def scale_by_temperature(x: torch.Tensor, temperature: float) -> torch.Tensor:
    """x / max(temperature, 1e-6) as an elementwise IEEE division, like the
    references and the chain kernel (a scalar divisor may be turned into a
    reciprocal multiply, which rounds differently)."""
    return x / torch.full_like(x, clamp_temperature(temperature))


def noise_width(vocab: int, params: SamplingParams) -> int:
    """Last-axis width of the Gumbel noise :func:`sample_token` consumes:
    ``K_CAP`` on the top-k subset path, the vocab otherwise."""
    if vocab > K_CAP and 0 < params.top_k <= K_CAP:
        return K_CAP
    return vocab


def gumbel_noise(
    shape: Tuple[int, ...], generator: torch.Generator, device
) -> torch.Tensor:
    """Gumbel(0, 1) float32 noise, -log(-log(U)) with U in [tiny, 1)
    (the construction ``jax.random.gumbel`` uses)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep entries >= the k-th largest value (ties kept)."""
    V = logits.shape[-1]
    if not 0 < k < V:
        return torch.ones_like(logits, dtype=torch.bool)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    threshold = sorted_desc[..., k - 1 : k]
    return logits >= threshold


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus mask: keep tokens whose exclusive cumulative probability (in
    descending order) is < p, i.e. including the first token crossing p."""
    if p >= 1.0:
        return torch.ones_like(logits, dtype=torch.bool)
    probs = torch.softmax(logits, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    cum_excl = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep_sorted = cum_excl < p
    keep = torch.zeros_like(keep_sorted)
    return keep.scatter(-1, order, keep_sorted)


def _sample_full(logits, params: SamplingParams, gumbel):
    scaled = scale_by_temperature(logits, params.temperature)
    scaled = torch.where(_top_k_mask(scaled, params.top_k), scaled, NEG_INF)
    scaled = torch.where(_top_p_mask(scaled, params.top_p), scaled, NEG_INF)
    return torch.argmax(gumbel + scaled, dim=-1)  # torch.argmax: first index wins ties


def _sample_topk_subset(logits, params: SamplingParams, gumbel):
    """Restrict to the top-K_CAP logits, then temperature / top-k / top-p in
    the sorted subset (equal to the full path whenever top_k <= K_CAP)."""
    V = logits.shape[-1]
    k_cap = min(K_CAP, V)
    # a stable descending sort orders ties by index, like lax.top_k
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k_cap], idx[..., :k_cap]
    k_idx = min(max(params.top_k - 1, 0), k_cap - 1)
    threshold = vals[..., k_idx : k_idx + 1]
    keep = vals >= threshold
    scaled = torch.where(keep, scale_by_temperature(vals, params.temperature), NEG_INF)
    probs = torch.softmax(scaled, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    pos = torch.arange(k_cap, device=logits.device)
    keep_p = (cum_excl < params.top_p) | (pos == 0)
    scaled = torch.where(keep_p, scaled, NEG_INF)
    choice = torch.argmax(gumbel + scaled, dim=-1)
    return torch.gather(idx, -1, choice[..., None])[..., 0]


def sample_token(
    logits: torch.Tensor,  # [..., V] float32
    params: SamplingParams,
    gumbel: Optional[torch.Tensor] = None,  # [..., noise_width(V, params)]
) -> torch.Tensor:
    """Sample token ids [...] (int64).  temperature <= 0 -> greedy argmax
    (``gumbel`` unused and may be None)."""
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    V = logits.shape[-1]
    width = noise_width(V, params)
    if gumbel is None or gumbel.shape[-1] != width:
        raise ValueError(f"sampled draw needs Gumbel noise of width {width}")
    if width == V:
        return _sample_full(logits, params, gumbel)
    return _sample_topk_subset(logits, params, gumbel)


def make_codec_suppress_mask(vocab_size: int = 3072, device=None) -> torch.Tensor:
    """Additive mask suppressing codec control tokens 2048..vocab-1 except CODEC_EOS."""
    ids = torch.arange(vocab_size, device=device)
    suppress = (ids >= 2048) & (ids != CODEC_EOS)
    zeros = torch.zeros(vocab_size, dtype=torch.float32, device=device)
    return zeros.masked_fill(suppress, NEG_INF)
