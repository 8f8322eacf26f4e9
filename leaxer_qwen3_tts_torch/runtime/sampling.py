"""Sampling: temperature / top-k / top-p with caller-supplied Gumbel noise.

Port of ``leaxer_qwen3_tts_tpu/runtime/sampling.py``.  The JAX reference
draws ``jax.random.categorical``, which is ``argmax(logits + Gumbel)``; here
the Gumbel noise is an ARGUMENT, drawn by the caller from the request's
``torch.Generator`` (:func:`gumbel_noise`).  Fed the noise that
``jax.random.categorical`` draws, :func:`sample_token` returns the JAX
package's index.  The knobs are host values -- scalars for one request, or
length-B tuples for per-row knobs in a serving batch -- so the greedy /
subset / full-vocab choice is made on the host with no device sync.  With
per-row knobs each row takes its own path (the JAX package takes the subset
path only when every row qualifies; the two agree whenever they both can):
a row's draw then depends on its own knobs and noise alone.

:class:`NoiseSource` draws the noise from one generator shared by the batch,
or from one generator per row (per-stream seeds, pool slots), so that a
seeded stream's samples do not depend on which row it has or on its
batch-mates.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..config import CODEC_EOS, DEFAULT_TEMPERATURE, DEFAULT_TOP_K, DEFAULT_TOP_P

NEG_INF = -1e30
K_CAP = 128  # static top-k subset width for the fast sampling path


class SamplingParams(NamedTuple):
    """Sampling knobs (host values): scalars for one request, or length-B
    tuples (any field) for per-row knobs in a batch."""

    temperature: Union[float, Tuple[float, ...]]
    top_k: Union[int, Tuple[int, ...]]  # <= 0 disables
    top_p: Union[float, Tuple[float, ...]]  # >= 1.0 disables
    forbid_eos: Union[bool, Tuple[bool, ...]]  # True masks CODEC_EOS (fixed-length runs)

    @classmethod
    def create(
        cls,
        temperature=DEFAULT_TEMPERATURE,
        top_k=DEFAULT_TOP_K,
        top_p=DEFAULT_TOP_P,
        forbid_eos=False,
    ) -> "SamplingParams":
        """Scalars, or sequences of one length B (per-row knobs)."""

        def norm(v, cast):
            return tuple(cast(x) for x in v) if isinstance(v, (list, tuple)) else cast(v)

        sp = cls(norm(temperature, float), norm(top_k, int), norm(top_p, float),
                 norm(forbid_eos, bool))
        if len({len(v) for v in sp if isinstance(v, tuple)}) > 1:
            raise ValueError("per-row knobs of different lengths")
        return sp

    @property
    def per_row(self) -> bool:
        return any(isinstance(v, tuple) for v in self)

    def rows(self, B: int) -> List["SamplingParams"]:
        """The scalar knobs of each of B rows."""
        cols = []
        for v in self:
            if isinstance(v, tuple):
                if len(v) != B:
                    raise ValueError(f"per-row knobs for {len(v)} rows, batch of {B}")
                cols.append(v)
            else:
                cols.append((v,) * B)
        return [SamplingParams(*r) for r in zip(*cols)]

    def repeat(self, slots: int) -> "SamplingParams":
        """Per-row knobs with each row repeated ``slots`` times (the K
        candidate rows of a stream in a verify pass); scalars as they are."""
        if slots == 1 or not self.per_row:
            return self
        return SamplingParams(*(
            tuple(x for x in v for _ in range(slots)) if isinstance(v, tuple) else v for v in self
        ))

    def select(self, rows: slice) -> "SamplingParams":
        """The knobs of the batch rows ``rows`` (a data group's): per-row
        knobs sliced, scalars as they are."""
        if not self.per_row:
            return self
        return SamplingParams(*(v[rows] if isinstance(v, tuple) else v for v in self))

    @property
    def greedy(self) -> bool:
        """True when every row decodes greedily."""
        t = self.temperature
        return all(x <= 0.0 for x in t) if isinstance(t, tuple) else t <= 0.0


def clamp_temperature(temperature: float) -> float:
    """max(temperature, 1e-6) in float32: the divisor every sampler uses."""
    return float(torch.clamp_min(torch.tensor(temperature, dtype=torch.float32), 1e-6))


def scale_by_temperature(x: torch.Tensor, temperature: float) -> torch.Tensor:
    """x / max(temperature, 1e-6) as an elementwise IEEE division, like the
    references and the chain kernel (a scalar divisor may be turned into a
    reciprocal multiply, which rounds differently)."""
    return x / torch.full_like(x, clamp_temperature(temperature))


def noise_width(vocab: int, params: SamplingParams) -> int:
    """Last-axis width of the Gumbel noise :func:`sample_token` consumes for
    one row (scalar knobs): ``K_CAP`` on the top-k subset path, the vocab
    otherwise."""
    if vocab > K_CAP and 0 < params.top_k <= K_CAP:
        return K_CAP
    return vocab


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_noise(
    shape: Tuple[int, ...], generator: torch.Generator, device
) -> torch.Tensor:
    """Gumbel(0, 1) float32 noise, -log(-log(U)) with U in [tiny, 1)
    (the construction ``jax.random.gumbel`` uses)."""
    return _gumbel(torch.rand(shape, generator=generator, dtype=torch.float32, device=device))


class NoiseSource:
    """The Gumbel noise of a batch of B rows: from one generator shared by
    every row, or from one generator per row.  A row's draws from its own
    generator are the draws a B=1 run with that generator makes (the same
    widths, in the same order), so a stream's noise is a function of its
    seed alone."""

    def __init__(self, generators: Sequence[Optional[torch.Generator]], device):
        self.generators = tuple(generators)
        self.device = device

    def draw(self, widths: Sequence[int], slots: int = 1) -> Optional[torch.Tensor]:
        """[B * slots, max(widths)] noise of B streams with ``slots`` rows
        each; stream b's rows b * slots .. b * slots + slots - 1 read their
        first widths[b] columns (0: a greedy stream, which draws nothing)."""
        W = max(widths)
        if W == 0:
            return None
        if len(self.generators) == 1:
            return gumbel_noise((len(widths) * slots, W), self.generators[0], self.device)
        u = torch.zeros((len(widths) * slots, W), dtype=torch.float32, device=self.device)
        for b, w in enumerate(widths):
            if w:
                u[b * slots : (b + 1) * slots, :w].uniform_(generator=self.generators[b])
        return _gumbel(u)

    def draw_chain(
        self, n: int, V: int, sampled: Sequence[bool], slots: int = 1
    ) -> Optional[torch.Tensor]:
        """[n, B * slots, V] noise of the MTP chain of B streams with
        ``slots`` candidate rows each (speculative verify: row b * slots + j
        is stream b's candidate j, drawn from stream b's generator); None
        when no stream samples."""
        if not any(sampled):
            return None
        B = len(sampled)
        if len(self.generators) == 1:
            return gumbel_noise((n, B * slots, V), self.generators[0], self.device)
        u = torch.zeros((B, slots, n, V), dtype=torch.float32, device=self.device)
        for b, s in enumerate(sampled):
            if s:
                u[b].uniform_(generator=self.generators[b])
        return _gumbel(u).reshape(B * slots, n, V).permute(1, 0, 2)


class RowKnobs(NamedTuple):
    """Knobs as device columns [B, 1] (or [1, 1] for scalar knobs), built once
    per decode chunk, plus each row's sampling path as [B] masks."""

    temperature: torch.Tensor  # float32, max(temperature, 1e-6)
    top_k: torch.Tensor  # int64
    top_p: torch.Tensor  # float32
    subset: torch.Tensor  # bool [B]: samples on the top-K_CAP subset path
    full: torch.Tensor  # bool [B]: samples on the full-vocab path
    eos_add: torch.Tensor  # float32 [B]: NEG_INF where CODEC_EOS is forbidden

    @classmethod
    def build(cls, params: SamplingParams, B: int, V: int, device) -> "RowKnobs":
        rows = params.rows(B) if params.per_row else [params]
        widths = [0 if r.greedy else noise_width(V, r) for r in rows]

        def col(vals, dtype):
            # a host-to-device copy that does not wait for the device
            return torch.tensor(vals, dtype=dtype).to(device, non_blocking=True)

        return cls(
            temperature=col([[clamp_temperature(r.temperature)] for r in rows], torch.float32),
            top_k=col([[r.top_k] for r in rows], torch.long),
            top_p=col([[r.top_p] for r in rows], torch.float32),
            subset=col([0 < w < V for w in widths], torch.bool),
            full=col([w == V for w in widths], torch.bool),
            eos_add=col([NEG_INF if r.forbid_eos else 0.0 for r in rows], torch.float32),
        )


def _sample_full(logits, knobs: RowKnobs, gumbel):
    """Exact full-vocab path: temperature, top-k (ties kept), top-p keeping
    the first token that crosses the bound, then argmax(noise + scaled)."""
    V = logits.shape[-1]
    scaled = logits / knobs.temperature  # elementwise IEEE division
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(knobs.top_k - 1, 0, V - 1).expand(logits.shape[0], 1)
    threshold = torch.gather(sorted_desc, -1, k_idx)  # the row's top_k-th largest
    keep_k = (scaled >= threshold) | ~((knobs.top_k > 0) & (knobs.top_k < V))
    scaled = torch.where(keep_k, scaled, NEG_INF)
    probs = torch.softmax(scaled, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    keep_sorted = (torch.cumsum(sorted_probs, dim=-1) - sorted_probs) < knobs.top_p
    keep_p = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    scaled = torch.where(keep_p | (knobs.top_p >= 1.0), scaled, NEG_INF)
    return torch.argmax(gumbel + scaled, dim=-1)  # torch.argmax: first index wins ties


def _sample_topk_subset(logits, knobs: RowKnobs, gumbel):
    """Restrict to the top-K_CAP logits, then temperature / top-k / top-p in
    the sorted subset (equal to the full path whenever top_k <= K_CAP)."""
    V = logits.shape[-1]
    k_cap = min(K_CAP, V)
    # a stable descending sort orders ties by index, like lax.top_k
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k_cap], idx[..., :k_cap]
    k_idx = torch.clamp(knobs.top_k - 1, 0, k_cap - 1).expand(logits.shape[0], 1)
    threshold = torch.gather(vals, -1, k_idx)
    keep = (vals >= threshold) | (knobs.top_k <= 0)
    scaled = torch.where(keep, vals / knobs.temperature, NEG_INF)
    probs = torch.softmax(scaled, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    pos = torch.arange(k_cap, device=logits.device)
    keep_p = (cum_excl < knobs.top_p) | (pos == 0)
    scaled = torch.where(keep_p, scaled, NEG_INF)
    choice = torch.argmax(gumbel + scaled, dim=-1)
    return torch.gather(idx, -1, choice[..., None])[..., 0]


def sample_token(
    logits: torch.Tensor,  # [B, V] float32
    params: SamplingParams,
    gumbel: Optional[torch.Tensor] = None,  # [B, >= the widest row's noise_width]
    knobs: Optional[RowKnobs] = None,  # RowKnobs.build(params, B, V, device), reused
) -> torch.Tensor:
    """Sample token ids [B] (int64).  Greedy rows (temperature <= 0) take the
    argmax; the others sample on the subset or the full-vocab path by their
    own knobs (``gumbel`` unused, and may be None, when every row is greedy)."""
    greedy = torch.argmax(logits, dim=-1)
    if params.greedy:
        return greedy
    B, V = logits.shape
    rows = params.rows(B) if params.per_row else [params]
    widths = {0 if r.greedy else noise_width(V, r) for r in rows}
    if gumbel is None or gumbel.shape[-1] < max(widths):
        raise ValueError(f"sampled draw needs Gumbel noise of width {max(widths)}")
    if knobs is None:
        knobs = RowKnobs.build(params, B, V, logits.device)
    out = greedy
    if any(0 < w < V for w in widths):
        sub = _sample_topk_subset(logits, knobs, gumbel[..., :K_CAP])
        out = sub if not params.per_row else torch.where(knobs.subset, sub, out)
    if V in widths:
        full = _sample_full(logits, knobs, gumbel[..., :V])
        out = full if not params.per_row else torch.where(knobs.full, full, out)
    return out


def make_codec_suppress_mask(vocab_size: int = 3072, device=None) -> torch.Tensor:
    """Additive mask suppressing codec control tokens 2048..vocab-1 except CODEC_EOS."""
    ids = torch.arange(vocab_size, device=device)
    suppress = (ids >= 2048) & (ids != CODEC_EOS)
    zeros = torch.zeros(vocab_size, dtype=torch.float32, device=device)
    return zeros.masked_fill(suppress, NEG_INF)
