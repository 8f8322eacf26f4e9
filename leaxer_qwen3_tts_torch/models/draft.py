"""Trained draft head for frame-level speculative decoding (EAGLE-style).

Port of ``leaxer_qwen3_tts_tpu/models/draft.py``.  It predicts the next
frames' 16 codec codes from the pending frame's talker hidden state and
input-embed sum, the two exact quantities ``runtime/speculative.py``
carries between iterations:

    x_0     = gelu(LN([hidden ; embed]) @ W_in)
    codes_j = argmax(x_j @ head0), argmax(x_j @ heads_sub[i])   (16 heads)
    x_{j+1} = gelu(LN([x_j ; frame_embed(codes_j)]) @ W_rec)

``frame_embed`` reuses the main model's codec and MTP embedding tables, and
:func:`draft_forward_teacher` gives the teacher-forced logits that
``training/draft_loss.py`` trains it on.  The draft never changes what is
committed (the verify pass produces every committed code), only how many
frames an iteration commits.  It is a few small products per iteration, so
it runs as plain PyTorch, on the card too, as the JAX package leaves it to
XLA outside any Pallas kernel.  Its products
take bf16 operands with float32 sums (``preferred_element_type=float32``)
and its GELU is the tanh approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..config import DraftConfig
from .embeddings import codec_embed
from .layers import _normal


def init_draft_params(cfg: DraftConfig, gen: torch.Generator, device) -> dict:
    """Random draft parameters (the JAX package's shapes and scales)."""
    H, D = cfg.hidden_size, cfg.d_model
    dt = cfg.torch_dtype
    return {
        "w_in": _normal(gen, (2 * H, D), (2 * H) ** -0.5, dt, device),
        "w_rec": _normal(gen, (D + H, D), (D + H) ** -0.5, dt, device),
        "head0": _normal(gen, (D, cfg.codec_vocab_size), D ** -0.5, dt, device),
        "heads_sub": _normal(
            gen, (cfg.num_codebooks - 1, D, cfg.subcode_vocab_size), D ** -0.5, dt, device
        ),
        "ln_in": torch.ones((2 * H,), dtype=dt, device=device),
        "ln_rec": torch.ones((D + H,), dtype=dt, device=device),
    }


def _norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * w.float()).to(x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 sums of the operands' exact products."""
    return torch.matmul(x.float(), w.float())


def _state_in(cfg: DraftConfig, p: dict, hidden, embed) -> torch.Tensor:
    dt = cfg.torch_dtype
    z = torch.cat([hidden.to(dt), embed.to(dt)], dim=-1)
    return F.gelu(_dot(_norm(z, p["ln_in"]), p["w_in"]), approximate="tanh").to(dt)


def _state_rec(cfg: DraftConfig, p: dict, x, frame_embed) -> torch.Tensor:
    dt = cfg.torch_dtype
    z = torch.cat([x, frame_embed.to(dt)], dim=-1)
    return F.gelu(_dot(_norm(z, p["ln_rec"]), p["w_rec"]), approximate="tanh").to(dt)


def _head_logits(p: dict, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits0 [B, Vc] f32, logits_sub [B, 15, Vs] f32)."""
    l0 = _dot(x, p["head0"])
    ls = torch.einsum("bd,idv->biv", x.float(), p["heads_sub"].float())
    return l0, ls


def _frame_embed_sum(embeddings: dict, codes: torch.Tensor) -> torch.Tensor:
    """codec_embed(code0) + sum_j table_j[subcode_j], codes [B, 16] -> [B, H]."""
    tables = embeddings["pred_embed"]  # [15, Vs, H]
    steps = torch.arange(tables.shape[0], device=codes.device)
    embs = tables[steps[None, :], codes[:, 1:]]  # [B, 15, H]
    return codec_embed(embeddings, codes[:, 0]) + embs.sum(dim=-2)


def draft_predict(
    cfg: DraftConfig,
    params: dict,
    embeddings: dict,
    hidden: torch.Tensor,  # [B, H]
    embed: torch.Tensor,  # [B, H]
    n_frames: int,
) -> torch.Tensor:
    """Greedy autoregressive draft of the next ``n_frames`` frames.
    Returns codes [B, n_frames, 16] int32, on the device, with no host sync."""
    x = _state_in(cfg, params, hidden, embed)
    out = []
    for _ in range(n_frames):
        l0, ls = _head_logits(params, x)
        codes = torch.cat([torch.argmax(l0, dim=-1)[:, None], torch.argmax(ls, dim=-1)], dim=1)
        out.append(codes.to(torch.int32))
        x = _state_rec(cfg, params, x, _frame_embed_sum(embeddings, codes))
    return torch.stack(out, dim=1)


def draft_forward_teacher(
    cfg: DraftConfig,
    params: dict,
    embeddings: dict,
    hiddens: torch.Tensor,  # [B, F, H] talker hidden at each frame
    embeds: torch.Tensor,  # [B, F, H] frame-embed sums at each frame
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Teacher-forced logits for training.

    step-1: x from (hidden_f, embed_f)   -> predicts codes_{f+1}
    step-2: x' from (x, embed_{f+1})     -> predicts codes_{f+2}
    Returns ((l0_s1, lsub_s1), (l0_s2, lsub_s2)): logits0 [B, n, Vc] and
    logits_sub [B, n, 15, Vs], float32, with n = F for step 1 and F - 1 for
    step 2.  ``embeddings`` is unused, as in the JAX package."""

    def logits(x):
        B, n, D = x.shape
        l0, ls = _head_logits(params, x.reshape(B * n, D))
        return l0.reshape(B, n, -1), ls.reshape(B, n, ls.shape[1], ls.shape[2])

    x1 = _state_in(cfg, params, hiddens, embeds)  # [B, F, D]
    x2 = _state_rec(cfg, params, x1[:, :-1], embeds[:, 1:])  # [B, F-1, D]
    return logits(x1), logits(x2)


def model_draft_fn(cfg: DraftConfig, params: dict, embeddings: dict) -> Callable:
    """A ``draft_fn(state, k)`` for ``runtime/speculative.py``: the k-1 drafted
    frames of every stream from its pending hidden state and embed sum."""

    def draft_fn(state, k: int):
        return draft_predict(cfg, params, embeddings, state.pending_hidden,
                             state.pending_nodrip, k - 1), None

    return draft_fn
