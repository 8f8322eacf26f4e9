"""Training loss and step for the speculative-decoding draft head.

Port of ``leaxer_qwen3_tts_tpu/training/draft_loss.py``.  The draft
(``models/draft.py``) learns next-frame code prediction from the quantities
the spec decoder feeds it at inference: the talker hidden that produced
frame f and frame f's embed sum, both from the teacher-forced talker pass of
the TTS loss (:func:`~.loss.teacher_forward`).  The main model is frozen:
that pass runs under ``torch.no_grad()`` (JAX's ``stop_gradient``), so a
talker with ``attn_impl="pallas"`` runs it on kernel K8, and gradients flow
only into the draft head.

Two transitions train together (teacher forced):
  step-1: x = in(hidden_f, embed_f)        -> codes_{f+1}
  step-2: x' = rec(x, embed_{f+1})         -> codes_{f+2}
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import DraftConfig, TTSModelConfig
from ..models.draft import draft_forward_teacher
from .loss import _cross_entropy, teacher_forward
from .train_step import Optimizer


class DraftLossMetrics(NamedTuple):
    loss: torch.Tensor
    step1_loss: torch.Tensor
    step2_loss: torch.Tensor
    step1_code0_acc: torch.Tensor  # greedy top-1 accuracy (acceptance proxy)
    frames: torch.Tensor


def draft_loss(
    cfg: TTSModelConfig,
    dcfg: DraftConfig,
    params: dict,  # main model params (frozen)
    draft_params: dict,
    text_ids: torch.Tensor,
    text_len: torch.Tensor,
    codes: torch.Tensor,  # [B, F, 16]
    num_frames: torch.Tensor,
    lang_id: Optional[int] = None,
) -> DraftLossMetrics:
    F = codes.shape[1]
    codes = codes.long()
    with torch.no_grad():
        tf = teacher_forward(cfg, params, text_ids, text_len, codes, num_frames, lang_id)
        hiddens = tf.pred_hidden
        embeds = tf.c0e + tf.sub_sum

    (l0_s1, ls_s1), (l0_s2, ls_s2) = draft_forward_teacher(
        dcfg, draft_params, params["embeddings"], hiddens, embeds)

    def masked_ce(l0, ls, offset):
        # logits at index f predict frame f + offset
        Fv = F - offset
        t0 = codes[:, offset:, 0]  # [B, Fv]
        tsub = codes[:, offset:, 1:]  # [B, Fv, 15]
        # source AND target frames real
        mask = (tf.frame_valid[:, :Fv] & tf.frame_valid[:, offset:]).float()
        ce0 = _cross_entropy(l0[:, :Fv], t0) * mask
        ces = _cross_entropy(ls[:, :Fv], tsub) * mask[..., None]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (ce0.sum() + ces.sum() / 15.0) / denom / 2.0
        acc = ((torch.argmax(l0[:, :Fv], dim=-1) == t0).float() * mask).sum() / denom
        return loss, acc

    s1, acc1 = masked_ce(l0_s1, ls_s1, 1)
    s2, _ = masked_ce(l0_s2, ls_s2, 2)
    return DraftLossMetrics(loss=s1 + s2, step1_loss=s1, step2_loss=s2, step1_code0_acc=acc1,
                            frames=tf.frame_valid.sum())


def make_draft_train_step(
    cfg: TTSModelConfig,
    dcfg: DraftConfig,
    tx: Optimizer,
    lang_id: Optional[int] = None,
) -> Callable:
    """The draft-only train step: ``(draft_params, opt_state, params, batch)
    -> (draft_params, opt_state, DraftLossMetrics)``, with ``opt_state =
    tx.init(draft_params)``; the draft is updated in place and the main
    params are only read."""

    def step(draft_params, opt_state, params, batch) -> Tuple[dict, object, DraftLossMetrics]:
        opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            m = draft_loss(cfg, dcfg, params, draft_params, batch["text_ids"],
                           batch["text_len"], batch["codes"], batch["num_frames"], lang_id)
            m.loss.backward()
        tx.apply(opt_state)
        return draft_params, opt_state, DraftLossMetrics(*(x.detach() for x in m))

    return step
