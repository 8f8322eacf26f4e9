"""Teacher-forced training loss for the Qwen3-TTS acoustic LM.

Port of ``leaxer_qwen3_tts_tpu/training/loss.py``.  Given text and
ground-truth codec frames, it reproduces the generation-time input schedule
(the prompt builder, the text drip and the codec-sum frame inputs) and
computes:

  * the talker loss: next-frame codebook-0 cross-entropy (and CODEC_EOS at
    the position after the last real frame);
  * the code-predictor loss: the teacher-forced 15-step MTP cross-entropy
    with the per-step heads and per-step embedding tables.

Both are masked means over real frames, so right-padded batches of varying
length train as the unpadded ones would. :func:`tts_loss_terms` gives each
mean's masked sum and count, from which a data-parallel step rebuilds the
whole batch's means out of its groups' terms (:func:`loss_from_terms`).
Every product takes float32 sums of the operands' exact products, as the
JAX package's ``preferred_element_type=float32`` dots and float32 einsums
do: the logits are never a bf16 product cast up afterwards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CODEC_EOS, TTSModelConfig
from ..models.embeddings import codec_embed
from ..models.layers import transformer_forward_nocache
from ..runtime.prompt import build_prompt


class LossMetrics(NamedTuple):
    loss: torch.Tensor
    talker_loss: torch.Tensor
    mtp_loss: torch.Tensor
    frames: torch.Tensor  # number of real target frames in the batch


class LossTerms(NamedTuple):
    """The masked sums and counts behind the two means of :func:`tts_loss`."""

    talker_sum: torch.Tensor  # code0 cross-entropy summed over targets (frames and EOS)
    talker_count: torch.Tensor  # the targets counted
    mtp_sum: torch.Tensor  # sub-code cross-entropy summed over real frames' steps
    mtp_count: torch.Tensor  # the (frame, step) pairs counted
    frames: torch.Tensor  # real target frames


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element cross-entropy in float32; logits [..., V], targets [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz - gold


class TeacherForward(NamedTuple):
    """What the teacher-forced talker pass yields (shared by the TTS loss and
    the draft loss)."""

    pred_hidden: torch.Tensor  # [B, F, H] hidden that predicts frame f
    c0e: torch.Tensor  # [B, F, H] codec_embed(code0)
    sub_e: torch.Tensor  # [B, F, S, H] per-step sub-code embeddings
    sub_sum: torch.Tensor  # [B, F, H]
    frame_valid: torch.Tensor  # [B, F] bool


def teacher_forward(
    cfg: TTSModelConfig,
    params: dict,
    text_ids: torch.Tensor,  # [B, T] int, right-padded
    text_len: torch.Tensor,  # [B] int
    codes: torch.Tensor,  # [B, F, 16] int
    num_frames: torch.Tensor,  # [B] int
    lang_id: Optional[int] = None,
) -> TeacherForward:
    """Teacher-forced talker pass with the generation-time input schedule."""
    t = cfg.talker.transformer
    emb = params["embeddings"]
    B, F, _ = codes.shape
    device = codes.device
    codes = codes.long()

    bundle = build_prompt(emb, text_ids, text_len, lang_id)
    P = bundle.prompt_len

    frame_ids = torch.arange(F, device=device)
    frame_valid = frame_ids[None, :] < num_frames.to(device)[:, None]  # [B, F]

    # generation-time frame inputs (teacher forced)
    c0e = codec_embed(emb, codes[..., 0])  # [B, F, H]
    tables = emb["pred_embed"]  # [S, V, H]
    steps = torch.arange(tables.shape[0], device=device)
    sub_e = tables[steps, codes[..., 1:]]  # [B, F, S, H]
    sub_sum = sub_e.sum(dim=2)

    # the text drip: frame f takes trailing[f] while f < trailing_len, else TTS_PAD
    Tt = bundle.trailing.shape[1]
    drip = bundle.trailing[:, torch.clamp(frame_ids, max=Tt - 1)]  # [B, F, H]
    use_text = frame_ids[None, :] < bundle.trailing_len[:, None]
    drip = torch.where(use_text[..., None], drip, bundle.tts_pad_embed.to(drip.dtype))
    frame_in = (c0e + sub_sum + drip).to(t.torch_dtype)

    # the talker over the whole teacher-forced sequence, no cache; pad
    # frames neither attend nor are attended
    seq = torch.cat([bundle.prompt_embeds.to(t.torch_dtype), frame_in], dim=1)
    seq_valid = torch.cat([torch.ones((B, P), dtype=torch.bool, device=device), frame_valid],
                          dim=1)
    hidden = transformer_forward_nocache(t, params["talker"]["transformer"], seq,
                                         valid=seq_valid)

    # position P-1+f predicts frame f; position P-1+n predicts EOS
    return TeacherForward(pred_hidden=hidden[:, P - 1 : P - 1 + F], c0e=c0e, sub_e=sub_e,
                          sub_sum=sub_sum, frame_valid=frame_valid)


def tts_loss(
    cfg: TTSModelConfig,
    params: dict,
    text_ids: torch.Tensor,  # [B, T] int (right-padded)
    text_len: torch.Tensor,  # [B] int
    codes: torch.Tensor,  # [B, F, 16] int ground-truth codec frames
    num_frames: torch.Tensor,  # [B] int real frame counts (<= F)
    lang_id: Optional[int] = None,
    mtp_weight: float = 1.0,
) -> LossMetrics:
    return loss_from_terms([tts_loss_terms(cfg, params, text_ids, text_len, codes, num_frames,
                                           lang_id)], mtp_weight)


def loss_from_terms(terms, mtp_weight: float = 1.0) -> LossMetrics:
    """The loss over every row of the batches whose :class:`LossTerms` are
    given (a data-parallel step's groups, on the first one's device): each
    mean is the summed masked sums over the summed counts, not a mean of
    the groups' means, which would weigh a group's frames by its share."""
    dev = terms[0].talker_sum.device
    total = [sum(getattr(t, f).to(dev) for t in terms) for f in LossTerms._fields]
    t = LossTerms(*total)
    talker_loss = t.talker_sum / torch.clamp(t.talker_count, min=1.0)
    mtp = t.mtp_sum / torch.clamp(t.mtp_count, min=1.0)
    return LossMetrics(loss=talker_loss + mtp_weight * mtp, talker_loss=talker_loss,
                       mtp_loss=mtp, frames=t.frames)


def tts_loss_terms(
    cfg: TTSModelConfig,
    params: dict,
    text_ids: torch.Tensor,  # [B, T] int (right-padded)
    text_len: torch.Tensor,  # [B] int
    codes: torch.Tensor,  # [B, F, 16] int ground-truth codec frames
    num_frames: torch.Tensor,  # [B] int real frame counts (<= F)
    lang_id: Optional[int] = None,
) -> LossTerms:
    """The masked sums and counts of the talker's and the code predictor's
    cross-entropies (:func:`tts_loss`'s means before the division)."""
    B, F, _ = codes.shape
    S = cfg.code_predictor.num_steps  # 15 sub-codebooks
    H = cfg.talker.transformer.hidden_size
    codes = codes.long()
    code0, subs = codes[..., 0], codes[..., 1:]
    frame_ids = torch.arange(F, device=codes.device)

    tf = teacher_forward(cfg, params, text_ids, text_len, codes, num_frames, lang_id)
    frame_valid = tf.frame_valid

    logits0 = torch.matmul(tf.pred_hidden.float(), params["talker"]["lm_head"].float())
    is_eos_pos = frame_ids[None, :] == num_frames.to(codes.device)[:, None]
    targets0 = torch.where(is_eos_pos, CODEC_EOS, code0)
    target_mask = (frame_valid | is_eos_pos).float()
    ce0 = _cross_entropy(logits0, targets0) * target_mask

    # the code predictor's loss, teacher forced and batched over frames: each
    # frame's sequence is [talker hidden, codec_embed(code0), sub_e[0..S-2]]
    pt = cfg.code_predictor.transformer
    mtp_seq = torch.cat([tf.pred_hidden[:, :, None], tf.c0e[:, :, None], tf.sub_e[:, :, : S - 1]],
                        dim=2).to(pt.torch_dtype).reshape(B * F, S + 1, H)
    mtp_hidden = transformer_forward_nocache(pt, params["code_predictor"]["transformer"], mtp_seq)
    # the output at index j+1 under head j predicts sub-code j (codebook j+1)
    step_hidden = mtp_hidden[:, 1:].reshape(B, F, S, H)
    logits_sub = torch.einsum("bfsh,shv->bfsv", step_hidden.float(),
                              params["code_predictor"]["heads"].float())
    ce_sub = _cross_entropy(logits_sub, subs)  # [B, F, S]
    sub_mask = frame_valid[..., None].expand(ce_sub.shape).float()
    return LossTerms(talker_sum=ce0.sum(), talker_count=target_mask.sum(),
                     mtp_sum=(ce_sub * sub_mask).sum(), mtp_count=sub_mask.sum(),
                     frames=frame_valid.sum())
