"""Prompt-embedding assembly with the Qwen3-TTS text-drip schedule.

Port of ``leaxer_qwen3_tts_tpu/runtime/prompt.py``:

  prompt = role(3) ⊕ [pad-block + TTS_BOS  added elementwise to  codec-prefill
  embeds](pad_count+1) ⊕ [first-text-token + CODEC_BOS embed](1)

The remaining text drips in one token per decode step through the
``trailing`` buffer (TTS_EOS terminated), then falls back to TTS_PAD.  A
speaker embedding (a CustomVoice preset's row of ``speaker_table``) is
spliced immediately before CODEC_BOS and widens the pad block by one; a
voice-design instruction segment sits between the role block and the codec
prefill, its slots past ``instruct_len`` carrying the TTS_PAD embedding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import (
    ASSISTANT,
    CODEC_BOS,
    CODEC_NOTHINK,
    CODEC_PAD,
    CODEC_THINK,
    CODEC_THINK_BOS,
    CODEC_THINK_EOS,
    IM_END,
    IM_START,
    TTS_BOS,
    TTS_EOS,
    TTS_PAD,
)
from ..models.embeddings import codec_embed, text_project


class PromptBundle(NamedTuple):
    """Everything the decode loop needs for one request batch."""

    prompt_embeds: torch.Tensor  # [B, P, H]
    prompt_len: int  # P (static: every row has the same prompt length)
    trailing: torch.Tensor  # [B, T, H] — token i+1 at row i, TTS_EOS at len-1
    trailing_len: torch.Tensor  # [B] int — rows of `trailing` that are real
    tts_pad_embed: torch.Tensor  # [H] — drip fallback after the text runs out


def codec_prefill_ids(lang_id: Optional[int]) -> list:
    if lang_id is None:
        ids = [CODEC_NOTHINK, CODEC_THINK_BOS, CODEC_THINK_EOS]
    else:
        ids = [CODEC_THINK, CODEC_THINK_BOS, int(lang_id), CODEC_THINK_EOS]
    return ids + [CODEC_PAD, CODEC_BOS]


def prompt_length(
    lang_id: Optional[int], has_speaker: bool = False, instruct_bucket: int = 0
) -> int:
    """Static prompt length: 3 role + instruct segment + (pad_count + 1)
    talker + 1 first-text."""
    n = len(codec_prefill_ids(lang_id))
    pad_count = n - 2 + (1 if has_speaker else 0)
    return 3 + instruct_bucket + pad_count + 2


def tts_embeds(emb_params: dict, device) -> torch.Tensor:
    """[3, H] text embeddings of TTS_BOS, TTS_EOS and TTS_PAD, from one
    product: every caller (the prompt, the pool's drip fallback) then gets
    the same values (a product's rounding may depend on its shape)."""
    ids = torch.tensor([TTS_BOS, TTS_EOS, TTS_PAD], dtype=torch.long, device=device)
    return text_project(emb_params, ids)


def wrap_text_ids(text_tokens: list) -> list:
    """Full chat wrapping: [IM_START, ASSISTANT, TTS_BOS, *text, TTS_EOS, IM_END]."""
    return [IM_START, ASSISTANT, TTS_BOS, *text_tokens, TTS_EOS, IM_END]


def build_prompt(
    emb_params: dict,
    text_ids: torch.Tensor,  # [B, T] int — BPE text tokens only, right-padded
    text_len: torch.Tensor,  # [B] int — true token counts (>= 1)
    lang_id: Optional[int],  # codec language token or None for auto
    speaker_embed: Optional[torch.Tensor] = None,  # [B, H]
    instruct_ids: Optional[torch.Tensor] = None,  # [B, I] int
    instruct_len: Optional[torch.Tensor] = None,  # [B] int (default: I)
) -> PromptBundle:
    B, T = text_ids.shape
    device = text_ids.device

    def ids(values):
        return torch.tensor(values, dtype=torch.long, device=device)

    tts_bos, tts_eos, tts_pad = tts_embeds(emb_params, device)
    H = tts_bos.shape[-1]

    codec_ids = codec_prefill_ids(lang_id)
    ce = codec_embed(emb_params, ids(codec_ids))  # [n, H]
    ce = ce[None].expand(B, len(codec_ids), H)
    if speaker_embed is not None:
        spk = speaker_embed.to(device=device, dtype=ce.dtype)[:, None, :]
        ce = torch.cat([ce[:, :-1], spk, ce[:, -1:]], dim=1)
    pad_count = ce.shape[1] - 2

    role = text_project(emb_params, ids([IM_START, ASSISTANT, TTS_BOS]))
    role = role[None].expand(B, 3, H)
    if instruct_ids is not None:
        n_instr = instruct_ids.shape[1]
        if instruct_len is None:
            instruct_len = torch.full((B,), n_instr, dtype=torch.long, device=device)
        ie = text_project(emb_params, instruct_ids.long())  # [B, I, H]
        pad_slot = torch.arange(n_instr, device=device)[None, :] >= instruct_len.to(device)[:, None]
        ie = torch.where(pad_slot[..., None], tts_pad[None, None, :], ie)
        role = torch.cat([role, ie], dim=1)

    # pad-block ⊕ TTS_BOS, elementwise-added to the codec prefill
    text_part = torch.cat([tts_pad[None].expand(pad_count, H), tts_bos[None]], dim=0)
    talker_part = text_part[None] + ce[:, : pad_count + 1]

    # first text token + CODEC_BOS embedding
    first_text = text_project(emb_params, text_ids[:, 0].long())  # [B, H]
    first_combined = (first_text + ce[:, pad_count + 1])[:, None, :]

    prompt = torch.cat([role, talker_part, first_combined], dim=1)  # [B, P, H]

    # trailing text-drip buffer: row i = text token i+1; row (text_len-1) = TTS_EOS
    all_text = text_project(emb_params, text_ids.long())  # [B, T, H]
    shifted = torch.cat(
        [all_text[:, 1:], torch.zeros((B, 1, H), dtype=all_text.dtype, device=device)], dim=1
    )
    is_eos_row = torch.arange(T, device=device)[None, :] == (text_len.to(device) - 1)[:, None]
    trailing = torch.where(is_eos_row[..., None], tts_eos[None, None, :], shifted)

    return PromptBundle(
        prompt_embeds=prompt,
        prompt_len=prompt.shape[1],
        trailing=trailing,
        trailing_len=text_len.to(device),
        tts_pad_embed=tts_pad,
    )
