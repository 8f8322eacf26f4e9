"""The generation loop: prefill once, then chunked decode.

Port of ``leaxer_qwen3_tts_tpu/runtime/generate.py`` at B=1 (the loop is
written for a batch, but the packed kernels take B=1).  One frame:

    sample code0 -> MTP chain -> embed sum (+ text drip) -> talker step

JAX scans ``chunk_len`` frames inside one jitted program; here a chunk is a
Python loop that only enqueues device work: the sampled codes, the EOS latch
and the validity flags stay on the device, and the caller syncs once per
chunk.  Positions and step counts are host integers (the fill is uniform).
Gumbel noise is drawn from the request's ``torch.Generator`` on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CODEC_EOS, TTSModelConfig
from ..models.code_predictor import predict_subcodes
from ..models.embeddings import codec_embed
from ..models.layers import KVCache
from ..models.talker import talker_decode_step, talker_init_cache, talker_prefill
from .prompt import PromptBundle, build_prompt
from .sampling import (
    SamplingParams,
    gumbel_noise,
    make_codec_suppress_mask,
    noise_width,
    sample_token,
)


class GenerateState(NamedTuple):
    cache: KVCache
    valid_mask: torch.Tensor  # [B, T] bool
    last_logits: torch.Tensor  # [B, V] f32
    last_hidden: torch.Tensor  # [B, H]
    pos: int  # RoPE position (and cache slot) of the next token
    step: int  # frames generated so far
    done: torch.Tensor  # [B] bool — EOS latched
    generator: Optional[torch.Generator]  # the request's noise stream


def prefill(
    cfg: TTSModelConfig,
    params: dict,
    text_ids: torch.Tensor,  # [B, T] int
    text_len: torch.Tensor,  # [B] int
    lang_id: Optional[int],
    max_len: int,
    generator: Optional[torch.Generator],
) -> Tuple[GenerateState, PromptBundle]:
    bundle = build_prompt(params["embeddings"], text_ids, text_len, lang_id)
    B, P, _ = bundle.prompt_embeds.shape
    device = bundle.prompt_embeds.device
    cache = talker_init_cache(cfg.talker, B, max_len, device)
    prompt_len = torch.full((B,), P, dtype=torch.long, device=device)
    last_logits, last_hidden, cache, valid = talker_prefill(
        cfg.talker, params["talker"], bundle.prompt_embeds, prompt_len, cache
    )
    state = GenerateState(
        cache=cache,
        valid_mask=valid,
        last_logits=last_logits,
        last_hidden=last_hidden,
        pos=P,
        step=0,
        done=torch.zeros((B,), dtype=torch.bool, device=device),
        generator=generator,
    )
    return state, bundle


def _compute_drip(step: int, trailing, trailing_len, tts_pad_embed) -> torch.Tensor:
    """This frame's text-drip embedding [B, H]: trailing row ``step`` while
    the text lasts, then the TTS_PAD embedding."""
    T = trailing.shape[1]
    drip = trailing[:, min(step, T - 1)]
    use_text = step < trailing_len  # [B]
    return torch.where(use_text[:, None], drip, tts_pad_embed[None, :].to(drip.dtype))


def _frame_step(
    cfg: TTSModelConfig,
    params: dict,
    suppress: torch.Tensor,
    trailing: torch.Tensor,
    trailing_len: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    sp: SamplingParams,
    state: GenerateState,
) -> Tuple[GenerateState, Tuple[torch.Tensor, torch.Tensor]]:
    """One 12 Hz frame.  Returns (state', (frame_codes [B, 16] int32, frame_valid [B]))."""
    emb = params["embeddings"]
    cp = cfg.code_predictor
    B = state.last_logits.shape[0]
    device = state.last_logits.device
    gen = state.generator

    def noise(shape):
        return None if sp.greedy else gumbel_noise(shape, gen, device)

    # --- codebook 0: suppress control tokens except EOS, sample ---
    logits = state.last_logits + suppress[None, :]
    if sp.forbid_eos:
        logits[:, CODEC_EOS] += -1e30
    code0 = sample_token(logits, sp, noise((B, noise_width(logits.shape[-1], sp))))
    is_eos = code0 == CODEC_EOS
    frame_valid = ~state.done & ~is_eos
    done = state.done | is_eos

    # --- codebooks 1..15 ---
    code0_embed = codec_embed(emb, code0)  # [B, H]
    width = noise_width(cp.subcode_vocab_size, sp)
    subcodes, sub_sum = predict_subcodes(
        cp,
        params["code_predictor"],
        emb["pred_embed"],
        state.last_hidden,
        code0_embed,
        lambda lg, j: sample_token(lg, sp, noise((B, width))),
        sp=sp,
        noise_fn=noise,
    )
    frame = torch.cat([code0[:, None].to(torch.int32), subcodes.to(torch.int32)], dim=1)
    frame = torch.where(frame_valid[:, None], frame, 0)

    # --- next talker input: codec sum + text drip ---
    drip = _compute_drip(state.step, trailing, trailing_len, tts_pad_embed)
    next_embed = (code0_embed + sub_sum + drip).to(code0_embed.dtype)

    logits2, hidden2, cache, valid_mask = talker_decode_step(
        cfg.talker, params["talker"], next_embed, state.pos, state.cache, state.valid_mask,
    )
    new_state = GenerateState(
        cache=cache,
        valid_mask=valid_mask,
        last_logits=logits2,
        last_hidden=hidden2,
        pos=state.pos + 1,
        step=state.step + 1,
        done=done,
        generator=gen,
    )
    return new_state, (frame, frame_valid)


def decode_frames(
    cfg: TTSModelConfig,
    params: dict,
    state: GenerateState,
    trailing: torch.Tensor,
    trailing_len: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    sp: SamplingParams,
    num_frames: int,
) -> Tuple[GenerateState, torch.Tensor, torch.Tensor]:
    """Run ``num_frames`` frames.  Returns (state, frames [B, F, 16] int32,
    valid [B, F] bool), all on the device; nothing here waits for it."""
    suppress = make_codec_suppress_mask(cfg.talker.codec_vocab_size, state.last_logits.device)
    frames, valid = [], []
    for _ in range(num_frames):
        state, (frame, fv) = _frame_step(
            cfg, params, suppress, trailing, trailing_len, tts_pad_embed, sp, state
        )
        frames.append(frame)
        valid.append(fv)
    return state, torch.stack(frames, dim=1), torch.stack(valid, dim=1)


class GenerateFns(NamedTuple):
    """Entry points bound to one (model config, batch, cache bucket, chunk)."""

    prefill: callable  # (params, text_ids, text_len, generator) -> (state, bundle)
    decode: callable  # (params, state, trailing, trailing_len, tts_pad_embed, sp) -> (state, frames, valid)


def make_generate_fns(
    cfg: TTSModelConfig,
    batch: int,
    max_len: int,
    chunk_len: int = 32,
    lang_id: Optional[int] = None,
) -> GenerateFns:
    """Prefill / decode-chunk callables, the shape of the JAX package's
    ``make_generate_fns``.  ``max_len`` is the first KV-cache bucket."""

    def prefill_fn(params, text_ids, text_len, generator=None):
        if text_ids.shape[0] != batch:
            raise ValueError(f"batch {text_ids.shape[0]} != {batch}")
        return prefill(cfg, params, text_ids, text_len, lang_id, max_len, generator)

    def decode_fn(params, state, trailing, trailing_len, tts_pad_embed, sp):
        return decode_frames(
            cfg, params, state, trailing, trailing_len, tts_pad_embed, sp, chunk_len
        )

    return GenerateFns(prefill=prefill_fn, decode=decode_fn)
