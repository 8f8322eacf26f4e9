"""The generation loop: prefill once, then chunked decode.

Port of ``leaxer_qwen3_tts_tpu/runtime/generate.py``.  One frame:

    sample code0 -> MTP chain -> embed sum (+ text drip) -> talker step

With ``cfg.frame_fused`` (or, with the field None, ``QTTS_FRAME_FUSED`` as
the JAX package reads it: :func:`frame_fused_enabled`) a B=1 frame that
passes the JAX package's gate
(:func:`frame_fused_eligible`) runs as ONE launch of kernel K7
(:func:`~leaxer_qwen3_tts_torch.ops.fused_frame.fused_frame_step`); only the
noise draw, the drip gather and the EOS bookkeeping stay outside it.

JAX scans ``chunk_len`` frames inside one jitted program; here a chunk is a
Python loop that only enqueues device work: the sampled codes, the EOS
latch, the per-stream positions and step counts and the validity flags stay
on the device, and the caller syncs once per chunk.  The positions ``pos``
and steps ``step`` are [B] device tensors, as in the JAX package, so the
continuous pool's slots can sit at different positions (``uniform_fill=
False``) and a pool chunk needs no host sync either.  Gumbel noise is drawn
on the device from the streams' ``torch.Generator``s: one for the batch, or
one per stream (:class:`~leaxer_qwen3_tts_torch.runtime.sampling.NoiseSource`).

With a ``mesh`` (the engine's, passed for a B=1 request only) a frame's
talker step is kernel K9 where the engine attached its pack, the prefill
uniform and the cache not int8 (the JAX package's gate: an int8 cache steps
on the plain layers, K10's chain beside it), and its chain kernel K10 where
that pack is; the prefill, the code0 draw, the embeddings and the lm_head
run on the mesh's first device.  A batch's rows split over the mesh's data
groups are decoded by each group's own callables on its lead device (the
engine holds each group's state through the chunks), built without the mesh:
JAX's K9 and K10 gates take B=1 only, so a group's share of a larger batch,
a pool and a verify pass step on the plain layers beside the cached chain.
``frame_fused`` is ineligible under a mesh, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..config import CODEC_EOS, TTSModelConfig
from ..models.code_predictor import predict_subcodes
from ..models.embeddings import codec_embed
from ..models.layers import KVCache, TPKVCache
from ..models.talker import (
    talker_decode_step,
    talker_init_cache,
    talker_prefill,
    talker_shard_cache,
)
from ..ops.fused_frame import fused_frame_step, supports_frame
from .prompt import PromptBundle, build_prompt
from .sampling import (
    NoiseSource,
    RowKnobs,
    SamplingParams,
    make_codec_suppress_mask,
    noise_width,
    sample_token,
)

Generators = Union[None, torch.Generator, Sequence[Optional[torch.Generator]]]


class GenerateState(NamedTuple):
    cache: Union[KVCache, TPKVCache]  # TPKVCache: a mesh's K9 step (B=1)
    valid_mask: torch.Tensor  # [B, T] bool
    last_logits: torch.Tensor  # [B, V] f32
    last_hidden: torch.Tensor  # [B, H]
    pos: torch.Tensor  # [B] int64 — RoPE position (and cache slot) of the next token
    step: torch.Tensor  # [B] int64 — frames generated so far, PER STREAM
    done: torch.Tensor  # [B] bool — EOS latched
    generators: Tuple[Optional[torch.Generator], ...]  # one for the batch, or one per row


def _as_generators(generator: Generators) -> Tuple[Optional[torch.Generator], ...]:
    if generator is None or isinstance(generator, torch.Generator):
        return (generator,)
    return tuple(generator)


def prefill(
    cfg: TTSModelConfig,
    params: dict,
    text_ids: torch.Tensor,  # [B, T] int
    text_len: torch.Tensor,  # [B] int
    lang_id: Optional[int],
    max_len: int,
    generator: Generators,  # one generator, or one per row
    speaker_embed: Optional[torch.Tensor] = None,  # [B, H]: a preset speaker's embedding
    instruct_ids: Optional[torch.Tensor] = None,  # [B, I] int: a voice-design instruction
    instruct_len: Optional[torch.Tensor] = None,  # [B] int
) -> Tuple[GenerateState, PromptBundle]:
    bundle = build_prompt(params["embeddings"], text_ids, text_len, lang_id, speaker_embed,
                          instruct_ids, instruct_len)
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
        pos=torch.full((B,), P, dtype=torch.long, device=device),
        step=torch.zeros((B,), dtype=torch.long, device=device),
        done=torch.zeros((B,), dtype=torch.bool, device=device),
        generators=_as_generators(generator),
    )
    return state, bundle


def sample_code0(
    logits: torch.Tensor,  # [B, V] f32, the talker's logits of B streams
    suppress: torch.Tensor,
    sp: SamplingParams,
    knobs: RowKnobs,
    noise: NoiseSource,
) -> torch.Tensor:
    """Codebook 0 of B streams: control tokens suppressed except EOS (and EOS
    too where forbidden), then each stream's draw.  Returns [B] int64."""
    B, V = logits.shape
    rows = sp.rows(B)
    logits = logits + suppress[None, :]
    if any(r.forbid_eos for r in rows):
        logits[:, CODEC_EOS] += knobs.eos_add if sp.per_row else -1e30
    return sample_token(logits, sp, noise.draw([0 if r.greedy else noise_width(V, r)
                                                for r in rows]), knobs)


def sample_subcodes(
    cfg: TTSModelConfig,
    params: dict,
    last_hidden: torch.Tensor,  # [B * slots, H]
    code0: torch.Tensor,  # [B * slots]
    sp: SamplingParams,  # the B streams' knobs
    noise: NoiseSource,
    slots: int = 1,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Codebooks 1..15 of B streams with ``slots`` candidate rows each (row
    b * slots + j: stream b's candidate j, sampled with stream b's knobs and
    noise).  Returns (code0_embed, subcodes, sub_sum), one row per input row."""
    emb = params["embeddings"]
    cp = cfg.code_predictor
    code0_embed = codec_embed(emb, code0)
    rows = sp.rows(last_hidden.shape[0] // slots)
    flat = sp.repeat(slots)
    Vs = cp.subcode_vocab_size
    sub_widths = [0 if r.greedy else noise_width(Vs, r) for r in rows]
    subcodes, sub_sum = predict_subcodes(
        cp,
        params["code_predictor"],
        emb["pred_embed"],
        last_hidden,
        code0_embed,
        lambda lg, j: sample_token(lg, flat, noise.draw(sub_widths, slots)),
        sp=flat,
        noise_fn=lambda: noise.draw_chain(cp.num_steps, Vs, [not r.greedy for r in rows], slots),
        mesh=mesh,
    )
    return code0_embed, subcodes, sub_sum


def compute_drip(step: torch.Tensor, trailing, trailing_len, tts_pad_embed) -> torch.Tensor:
    """The text-drip embedding of frame index ``step`` ([B] or [B, k]): row
    ``step[b]`` of stream b's trailing buffer while its text lasts, then the
    TTS_PAD embedding.  Returns [B, H] or [B, k, H]."""
    B, T = trailing.shape[:2]
    rows = torch.arange(B, device=trailing.device).reshape((B,) + (1,) * (step.dim() - 1))
    drip = trailing[rows, torch.clamp(step, max=T - 1)]
    use_text = step < trailing_len.reshape(rows.shape)
    return torch.where(use_text[..., None], drip, tts_pad_embed.to(drip.dtype))


def frame_fused_enabled(cfg: TTSModelConfig) -> bool:
    """The whole-frame kernel's switch, as the JAX package resolves it
    (``runtime/generate.py::_frame_fused_eligible``): ``cfg.frame_fused``
    when set, else ``QTTS_FRAME_FUSED`` (off unless set to other than "0")."""
    if cfg.frame_fused is not None:
        return bool(cfg.frame_fused)
    return os.environ.get("QTTS_FRAME_FUSED", "0") != "0"


def frame_fused_eligible(cfg: TTSModelConfig, params: dict, state: GenerateState,
                         sp: Optional[SamplingParams], uniform_fill: bool = True,
                         mesh=None) -> bool:
    """The JAX package's gate for the whole-frame kernel (its
    ``_frame_fused_eligible``), and nothing more: no mesh,
    :func:`frame_fused_enabled`, B=1 sequential decode, the fused talker and
    MTP packs and no talker ``fused_tp`` pack, per-step heads, and
    :func:`~leaxer_qwen3_tts_torch.ops.fused_frame.supports_frame` at this
    cache bucket.  Shapes and config only: no device data.  (The lm_head and
    heads packs K7 reads are there wherever the packs are: the talker's
    ``fused_lm_head``, int8 or bf16 rows, and the chain's ``fused_heads``.)"""
    if mesh is not None or not frame_fused_enabled(cfg) or sp is None or not uniform_fill:
        return False
    if state.last_hidden.shape[0] != 1:
        return False
    tp = params.get("talker", {})
    cp = params.get("code_predictor", {})
    if cfg.talker.decode_impl != "fused" or "fused_step" not in tp:
        return False
    if "fused_step" not in cp or "fused_tp" in tp:
        return False
    if cfg.code_predictor.head_mode != "per_step":
        return False
    return supports_frame(cp["fused_step"], state.cache.max_len, cfg.talker.transformer,
                          kvq=state.cache.quantized)


def _frame_step_fused(
    cfg: TTSModelConfig,
    params: dict,
    suppress: torch.Tensor,
    trailing: torch.Tensor,
    trailing_len: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    sp: SamplingParams,
    state: GenerateState,
) -> Tuple[GenerateState, Tuple[torch.Tensor, torch.Tensor]]:
    """One frame through kernel K7: the code0 draw, the chain, the next-input
    sum, the talker step and the lm_head in one launch.  The noise comes from
    the stream's generator in the JAX order, code0's [Vc] first and then the
    chain's [n, V], in one draw (none when greedy)."""
    emb, tp, cp = params["embeddings"], params["talker"], params["code_predictor"]
    knobs = sp.rows(1)[0]
    Vc = cfg.talker.codec_vocab_size
    n, V = cfg.code_predictor.num_steps, cfg.code_predictor.subcode_vocab_size
    g0 = gm = None
    if not knobs.greedy:
        noise = NoiseSource(state.generators, state.last_logits.device).draw([Vc + n * V])
        g0, gm = noise[:, :Vc], noise[0, Vc:].reshape(n, 1, V)
    drip = compute_drip(state.step, trailing, trailing_len, tts_pad_embed)
    cache = state.cache
    pos = min(int(cache.length), cache.max_len - 1)
    code0, subcodes, logits2, hidden2 = fused_frame_step(
        cfg.talker.transformer, cfg.code_predictor.transformer, tp["fused_step"],
        tp["transformer"]["final_norm"], tp["fused_lm_head"], emb["codec_embed"],
        cp["fused_step"], cp["transformer"]["final_norm"], cp["fused_heads"], emb["pred_embed"],
        state.last_logits, state.last_hidden, suppress, drip, pos, cache.k, cache.v, g0, gm,
        knobs.temperature, knobs.top_k, knobs.top_p, knobs.forbid_eos, *cache.scales,
        mtp_cache_dtype=cfg.code_predictor.transformer.torch_dtype,
    )[:4]
    is_eos = code0 == CODEC_EOS
    frame_valid = ~state.done & ~is_eos
    frame = torch.cat([code0[:, None], subcodes], dim=1)
    frame = torch.where(frame_valid[:, None], frame, 0)
    valid_mask = state.valid_mask.clone()
    valid_mask[:, pos] = True
    new_state = GenerateState(
        cache=cache._replace(length=cache.length + 1),
        valid_mask=valid_mask,
        last_logits=logits2,
        last_hidden=hidden2.to(state.last_hidden.dtype),
        pos=state.pos + 1,
        step=state.step + 1,
        done=state.done | is_eos,
        generators=state.generators,
    )
    return new_state, (frame, frame_valid)


def _frame_step(
    cfg: TTSModelConfig,
    params: dict,
    suppress: torch.Tensor,
    trailing: torch.Tensor,
    trailing_len: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    sp: SamplingParams,
    knobs: RowKnobs,
    state: GenerateState,
    uniform_fill: bool = True,
    frame_fused: bool = False,
    mesh=None,
) -> Tuple[GenerateState, Tuple[torch.Tensor, torch.Tensor]]:
    """One 12 Hz frame.  Returns (state', (frame_codes [B, 16] int32, frame_valid [B])).
    ``frame_fused``: :func:`frame_fused_eligible` for this chunk."""
    if frame_fused:
        return _frame_step_fused(cfg, params, suppress, trailing, trailing_len, tts_pad_embed,
                                 sp, state)
    noise = NoiseSource(state.generators, state.last_logits.device)
    code0 = sample_code0(state.last_logits, suppress, sp, knobs, noise)
    is_eos = code0 == CODEC_EOS
    frame_valid = ~state.done & ~is_eos
    done = state.done | is_eos
    code0_embed, subcodes, sub_sum = sample_subcodes(cfg, params, state.last_hidden, code0, sp,
                                                     noise, mesh=mesh)
    frame = torch.cat([code0[:, None].to(torch.int32), subcodes.to(torch.int32)], dim=1)
    frame = torch.where(frame_valid[:, None], frame, 0)

    # --- next talker input: codec sum + text drip ---
    drip = compute_drip(state.step, trailing, trailing_len, tts_pad_embed)
    next_embed = (code0_embed + sub_sum + drip).to(code0_embed.dtype)

    logits2, hidden2, cache, valid_mask = talker_decode_step(
        cfg.talker, params["talker"], next_embed, state.pos, state.cache, state.valid_mask,
        uniform_fill=uniform_fill, mesh=mesh,
    )
    new_state = GenerateState(
        cache=cache,
        valid_mask=valid_mask,
        last_logits=logits2,
        last_hidden=hidden2,
        pos=state.pos + 1,
        step=state.step + 1,
        done=done,
        generators=state.generators,
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
    uniform_fill: bool = True,
    mesh=None,
) -> Tuple[GenerateState, torch.Tensor, torch.Tensor]:
    """Run ``num_frames`` frames.  Returns (state, frames [B, F, 16] int32,
    valid [B, F] bool), all on the device; nothing here waits for it."""
    device = state.last_logits.device
    B, V = state.last_logits.shape
    suppress = make_codec_suppress_mask(cfg.talker.codec_vocab_size, device)
    knobs = RowKnobs.build(sp, B, V, device)  # once per chunk
    fused = frame_fused_eligible(cfg, params, state, sp, uniform_fill, mesh)  # once per chunk
    frames, valid = [], []
    for _ in range(num_frames):
        state, (frame, fv) = _frame_step(
            cfg, params, suppress, trailing, trailing_len, tts_pad_embed, sp, knobs, state,
            uniform_fill, fused, mesh,
        )
        frames.append(frame)
        valid.append(fv)
    return state, torch.stack(frames, dim=1), torch.stack(valid, dim=1)


class GenerateFns(NamedTuple):
    """Entry points bound to one (model config, batch, cache bucket, chunk)."""

    prefill: callable  # (params, text_ids, text_len, generator, **segments) -> (state, bundle)
    decode: callable  # (params, state, trailing, trailing_len, tts_pad_embed, sp) -> (state, frames, valid)


def make_generate_fns(
    cfg: TTSModelConfig,
    batch: int,
    max_len: int,
    chunk_len: int = 32,
    lang_id: Optional[int] = None,
    uniform_fill: bool = True,
    mesh=None,
) -> GenerateFns:
    """Prefill / decode-chunk callables, the shape of the JAX package's
    ``make_generate_fns``.  ``max_len`` is the first KV-cache bucket;
    ``uniform_fill=False`` decodes a pool state whose rows sit at their own
    positions (``cache.length`` a [B] device tensor); ``mesh``: the
    tensor-parallel mesh of the decode (K9, K10)."""

    def prefill_fn(params, text_ids, text_len, generator=None, **segments):
        """``segments``: the optional prompt segments of :func:`prefill`
        (``speaker_embed``, ``instruct_ids``, ``instruct_len``)."""
        if text_ids.shape[0] != batch:
            raise ValueError(f"batch {text_ids.shape[0]} != {batch}")
        state, bundle = prefill(cfg, params, text_ids, text_len, lang_id, max_len, generator,
                                **segments)
        if uniform_fill:  # a mesh's K9 step takes the ranks' head shards
            state = state._replace(cache=talker_shard_cache(cfg.talker, params["talker"],
                                                            state.cache, mesh))
        return state, bundle

    def decode_fn(params, state, trailing, trailing_len, tts_pad_embed, sp):
        return decode_frames(
            cfg, params, state, trailing, trailing_len, tts_pad_embed, sp, chunk_len,
            uniform_fill, mesh,
        )

    return GenerateFns(prefill=prefill_fn, decode=decode_fn)
