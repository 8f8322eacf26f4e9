"""Frame-level speculative decoding: K candidate frames per talker pass.

Port of ``leaxer_qwen3_tts_tpu/runtime/speculative.py``.  Sequential decode
reads every talker weight once per 12 Hz frame.  One verify iteration here
runs K candidate inputs per stream through the talker in ONE pass (kernel K6
on the card) and their MTP chains as ONE batch of B x K rows (kernel K5),
so the weight bytes are shared by every frame the iteration commits:

  inputs   = [embed(pending)] + [embed(draft_1) ... embed(draft_{K-1})]
  verify   = talker pass over the K inputs        (weights read once)
  cand[i]  = sample(logits[i]), MTP(hidden[i], cand0[i])   for i = 0..K-1
  n_b      = longest prefix with cand[i] == draft_{i+1}   (per stream)
  commit   = cand[0..n_b]                         (n_b drafts + 1 bonus)

A stream commits between 1 and K frames per iteration; streams of a batch
commit at their own rates, so each keeps its own fill level, position and
step (all [B] device tensors: a dispatch of several iterations runs without
a host sync, and the caller syncs once when it copies the frames).

Exactness.  The committed codes always come from the exact model: the draft
only chooses which inputs go into the verify pass.  A talker input is a pure
function of the frame's 16 codes, and the verify pass computes each row with
the sequential step's arithmetic (K6's row (b, s) equals the K1 / K4 step at
that position bit for bit; the final norm, the ``lm_head`` and the code0
draw run per candidate slot on [B, H], the sequential shape; a drafted
frame's embed sum is rebuilt in the chain kernel's summation order).  So
GREEDY output equals the sequential loop's, bit for bit, at any acceptance.

Sampled requests.  Noise comes from the streams' ``torch.Generator``s: each
iteration draws, for every stream from its own generator (or from the one
shared generator), K code0 draws and the chain noise of its K candidate
rows, whatever it then commits.  So a sampled request is deterministic for
a given seed, in a pool it does not depend on its slot or its co-tenants,
and every committed frame is a valid draw of the model; it does NOT equal
the sequential loop's sampled output (the draws are spent differently).  The
JAX package promises no more: its sub-code stream and its B>1 streams are
distribution-equal to sequential decode, not bit-equal.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import CODEC_EOS, TTSModelConfig
from ..models.code_predictor import subcode_embed_sum
from ..models.draft import model_draft_fn
from ..models.embeddings import codec_embed
from ..models.layers import KVCache
from ..models.talker import talker_decode_step, talker_verify_step
from .generate import (
    GenerateState,
    Generators,
    compute_drip,
    prefill,
    sample_code0,
    sample_subcodes,
)
from .prompt import PromptBundle
from .sampling import NoiseSource, RowKnobs, SamplingParams, make_codec_suppress_mask


class SpecState(NamedTuple):
    """Loop state of speculative decode (B streams).

    Between iterations ``pending[b]`` is stream b's last committed frame,
    whose talker input (``pending_nodrip`` plus its text drip) has NOT been
    consumed; the cache holds the prompt plus the inputs of every earlier
    committed frame.  The prompt has one static length, so a stream's fill
    level equals its RoPE position: ``rope_pos`` is both (``cache.length``
    is set from it), the first slot the next verify pass writes."""

    cache: KVCache  # length: the [B] fill levels, equal to rope_pos
    valid_mask: torch.Tensor  # [B, T] bool
    pending: torch.Tensor  # [B, 16] int32 -- last committed frame's codes
    pending_nodrip: torch.Tensor  # [B, H] -- its code0_embed + sub_sum (exact)
    pending_hidden: torch.Tensor  # [B, H] -- the talker hidden that produced it
    rope_pos: torch.Tensor  # [B] int64 -- RoPE position and cache slot of the pending input
    step: torch.Tensor  # [B] int64 -- frames committed so far (pending included)
    done: torch.Tensor  # [B] bool -- EOS latched
    generators: Tuple[Optional[torch.Generator], ...]  # one for the batch, or one per stream


DraftFn = Callable[[SpecState, int], Tuple[torch.Tensor, Optional[torch.Tensor]]]


def init_spec_state(
    cfg: TTSModelConfig,
    params: dict,
    text_ids: torch.Tensor,  # [B, T] int
    text_len: torch.Tensor,  # [B] int
    lang_id: Optional[int],
    max_len: int,
    generator: Generators,
    sp: SamplingParams,
    **segments,
) -> Tuple[SpecState, PromptBundle, torch.Tensor, torch.Tensor]:
    """Prefill and frame 0 (code0 from the prefill logits and its MTP chain,
    the sampling half of the sequential frame, with the same draws).
    ``segments``: the prompt's optional speaker and instruct segments, as
    :func:`~leaxer_qwen3_tts_torch.runtime.generate.prefill` takes them.

    Returns (state, bundle, frame0 [B, 16] int32, valid0 [B])."""
    gs, bundle = prefill(cfg, params, text_ids, text_len, lang_id, max_len, generator,
                         **segments)
    B, V = gs.last_logits.shape
    device = gs.last_logits.device
    P = bundle.prompt_embeds.shape[1]
    if gs.cache.length != P:
        raise RuntimeError(f"prefill filled {gs.cache.length} slots for a {P}-position prompt")
    noise = NoiseSource(gs.generators, device)
    suppress = make_codec_suppress_mask(cfg.talker.codec_vocab_size, device)
    code0 = sample_code0(gs.last_logits, suppress, sp, RowKnobs.build(sp, B, V, device), noise)
    code0_embed, subcodes, sub_sum = sample_subcodes(cfg, params, gs.last_hidden, code0, sp, noise)
    frame = torch.cat([code0[:, None], subcodes], dim=1).to(torch.int32)
    valid = code0 != CODEC_EOS
    state = SpecState(
        cache=gs.cache._replace(length=gs.pos.clone()),
        valid_mask=gs.valid_mask,
        pending=frame,
        pending_nodrip=code0_embed + sub_sum,
        pending_hidden=gs.last_hidden,
        rope_pos=gs.pos,
        step=torch.ones((B,), dtype=torch.long, device=device),
        done=~valid,
        generators=gs.generators,
    )
    return state, bundle, torch.where(valid[:, None], frame, 0), valid


def repeat_draft(state: SpecState, k: int):
    """The zero-cost draft: every drafted frame repeats the pending frame.

    Returns (codes [B, k-1, 16], nodrip [B, k-1, H]): reusing the pending
    frame's exact embed sum keeps an accepted draft's input bit-identical to
    the sequential loop's."""
    B, H = state.pending_nodrip.shape
    return (
        state.pending[:, None, :].expand(B, k - 1, state.pending.shape[1]),
        state.pending_nodrip[:, None, :].expand(B, k - 1, H),
    )


def default_draft(cfg: TTSModelConfig, params: dict) -> DraftFn:
    """The trained draft head when the parameters carry one, else the
    repeat draft."""
    if cfg.draft is not None and "draft" in params:
        return model_draft_fn(cfg.draft, params["draft"], params["embeddings"])
    return repeat_draft


def make_replay_draft(traj) -> DraftFn:
    """Replay a recorded trajectory: ``traj`` [F, 1 + num_steps], frame f of a greedy
    decode of the same prompt.  ``pending`` is frame ``step - 1`` and
    candidate slot j verifies frame ``step + j - 1``, so drafting
    ``traj[step + j]`` for slot j+1 makes every draft match its greedy
    candidate: acceptance 1 by construction, for any weights.  Per-stream
    steps index independently (any B); the lookup stays on the device (pass
    ``traj`` on the decode's device, or it is copied there each iteration)."""
    traj = torch.as_tensor(traj, dtype=torch.int32)
    F = traj.shape[0]

    def draft(state: SpecState, k: int):
        device = state.step.device
        start = torch.clamp(state.step, 0, F - (k - 1))
        idx = start[:, None] + torch.arange(k - 1, device=device)[None, :]
        return traj.to(device, non_blocking=True)[idx], None

    return draft


def _spec_iteration(
    cfg: TTSModelConfig,
    params: dict,
    suppress: torch.Tensor,
    trailing: torch.Tensor,
    trailing_len: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    sp: SamplingParams,
    knobs: RowKnobs,
    k: int,
    draft_fn: DraftFn,
    state: SpecState,
    force_accept: bool = False,
) -> Tuple[SpecState, Tuple[torch.Tensor, torch.Tensor]]:
    """One verify iteration.  Returns (state', (frames [B, k, 16] int32,
    valid [B, k])); uncommitted candidate slots are zeroed and invalid.

    ``force_accept`` is a measurement probe only: every draft counts as
    matched, so each iteration commits k frames (the full-acceptance cost,
    for any weights); the compute is that of a real iteration."""
    emb = params["embeddings"]
    B, H = state.pending_nodrip.shape
    device = state.pending.device
    noise = NoiseSource(state.generators, device)

    # --- the K talker inputs per stream ----------------------------------
    drafts, d_nodrip = draft_fn(state, k)  # [B, k-1, 16], [B, k-1, H] | None
    if d_nodrip is None:
        # rebuild the drafted frames' embed sums as the chain would return
        # them, so an accepted draft's input is the sequential input's bits
        d_nodrip = codec_embed(emb, drafts[..., 0]) + subcode_embed_sum(
            cfg.code_predictor, params["code_predictor"], emb["pred_embed"], drafts[..., 1:],
            B * k, state.pending_hidden.dtype,
        )
    nodrip = torch.cat([state.pending_nodrip[:, None, :], d_nodrip.to(state.pending_nodrip.dtype)],
                       dim=1)
    drip_idx = (state.step - 1)[:, None] + torch.arange(k, device=device)[None, :]  # [B, k]
    drip = compute_drip(drip_idx, trailing, trailing_len, tts_pad_embed)
    inputs = (nodrip + drip).to(state.pending_hidden.dtype)

    # --- ONE talker pass over the B x k inputs ----------------------------
    logits, hidden, cache, valid_mask = talker_verify_step(
        cfg.talker, params["talker"], inputs, state.rope_pos, state.cache, state.valid_mask,
    )

    # --- candidates: code0 per slot on [B, V], ONE chain over B x k rows ---
    cand0 = torch.stack(
        [sample_code0(logits[:, s], suppress, sp, knobs, noise) for s in range(k)], dim=1
    )  # [B, k]
    c0e, subcodes, sub_sums = sample_subcodes(
        cfg, params, hidden.reshape(B * k, H), cand0.reshape(B * k), sp, noise, slots=k,
    )
    cand = torch.cat([cand0[..., None], subcodes.reshape(B, k, -1)], dim=-1).to(torch.int32)

    # --- acceptance per stream: longest draft-matching prefix -------------
    match = torch.all(cand[:, : k - 1] == drafts, dim=-1)  # [B, k-1]
    if force_accept:
        match = torch.ones_like(match)
    m = torch.cumprod(match.long(), dim=1).sum(dim=1) + 1  # [B] committed candidates

    # --- EOS / validity (the sequential loop's latching) ------------------
    is_eos = cand0 == CODEC_EOS  # [B, k]
    committed = torch.arange(k, device=device)[None, :] < m[:, None]
    eos_before = torch.cumsum(is_eos.long(), dim=1) - is_eos.long()
    valid = committed & ~state.done[:, None] & (eos_before == 0) & ~is_eos
    done = state.done | torch.any(is_eos & committed, dim=1)
    frames = torch.where(valid[..., None], cand, 0)

    # --- roll each stream to its bonus frame ------------------------------
    # a stream that entered the iteration done is frozen: it consumes no
    # slots (its repeat draft would self-accept post-EOS output and race
    # through the bucket); one that hits EOS now advances once, then freezes
    frozen = state.done
    m_adv = torch.where(frozen, 0, m)
    rows = torch.arange(B, device=device)
    pick = m - 1
    new_pos = state.rope_pos + m_adv
    slots = torch.arange(cache.max_len, device=device)
    new_state = SpecState(
        cache=cache._replace(length=new_pos),
        # slots past the fill hold rejected drafts' K/V until overwritten
        valid_mask=valid_mask & (slots[None, :] < new_pos[:, None]),
        pending=torch.where(frozen[:, None], state.pending, cand[rows, pick]),
        pending_nodrip=torch.where(
            frozen[:, None], state.pending_nodrip,
            (c0e + sub_sums).reshape(B, k, H)[rows, pick].to(state.pending_nodrip.dtype),
        ),
        pending_hidden=torch.where(frozen[:, None], state.pending_hidden, hidden[rows, pick]),
        rope_pos=new_pos,
        step=state.step + m_adv,
        done=done,
        generators=state.generators,
    )
    return new_state, (frames, valid)


def decode_frames_spec(
    cfg: TTSModelConfig,
    params: dict,
    state: SpecState,
    trailing: torch.Tensor,
    trailing_len: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    sp: SamplingParams,
    k: int,
    num_iters: int,
    draft_fn: DraftFn = repeat_draft,
    force_accept: bool = False,
) -> Tuple[SpecState, torch.Tensor, torch.Tensor]:
    """Run ``num_iters`` verify iterations.  Returns (state', frames
    [B, num_iters * k, 16], valid [B, num_iters * k]), all on the device:
    committed frames in per-stream order with valid=True, uncommitted slots
    and post-EOS frames zeroed with valid=False (callers compact per stream
    on the mask; commit counts are data-dependent)."""
    device = state.pending.device
    B = state.pending.shape[0]
    suppress = make_codec_suppress_mask(cfg.talker.codec_vocab_size, device)
    knobs = RowKnobs.build(sp, B, cfg.talker.codec_vocab_size, device)  # once per dispatch
    frames, valid = [], []
    for _ in range(num_iters):
        state, (fr, vd) = _spec_iteration(
            cfg, params, suppress, trailing, trailing_len, tts_pad_embed, sp, knobs, k,
            draft_fn, state, force_accept,
        )
        frames.append(fr)
        valid.append(vd)
    return state, torch.cat(frames, dim=1), torch.cat(valid, dim=1)


def spec_to_seq(
    cfg: TTSModelConfig,
    params: dict,
    state: SpecState,
    trailing: torch.Tensor,
    trailing_len: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    uniform_fill: bool = True,
) -> GenerateState:
    """Convert a SpecState into a sequential GenerateState (the adaptive
    fallback): ONE decode step consumes the pending frame's input, after
    which the sequential loop goes on exactly as if it had produced every
    committed frame itself (greedy continuation equals a sequential decode
    of the same prefix).  With ``uniform_fill`` (the engine at B=1) the
    cache's fill level must be a host int, set by the caller from its copy
    of the step count."""
    drip = compute_drip(state.step - 1, trailing, trailing_len, tts_pad_embed)
    embed = (state.pending_nodrip + drip).to(state.pending_hidden.dtype)
    cache = state.cache if uniform_fill else state.cache._replace(length=state.rope_pos)
    logits, hidden, cache, valid_mask = talker_decode_step(
        cfg.talker, params["talker"], embed, state.rope_pos, cache, state.valid_mask,
        uniform_fill=uniform_fill,
    )
    return GenerateState(
        cache=cache,
        valid_mask=valid_mask,
        last_logits=logits,
        last_hidden=hidden,
        pos=state.rope_pos + 1,
        step=state.step,
        done=state.done,
        generators=state.generators,
    )


class SpecGenerateFns(NamedTuple):
    """Entry points bound to one (model config, batch, bucket, k, iterations)."""

    # (params, text_ids, text_len, generator, sp) -> (state, bundle, frame0, valid0)
    prefill: callable
    # (params, state, trailing, trailing_len, tts_pad_embed, sp) -> (state, frames, valid)
    decode: callable


def make_spec_generate_fns(
    cfg: TTSModelConfig,
    max_len: int,
    k: int = 4,
    num_iters: int = 8,
    batch: int = 1,
    lang_id: Optional[int] = None,
    draft_fn: DraftFn = repeat_draft,
    force_accept: bool = False,
) -> SpecGenerateFns:
    """Speculative prefill / decode callables for ``batch`` streams, the
    shape of the JAX package's ``make_spec_generate_fns``.  A decode call
    runs ``num_iters`` iterations and commits between ``num_iters`` and
    ``num_iters * k`` frames per stream.  ``force_accept`` is the
    measurement probe of :func:`_spec_iteration`."""

    def prefill_fn(params, text_ids, text_len, generator, sp, **segments):
        if text_ids.shape[0] != batch:
            raise ValueError(f"batch {text_ids.shape[0]} != {batch}")
        return init_spec_state(cfg, params, text_ids, text_len, lang_id, max_len, generator, sp,
                               **segments)

    def decode_fn(params, state, trailing, trailing_len, tts_pad_embed, sp):
        return decode_frames_spec(cfg, params, state, trailing, trailing_len, tts_pad_embed, sp,
                                  k, num_iters, draft_fn, force_accept)

    return SpecGenerateFns(prefill=prefill_fn, decode=decode_fn)
