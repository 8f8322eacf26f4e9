"""The talker: 28-layer GQA codec-token LM (prefill + single-step decode).

Port of ``leaxer_qwen3_tts_tpu/models/talker.py``.  The dispatch keeps the
JAX shape: with a packed ``fused_step`` the decode step is kernel K1 at B=1
(:func:`~leaxer_qwen3_tts_torch.ops.fused_step.fused_decode_step`) and kernel
K4 at B >= 2 (:func:`~leaxer_qwen3_tts_torch.ops.fused_step.fused_decode_step_batched`,
per-row positions; past 32 rows as launches of at most 32), and the
speculative verify pass of K candidates per stream is kernel K6
(:func:`~leaxer_qwen3_tts_torch.ops.fused_verify.fused_verify_step`; past 32
rows as launches of whole streams); under a tensor-parallel mesh with a ``fused_tp`` pack a
B=1 step with a uniform fill and no int8 cache is kernel K9 on the first
data row's model ranks
(:func:`~leaxer_qwen3_tts_torch.ops.fused_tp.fused_decode_step_tp`, on the
ranks' kv-head shards of a :class:`~.layers.TPKVCache`, which
:func:`talker_shard_cache` makes from the prefill's cache, or from a spec
fallback's converted one); any other step under a mesh (B > 1, a pool's,
an int8 cache, no pack) is the plain layers', as JAX's gate sends it.  Wherever the
JAX package's predicates send a step or a verify pass to its plain
``transformer_forward`` the port runs its plain layers, on the card as on
the CPU: an unpacked talker (``decode_impl="xla"``, JAX's default, or an
architecture its unit gate refuses), and an int8 cache on a bucket the
kernels' gate refuses (:func:`~leaxer_qwen3_tts_torch.ops.fused_step.kvq_bucket_ok`:
128-aligned for K1 and K4, and past 512 slots a multiple of 512 for K6).
``QTTS_ASSERT_FUSED=1`` makes a packed talker's step that falls to the
plain layers raise, as the JAX package's does; on the card such a fall is
logged once per bucket without it.  The final norm and the
``lm_head`` stay outside the kernels, in plain PyTorch, as the JAX package
left them to XLA.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from ..config import TalkerConfig
from ..ops.fused_step import (
    fused_decode_step,
    fused_decode_step_batched,
    kvq_bucket_ok,
    pack_fused_weights,
    supports,
)
from ..ops.fused_mtp import pack_heads
from ..ops.fused_tp import fused_decode_step_tp
from ..ops.fused_verify import MAX_S, MIN_S, fused_verify_step
from ..ops.quant import dense
from .layers import KVCache, TPKVCache, _normal, init_kv_cache, init_transformer_params, rms_norm, transformer_forward
from ..utils.logging import get_logger

log = get_logger(__name__)


def init_talker_params(cfg: TalkerConfig, gen: torch.Generator, device) -> dict:
    h = cfg.hidden_size
    return {
        "transformer": init_transformer_params(cfg.transformer, gen, device),
        "lm_head": _normal(
            gen, (h, cfg.codec_vocab_size), h ** -0.5, cfg.transformer.torch_dtype, device
        ),
    }


def talker_init_cache(cfg: TalkerConfig, batch: int, max_len: int, device) -> KVCache:
    return init_kv_cache(cfg.transformer, batch, max_len, device)


def talker_shard_cache(cfg: TalkerConfig, talker_params: dict, cache: KVCache, mesh):
    """The prefill's cache as the ranks' kv-head shards (a :class:`TPKVCache`)
    where the mesh's step is kernel K9 (the JAX package's predicate: fused
    decode, a ``fused_tp`` pack, B=1, no int8 cache; the caller's fill is
    uniform), else the cache as it is."""
    if (mesh is None or cfg.decode_impl != "fused" or "fused_tp" not in talker_params
            or cache.k.shape[1] != 1 or cache.quantized):
        return cache
    return TPKVCache.split(cache, mesh.model_devices())


def prepare_fused_talker(cfg: TalkerConfig, talker_params: dict, bits: int = 8) -> dict:
    """Attach the packed K1 weights when the architecture qualifies (bits=8:
    int8 units of quantized params; bits=16: bf16 units of raw params;
    bits=4: int4 units of raw params, before the engine's int4
    ``quantize_params``), and the lm_head K7's epilogue reads
    (:func:`attach_lm_head`)."""
    if not supports(cfg.transformer):
        return talker_params
    out = dict(talker_params)
    out["fused_step"] = pack_fused_weights(
        cfg.transformer, talker_params["transformer"]["layers"], bits=bits
    )
    return attach_lm_head(out)


def attach_lm_head(talker_params: dict) -> dict:
    """The lm_head as kernel K7 reads it (``fused_lm_head``): [Vc, H] rows +
    [Vc] scales, int8 rows of a quantized lm_head, bf16 rows with scales of
    one of a raw one (as the JAX frame kernel casts it).  The engine attaches
    it again after an int4 ``quantize_params``, which leaves the lm_head
    int8, so that it is the lm_head the plain path reads."""
    return dict(talker_params, fused_lm_head=pack_heads(talker_params["lm_head"]))


def talker_prefill(
    cfg: TalkerConfig,
    params: dict,
    prompt_embeds: torch.Tensor,  # [B, P, H]
    prompt_len: torch.Tensor,  # [B] int true lengths
    cache: KVCache,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache, torch.Tensor]:
    """Prompt pass.  Returns (last_logits [B, V] f32, last_hidden [B, H],
    cache, valid_mask [B, T])."""
    B, P, H = prompt_embeds.shape
    device = prompt_embeds.device
    positions = torch.arange(P, device=device)[None, :].expand(B, P)
    query_valid = positions < prompt_len.to(device)[:, None]
    valid_mask = torch.zeros((B, cache.max_len), dtype=torch.bool, device=device)
    hidden, cache, valid_mask = transformer_forward(
        cfg.transformer, params["transformer"], prompt_embeds, positions, cache,
        valid_mask, query_valid=query_valid,
    )
    idx = torch.clamp(prompt_len.to(device) - 1, 0, P - 1)
    last_hidden = hidden[torch.arange(B, device=device), idx]
    last_logits = dense(last_hidden, params["lm_head"])
    return last_logits, last_hidden, cache, valid_mask


def talker_prefill_all_logits(
    cfg: TalkerConfig,
    params: dict,
    prompt_embeds: torch.Tensor,  # [B, P, H]
    prompt_len: torch.Tensor,  # [B] int true lengths
    cache: KVCache,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache, torch.Tensor]:
    """Like :func:`talker_prefill`, with the logits of every prompt position
    (the scoring path, JAX ``talker_prefill_all_logits``).  Returns (logits
    [B, P, V] f32, hidden [B, P, H], cache, valid_mask [B, T])."""
    B, P, H = prompt_embeds.shape
    device = prompt_embeds.device
    positions = torch.arange(P, device=device)[None, :].expand(B, P)
    query_valid = positions < prompt_len.to(device)[:, None]
    valid_mask = torch.zeros((B, cache.max_len), dtype=torch.bool, device=device)
    hidden, cache, valid_mask = transformer_forward(
        cfg.transformer, params["transformer"], prompt_embeds, positions, cache,
        valid_mask, query_valid=query_valid,
    )
    return dense(hidden, params["lm_head"]), hidden, cache, valid_mask


def step_on_kernel(cfg: TalkerConfig, params: dict, cache) -> bool:
    """Whether a decode step runs on the step kernels (K1 at B=1 with a
    uniform fill, else K4) rather than the plain layers: a packed talker,
    and an int8 cache only on a bucket their gate takes (128-aligned, the
    JAX kernels' ``kvq`` gate).  The JAX package also sends 2-32 rows at a
    bucket off its batched window, more than 32 rows and B=1 past
    ``fused_max_cache`` off its 512-slot window to its plain step, which the
    port's kernels take (ROADMAP Queue 3's standing difference)."""
    return (cfg.decode_impl == "fused" and "fused_step" in params
            and (not cache.quantized or kvq_bucket_ok(cache.max_len)))


def _assert_fused(cfg: TalkerConfig, B: int, T: int, kv_q: bool, uniform_fill: bool) -> None:
    """``QTTS_ASSERT_FUSED=1``: a packed talker's step that falls to the
    plain layers raises, with the JAX package's message (its ``fused_ok``:
    the bucket at most ``fused_max_cache`` slots or a multiple of 512)."""
    if os.environ.get("QTTS_ASSERT_FUSED") == "1":
        fused_ok = T <= cfg.fused_max_cache or T % 512 == 0
        raise RuntimeError(
            "QTTS_ASSERT_FUSED: fused decode step ineligible here "
            f"(B={B}, max_len={T}, kv_quant={kv_q}, "
            f"uniform_fill={uniform_fill}, fused_ok={fused_ok}) — "
            "check bucket alignment (kvq needs max_len % 128 == 0; "
            "windowed needs % 512) and batch <= 32"
        )


_FALLS_LOGGED: set = set()


def _log_plain_fall(what: str, T: int, kv_q: bool, on_card: bool) -> None:
    """On the card a packed talker's step or verify pass that falls to the
    plain layers is host-bound (~25,000 ops a frame against one launch), so
    the fall is logged, once per (pass, bucket, cache type): the route is the
    JAX package's, but never silent (``QTTS_ASSERT_FUSED=1`` makes a step
    raise instead)."""
    key = (what, T, kv_q)
    if on_card and key not in _FALLS_LOGGED:
        _FALLS_LOGGED.add(key)
        log.warning(
            "packed talker: the %s at a %d-slot bucket (kv_quant=%s) runs on the plain layers, "
            "as the JAX package's does: the kernels take an int8 cache on 128-aligned buckets "
            "(the verify pass past 512 slots on multiples of 512); QTTS_ASSERT_FUSED=1 makes "
            "the step raise", what, T, kv_q)


def talker_decode_step(
    cfg: TalkerConfig,
    params: dict,
    embed: torch.Tensor,  # [B, H] — the summed next-input embedding
    position: torch.Tensor,  # [B] int RoPE position (and cache slot) of this token
    cache: KVCache,
    valid_mask: torch.Tensor,  # [B, T] bool
    uniform_fill: bool = True,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache, torch.Tensor]:
    """One decode step.  Returns (logits [B, V] f32, hidden [B, H], cache,
    valid_mask).  The cache is updated in place.

    ``uniform_fill`` (every row at one fill level, the engine paths): the
    position is the cache's host fill level ``cache.length``, which the
    kernels take as a host int.  ``uniform_fill=False`` (the continuous
    pool): the rows' positions are the [B] device tensor ``position``, which
    the batched kernel reads on the device.  ``mesh``: the engine's
    tensor-parallel mesh; a :class:`TPKVCache` (:func:`talker_shard_cache`
    made it where the JAX package's predicate routes the step to K9) runs
    K9 on the ranks' shards."""
    B, H = embed.shape
    t = cfg.transformer
    if isinstance(cache, TPKVCache):
        pos = min(cache.length, cache.max_len - 1)
        x_out = fused_decode_step_tp(t, params["fused_tp"], embed, pos, cache.k, cache.v,
                                     mesh)[0]
        hidden = rms_norm(
            x_out, params["transformer"]["final_norm"], t.rms_norm_eps
        ).to(embed.dtype)
        logits = dense(hidden, params["lm_head"])
        valid_mask = valid_mask.clone()
        valid_mask[:, pos] = True
        return logits, hidden, cache._replace(length=cache.length + 1), valid_mask
    T = cache.max_len
    if step_on_kernel(cfg, params, cache):
        if uniform_fill:
            pos = min(int(cache.length), T - 1)
        if B == 1 and uniform_fill:
            x_out = fused_decode_step(t, params["fused_step"], embed, pos, cache.k, cache.v,
                                      *cache.scales)[0]
        else:
            x_out = fused_decode_step_batched(
                t, params["fused_step"], embed, pos if uniform_fill else position,
                cache.k, cache.v, *cache.scales,
            )[0]
        hidden = rms_norm(
            x_out, params["transformer"]["final_norm"], t.rms_norm_eps
        ).to(embed.dtype)
        logits = dense(hidden, params["lm_head"])
        if uniform_fill:
            valid_mask = valid_mask.clone()
            valid_mask[:, pos] = True
        else:
            slots = torch.arange(T, device=embed.device)
            valid_mask = valid_mask | (slots[None, :] == position[:, None])
        return logits, hidden, cache._replace(length=cache.length + 1), valid_mask
    if cfg.decode_impl == "fused" and "fused_step" in params:
        _assert_fused(cfg, B, T, cache.quantized, uniform_fill)
        _log_plain_fall("decode step", T, cache.quantized, embed.is_cuda)
    hidden, cache, valid_mask = transformer_forward(
        t, params["transformer"], embed[:, None, :], position[:, None], cache, valid_mask,
        uniform_fill=uniform_fill,
    )
    hidden = hidden[:, 0]
    return dense(hidden, params["lm_head"]), hidden, cache, valid_mask


def talker_verify_step(
    cfg: TalkerConfig,
    params: dict,
    embeds: torch.Tensor,  # [B, K, H] -- K candidate inputs per stream
    start: torch.Tensor,  # [B] int device tensor: RoPE position and cache slot of candidate 0
    cache: KVCache,
    valid_mask: torch.Tensor,  # [B, T] bool
) -> Tuple[torch.Tensor, torch.Tensor, KVCache, torch.Tensor]:
    """The speculative verify pass: candidate s of stream b at position
    ``start[b] + s``, attending over the cache before ``start[b]`` and the
    new slots of candidates 0..s.  Returns (logits [B, K, V] f32, hidden
    [B, K, H], cache, valid_mask); the cache is updated in place and its
    fill level becomes ``start + K``.

    The final norm and the ``lm_head`` run once per candidate slot on [B, H],
    the shape a sequential step of the same streams gives them, so that each
    row's logits carry the sequential step's bits (a product over more rows
    may round differently)."""
    B, K, H = embeds.shape
    t = cfg.transformer
    T = cache.max_len
    slots = torch.arange(T, device=embeds.device)
    new = (slots[None, :] >= start[:, None]) & (slots[None, :] < start[:, None] + K)
    if (cfg.decode_impl == "fused" and "fused_step" in params and MIN_S <= K <= MAX_S
            and (not cache.quantized or kvq_bucket_ok(T, window=True))):
        x_out = fused_verify_step(t, params["fused_step"], embeds, start, cache.k, cache.v,
                                  *cache.scales)[0]
        fn = params["transformer"]["final_norm"]
        hidden = [rms_norm(x_out[:, s].contiguous(), fn, t.rms_norm_eps).to(embeds.dtype)
                  for s in range(K)]
        valid_mask = valid_mask | new
    else:
        if cfg.decode_impl == "fused" and "fused_step" in params:
            _log_plain_fall("verify pass", T, cache.quantized, embeds.is_cuda)
        positions = start[:, None] + torch.arange(K, device=embeds.device)[None, :]
        h, cache, valid_mask = transformer_forward(
            t, params["transformer"], embeds, positions, cache._replace(length=start), valid_mask,
            uniform_fill=False,
        )
        hidden = [h[:, s] for s in range(K)]
    logits = torch.stack([dense(h, params["lm_head"]) for h in hidden], dim=1)
    return logits, torch.stack(hidden, dim=1), cache._replace(length=start + K), valid_mask
