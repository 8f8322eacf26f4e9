"""Core transformer building blocks on torch tensors (parameter dicts).

Port of ``leaxer_qwen3_tts_tpu/models/layers.py``.  One code path serves
prefill and the unpacked decode step: every forward writes the new K/V into a
preallocated head-major cache at ``cache.length`` and attends over the whole
(masked) cache.  Unlike the JAX reference, which returns new arrays, the
cache tensors are updated IN PLACE.  The uniform fill (every sequence at the
same slot: the engine path) keeps one host integer as the fill level;
``uniform_fill=False`` (the continuous pool, whose slots fill at different
rates) keeps a [B] device tensor and writes each row at its own offset.
An int8 KV cache (``kv_cache_quant``) keeps per-(slot, kv head) float32
scales beside its values (``KVCache.k_scale`` / ``v_scale``, the JAX
package's ``quantize_kv`` grid).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..config import TransformerConfig
from ..ops.attention import attend
from ..ops.quant import dense, index_weight


class KVCache(NamedTuple):
    """Static per-model KV cache, HEAD-MAJOR layout.

    k, v: [num_layers, batch, num_kv_heads, max_len, head_dim]
    length: filled slots -- one host int when the fill is uniform across the
    batch, else a [batch] int64 tensor on the cache's device.
    k_scale, v_scale: None (bf16 / float32 cache), or float32
    [num_layers, batch, num_kv_heads, max_len] when k and v are int8: the
    symmetric scale of each slot's head vector.
    """

    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def scales(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(k_scale, v_scale): the kernels' optional scale arguments."""
        return self.k_scale, self.v_scale

    def grow(self, new_len: int) -> "KVCache":
        """Zero-padded up to ``new_len`` slots (an int8 cache's scales alongside)."""
        pad = new_len - self.max_len
        out = self._replace(k=F.pad(self.k, (0, 0, 0, pad)), v=F.pad(self.v, (0, 0, 0, pad)))
        if self.quantized:
            out = out._replace(k_scale=F.pad(self.k_scale, (0, pad)),
                               v_scale=F.pad(self.v_scale, (0, pad)))
        return out


class TPKVCache(NamedTuple):
    """The talker's KV cache of a tensor-parallel mesh's decode step (kernel
    K9, batch 1): the model ranks' kv-head shards, rank r's
    [num_layers, 1, num_kv_heads / tp, max_len, head_dim] on its device
    holding kv heads r nk / tp .. (r + 1) nk / tp - 1.  Made once from the
    prefill's :class:`KVCache` (:meth:`split`); bf16 / float32 only."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    length: int

    @classmethod
    def split(cls, cache: KVCache, devices) -> "TPKVCache":
        from ..ops.fused_tp import split_heads

        return cls(k=split_heads(cache.k, devices), v=split_heads(cache.v, devices),
                   length=cache.length)

    @property
    def max_len(self) -> int:
        return self.k[0].shape[3]

    def grow(self, new_len: int) -> "TPKVCache":
        """Every rank's shard zero-padded up to ``new_len`` slots."""
        pad = new_len - self.max_len
        return self._replace(k=tuple(F.pad(c, (0, 0, 0, pad)) for c in self.k),
                             v=tuple(F.pad(c, (0, 0, 0, pad)) for c in self.v))


def init_kv_cache(
    cfg: TransformerConfig, batch: int, max_len: int, device: torch.device
) -> KVCache:
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if cfg.kv_cache_quant:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            length=0,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        length=0,
    )


def splice_kv_cache(cache: KVCache, c1: KVCache, slot: int) -> KVCache:
    """Write the 1-stream cache ``c1`` into batch row ``slot`` of ``cache``
    (continuous-pool admission), in place.  ``cache.length`` is the pool's
    [B] tensor; its row takes ``c1``'s fill level.  The scales of an int8
    cache splice alongside."""
    cache.k[:, slot].copy_(c1.k[:, 0])
    cache.v[:, slot].copy_(c1.v[:, 0])
    if cache.quantized:
        cache.k_scale[:, slot].copy_(c1.k_scale[:, 0])
        cache.v_scale[:, slot].copy_(c1.v_scale[:, 0])
    cache.length[slot] = c1.length  # a host int: filled on the device
    return cache


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., d] float -> (int8 [..., d], float32 scale [...]), symmetric per
    vector: scale = max(amax / 127, 1e-8), q = clip(round(x / scale), +-127)
    in float32, rounding half to even (as ``jnp.round``).  Both divisions are
    elementwise by a tensor, so that no device turns them into a product
    with a reciprocal."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, result cast back to the input dtype (Qwen3 style)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Rotary inverse frequencies [head_dim/2] float32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding.  positions: [...]; returns [..., head_dim/2]."""
    freqs = rope_inv_freq(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, rotate-half convention.  x: [B, S, N, D]; cos/sin: [B, S, D/2]."""
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return rotated.to(x.dtype)


def _qkv(cfg: TransformerConfig, p: dict, h: torch.Tensor, dtype: torch.dtype):
    """q/k/v projections; uses the fused wqkv weight when present."""
    if "wqkv" in p:
        qkv = dense(h, p["wqkv"]).to(dtype)
        q = qkv[..., : cfg.q_dim]
        k = qkv[..., cfg.q_dim : cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim :]
        return q, k, v
    return (
        dense(h, p["wq"]).to(dtype),
        dense(h, p["wk"]).to(dtype),
        dense(h, p["wv"]).to(dtype),
    )


def _mlp(cfg: TransformerConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP; uses the fused wgu weight when present."""
    if "wgu" in p:
        gu = dense(h, p["wgu"])
        gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
        act = (F.silu(gate) * up).to(h.dtype)
        return dense(act, p["wd"]).to(h.dtype)
    gate = F.silu(dense(h, p["wg"]))
    up = dense(h, p["wu"])
    return dense((gate * up).to(h.dtype), p["wd"]).to(h.dtype)


def layer_params(layers: dict, i: int) -> dict:
    """Parameters of layer ``i`` from the stacked (leading [L]) layer dict."""
    out = {}
    for k, v in layers.items():
        out[k] = index_weight(v, i)
    return out


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def init_transformer_params(
    cfg: TransformerConfig, gen: torch.Generator, device
) -> dict:
    """Stacked-layer params: every layer leaf has a leading [num_layers] axis."""
    L, h, qd, kvd, I = (
        cfg.num_layers, cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size,
    )
    dt = cfg.torch_dtype

    def dense_init(fan_in, shape):
        return _normal(gen, (L,) + shape, fan_in ** -0.5, dt, device)

    layers = {
        "attn_norm": torch.ones((L, h), dtype=dt, device=device),
        "wq": dense_init(h, (h, qd)),
        "wk": dense_init(h, (h, kvd)),
        "wv": dense_init(h, (h, kvd)),
        "wo": dense_init(qd, (qd, h)),
        "mlp_norm": torch.ones((L, h), dtype=dt, device=device),
        "wg": dense_init(h, (h, I)),
        "wu": dense_init(h, (h, I)),
        "wd": dense_init(I, (I, h)),
    }
    if cfg.use_qk_norm:
        layers["q_norm"] = torch.ones((L, cfg.head_dim), dtype=dt, device=device)
        layers["k_norm"] = torch.ones((L, cfg.head_dim), dtype=dt, device=device)
    return {"layers": layers, "final_norm": torch.ones((h,), dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block(
    cfg: TransformerConfig,
    p: dict,
    x: torch.Tensor,  # [B, S, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_cache: torch.Tensor,  # [B, Nk, T, D] (one layer's view; written in place)
    v_cache: torch.Tensor,
    ks_cache: Optional[torch.Tensor],  # float32 [B, Nk, T] int8 scales, or None
    vs_cache: Optional[torch.Tensor],
    cache_len,  # host int (uniform fill) or [B, S] slot indices (per-row fill)
    attn_mask: torch.Tensor,  # [B, S, T] bool
) -> torch.Tensor:
    B, S, H = x.shape
    nq, nk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, p, h, x.dtype)
    q = q.reshape(B, S, nq, d)
    k = k.reshape(B, S, nk, d)
    v = v.reshape(B, S, nk, d)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if ks_cache is not None:
        # int8 cache: the post-RoPE K/V per (token, head) on the int8 grid
        k, k_sc = quantize_kv(k)  # [B, S, nk, d] int8, [B, S, nk] float32
        v, v_sc = quantize_kv(v)

    if isinstance(cache_len, int):
        k_cache[:, :, cache_len : cache_len + S] = k.transpose(1, 2).to(k_cache.dtype)
        v_cache[:, :, cache_len : cache_len + S] = v.transpose(1, 2).to(v_cache.dtype)
        if ks_cache is not None:
            ks_cache[:, :, cache_len : cache_len + S] = k_sc.transpose(1, 2)
            vs_cache[:, :, cache_len : cache_len + S] = v_sc.transpose(1, 2)
    else:
        rows = torch.arange(B, device=x.device)[:, None]
        k_cache[rows, :, cache_len] = k.to(k_cache.dtype)  # [B, S, nk, d]
        v_cache[rows, :, cache_len] = v.to(v_cache.dtype)
        if ks_cache is not None:
            ks_cache[rows, :, cache_len] = k_sc  # [B, S, nk]
            vs_cache[rows, :, cache_len] = v_sc

    out = attend(q, k_cache, v_cache, attn_mask, impl=cfg.attn_impl,
                 k_scale=ks_cache, v_scale=vs_cache).reshape(B, S, nq * d)
    x = x + dense(out, p["wo"]).to(x.dtype)
    h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp(cfg, p, h)


def transformer_forward(
    cfg: TransformerConfig,
    params: dict,
    embeds: torch.Tensor,  # [B, S, H]
    positions: torch.Tensor,  # [B, S] int — RoPE positions per sequence
    cache: KVCache,
    valid_mask: torch.Tensor,  # [B, T] bool — cache slots that hold real tokens
    query_valid: Optional[torch.Tensor] = None,  # [B, S] bool — real (non-pad) queries
    uniform_fill: bool = True,
) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Unified prefill/decode forward.

    Writes S new tokens at cache slots [length[b], length[b]+S) (in place)
    and lets query i attend to slot t iff ``valid_mask[b, t]`` and
    t <= length[b]+i.  ``uniform_fill=True`` (engine paths: every row in
    lockstep) takes ``cache.length`` as one host int; ``uniform_fill=False``
    (the continuous pool) as a [B] device tensor, and clamps each row's write
    into the cache as the JAX package's dynamic_update_slice does (an idle
    slot keeps stepping).  Returns post-final-norm hidden states [B, S, H],
    the cache with its length advanced by S, and the updated validity mask.
    """
    B, S, H = embeds.shape
    T = cache.max_len
    length = cache.length
    device = embeds.device
    if uniform_fill and length + S > T:
        raise ValueError(f"cache overflow: {length} + {S} > {T} slots")

    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    slot_ids = torch.arange(T, device=device)
    steps = torch.arange(S, device=device)
    if query_valid is None:
        query_valid = torch.ones((B, S), dtype=torch.bool, device=device)
    len_col = length if uniform_fill else length.to(device)[:, None]  # int | [B, 1]
    new_slots = (slot_ids >= len_col) & (slot_ids < len_col + S)  # [T] | [B, T]
    write_idx = torch.clamp(slot_ids - len_col, 0, S - 1)  # [T] | [B, T]
    written_valid = torch.gather(query_valid, 1, torch.broadcast_to(write_idx, (B, T)))
    valid_mask = torch.where(new_slots, written_valid, valid_mask)

    global_q = len_col + steps  # [S] | [B, S]
    causal = slot_ids <= global_q[..., None]  # [S, T] | [B, S, T]
    attn_mask = causal & valid_mask[:, None, :]
    # where each row writes: slots [start, start + S), start clamped into the cache
    write_at = length if uniform_fill else torch.clamp(len_col, 0, T - S) + steps

    x = embeds
    layers = params["layers"]
    q8 = cache.quantized
    for i in range(cfg.num_layers):
        x = _block(
            cfg, layer_params(layers, i), x, cos, sin, cache.k[i], cache.v[i],
            cache.k_scale[i] if q8 else None, cache.v_scale[i] if q8 else None,
            write_at, attn_mask,
        )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, cache._replace(length=length + S), valid_mask


def transformer_forward_nocache(
    cfg: TransformerConfig,
    params: dict,
    embeds: torch.Tensor,  # [B, S, H]
    positions: Optional[torch.Tensor] = None,  # [B, S] int (default: 0..S-1)
    valid: Optional[torch.Tensor] = None,  # [B, S] bool
) -> torch.Tensor:
    """Plain causal forward without a cache (the training and scoring path):
    query i attends to key t iff t <= i and ``valid[b, t]``.  Differentiable
    with respect to the stacked layer leaves (separate or fused projections).
    Returns post-final-norm hidden states [B, S, H]."""
    B, S, H = embeds.shape
    device = embeds.device
    if positions is None:
        positions = torch.arange(S, device=device).expand(B, S)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    ids = torch.arange(S, device=device)
    attn_mask = (ids[None, :] <= ids[:, None]).expand(B, S, S)
    if valid is not None:
        attn_mask = attn_mask & valid[:, None, :]
    nq, nk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    x = embeds
    layers = params["layers"]
    for i in range(cfg.num_layers):
        p = layer_params(layers, i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, p, h, x.dtype)
        q = q.reshape(B, S, nq, d)
        k = k.reshape(B, S, nk, d)
        v = v.reshape(B, S, nk, d)
        if cfg.use_qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = attend(q, k.transpose(1, 2), v.transpose(1, 2), attn_mask, impl=cfg.attn_impl)
        x = x + dense(out.reshape(B, S, nq * d), p["wo"]).to(x.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
