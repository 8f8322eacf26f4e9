"""Kernels K1 and K4: the fused single-token transformer step, for one
stream (K1) and for a batch of streams at their own positions (K4: up to 32
rows a launch; a call of more runs as launches of nearly equal size).

Port of ``leaxer_qwen3_tts_tpu/ops/fused_step.py::fused_decode_step`` and
``fused_decode_step_batched``.  One call runs one token per stream through
all L layers: RMSNorm, the int8 qkv product, per-head QK-norm, rotate-half
RoPE at the stream's position, the K/V write there, GQA attention over slots
0..pos, wo plus the residual, RMSNorm, gate/up, silu(gate)*up and down plus
the residual.  The residual stream stays float32 across layers and the
result is the PRE-final-norm hidden state.  K4 reads each weight row once
for the whole batch, and its row b is K1's arithmetic on that row.

Unlike the JAX kernel, which returns new arrays, the caches are updated IN
PLACE (and returned for the same call shape).

An int8 KV cache (the JAX kernels' ``kvq`` mode) comes with float32 scales
``k_scale`` / ``v_scale`` [L, B, nk, T], one per (slot, kv head): the new
slot is quantized as ``models.layers.quantize_kv`` quantizes it (per head
vector, after QK-norm and RoPE for k), the scores are multiplied by the
slots' k scales after the 1/sqrt(d) factor, and the softmax weights by the
slots' v scales before the weights.V product (the normaliser sums the
weights without them).  The scales are updated in place too, and returned
after the caches, as the JAX wrappers return them.  The card takes JAX's
bucket gates for such a cache (:func:`kvq_bucket_ok`) and raises elsewhere.

On a CUDA tensor :func:`fused_decode_step` launches the hand-written kernel
(``csrc/fused_step.cu``: the whole step in one persistent cooperative launch,
its weights streamed through a TMA ring by the plan of ``ops/persistent.py``)
and :func:`fused_decode_step_batched` its batched twin
(``csrc/fused_step_batched.cu``: the same transport for B rows, one
cooperative launch per step); on a CPU tensor they run
:func:`fused_decode_step_reference` / :func:`fused_decode_step_batched_reference`,
the plain PyTorch versions of the same functions (bf16-rounded operands
upcast to float32 before each product, which equals a bf16 dot with float32
accumulation).

The pack is Hopper's own layout: every matrix stored [N, K] (one output row
with its K values contiguous) so the kernel streams 16-byte loads along K.
Its units are int8 (``bits=8``: the dequantized values equal
``ops.quant.quantize_weight``'s, and so the JAX package's unit pack's), bf16
with scales of one (``bits=16``, the unquantized config: the JAX package's
bits=16 pack, the raw weights cast to bf16) or int4 (``bits=4``: rows of K/2
bytes, byte j holding columns 2j (low nibble) and 2j + 1 (high), two's
complement, with float32 scales [N, K/128], one per 128-column group: the
integers and scales of ``ops.quant.quantize_weight_int4``'s group-128 grid,
and so of the JAX package's bits=4 unit pack).  The int4 rows are stored as
``torch.uint8``, a dtype of their own, so that no gate takes them for int8
units.  K1 and its plain version take all three; an int4 product sums each
128-column group apart and applies the group's scale after its dot (JAX's
``_make_matmul``).
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import TransformerConfig
from ..models.layers import quantize_kv, rope_inv_freq
from . import persistent
from ._build import MAX_BATCH
from .quant import QuantizedLinear, QuantizedLinear4, quantize_int4_values, quantize_weight


class FusedStepWeights(NamedTuple):
    """Per-layer-stacked weight units of one transformer, Hopper layout:
    int8 with per-row scales, bf16 with scales of one, or int4 (uint8 rows
    of K/2 bytes) with per-(row, 128-column group) scales [L, N, K/128]."""

    wqkv: torch.Tensor  # int8 or bf16 [L, A, H], A = q_dim + 2 * kv_dim; uint8 [L, A, H/2]
    sqkv: torch.Tensor  # f32 [L, A] per-output-column scale; [L, A, H/128] at int4
    wo: torch.Tensor  # [L, H, q_dim]
    so: torch.Tensor  # f32 [L, H]
    wgu: torch.Tensor  # [L, 2I, H]
    sgu: torch.Tensor  # f32 [L, 2I]
    wd: torch.Tensor  # [L, H, I]
    sd: torch.Tensor  # f32 [L, H]
    attn_norm: torch.Tensor  # f32 [L, H]
    mlp_norm: torch.Tensor  # f32 [L, H]
    q_norm: torch.Tensor  # f32 [L, d]
    k_norm: torch.Tensor  # f32 [L, d]
    inv_freq: torch.Tensor  # f32 [d/2] rotary inverse frequencies


UNIT_DTYPES = {4: torch.uint8, 8: torch.int8, 16: torch.bfloat16}  # bits -> the units' dtype
UNIT_BITS = {dt: bits for bits, dt in UNIT_DTYPES.items()}
UNIT_NAMES = {torch.uint8: "int4", torch.int8: "int8", torch.bfloat16: "bf16"}
INT4_COLS = 128  # columns per int4 scale group (ops.quant.INT4_GROUP)
WINDOW = 512  # the JAX talker step's long-form cache window


def meta_pack(cfg: TransformerConfig, bits: int = 8) -> FusedStepWeights:
    """A ``bits`` pack (4: int4 units, 8: int8, 16: bf16) of ``cfg``'s
    shapes on the meta device (nothing allocated): what the gates that read
    a pack's sizes and unit type need."""
    L, H, A = cfg.num_layers, cfg.hidden_size, cfg.q_dim + 2 * cfg.kv_dim
    I, qd, d = cfg.intermediate_size, cfg.q_dim, cfg.head_dim

    def m(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def rows(N, K):  # a product's units and scales
        if bits == 4:
            return m((L, N, K // 2), torch.uint8), m((L, N, K // INT4_COLS))
        return m((L, N, K), UNIT_DTYPES[bits]), m((L, N))

    (wqkv, sqkv), (wo, so), (wgu, sgu), (wd, sd) = (
        rows(A, H), rows(H, qd), rows(2 * I, H), rows(H, I))
    return FusedStepWeights(
        wqkv=wqkv, sqkv=sqkv, wo=wo, so=so, wgu=wgu, sgu=sgu, wd=wd, sd=sd,
        attn_norm=m((L, H)), mlp_norm=m((L, H)), q_norm=m((L, d)), k_norm=m((L, d)),
        inv_freq=m((d // 2,)),
    )


def unit_gate(cfg: TransformerConfig) -> bool:
    """The JAX package's gate of its fused step (``ops/fused_step.py::
    supports``): hidden size, qkv width and 2 x intermediate size multiples
    of its 1024-wide units, q_dim and the intermediate size multiples of the
    hidden size.  Where it fails, the JAX package packs nothing and decodes
    on its plain layers, and so does the port."""
    H = cfg.hidden_size
    A = cfg.q_dim + 2 * cfg.kv_dim
    return (
        H % 1024 == 0
        and A % 1024 == 0
        and cfg.q_dim % H == 0
        and (2 * cfg.intermediate_size) % 1024 == 0
        and cfg.intermediate_size % H == 0
    )


def supports(cfg: TransformerConfig) -> bool:
    """Architectures the packed path takes: :func:`unit_gate` plus what the
    CUDA attention items need (head_dim 128, at most 8 q heads per kv head,
    QK-norm).  An architecture that passes the first and not the rest is one
    the JAX package decodes fused and the card refuses (ROADMAP item K1a)."""
    return (
        unit_gate(cfg)
        and cfg.head_dim == 128
        and cfg.num_heads % cfg.num_kv_heads == 0
        and cfg.num_heads // cfg.num_kv_heads <= 8
        and cfg.use_qk_norm
    )


def _rows(w: QuantizedLinear) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, K, N] int8 + [L, 1, N] scale -> [L, N, K] rows + [L, N]."""
    return w.q.transpose(1, 2).contiguous(), w.scale[:, 0, :].float().contiguous()


def _rows4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw [L, K, N] -> int4 rows [L, N, K/2] uint8 (byte j: columns 2j low,
    2j + 1 high) + scales [L, N, K/128], on ``quantize_weight_int4``'s grid
    (whose groups and columns the JAX unit slices keep, so each unit of the
    JAX bits=4 pack holds the same integers and scales)."""
    q, scale = quantize_int4_values(w)
    if q.shape[-2] // scale.shape[-2] != INT4_COLS:
        raise ValueError(f"int4 rows need K a multiple of {2 * INT4_COLS}")
    r = q.transpose(1, 2)  # [L, N, K]
    packed = (r[..., 0::2] & 0xF) | ((r[..., 1::2] & 0xF) << 4)
    return packed.to(torch.uint8).contiguous(), scale.transpose(1, 2).float().contiguous()


def unpack_rows4(w: torch.Tensor) -> torch.Tensor:
    """int4 rows [..., N, K/2] uint8 -> int32 values [..., N, K] in [-8, 7]."""
    b = w.to(torch.int32)
    lo, hi = ((b & 0xF) ^ 8) - 8, ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*w.shape[:-1], 2 * w.shape[-1])


def pack_fused_weights(
    cfg: TransformerConfig, layer_params: dict, bits: int = 8
) -> FusedStepWeights:
    """Pack stacked layer params into the kernel layout.  bits=8: fused /
    quantized by ``ops.quant`` or raw arrays, quantized here on the same
    grid.  bits=16 (the unquantized config): raw arrays only, cast to bf16
    units with scales of one, as the JAX package's bits=16 pack.  bits=4:
    raw arrays only, quantized on the group-128 int4 grid (pack before
    ``quantize_params``, as the JAX engine does)."""
    if bits not in UNIT_DTYPES:
        raise ValueError(f"bits must be 4, 8 or 16, got {bits}")
    if not supports(cfg):
        raise ValueError("the fused step kernel does not take this architecture")

    def as_quant(w):
        if isinstance(w, (QuantizedLinear, QuantizedLinear4)):
            if bits != 8 or isinstance(w, QuantizedLinear4):
                raise ValueError(f"bits={bits} packing needs raw weights (pack before "
                                 "quantize_params in the engine)")
            return w
        if bits == 16:
            ones = torch.ones(w.shape[:-2] + (1, w.shape[-1]), dtype=torch.float32,
                              device=w.device)
            return QuantizedLinear(w.to(torch.bfloat16), ones)
        return quantize_weight(w)

    p = layer_params
    mats = [p["wqkv"] if "wqkv" in p else torch.cat([p["wq"], p["wk"], p["wv"]], -1), p["wo"],
            p["wgu"] if "wgu" in p else torch.cat([p["wg"], p["wu"]], -1), p["wd"]]
    if bits == 4:
        if any(isinstance(w, (QuantizedLinear, QuantizedLinear4)) for w in mats):
            raise ValueError("bits=4 packing needs raw weights (pack before quantize_params in "
                             "the engine)")
        packed = [_rows4(w) for w in mats]
    else:
        packed = [_rows(as_quant(w)) for w in mats]
    (wqkv_r, sqkv), (wo_r, so), (wgu_r, sgu), (wd_r, sd) = packed
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, wqkv_r.device)
    return FusedStepWeights(
        wqkv=wqkv_r, sqkv=sqkv, wo=wo_r, so=so, wgu=wgu_r, sgu=sgu, wd=wd_r, sd=sd,
        attn_norm=p["attn_norm"].float().contiguous(),
        mlp_norm=p["mlp_norm"].float().contiguous(),
        q_norm=p["q_norm"].float().contiguous(),
        k_norm=p["k_norm"].float().contiguous(),
        inv_freq=inv_freq,
    )


def attn_scale(head_dim: int) -> float:
    """1/sqrt(head_dim) as the reference kernel rounds it (float64, then float32)."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=torch.float32))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _gemv(h: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[1, K] f32 @ rows [N, K] int8 -> [1, N] f32: bf16 lhs, scale after the
    dot; int4 rows [N, K/2] with scales [N, K/128]: one dot per 128-column
    group, each group's scale after its dot, the groups summed in order."""
    if w.dtype == torch.uint8:
        B, K = h.shape
        N, G = s.shape
        part = torch.einsum("bgk,ngk->bgn", _bf16(h).reshape(B, G, K // G),
                            unpack_rows4(w).float().reshape(N, G, K // G))
        return (part * s.t()).sum(dim=1)
    return torch.matmul(_bf16(h), w.float().t()) * s


def _gemv_rows(h: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[B, K] -> [B, N], one :func:`_gemv` per row: the B=1 product's exact
    values (a [B, K] matmul may take another summation order per batch size,
    and a last-bit difference flips the bf16 rounding of the next input)."""
    return torch.cat([_gemv(h[b : b + 1], w, s) for b in range(h.shape[0])])


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _store_slot(caches, where, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write the new k and v at ``where`` (an index of one layer's [B, nk,
    T] slots) of ``caches`` = (k_cache, v_cache, k_scale, v_scale), rounded
    to the cache dtype, or onto the int8 grid with their scales."""
    k_cache, v_cache, k_scale, v_scale = caches
    if k_scale is not None:
        k, k_scale[where] = quantize_kv(k)
        v, v_scale[where] = quantize_kv(v)
    k_cache[where] = k.to(k_cache.dtype)
    v_cache[where] = v.to(v_cache.dtype)


def _attend_slots(q, caches, b: int, end: int, scale: float) -> torch.Tensor:
    """Row b's attention of q [nk, g, d] over its slots 0..end-1 of one
    layer's ``caches`` (k, v and, int8, their scales)."""
    kc, vc, ks, vs = caches
    K, V = kc[b, :, :end].float(), vc[b, :, :end].float()  # [nk, end, d]
    scores = torch.einsum("ngd,ntd->ngt", q, K) * scale
    if ks is not None:
        scores = scores * ks[b, :, None, :end]
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    if vs is not None:
        w = w * vs[b, :, None, :end]
    return torch.einsum("ngt,ntd->ngd", w, V)


def _layer_caches(l: int, k_cache, v_cache, k_scale, v_scale) -> tuple:
    """Layer l's (k, v, k scale, v scale) views (scales None unless int8)."""
    if k_scale is None:
        return k_cache[l], v_cache[l], None, None
    return k_cache[l], v_cache[l], k_scale[l], v_scale[l]


def _with_scales(out: tuple, k_scale, v_scale) -> tuple:
    """A wrapper's result: the scales follow the caches when given."""
    return out if k_scale is None else out + (k_scale, v_scale)


def fused_decode_step_reference(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    x: torch.Tensor,  # [1, H]
    pos: int,
    k_cache: torch.Tensor,  # [L, 1, nk, T, d], updated in place
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # float32 [L, 1, nk, T] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> tuple:
    """Plain PyTorch version of the kernel; same contract."""
    nq, nk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = nq // nk
    qd, kvd, I = cfg.q_dim, cfg.kv_dim, cfg.intermediate_size
    eps = cfg.rms_norm_eps
    scale = attn_scale(d)
    angles = torch.tensor(float(pos), dtype=torch.float32, device=x.device) * fw.inv_freq
    cos, sin = torch.cos(angles)[None, :], torch.sin(angles)[None, :]
    x = x.float()
    for l in range(fw.wqkv.shape[0]):
        h = _rms(x, fw.attn_norm[l], eps)
        qkv = _gemv(h, fw.wqkv[l], fw.sqkv[l])[0]
        q = _rms(qkv[:qd].reshape(nq, d), fw.q_norm[l], eps)
        k = _rms(qkv[qd : qd + kvd].reshape(nk, d), fw.k_norm[l], eps)
        v = qkv[qd + kvd :].reshape(nk, d)
        q = _rope(q, cos, sin)
        k = _rope(k, cos, sin)
        caches = _layer_caches(l, k_cache, v_cache, k_scale, v_scale)
        _store_slot(caches, (0, slice(None), pos), k, v)
        attn = _attend_slots(q.reshape(nk, g, d), caches, 0, pos + 1, scale).reshape(1, qd)
        x = x + _gemv(attn, fw.wo[l], fw.so[l])
        h = _rms(x, fw.mlp_norm[l], eps)
        gu = _gemv(h, fw.wgu[l], fw.sgu[l])
        gate, up = gu[:, :I], gu[:, I:]
        act = gate * (1.0 / (1.0 + torch.exp(-gate))) * up
        x = x + _gemv(act, fw.wd[l], fw.sd[l])
    return _with_scales((x, k_cache, v_cache), k_scale, v_scale)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def unit_bits(fw: FusedStepWeights) -> int:
    """Bits per weight of the pack's units: 4, 8 or 16."""
    return UNIT_BITS[fw.wqkv.dtype]


def unit_bytes(fw: FusedStepWeights) -> float:
    """Bytes per weight of the pack's units: 0.5 (int4), 1 (int8) or 2 (bf16)."""
    return unit_bits(fw) / 8


def kvq_bucket_ok(T: int, window: bool = False) -> bool:
    """The JAX kernels' bucket gates for an int8 KV cache: 128-aligned (the
    scale rows' slot windows: K1 and K4), and with ``window`` (K6 and K7)
    beyond 512 slots a multiple of the 512-slot window."""
    return T % 128 == 0 and (not window or T <= 512 or T % WINDOW == 0)


def _check_cuda_inputs(fw: FusedStepWeights, k_cache, v_cache, bf16_units: bool = False,
                       k_scale=None, v_scale=None, window: bool = False,
                       int4_units: bool = False) -> None:
    """The checks every kernel wrapper makes; ``bf16_units``: the kernel
    takes bf16 packs besides int8 (K1, K3, K4, K5, K6); ``int4_units``: int4
    packs too (K1-K6; the launch-per-op entries take int8 only).  An int8 cache comes with its float32 scales and
    meets :func:`kvq_bucket_ok` (``window``: K6's and K7's gate)."""
    if k_cache.dtype not in (torch.bfloat16, torch.float32, torch.int8) or (
            v_cache.dtype != k_cache.dtype):
        raise NotImplementedError(f"KV cache dtype {k_cache.dtype}: the kernels take bfloat16, "
                                  "float32 and int8 caches")
    scales = [t for t in (k_scale, v_scale) if t is not None]
    if (k_cache.dtype == torch.int8) != (len(scales) == 2) or len(scales) == 1:
        raise ValueError("an int8 KV cache needs its k and v scales, and only an int8 one")
    if scales:
        if any(t.dtype != torch.float32 or t.shape != k_cache.shape[:-1] for t in scales):
            raise ValueError(f"int8 KV scales must be float32 {tuple(k_cache.shape[:-1])}")
        T = k_cache.shape[3]
        if not kvq_bucket_ok(T, window):
            raise ValueError(
                f"int8 KV fused decode needs the bucket ({T}) 128-aligned"
                + (" (and beyond 512 slots a multiple of 512)" if window else "")
                + "; the engine rounds its top bucket so")
    units = (torch.int8,) + ((torch.bfloat16,) if bf16_units else ()) + (
        (torch.uint8,) if int4_units else ())
    if fw.wqkv.dtype not in units or any(w.dtype != fw.wqkv.dtype for w in (fw.wo, fw.wgu, fw.wd)):
        raise NotImplementedError(
            f"{UNIT_NAMES.get(fw.wqkv.dtype, fw.wqkv.dtype)} units: this kernel takes "
            f"{' and '.join(UNIT_NAMES[u] for u in units)} packs (bf16 units in K2: ROADMAP item "
            "K1v-b / K2v)"
        )
    want = (fw.wqkv.shape[0], fw.wqkv.shape[1]) + ((fw.wqkv.shape[2] // (INT4_COLS // 2),)
                                                   if fw.wqkv.dtype == torch.uint8 else ())
    if fw.sqkv.shape != want:
        raise ValueError(f"scales {tuple(fw.sqkv.shape)} for {names_of(fw)} units: want {want}")
    for t in (*fw, k_cache, v_cache, *scales):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("fused_decode_step: every tensor must be contiguous and on CUDA")
    # the persistent kernels' bulk copies move 16-byte-aligned runs of rows
    # and scales out of every pack tensor
    if any(t.data_ptr() % 16 for t in fw):
        raise ValueError("fused_decode_step: the pack's tensors must be 16-byte aligned")


# the units' type code of QttsStepWeights.unit (csrc/qtts_kernels.cuh)
UNIT_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.uint8: 2}


def names_of(fw: FusedStepWeights) -> str:
    """The pack's unit type, as the errors name it."""
    return UNIT_NAMES[fw.wqkv.dtype]


def scale_ptrs(k_scale, v_scale) -> tuple:
    """The entries' scale pointers: an int8 cache's scales, else null."""
    return (None, None) if k_scale is None else (k_scale.data_ptr(), v_scale.data_ptr())


def _weights_struct(cfg: TransformerConfig, fw: FusedStepWeights):
    from ._build import StepWeights

    return StepWeights(
        fw.wqkv.data_ptr(), fw.sqkv.data_ptr(), fw.wo.data_ptr(), fw.so.data_ptr(),
        fw.wgu.data_ptr(), fw.sgu.data_ptr(), fw.wd.data_ptr(), fw.sd.data_ptr(),
        fw.attn_norm.data_ptr(), fw.mlp_norm.data_ptr(), fw.q_norm.data_ptr(),
        fw.k_norm.data_ptr(), fw.inv_freq.data_ptr(),
        fw.wqkv.shape[0], cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.intermediate_size, cfg.rms_norm_eps, attn_scale(cfg.head_dim),
        UNIT_TYPES[fw.wqkv.dtype],
    )


def step_structs(cfg: TransformerConfig, fw: FusedStepWeights, T: int, device):
    """ctypes argument structs of one decode step, with the scratch tensors
    they point to (kept alive by the caller for the launch)."""
    from ._build import StepScratch, load_kernels

    nq, d, I = cfg.num_heads, cfg.head_dim, cfg.intermediate_size
    chunk = load_kernels().qtts_attn_chunk()
    max_splits = (T + chunk - 1) // chunk
    A = cfg.q_dim + 2 * cfg.kv_dim
    scratch = torch.empty(A + cfg.q_dim + 2 * I + nq * max_splits * (d + 2),
                          dtype=torch.float32, device=device)
    qkv, attn, gu, part = torch.split(scratch, [A, cfg.q_dim, 2 * I, nq * max_splits * (d + 2)])
    s = StepScratch(qkv.data_ptr(), attn.data_ptr(), gu.data_ptr(), part.data_ptr(), max_splits)
    return _weights_struct(cfg, fw), s, scratch


class _StepEntry:
    """The argument structs, scratch and plan of one (pack, cache bucket) on
    one stream of one thread: built once, reused by every step there (two
    threads, such as a pool's admissions, never share one)."""

    def __init__(self, cfg: TransformerConfig, fw: FusedStepWeights, T: int, device):
        self.w, self.s, self.scratch = step_structs(cfg, fw, T, device)
        self.plan = persistent.device_plan(cfg, device, unit_bytes=unit_bytes(fw))


_STEP_ENTRIES: "OrderedDict[tuple, _StepEntry]" = OrderedDict()
_MAX_ENTRIES = 16


def _step_entry(cfg: TransformerConfig, fw: FusedStepWeights, T: int, device) -> _StepEntry:
    """The cached entry of this pack: keyed by every pointer the structs
    hold, so a hit is the struct these tensors would build."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (cfg, T, device, stream, threading.get_ident(), fw.wqkv.dtype,
           *(t.data_ptr() for t in fw))
    entry = _STEP_ENTRIES.get(key)
    if entry is None:
        entry = _StepEntry(cfg, fw, T, device)
        _STEP_ENTRIES[key] = entry
        while len(_STEP_ENTRIES) > _MAX_ENTRIES:
            _STEP_ENTRIES.popitem(last=False)
    return entry


def fused_decode_step(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    x: torch.Tensor,  # [1, H]
    pos: int,
    k_cache: torch.Tensor,  # [L, 1, nk, T, d]
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # float32 [L, 1, nk, T] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> tuple:
    """One fused decode step over all layers.

    Returns (x_out [1, H] float32 pre-final-norm, k_cache, v_cache[,
    k_scale, v_scale]); the caches (and scales) are updated in place.
    ``pos`` is clamped to the last slot like the reference."""
    T = k_cache.shape[3]
    pos = min(int(pos), T - 1)
    if x.device.type == "cpu":
        return fused_decode_step_reference(cfg, fw, x, pos, k_cache, v_cache, k_scale, v_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_step: unsupported device {x.device}")
    _check_cuda_inputs(fw, k_cache, v_cache, True, k_scale, v_scale, int4_units=True)
    from ._build import check, load_kernels

    lib = load_kernels()
    entry = _step_entry(cfg, fw, T, x.device)
    x_in = x.float().reshape(-1).contiguous()
    x_out = torch.empty((1, cfg.hidden_size), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fused_decode_step.launches += 1
    err = lib.qtts_decode_step(
        entry.w, entry.s, entry.plan.struct, x_in.data_ptr(), x_out.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), *scale_ptrs(k_scale, v_scale),
        int(k_cache.dtype == torch.bfloat16), T, pos, stream,
    )
    check(err, "fused_decode_step")
    return _with_scales((x_out, k_cache, v_cache), k_scale, v_scale)


fused_decode_step.launches = 0  # kernel launches, for chip_smoke.py's path check


# ---------------------------------------------------------------------------
# Kernel K4: the batched step
# ---------------------------------------------------------------------------


def _row_positions(pos, B: int, T: int, device) -> torch.Tensor:
    """[B] int64 positions, clamped to the last slot like the JAX wrapper."""
    if isinstance(pos, torch.Tensor):
        return torch.clamp(pos.to(device=device, dtype=torch.long).reshape(B), 0, T - 1)
    return torch.full((B,), min(int(pos), T - 1), dtype=torch.long, device=device)


def fused_decode_step_batched_reference(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    x: torch.Tensor,  # [B, H]
    pos,  # [B] int tensor, or one int for every row
    k_cache: torch.Tensor,  # [L, B, nk, T, d], updated in place
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # float32 [L, B, nk, T] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> tuple:
    """Plain PyTorch version of kernel K4; same contract.  Row b is the B=1
    plain step on row b (its products and its attention row by row)."""
    B = x.shape[0]
    nq, nk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = nq // nk
    qd, kvd, I = cfg.q_dim, cfg.kv_dim, cfg.intermediate_size
    eps = cfg.rms_norm_eps
    scale = attn_scale(d)
    T = k_cache.shape[3]
    device = x.device
    pos = _row_positions(pos, B, T, device)
    angles = pos.float()[:, None] * fw.inv_freq[None, :]  # [B, d/2]
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    rows = torch.arange(B, device=device)
    ends = [p + 1 for p in pos.tolist()]  # each row attends over its slots 0..pos
    x = x.float()
    for l in range(fw.wqkv.shape[0]):
        h = _rms(x, fw.attn_norm[l], eps)
        qkv = _gemv_rows(h, fw.wqkv[l], fw.sqkv[l])
        q = _rms(qkv[:, :qd].reshape(B, nq, d), fw.q_norm[l], eps)
        k = _rms(qkv[:, qd : qd + kvd].reshape(B, nk, d), fw.k_norm[l], eps)
        v = qkv[:, qd + kvd :].reshape(B, nk, d)
        q = _rope(q, cos, sin)
        k = _rope(k, cos, sin)
        caches = _layer_caches(l, k_cache, v_cache, k_scale, v_scale)
        _store_slot(caches, (rows, slice(None), pos), k, v)
        attn = [_attend_slots(q[b].reshape(nk, g, d), caches, b, end, scale).reshape(qd)
                for b, end in enumerate(ends)]  # B=1's attention, row by row
        x = x + _gemv_rows(torch.stack(attn), fw.wo[l], fw.so[l])
        h = _rms(x, fw.mlp_norm[l], eps)
        gu = _gemv_rows(h, fw.wgu[l], fw.sgu[l])
        gate, up = gu[:, :I], gu[:, I:]
        act = gate * (1.0 / (1.0 + torch.exp(-gate))) * up
        x = x + _gemv_rows(act, fw.wd[l], fw.sd[l])
    return _with_scales((x, k_cache, v_cache), k_scale, v_scale)


def batch_structs(cfg: TransformerConfig, fw: FusedStepWeights, B: int, T: int, device):
    """ctypes argument structs of one batched step, with the scratch tensors
    they point to (kept alive by the caller for the launch)."""
    from ._build import BatchScratch, load_kernels

    nq, d, I, H = cfg.num_heads, cfg.head_dim, cfg.intermediate_size, cfg.hidden_size
    chunk = load_kernels().qtts_attn_chunk()
    max_splits = (T + chunk - 1) // chunk
    A = cfg.q_dim + 2 * cfg.kv_dim
    sizes = [B * A, B * 2 * I, B * nq * max_splits * (d + 2), B * cfg.q_dim]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    qkv, gu, part, attn = torch.split(scratch, sizes)
    # the next GEMV's bf16 input; the persistent K4 and K5 keep the down
    # projection's there in rows of I rounded up to 512
    hb = torch.empty(B * -(-max(H, cfg.q_dim, I) // 512) * 512, dtype=torch.bfloat16,
                     device=device)
    s = BatchScratch(qkv.data_ptr(), gu.data_ptr(), part.data_ptr(), hb.data_ptr(), max_splits,
                     attn.data_ptr())
    return _weights_struct(cfg, fw), s, (scratch, hb)


class _BatchEntry:
    """The argument structs, scratch and plan of one (pack, B, cache bucket)
    on one stream of one thread, for the persistent K4 (as _StepEntry)."""

    def __init__(self, cfg: TransformerConfig, fw: FusedStepWeights, B: int, T: int, device):
        self.w, self.s, self.scratch = batch_structs(cfg, fw, B, T, device)
        self.plan = persistent.device_plan(cfg, device, batch=B, unit_bytes=unit_bytes(fw))


_BATCH_ENTRIES: "OrderedDict[tuple, _BatchEntry]" = OrderedDict()


def _batch_entry(cfg: TransformerConfig, fw: FusedStepWeights, B: int, T: int,
                 device) -> _BatchEntry:
    """The cached entry of this pack at B rows, keyed by every pointer it holds."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (cfg, B, T, device, stream, threading.get_ident(), fw.wqkv.dtype,
           *(t.data_ptr() for t in fw))
    entry = _BATCH_ENTRIES.get(key)
    if entry is None:
        entry = _BatchEntry(cfg, fw, B, T, device)
        _BATCH_ENTRIES[key] = entry
        while len(_BATCH_ENTRIES) > _MAX_ENTRIES:
            _BATCH_ENTRIES.popitem(last=False)
    return entry


def fused_decode_step_batched(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    x: torch.Tensor,  # [B, H]
    pos,  # [B] int tensor on x's device (per-row), or one int (every row)
    k_cache: torch.Tensor,  # [L, B, nk, T, d]
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # float32 [L, B, nk, T] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> tuple:
    """One fused decode step of B streams over all layers.

    Returns (x_out [B, H] float32 pre-final-norm, k_cache, v_cache[,
    k_scale, v_scale]); the caches (and scales) are updated in place.
    Positions past the last slot are clamped to it.  A position tensor
    stays on the device: the kernel reads it, so the step needs no host
    sync.  More than ``persistent.LAUNCH_ROWS`` rows run as
    :func:`~.persistent.row_launches` launches of consecutive rows on the
    one cache (on the CPU the plain version on each launch's rows): each row
    is what a call of at most LAUNCH_ROWS rows gives it, bit for bit."""
    outs = [_step_rows(cfg, fw, x[r0 : r0 + nb], _row_slice(pos, r0, nb), k_cache, v_cache,
                       k_scale, v_scale, r0)
            for r0, nb in persistent.row_launches(x.shape[0])]
    x_out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return _with_scales((x_out, k_cache, v_cache), k_scale, v_scale)


def _row_slice(pos, r0: int, nb: int):
    """Rows r0 .. r0 + nb - 1 of a [B] position (or start) tensor; one int
    stays as it is."""
    return pos.reshape(-1)[r0 : r0 + nb] if isinstance(pos, torch.Tensor) else pos


def _cache_rows(caches, r0: int, nb: int) -> list:
    """Cache rows r0 .. r0 + nb - 1 of every [L, B, ...] tensor (views; None stays)."""
    return [None if t is None else t[:, r0 : r0 + nb] for t in caches]


def _step_rows(cfg, fw, x, pos, k_cache, v_cache, k_scale, v_scale, row0: int) -> torch.Tensor:
    """x_out of one launch of K4: ``x``'s rows on cache rows row0 ..; on
    the CPU the plain version on those cache rows."""
    if x.device.type == "cpu":
        caches = (k_cache, v_cache, k_scale, v_scale)
        if row0 or x.shape[0] != k_cache.shape[1]:
            caches = _cache_rows(caches, row0, x.shape[0])
        return fused_decode_step_batched_reference(cfg, fw, x, pos, *caches)[0]
    return _launch_step_batched(fused_decode_step_batched, "qtts_decode_step_batched", cfg, fw, x,
                                pos, k_cache, v_cache, k_scale, v_scale, row0)[0]


def _launch_step_batched(wrapper, entry: str, cfg: TransformerConfig, fw: FusedStepWeights,
                         x: torch.Tensor, pos, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k_scale=None, v_scale=None, row0: int = 0):
    """Launch a batched step entry (``qtts_decode_step_batched``: K4,
    persistent, with its cached plan, on cache rows row0 .. row0 + B - 1;
    ``qtts_decode_step_batched_multi``: the launch-per-op sequence, int8
    units on a bf16 or float32 cache of B rows) on CUDA tensors, counting
    the launch on ``wrapper``."""
    what = wrapper.__name__
    B, T = x.shape[0], k_cache.shape[3]
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"{what} takes 1..{MAX_BATCH} rows a launch, got {B}")
    if not 0 <= row0 <= k_cache.shape[1] - B:
        raise ValueError(f"{what}: rows {row0}..{row0 + B - 1} of a {k_cache.shape[1]}-row cache")
    planned = entry == "qtts_decode_step_batched"  # the _multi sequence takes int8 only
    if not planned and (k_scale is not None or k_cache.shape[1] != B):
        raise NotImplementedError(f"{what}: the launch-per-op sequence takes no int8 cache, and "
                                  "a cache of its B rows")
    _check_cuda_inputs(fw, k_cache, v_cache, planned, k_scale, v_scale, int4_units=planned)
    from ._build import check, load_kernels

    lib = load_kernels()
    if planned:
        e = _batch_entry(cfg, fw, B, T, x.device)
        w, s, scratch = e.w, e.s, None
    else:
        w, s, scratch = batch_structs(cfg, fw, B, T, x.device)
    x_in = x.float().contiguous()
    x_out = torch.empty((B, cfg.hidden_size), dtype=torch.float32, device=x.device)
    if isinstance(pos, torch.Tensor):
        pos_dev = pos.to(dtype=torch.long).reshape(B).contiguous()
        if pos_dev.device != x.device:
            raise ValueError(f"{what}: positions must be on the device")
        pos_ptr, pos_host = pos_dev.data_ptr(), 0
    else:
        pos_ptr, pos_host = None, min(int(pos), T - 1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    caches = (x_in.data_ptr(), x_out.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    args = (int(k_cache.dtype == torch.bfloat16), B, T, pos_ptr, pos_host)
    wrapper.launches += 1
    if planned:
        err = lib.qtts_decode_step_batched(w, s, e.plan.struct, *caches,
                                           *scale_ptrs(k_scale, v_scale), *args,
                                           k_cache.shape[1], row0, stream)
    else:
        err = lib.qtts_decode_step_batched_multi(w, s, *caches, *args, stream)
    check(err, what)
    del scratch  # enqueued; the caching allocator orders reuse on the stream
    return _with_scales((x_out, k_cache, v_cache), k_scale, v_scale)


fused_decode_step_batched.launches = 0  # kernel launches, for chip_smoke.py's path check
