"""Kernel K7: one whole B=1 12 Hz frame in one launch.

Port of ``leaxer_qwen3_tts_tpu/ops/fused_frame.py::fused_frame_step``.  One
call runs the whole frame, in the JAX kernel's order:

    code0:  last_logits + suppress (-1e30 at CODEC_EOS when forbidden), drawn
            by :func:`~leaxer_qwen3_tts_torch.ops.fused_mtp.gumbel_topk_topp_sample`
            on the full row with the caller's noise ``g0``;
    c0e:    the ``codec_embed`` row of code0, as float32;
    chain:  the whole MTP chain, prefix included (kernel K2's function), at
            ``mtp_cache_dtype``;
    x:      c0e + sub_sum + drip in float32, with no cast (the multi-dispatch
            path rounds it to the embedding dtype first);
    talker: one step through every talker layer at min(pos, T - 1) (kernel
            K1's function), the caches updated in place;
    head:   hidden = RMSNorm(x) * final_norm (float32) and the lm_head as
            bf16(hidden) . bf16(int8 rows) * scale.

So its sampled output is a different per-seed stream from the multi-dispatch
path's, and its greedy output may differ where logits nearly tie (the JAX
kernel's numerics, kept here).  On a CUDA tensor :func:`fused_frame_step`
launches the hand-written persistent kernel (``csrc/fused_frame.cu``); on a
CPU tensor it runs :func:`fused_frame_step_reference`, the plain PyTorch
version.  The kernel launch is cooperative: a card that cannot hold the
grid at once raises, and nothing runs in its place.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Optional, Tuple

import torch

from ..config import CODEC_EOS, TransformerConfig
from .fused_mtp import (
    NEG_INF,
    RESIDENT_MAX_BYTES,
    HeadPack,
    fused_mtp_chain_reference,
    gumbel_topk_topp_sample,
    trunk_bytes,
)
from .fused_step import (
    FusedStepWeights,
    _check_cuda_inputs,
    _gemv,
    _rms,
    fused_decode_step_reference,
    step_structs,
    supports,
)
from ..runtime.sampling import clamp_temperature

# The JAX kernel's fixed VMEM beyond the resident trunk (its _FRAME_FIXED),
# kept as the port's gate: the trunk sizes the TPU frame kernel takes.
FRAME_FIXED_BYTES = 24 * 1024 * 1024
WINDOW = 512  # the JAX talker step's long-form cache window


def supports_frame(mfw: FusedStepWeights, T: int, cfg: TransformerConfig) -> bool:
    """The JAX gate (``supports_frame`` without int8 KV): an int8 MTP trunk,
    a talker bucket of at most 512 slots or a multiple of 512, an
    architecture the step kernel takes, and the trunk plus the fixed buffers
    within the TPU's resident budget (0.6B: 78 MB passes; 1.7B: 302 MB does
    not)."""
    if mfw.wqkv.dtype != torch.int8:
        return False
    if T > 512 and T % WINDOW != 0:
        return False
    if not supports(cfg):
        return False
    return trunk_bytes(mfw) + FRAME_FIXED_BYTES <= RESIDENT_MAX_BYTES


def _eos_gate(logits: torch.Tensor, suppress: torch.Tensor, forbid_eos: bool) -> torch.Tensor:
    """last_logits + suppress, plus -1e30 at CODEC_EOS when forbidden (0 elsewhere)."""
    Vc = logits.shape[-1]
    add = torch.zeros((Vc,), dtype=torch.float32, device=logits.device)
    if forbid_eos and CODEC_EOS < Vc:
        add[CODEC_EOS] = NEG_INF
    return logits.float() + suppress.float()[None, :] + add[None, :]


def fused_frame_step_reference(
    tcfg: TransformerConfig,
    mcfg: TransformerConfig,
    tfw: FusedStepWeights,
    talker_fnorm: torch.Tensor,
    lm_head: HeadPack,
    codec_table: torch.Tensor,
    mfw: FusedStepWeights,
    mtp_fnorm: torch.Tensor,
    heads: HeadPack,
    tables: torch.Tensor,
    last_logits: torch.Tensor,
    last_hidden: torch.Tensor,
    suppress: torch.Tensor,
    drip: torch.Tensor,
    pos: int,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    g0: Optional[torch.Tensor],
    gumbel: Optional[torch.Tensor],
    temperature: float,
    top_k: int,
    top_p: float,
    forbid_eos: bool,
    mtp_cache_dtype: torch.dtype = torch.float32,
):
    """Plain PyTorch version of the kernel; same contract."""
    pos = min(int(pos), k_cache.shape[3] - 1)
    logits0 = _eos_gate(last_logits, suppress, forbid_eos)
    code0 = gumbel_topk_topp_sample(logits0, g0, temperature, top_k, top_p)  # [1]
    c0e = codec_table[code0].float()  # [1, H]
    subcodes, sub_sum = fused_mtp_chain_reference(
        mcfg, mfw, mtp_fnorm, heads, tables, last_hidden, c0e, gumbel, temperature, top_k,
        top_p, mtp_cache_dtype,
    )
    x = c0e + sub_sum + drip.float()
    x, _, _ = fused_decode_step_reference(tcfg, tfw, x, pos, k_cache, v_cache)
    hidden = _rms(x, talker_fnorm.float(), tcfg.rms_norm_eps)
    logits = _gemv(hidden, lm_head.q, lm_head.scale)
    return code0.to(torch.int32), subcodes, logits, hidden, k_cache, v_cache


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


class _Entry:
    """The argument struct and scratch of one (packs, cache bucket, cache
    dtype): built once, then only the per-frame fields change."""

    def __init__(self, tcfg, mcfg, tfw, talker_fnorm, lm_head, codec_table, mfw, mtp_fnorm,
                 heads, tables, T: int, cache_dtype: torch.dtype, device):
        from ._build import FrameArgs

        n, V, H = heads.q.shape
        Lm, nk, d = mfw.wqkv.shape[0], mcfg.num_kv_heads, mcfg.head_dim
        tw, ts, t_scratch = step_structs(tcfg, tfw, T, device)
        mw, ms, m_scratch = step_structs(mcfg, mfw, n + 2, device)
        self.norms = (talker_fnorm.float().contiguous(), mtp_fnorm.float().contiguous())
        self.buf = torch.empty(5 * H + V, dtype=torch.float32, device=device)
        x, mx, mx_in, sub_sum, c0e, head_logits = torch.split(self.buf, [H] * 5 + [V])
        self.work = {"x": x, "sub_sum": sub_sum, "c0e": c0e}
        self.mk = torch.empty((Lm, nk, n + 2, d), dtype=cache_dtype, device=device)
        self.mv = torch.empty_like(self.mk)
        self.scratch = (t_scratch, m_scratch)
        a = FrameArgs()
        a.tw, a.ts, a.mw, a.ms = tw, ts, mw, ms
        a.talker_norm, a.mtp_norm = (t.data_ptr() for t in self.norms)
        a.lm, a.lm_scale = lm_head.q.data_ptr(), lm_head.scale.data_ptr()
        a.codec = codec_table.data_ptr()
        a.heads, a.head_scales, a.tables = heads.q.data_ptr(), heads.scale.data_ptr(), tables.data_ptr()
        a.mk_cache, a.mv_cache = self.mk.data_ptr(), self.mv.data_ptr()
        a.x, a.mx, a.mx_in = x.data_ptr(), mx.data_ptr(), mx_in.data_ptr()
        a.sub_sum, a.c0e, a.head_logits = sub_sum.data_ptr(), c0e.data_ptr(), head_logits.data_ptr()
        a.cache_bf16 = int(cache_dtype == torch.bfloat16)
        a.T, a.Vc, a.n, a.V, a.Vt = T, lm_head.q.shape[0], n, V, tables.shape[1]
        a.eos = CODEC_EOS
        self.args = a


_ENTRIES: "OrderedDict[tuple, _Entry]" = OrderedDict()
_MAX_ENTRIES = 8


def _entry(tcfg, mcfg, tfw, talker_fnorm, lm_head, codec_table, mfw, mtp_fnorm, heads, tables,
           T, cache_dtype, device) -> _Entry:
    """The cached entry of these tensors: keyed by every pointer the struct
    holds, so a hit is the struct these tensors would build."""
    tensors = (*tfw, *mfw, talker_fnorm, *lm_head, codec_table, mtp_fnorm, *heads, tables)
    key = (tcfg, mcfg, T, cache_dtype, device, *(t.data_ptr() for t in tensors))
    entry = _ENTRIES.get(key)
    if entry is None:
        entry = _Entry(tcfg, mcfg, tfw, talker_fnorm, lm_head, codec_table, mfw, mtp_fnorm,
                       heads, tables, T, cache_dtype, device)
        _ENTRIES[key] = entry
        while len(_ENTRIES) > _MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
    return entry


def _check_frame_inputs(tfw, mfw, lm_head, codec_table, heads, tables, k_cache, v_cache,
                        mtp_cache_dtype) -> None:
    _check_cuda_inputs(tfw, k_cache, v_cache)
    _check_cuda_inputs(mfw, k_cache, v_cache)
    if mtp_cache_dtype != k_cache.dtype:
        raise NotImplementedError(
            f"the frame kernel keeps the chain's cache in the talker cache dtype ({k_cache.dtype}), "
            f"not {mtp_cache_dtype}"
        )
    if codec_table.dtype != torch.bfloat16 or tables.dtype != torch.bfloat16:
        raise NotImplementedError(
            "embedding tables other than bf16 do not run on the card (ROADMAP item K2v)"
        )
    for t in (*lm_head, *heads, codec_table, tables):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("fused_frame_step: every tensor must be contiguous and on CUDA")
    if lm_head.q.dtype != torch.int8 or heads.q.dtype != torch.int8:
        raise NotImplementedError("the frame kernel takes int8 lm_head and MTP head rows")


def fused_frame_step(
    tcfg: TransformerConfig,  # talker transformer
    mcfg: TransformerConfig,  # MTP trunk transformer
    tfw: FusedStepWeights,  # talker pack
    talker_fnorm: torch.Tensor,  # [H] talker final norm
    lm_head: HeadPack,  # [Vc, H] int8 rows + [Vc] scales
    codec_table: torch.Tensor,  # [codec vocab, H] codec_embed table
    mfw: FusedStepWeights,  # MTP trunk pack
    mtp_fnorm: torch.Tensor,  # [H] MTP final norm
    heads: HeadPack,  # [n, V, H] MTP head rows
    tables: torch.Tensor,  # [n, Vt, H] MTP step embedding tables
    last_logits: torch.Tensor,  # [1, Vc] f32
    last_hidden: torch.Tensor,  # [1, H]
    suppress: torch.Tensor,  # [Vc] f32 codec control-token mask
    drip: torch.Tensor,  # [1, H] this frame's text-drip embedding
    pos: int,  # talker write slot (host int)
    k_cache: torch.Tensor,  # [L, 1, nk, T, d], updated in place
    v_cache: torch.Tensor,
    g0: Optional[torch.Tensor],  # [1, Vc] f32 code0 Gumbel noise (None when greedy)
    gumbel: Optional[torch.Tensor],  # [n, 1, V] f32 chain noise (None when greedy)
    temperature: float,
    top_k: int,
    top_p: float,
    forbid_eos: bool,
    k_scale=None,
    v_scale=None,
    mtp_cache_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """One whole 12 Hz frame.

    Returns (code0 [1] int32, subcodes [1, n] int32, logits [1, Vc] f32,
    hidden [1, H] f32, k_cache, v_cache); the caches are updated in place."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("the int8 KV cache is not ported yet (ROADMAP item K1v)")
    T = k_cache.shape[3]
    pos = min(int(pos), T - 1)
    args = (tcfg, mcfg, tfw, talker_fnorm, lm_head, codec_table, mfw, mtp_fnorm, heads, tables)
    if last_logits.device.type == "cpu":
        return fused_frame_step_reference(
            *args, last_logits, last_hidden, suppress, drip, pos, k_cache, v_cache, g0, gumbel,
            temperature, top_k, top_p, forbid_eos, mtp_cache_dtype,
        )
    if last_logits.device.type != "cuda":
        raise ValueError(f"fused_frame_step: unsupported device {last_logits.device}")
    greedy = temperature <= 0.0
    if not greedy and (g0 is None or gumbel is None):
        raise ValueError("a sampled frame needs Gumbel noise g0 [1, Vc] and gumbel [n, 1, V]")
    _check_frame_inputs(tfw, mfw, lm_head, codec_table, heads, tables, k_cache, v_cache,
                        mtp_cache_dtype)
    from ._build import check, load_kernels

    lib = load_kernels()
    device = last_logits.device
    entry = _entry(*args, T, k_cache.dtype, device)
    a = entry.args
    n, H = heads.q.shape[0], tcfg.hidden_size
    Vc = a.Vc
    ll = last_logits.float().contiguous()
    sup = suppress.float().contiguous()
    lh = last_hidden.contiguous()
    dr = drip.contiguous()
    for t in (lh, dr):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.numel() != H:
            raise ValueError("fused_frame_step: last_hidden and drip must be [1, H] float32 or bf16")
    if ll.numel() != Vc or sup.numel() != Vc:
        raise ValueError(f"fused_frame_step: last_logits and suppress must hold {Vc} values")
    out = torch.empty(Vc + H, dtype=torch.float32, device=device)
    logits, hidden = torch.split(out, [Vc, H])
    codes = torch.empty(1 + n, dtype=torch.int32, device=device)
    if greedy:
        noise = (ll, ll)  # unread
    else:
        noise = (g0.float().contiguous(), gumbel.float().contiguous())
        if noise[0].numel() != Vc or noise[1].numel() != n * a.V:
            raise ValueError("fused_frame_step: noise must be g0 [1, Vc] and gumbel [n, 1, V]")
    a.last_logits, a.suppress = ll.data_ptr(), sup.data_ptr()
    a.g0, a.gumbel = noise[0].data_ptr(), noise[1].data_ptr()
    a.last_hidden, a.drip = lh.data_ptr(), dr.data_ptr()
    a.lh_bf16, a.drip_bf16 = int(lh.dtype == torch.bfloat16), int(dr.dtype == torch.bfloat16)
    a.k_cache, a.v_cache = k_cache.data_ptr(), v_cache.data_ptr()
    a.codes, a.logits, a.hidden = codes.data_ptr(), logits.data_ptr(), hidden.data_ptr()
    a.pos, a.forbid_eos = pos, int(bool(forbid_eos))
    a.temperature, a.top_k, a.top_p = clamp_temperature(temperature), int(top_k), float(top_p)
    a.greedy = int(greedy)
    stream = torch.cuda.current_stream(device).cuda_stream
    fused_frame_step.launches += 1
    err = lib.qtts_frame_step(ctypes.byref(a), stream)
    check(err, "fused_frame_step")
    return (codes[:1], codes[1:].reshape(1, n), logits.reshape(1, Vc), hidden.reshape(1, H),
            k_cache, v_cache)


fused_frame_step.launches = 0  # kernel launches, for chip_smoke.py's path check


def _packs_entry(args) -> _Entry:
    *packs, T, cache_dtype = args
    return _entry(*packs, T, cache_dtype, packs[2].wqkv.device)


def frame_grid(*args) -> int:
    """The grid (blocks of 256 threads) K7 launches with for these packs at
    cache bucket T (``args``: :func:`fused_frame_step`'s first ten, then T and
    the cache dtype)."""
    from ._build import load_kernels

    return load_kernels().qtts_frame_grid(ctypes.byref(_packs_entry(args).args))


def frame_work(*args) -> dict:
    """K7's float32 work vectors [H] for these packs (``args`` as
    :func:`frame_grid`'s), as the last launch left them: ``x`` (the talker
    residual before the final norm), ``sub_sum`` and ``c0e`` (the codec row of
    code0).  chip_smoke.py holds them to kernels K2 and K1 bit for bit."""
    return _packs_entry(args).work
