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
            K1's function), the caches updated in place (an int8 cache with
            its scales: K1's int8-cache step);
    head:   hidden = RMSNorm(x) * final_norm (float32) and the lm_head as
            bf16(hidden) . bf16(rows) * scale (int8 rows, or bf16 rows with
            scales of one).

Unit mixes, as the JAX kernel takes them (its tw4 / mw4 and bits=16
talker): a talker of int8, int4 or bf16 units beside an int8 or int4 MTP
trunk (never bf16: :func:`supports_frame`), the lm_head and the chain heads
bf16 exactly where the talker is (the engine's raw heads at
``quantize=None``), else int8.

So its sampled output is a different per-seed stream from the multi-dispatch
path's, and its greedy output may differ where logits nearly tie (the JAX
kernel's numerics, kept here).  On a CUDA tensor :func:`fused_frame_step`
launches the hand-written persistent kernel (``csrc/fused_frame.cu``: the
transport of K1 and K2 on a plan of two weight sets, ``ops/persistent.py``);
on a CPU tensor it runs :func:`fused_frame_step_reference`, the plain
PyTorch version.  The kernel launch is cooperative: a card that cannot hold
the grid at once raises, and nothing runs in its place.  The kernel keeps
the chain's cache in the talker cache's dtype, or in bf16 beside an int8
talker cache.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import torch

from ..config import CODEC_EOS, TransformerConfig
from . import persistent
from .fused_mtp import (
    NEG_INF,
    RESIDENT_MAX_BYTES,
    HeadPack,
    fused_mtp_chain_reference,
    gumbel_topk_topp_sample,
    trunk_bytes,
)
from .fused_step import (
    WINDOW,
    FusedStepWeights,
    _check_cuda_inputs,
    _gemv,
    _rms,
    _with_scales,
    fused_decode_step_reference,
    names_of,
    scale_ptrs,
    step_structs,
    supports,
    unit_bytes,
)
from ..runtime.sampling import clamp_temperature

# The JAX kernel's fixed VMEM beyond the resident trunk (its _FRAME_FIXED),
# kept as the port's gate: the trunk sizes the TPU frame kernel takes.
FRAME_FIXED_BYTES = 24 * 1024 * 1024


def supports_frame(mfw: FusedStepWeights, T: int, cfg: TransformerConfig,
                   kvq: bool = False) -> bool:
    """The JAX gate (``supports_frame``): an int8 or int4 MTP trunk (JAX's
    int4 units are int8-typed; the port's are uint8 pairs) and never a bf16
    one, a talker bucket of at most 512 slots (128-aligned under an int8 KV
    cache, ``kvq``) or a multiple of 512, an architecture the step kernel
    takes, and the trunk plus the fixed buffers within the TPU's resident
    budget (0.6B: 78 MB int8, 39 MB int4 pass; 1.7B: 302 MB int8 and 151 MB
    int4 do not)."""
    if mfw.wqkv.dtype not in (torch.int8, torch.uint8):
        return False
    if T <= 512:
        if kvq and T % 128 != 0:
            return False
    elif T % WINDOW != 0:
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
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
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
    x = fused_decode_step_reference(tcfg, tfw, x, pos, k_cache, v_cache, k_scale, v_scale)[0]
    hidden = _rms(x, talker_fnorm.float(), tcfg.rms_norm_eps)
    logits = _gemv(hidden, lm_head.q, lm_head.scale)
    return _with_scales((code0.to(torch.int32), subcodes, logits, hidden, k_cache, v_cache),
                        k_scale, v_scale)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def chain_cache_dtype(cache_dtype: torch.dtype) -> torch.dtype:
    """The dtype of the chain's cache beside a talker cache of ``cache_dtype``."""
    return torch.bfloat16 if cache_dtype == torch.int8 else cache_dtype


class _Entry:
    """The argument struct, scratch, chain caches and plan of one (packs,
    cache bucket, talker cache dtype) for a frame entry on one stream of one
    thread: built once, then a call sets its inputs, outputs, norms and knobs
    (two threads never share one).  ``plan``: the persistent frame's (K7),
    else None."""

    def __init__(self, tcfg, mcfg, tfw, lm_head, codec_table, mfw, heads, tables, T: int,
                 cache_dtype: torch.dtype, device, planned: bool):
        from ._build import FrameArgs

        n, V, H = heads.q.shape
        Vc = lm_head.q.shape[0]
        Lm, nk, d = mfw.wqkv.shape[0], mcfg.num_kv_heads, mcfg.head_dim
        tw, ts, t_scratch = step_structs(tcfg, tfw, T, device)
        mw, ms, m_scratch = step_structs(mcfg, mfw, n + 2, device)
        self.buf = torch.empty(6 * H + V, dtype=torch.float32, device=device)
        x, mx, mx_in, sub_sum, c0e, lh, head_logits = torch.split(self.buf, [H] * 6 + [V])
        self.work = {"x": x, "sub_sum": sub_sum, "c0e": c0e}
        self.mk = torch.empty((Lm, nk, n + 2, d), dtype=chain_cache_dtype(cache_dtype),
                              device=device)
        self.mv = torch.empty_like(self.mk)
        self.scratch = (t_scratch, m_scratch)
        a = FrameArgs()
        a.tw, a.ts, a.mw, a.ms = tw, ts, mw, ms
        c = a.mc  # shares a's memory
        c.heads, c.head_scales = heads.q.data_ptr(), heads.scale.data_ptr()
        c.tables = tables.data_ptr()
        c.last_hidden, c.code0_embed = lh.data_ptr(), c0e.data_ptr()
        c.sub_sum, c.x, c.x_in, c.logits = (t.data_ptr() for t in (sub_sum, mx, mx_in, head_logits))
        c.k_cache, c.v_cache = self.mk.data_ptr(), self.mv.data_ptr()
        c.cache_bf16 = int(self.mk.dtype == torch.bfloat16)
        c.n, c.V, c.Vt = n, V, tables.shape[1]
        c.heads_bf16 = int(heads.q.dtype == torch.bfloat16)
        a.lm, a.lm_scale = lm_head.q.data_ptr(), lm_head.scale.data_ptr()
        a.codec = codec_table.data_ptr()
        a.x, a.c0e, a.lh = x.data_ptr(), c0e.data_ptr(), lh.data_ptr()
        a.cache_bf16, a.T, a.Vc, a.eos = int(cache_dtype == torch.bfloat16), T, Vc, CODEC_EOS
        self.args = a
        self.plan = persistent.device_plan(
            mcfg, device, head_rows=V, talker=tcfg, lm_rows=Vc, unit_bytes=unit_bytes(mfw),
            head_bytes=heads.q.element_size(), talker_bytes=unit_bytes(tfw)) if planned else None


_ENTRIES: "OrderedDict[tuple, _Entry]" = OrderedDict()
_MAX_ENTRIES = 8


def _entry(entry: str, tcfg, mcfg, tfw, lm_head, codec_table, mfw, heads, tables, T,
           cache_dtype, device) -> _Entry:
    """The cached entry of these tensors on this stream and thread, keyed by
    every pointer the struct holds, so a hit is the struct these tensors
    would build."""
    tensors = (*tfw, *mfw, *lm_head, codec_table, *heads, tables)
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (entry, tcfg, mcfg, T, cache_dtype, device, stream, threading.get_ident(),
           *(t.dtype for t in (tfw.wqkv, mfw.wqkv, heads.q)), *(t.data_ptr() for t in tensors))
    hit = _ENTRIES.get(key)
    if hit is None:
        hit = _Entry(tcfg, mcfg, tfw, lm_head, codec_table, mfw, heads, tables, T, cache_dtype,
                     device, planned=not entry.endswith("_multi"))
        _ENTRIES[key] = hit
        while len(_ENTRIES) > _MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
    return hit


def _check_frame_inputs(tfw, mfw, lm_head, codec_table, heads, tables, k_cache, v_cache,
                        k_scale, v_scale, mtp_cache_dtype, multi: bool = False) -> None:
    """The frame's checks: K7 takes a talker of int8, int4 or bf16 units
    beside an int8 or int4 trunk, its lm_head and heads bf16 exactly where
    the talker is; the launch-per-op frame (``multi``) int8 units and heads."""
    _check_cuda_inputs(tfw, k_cache, v_cache, not multi, k_scale, v_scale, window=True,
                       int4_units=not multi)
    _check_cuda_inputs(mfw, k_cache, v_cache, False, k_scale, v_scale, window=True,
                       int4_units=not multi)
    if mtp_cache_dtype != chain_cache_dtype(k_cache.dtype):
        raise NotImplementedError(
            f"the frame kernel keeps the chain's cache in {chain_cache_dtype(k_cache.dtype)} "
            f"beside a {k_cache.dtype} talker cache, not in {mtp_cache_dtype}"
        )
    if codec_table.dtype != torch.bfloat16 or tables.dtype != torch.bfloat16:
        raise NotImplementedError(
            "embedding tables other than bf16 do not run on the card (ROADMAP item K2v)"
        )
    for t in (*lm_head, *heads, codec_table, tables):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("fused_frame_step: every tensor must be contiguous and on CUDA")
    rows = torch.bfloat16 if tfw.wqkv.dtype == torch.bfloat16 else torch.int8
    if lm_head.q.dtype != rows or heads.q.dtype != rows:
        raise NotImplementedError(
            f"the frame kernel takes {rows} lm_head and MTP head rows beside "
            f"{names_of(tfw)} talker units (bf16 exactly beside bf16 units), not "
            f"{lm_head.q.dtype} and {heads.q.dtype}")
    if any(t.data_ptr() % 16 for t in (*lm_head, *heads)):
        raise ValueError("fused_frame_step: the lm_head and heads must be 16-byte aligned")


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
    k_scale: Optional[torch.Tensor] = None,  # float32 [L, 1, nk, T] (int8 talker cache)
    v_scale: Optional[torch.Tensor] = None,
    mtp_cache_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """One whole 12 Hz frame.

    Returns (code0 [1] int32, subcodes [1, n] int32, logits [1, Vc] f32,
    hidden [1, H] f32, k_cache, v_cache[, k_scale, v_scale]); the caches
    (and scales) are updated in place."""
    T = k_cache.shape[3]
    pos = min(int(pos), T - 1)
    args = (tcfg, mcfg, tfw, talker_fnorm, lm_head, codec_table, mfw, mtp_fnorm, heads, tables)
    if last_logits.device.type == "cpu":
        return fused_frame_step_reference(
            *args, last_logits, last_hidden, suppress, drip, pos, k_cache, v_cache, g0, gumbel,
            temperature, top_k, top_p, forbid_eos, mtp_cache_dtype, k_scale, v_scale,
        )
    return _launch_frame(fused_frame_step, "qtts_frame_step", *args, last_logits, last_hidden,
                         suppress, drip, pos, k_cache, v_cache, g0, gumbel, temperature, top_k,
                         top_p, forbid_eos, mtp_cache_dtype, k_scale, v_scale)


fused_frame_step.launches = 0  # kernel launches, for chip_smoke.py's path check


def _launch_frame(wrapper, entry: str, tcfg, mcfg, tfw, talker_fnorm, lm_head, codec_table, mfw,
                  mtp_fnorm, heads, tables, last_logits, last_hidden, suppress, drip, pos,
                  k_cache, v_cache, g0, gumbel, temperature, top_k, top_p, forbid_eos,
                  mtp_cache_dtype, k_scale=None, v_scale=None):
    """Launch a frame entry (``qtts_frame_step``: K7, persistent, with its
    plan; ``qtts_frame_step_multi``: the launch-per-op frame kernel, on a
    bf16 or float32 talker cache) on CUDA tensors, counting the launch on
    ``wrapper``."""
    what = wrapper.__name__
    if last_logits.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {last_logits.device}")
    greedy = temperature <= 0.0
    if not greedy and (g0 is None or gumbel is None):
        raise ValueError("a sampled frame needs Gumbel noise g0 [1, Vc] and gumbel [n, 1, V]")
    if entry.endswith("_multi") and k_scale is not None:
        raise NotImplementedError(f"{what}: the launch-per-op frame takes no int8 cache")
    _check_frame_inputs(tfw, mfw, lm_head, codec_table, heads, tables, k_cache, v_cache,
                        k_scale, v_scale, mtp_cache_dtype, multi=entry.endswith("_multi"))
    from ._build import check, load_kernels

    lib = load_kernels()
    device = last_logits.device
    T = k_cache.shape[3]
    pos = min(int(pos), T - 1)
    e = _entry(entry, tcfg, mcfg, tfw, lm_head, codec_table, mfw, heads, tables, T,
               k_cache.dtype, device)
    a = e.args
    n, H = heads.q.shape[0], tcfg.hidden_size
    Vc = a.Vc
    ll = last_logits.float().contiguous()
    sup = suppress.float().contiguous()
    lh = last_hidden.contiguous()
    dr = drip.contiguous()
    for t in (lh, dr):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.numel() != H:
            raise ValueError(f"{what}: last_hidden and drip must be [1, H] float32 or bf16")
    if ll.numel() != Vc or sup.numel() != Vc:
        raise ValueError(f"{what}: last_logits and suppress must hold {Vc} values")
    out = torch.empty(Vc + H, dtype=torch.float32, device=device)
    logits, hidden = torch.split(out, [Vc, H])
    codes = torch.empty(1 + n, dtype=torch.int32, device=device)
    if greedy:
        noise = (ll, ll)  # unread
    else:
        noise = (g0.float().contiguous(), gumbel.float().contiguous())
        if noise[0].numel() != Vc or noise[1].numel() != n * a.mc.V:
            raise ValueError(f"{what}: noise must be g0 [1, Vc] and gumbel [n, 1, V]")
    # converted on every call: the entry is keyed by pointers only, and a
    # later model's norm may come to lie at the same address
    norms = (talker_fnorm.float().contiguous(), mtp_fnorm.float().contiguous())
    c = a.mc
    a.talker_norm, c.final_norm = (t.data_ptr() for t in norms)
    a.last_logits, a.suppress = ll.data_ptr(), sup.data_ptr()
    a.g0, c.gumbel = noise[0].data_ptr(), noise[1].data_ptr()
    a.last_hidden, a.drip = lh.data_ptr(), dr.data_ptr()
    a.lh_bf16, a.drip_bf16 = int(lh.dtype == torch.bfloat16), int(dr.dtype == torch.bfloat16)
    a.k_cache, a.v_cache = k_cache.data_ptr(), v_cache.data_ptr()
    a.k_scale, a.v_scale = scale_ptrs(k_scale, v_scale)
    a.codes, c.subcodes = codes.data_ptr(), codes.data_ptr() + codes.element_size()
    a.logits, a.hidden = logits.data_ptr(), hidden.data_ptr()
    a.pos, a.forbid_eos = pos, int(bool(forbid_eos))
    c.temperature, c.top_k, c.top_p = clamp_temperature(temperature), int(top_k), float(top_p)
    c.greedy = int(greedy)
    stream = torch.cuda.current_stream(device).cuda_stream
    wrapper.launches += 1
    if e.plan is None:
        err = getattr(lib, entry)(a, stream)
    else:
        err = getattr(lib, entry)(a, e.plan.struct, stream)
    check(err, what)
    return _with_scales((codes[:1], codes[1:].reshape(1, n), logits.reshape(1, Vc),
                         hidden.reshape(1, H), k_cache, v_cache), k_scale, v_scale)


def _packs_entry(args, entry: str = "qtts_frame_step") -> _Entry:
    tcfg, mcfg, tfw, _, lm_head, codec_table, mfw, _, heads, tables, T, cache_dtype = args
    return _entry(entry, tcfg, mcfg, tfw, lm_head, codec_table, mfw, heads, tables, T,
                  cache_dtype, mfw.wqkv.device)


def frame_plan(*args) -> persistent.DevicePlan:
    """K7's device plan for these packs at cache bucket T on this stream and
    thread (``args``: :func:`fused_frame_step`'s first ten, then T and the
    cache dtype): its grid is the launch's; chip_smoke.py traces it."""
    return _packs_entry(args).plan


def frame_work(*args, entry: str = "qtts_frame_step") -> dict:
    """The float32 work vectors [H] of a frame entry for these packs
    (``args`` as :func:`frame_plan`'s), as its last launch on this stream
    and thread left them: ``x`` (the talker residual before the final norm),
    ``sub_sum`` and ``c0e`` (the codec row of code0).  chip_smoke.py holds
    them to kernels K2 and K1 bit for bit."""
    return _packs_entry(args, entry).work
