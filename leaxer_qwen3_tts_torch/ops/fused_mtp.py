"""Kernels K2 and K5: the whole MTP sub-code chain of one frame, for one
stream (K2) and for a batch of streams with per-row knobs (K5: up to 32 rows
a launch; a call of more runs as launches of nearly equal size).

Port of ``leaxer_qwen3_tts_tpu/ops/fused_mtp.py::fused_mtp_chain`` and
``fused_mtp_chain_batched``: the 2-token prefix (talker hidden at position 0,
codec_embed(code0) at 1) and the 15-step chain, each step a step-indexed
int8 head, the in-chain sampler (:func:`gumbel_topk_topp_sample`) on
caller-supplied Gumbel noise, and the embedding-row gather whose value feeds
the next trunk pass and ``sub_sum``.

A Hopper SM cannot hold the 82 MB int8 trunk the TPU kept resident in VMEM,
so the CUDA chain (``csrc/fused_mtp.cu``) streams it: the whole chain is one
persistent cooperative launch whose trunk passes run kernel K1's phases on
the MTP pack and whose heads are one more GEMV phase each, every weight row
streamed through one TMA ring (the plan of ``ops/persistent.py``), with the
sampler and the gather on one block between them.  The sampled index stays
in device memory; there is no host sync in the chain.
The batched chain (``csrc/fused_mtp_batched.cu``) is the same one
persistent launch for B rows: its trunk passes run the persistent K4's
phases, each head row is read once for the batch, and block b samples row b
with that row's knobs.  On a CPU tensor
:func:`fused_mtp_chain` and :func:`fused_mtp_chain_batched` run their plain
versions, :func:`fused_mtp_chain_reference` and
:func:`fused_mtp_chain_batched_reference`.

Units are int8, int4 or bf16 with scales of one, and heads int8 or bf16
(:func:`pack_heads` of raw heads, as the JAX chains cast them).  K2 and K3
take heads of either type beside an int8 or int4 trunk (JAX's int4 mode
keeps the heads int8; an unquantized talker beside a quantized MTP trunk,
``mtp_quantize``, leaves the heads raw: bf16), and a bf16 trunk with bf16
heads on a float32 cache; a bf16 trunk's B=1 chain is K3 (the JAX residency
gate refuses bf16 trunks).  K5 takes what K2 and K3 take, at any batch:
int8 and int4 trunks with int8 or bf16 heads (the ``mtp_quantize`` mixes,
and the ``"auto"`` int4 alt trunk that JAX's ``resident_pack`` takes past
the primary's residency), and a bf16 trunk with bf16 heads on a float32
cache, K3's, so that each of its rows equals K3 on it.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..config import TransformerConfig
from .fused_step import (
    MAX_BATCH,
    FusedStepWeights,
    _check_cuda_inputs,
    _gemv,
    _gemv_rows,
    _rms,
    batch_structs,
    fused_decode_step_batched_reference,
    fused_decode_step_reference,
    step_structs,
    unit_bytes,
)
from ..runtime.sampling import clamp_temperature, scale_by_temperature
from . import persistent
from .quant import QuantizedLinear

NEG_INF = -1e30
_BISECT_ITERS = 40

# The JAX package's residency gate (ops/fused_mtp.py::supports_resident), kept
# as the port's routing rule: the trunk sizes that the TPU chain K2 holds in
# VMEM go to K2 here too, larger ones (the 1.7B trunk) to K3.  Hopper streams
# both from device memory; the byte arithmetic is the TPU's.
RESIDENT_MAX_BYTES = 112 * 1024 * 1024
_FIXED_B1 = 5 * 1024 * 1024  # B=1: heads double buffer, norms, scales, rope
_FIXED_BATCHED = 13 * 1024 * 1024  # B > 1: the tables' double buffer too
_PER_ROW = 1_100_000  # one row's KV scratch, noise and activations


def trunk_bytes(fw: FusedStepWeights) -> int:
    """Bytes of the packed trunk matrices, scales left out: the JAX unit
    pack's ``units.nbytes`` (int4: the halved nibble bytes)."""
    return sum(w.numel() * w.element_size() for w in (fw.wqkv, fw.wo, fw.wgu, fw.wd))


def supports_resident(fw: FusedStepWeights, batch: int = 1) -> bool:
    """True when the int8 or int4 trunk plus the buffers of a ``batch``-row
    chain fit the TPU's resident-VMEM budget (JAX ``supports_resident``,
    whose int4 units are int8 bytes): at B=1 the 0.6B MTP trunk (78 MB int8,
    39 MB int4) does, the 1.7B one (302 MB int8, 151 MB int4) does not; the
    0.6B int8 trunk through B=16, its int4 one through B=32; bf16 never."""
    if fw.wqkv.dtype not in (torch.int8, torch.uint8):
        return False
    fixed = _FIXED_BATCHED if batch > 1 else _FIXED_B1
    return trunk_bytes(fw) + fixed + _PER_ROW * batch <= RESIDENT_MAX_BYTES


class HeadPack(NamedTuple):
    """Step-indexed heads in kernel layout: int8 rows with their scales, or
    bf16 rows with scales of one."""

    q: torch.Tensor  # int8 or bf16 [n, V, H] (one output row per V, H contiguous); [V, H] for one
    scale: torch.Tensor  # f32 [n, V]; [V]


def pack_heads(heads: Union[QuantizedLinear, torch.Tensor]) -> HeadPack:
    """QuantizedLinear [..., H, V] / [..., 1, V] -> HeadPack [..., V, H] / [..., V]
    (the step-indexed heads [n, H, V], or one head such as the lm_head); raw
    heads [..., H, V] -> bf16 rows [..., V, H] with scales of one, as the JAX
    chains cast unquantized heads."""
    if not isinstance(heads, QuantizedLinear):
        return HeadPack(
            q=heads.to(torch.bfloat16).transpose(-1, -2).contiguous(),
            scale=torch.ones(heads.shape[:-2] + heads.shape[-1:], dtype=torch.float32,
                             device=heads.device),
        )
    return HeadPack(
        q=heads.q.transpose(-1, -2).contiguous(),
        scale=heads.scale[..., 0, :].float().contiguous(),
    )


def _bisect_topk_mask(scaled: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep entries >= the top_k-th largest per row (ties kept), found by
    bisection.  Inactive when top_k <= 0 or top_k >= V."""
    V = scaled.shape[-1]
    lo = scaled.amin(dim=-1, keepdim=True)
    hi = scaled.amax(dim=-1, keepdim=True)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = (scaled >= mid).sum(dim=-1, keepdim=True)
        sel = ge >= top_k
        lo = torch.where(sel, mid, lo)
        hi = torch.where(sel, hi, mid)
    if not 0 < top_k < V:
        return torch.ones_like(scaled, dtype=torch.bool)
    return scaled >= lo


def _bisect_topp_mask(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep token i iff the row's mass of strictly larger probs is < top_p."""
    lo = torch.zeros(probs.shape[:-1] + (1,), dtype=torch.float32, device=probs.device)
    hi = torch.ones_like(lo)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        s = torch.where(probs > mid, probs, 0.0).sum(dim=-1, keepdim=True)
        sel = s < top_p
        lo = torch.where(sel, lo, mid)
        hi = torch.where(sel, mid, hi)
    if top_p >= 1.0:
        return torch.ones_like(probs, dtype=torch.bool)
    return probs > lo


def gumbel_topk_topp_sample(
    logits: torch.Tensor,  # [B, V] f32
    gumbel: Optional[torch.Tensor],  # [B, V] f32 Gumbel(0, 1) noise (unused when greedy)
    temperature: float,
    top_k: int,
    top_p: float,
) -> torch.Tensor:
    """One temperature / top-k / top-p draw per row as vector math (no sort):
    greedy first-index argmax when temperature <= 0, else argmax of the
    masked scaled logits plus the noise.  Returns [B] int64."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = scale_by_temperature(logits, temperature)
    keep_k = _bisect_topk_mask(scaled, top_k)
    masked = torch.where(keep_k, scaled, NEG_INF)
    e = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    keep_p = _bisect_topp_mask(probs, top_p)
    final = torch.where(keep_p, masked, NEG_INF)
    return torch.argmax(final + gumbel, dim=-1)


def fused_mtp_chain_reference(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    final_norm: torch.Tensor,  # [H]
    heads: HeadPack,
    tables: torch.Tensor,  # [n, Vt, H]
    last_hidden: torch.Tensor,  # [1, H]
    code0_embed: torch.Tensor,  # [1, H]
    gumbel: Optional[torch.Tensor],  # [n, 1, V] f32
    temperature: float,
    top_k: int,
    top_p: float,
    cache_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the chain kernel; same contract."""
    n = heads.q.shape[0]
    L, nk, d = fw.wqkv.shape[0], cfg.num_kv_heads, cfg.head_dim
    device = last_hidden.device
    kc = torch.zeros((L, 1, nk, n + 2, d), dtype=cache_dtype, device=device)
    vc = torch.zeros_like(kc)
    x, _, _ = fused_decode_step_reference(cfg, fw, last_hidden.float(), 0, kc, vc)
    x, _, _ = fused_decode_step_reference(cfg, fw, code0_embed.float(), 1, kc, vc)
    fn = final_norm.float()
    subs = []
    ssum = torch.zeros((1, cfg.hidden_size), dtype=torch.float32, device=device)
    for j in range(n):
        hp = _rms(x, fn, cfg.rms_norm_eps)
        logits = _gemv(hp, heads.q[j], heads.scale[j])  # [1, V]
        sub = gumbel_topk_topp_sample(
            logits, None if gumbel is None else gumbel[j], temperature, top_k, top_p
        )
        subs.append(sub)
        emb = tables[j][sub].float()  # [1, H]
        ssum = ssum + emb
        if j < n - 1:
            x, _, _ = fused_decode_step_reference(cfg, fw, emb, 2 + j, kc, vc)
    return torch.stack(subs, dim=1).to(torch.int32), ssum


def fused_mtp_chain(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    final_norm: torch.Tensor,
    heads: HeadPack,
    tables: torch.Tensor,
    last_hidden: torch.Tensor,
    code0_embed: torch.Tensor,
    gumbel: Optional[torch.Tensor],
    temperature: float,
    top_k: int,
    top_p: float,
    cache_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole sub-code chain, prefix included.

    Returns (subcodes [1, n] int32, sub_sum [1, H] float32).  ``gumbel`` may
    be None under greedy decoding (temperature <= 0)."""
    if last_hidden.device.type == "cpu":
        return fused_mtp_chain_reference(
            cfg, fw, final_norm, heads, tables, last_hidden, code0_embed, gumbel,
            temperature, top_k, top_p, cache_dtype,
        )
    return _launch_chain(
        fused_mtp_chain, "qtts_mtp_chain", cfg, fw, final_norm, heads, tables, last_hidden,
        code0_embed, gumbel, temperature, top_k, top_p, cache_dtype,
    )


class _ChainEntry:
    """The argument structs, scratch and 17-slot caches of one (packs, cache
    dtype) for a B=1 chain entry on one stream of one thread: built once,
    then a call sets its inputs, outputs and knobs (two threads, such as a
    pool's admissions, never share one).  ``plan``: the persistent chain's
    (K2, K3), else None."""

    def __init__(self, cfg, fw, heads, tables, cache_dtype, device, planned):
        from ._build import ChainArgs

        n, V, H = heads.q.shape
        T = n + 2
        self.kc = torch.empty((fw.wqkv.shape[0], 1, cfg.num_kv_heads, T, cfg.head_dim),
                              dtype=cache_dtype, device=device)
        self.vc = torch.empty_like(self.kc)
        self.w, self.s, self.scratch = step_structs(cfg, fw, T, device)
        self.buf = torch.empty(2 * H + V, dtype=torch.float32, device=device)
        x, x_in, logits = torch.split(self.buf, [H, H, V])
        self.logits = logits
        # the launch-per-op chains' head tickets
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        a = ChainArgs()
        a.heads, a.head_scales = heads.q.data_ptr(), heads.scale.data_ptr()
        a.tables, a.x, a.x_in, a.logits = tables.data_ptr(), x.data_ptr(), x_in.data_ptr(), logits.data_ptr()
        a.counter, a.k_cache, a.v_cache = self.counter.data_ptr(), self.kc.data_ptr(), self.vc.data_ptr()
        a.cache_bf16, a.n, a.V, a.Vt = int(cache_dtype == torch.bfloat16), n, V, tables.shape[1]
        a.heads_bf16 = int(heads.q.dtype == torch.bfloat16)
        self.args = a
        self.plan = persistent.device_plan(cfg, device, head_rows=V, unit_bytes=unit_bytes(fw),
                                           head_bytes=heads.q.element_size()) if planned else None


_CHAIN_ENTRIES: "OrderedDict[tuple, _ChainEntry]" = OrderedDict()
_MAX_ENTRIES = 16


def _chain_entry(entry: str, cfg, fw, heads, tables, cache_dtype, device) -> _ChainEntry:
    """The cached entry of these tensors, keyed by every pointer it holds."""
    tensors = (*fw, *heads, tables)
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (entry, cfg, cache_dtype, device, stream, threading.get_ident(), fw.wqkv.dtype,
           heads.q.dtype, *(t.data_ptr() for t in tensors))
    hit = _CHAIN_ENTRIES.get(key)
    if hit is None:
        hit = _ChainEntry(cfg, fw, heads, tables, cache_dtype, device,
                          planned=not entry.endswith("_multi"))
        _CHAIN_ENTRIES[key] = hit
        while len(_CHAIN_ENTRIES) > _MAX_ENTRIES:
            _CHAIN_ENTRIES.popitem(last=False)
    return hit


def _check_chain_units(what: str, fw, heads, cache_dtype, bf16_ok: bool) -> None:
    """A chain kernel's units and heads: int8 or int4 units with int8 or
    bf16 heads, or bf16 units and heads where the kernel takes them
    (``bf16_ok``: K3, K5).  A bf16 trunk's chain runs on a float32 cache."""
    if heads.q.dtype not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(f"{what}: {heads.q.dtype} heads: the chains take int8 and bf16")
    if fw.wqkv.dtype == torch.bfloat16:
        if heads.q.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"{what}: {heads.q.dtype} heads on bf16 units: a bf16 trunk's chain takes bf16 "
                "heads (the unquantized config's raw heads)")
        if not bf16_ok:
            raise NotImplementedError(
                f"{what}: bf16 units run the streamed chain K3 at B=1 (the JAX residency gate "
                "refuses bf16 trunks); bf16 in K2: ROADMAP item K1v-b / K2v")
        if cache_dtype != torch.float32:
            raise ValueError(f"{what}: a bf16 trunk's chain runs on K3's float32 cache")


def _launch_chain(wrapper, entry: str, cfg, fw, final_norm, heads, tables, last_hidden,
                  code0_embed, gumbel, temperature, top_k, top_p, cache_dtype):
    """Launch a B=1 chain entry (``qtts_mtp_chain``: K2, and
    ``qtts_mtp_chain_streamed``: K3, persistent, each with its plan; the
    ``_multi`` entries: the launch-per-op chains) on CUDA tensors, counting
    the launch on ``wrapper``."""
    what = wrapper.__name__
    if last_hidden.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {last_hidden.device}")
    from ._build import check, load_kernels

    n, V, H = heads.q.shape
    greedy = temperature <= 0.0
    if gumbel is None and not greedy:
        raise ValueError("sampled chain needs Gumbel noise [n, 1, V]")
    if tables.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"embedding tables of dtype {tables.dtype}: only bf16 tables run on the card "
            "(other dtypes: ROADMAP item K2v)"
        )
    device = last_hidden.device
    planned = not entry.endswith("_multi")  # the _multi chains take int8 only
    _check_chain_units(what, fw, heads, cache_dtype, entry == "qtts_mtp_chain_streamed")
    if not planned and (fw.wqkv.dtype != torch.int8 or heads.q.dtype != torch.int8):
        raise NotImplementedError(f"{what}: the launch-per-op chain takes int8 units and heads")
    e = _chain_entry(entry, cfg, fw, heads, tables, cache_dtype, device)
    _check_cuda_inputs(fw, e.kc, e.vc, bf16_units=entry == "qtts_mtp_chain_streamed",
                       int4_units=planned)
    for t in (heads.q, heads.scale, tables, final_norm) + (() if greedy else (gumbel,)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous and on CUDA")
    if any(t.data_ptr() % 16 for t in heads):
        raise ValueError(f"{what}: the heads must be 16-byte aligned")
    lib = load_kernels()
    subcodes = torch.empty(n, dtype=torch.int32, device=device)
    sub_sum = torch.empty(H, dtype=torch.float32, device=device)
    lh = last_hidden.float().reshape(-1).contiguous()
    c0 = code0_embed.float().reshape(-1).contiguous()
    # converted on every call: the entry is keyed by pointers only, and a
    # later model's norm may come to lie at the same address
    fn = final_norm.float().contiguous()
    noise = e.logits if greedy else gumbel.float().contiguous()
    a = e.args
    a.gumbel, a.last_hidden, a.code0_embed = noise.data_ptr(), lh.data_ptr(), c0.data_ptr()
    a.final_norm = fn.data_ptr()
    a.subcodes, a.sub_sum = subcodes.data_ptr(), sub_sum.data_ptr()
    a.temperature, a.top_k, a.top_p = clamp_temperature(temperature), int(top_k), float(top_p)
    a.greedy = int(greedy)
    stream = torch.cuda.current_stream(device).cuda_stream
    wrapper.launches += 1
    if e.plan is None:
        err = getattr(lib, entry)(e.w, e.s, a, stream)
    else:
        err = getattr(lib, entry)(e.w, e.s, e.plan.struct, a, stream)
    check(err, what)
    return subcodes.reshape(1, n), sub_sum.reshape(1, H)


fused_mtp_chain.launches = 0  # chain launches, for chip_smoke.py's path check


# ---------------------------------------------------------------------------
# Kernel K5: the batched chain
# ---------------------------------------------------------------------------

Knob = Union[float, int, Sequence]


def row_knobs(temperature: Knob, top_k: Knob, top_p: Knob, B: int) -> List[Tuple[float, int, float]]:
    """Per-row (temperature, top_k, top_p) from scalars or length-B sequences."""

    def rows(v, cast):
        if isinstance(v, (list, tuple)):
            vals = [cast(x) for x in v]
            if len(vals) != B:
                raise ValueError(f"per-row knob of length {len(vals)} for {B} rows")
            return vals
        return [cast(v)] * B

    return list(zip(rows(temperature, float), rows(top_k, int), rows(top_p, float)))


def fused_mtp_chain_batched_reference(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    final_norm: torch.Tensor,  # [H]
    heads: HeadPack,
    tables: torch.Tensor,  # [n, Vt, H]
    last_hidden: torch.Tensor,  # [B, H]
    code0_embed: torch.Tensor,  # [B, H]
    gumbel: Optional[torch.Tensor],  # [n, B, V] f32 (None when every row is greedy)
    temperature: Knob,  # scalar or [B]
    top_k: Knob,
    top_p: Knob,
    cache_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K5; same contract.  Row b samples with
    row b's knobs and noise, exactly as the B=1 chain samples."""
    n = heads.q.shape[0]
    B = last_hidden.shape[0]
    knobs = row_knobs(temperature, top_k, top_p, B)
    L, nk, d = fw.wqkv.shape[0], cfg.num_kv_heads, cfg.head_dim
    device = last_hidden.device
    kc = torch.zeros((L, B, nk, n + 2, d), dtype=cache_dtype, device=device)
    vc = torch.zeros_like(kc)
    x, _, _ = fused_decode_step_batched_reference(cfg, fw, last_hidden.float(), 0, kc, vc)
    x, _, _ = fused_decode_step_batched_reference(cfg, fw, code0_embed.float(), 1, kc, vc)
    fn = final_norm.float()
    subs = []
    ssum = torch.zeros((B, cfg.hidden_size), dtype=torch.float32, device=device)
    for j in range(n):
        hp = _rms(x, fn, cfg.rms_norm_eps)
        logits = _gemv_rows(hp, heads.q[j], heads.scale[j])  # [B, V]
        sub = torch.cat([
            gumbel_topk_topp_sample(
                logits[b : b + 1], None if t <= 0.0 else gumbel[j, b : b + 1], t, k, p
            )
            for b, (t, k, p) in enumerate(knobs)
        ])
        subs.append(sub)
        emb = tables[j][sub].float()  # [B, H]
        ssum = ssum + emb
        if j < n - 1:
            x, _, _ = fused_decode_step_batched_reference(cfg, fw, emb, 2 + j, kc, vc)
    return torch.stack(subs, dim=1).to(torch.int32), ssum


def fused_mtp_chain_batched(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    final_norm: torch.Tensor,
    heads: HeadPack,
    tables: torch.Tensor,
    last_hidden: torch.Tensor,
    code0_embed: torch.Tensor,
    gumbel: Optional[torch.Tensor],
    temperature: Knob,
    top_k: Knob,
    top_p: Knob,
    cache_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole sub-code chain of B rows, prefix included.

    Returns (subcodes [B, n] int32, sub_sum [B, H] float32).  The knobs are
    host scalars or length-B sequences; ``gumbel`` ([n, B, V], any strides
    with a contiguous last axis) may be None when every row is greedy.
    More than ``persistent.LAUNCH_ROWS`` rows run as
    :func:`~.persistent.row_launches` launches of consecutive rows (on the
    CPU the plain version on each launch's rows), each on its rows' inputs,
    knobs and the slice [:, rows] of the one noise draw: each row is what a
    call of at most LAUNCH_ROWS rows gives it, bit for bit."""
    knobs = row_knobs(temperature, top_k, top_p, last_hidden.shape[0])
    outs = []
    for r0, nb in persistent.row_launches(last_hidden.shape[0]):
        rows = slice(r0, r0 + nb)
        temp, k, p = (list(v) for v in zip(*knobs[rows]))
        outs.append(_chain_rows(cfg, fw, final_norm, heads, tables, last_hidden[rows],
                                code0_embed[rows], None if gumbel is None else gumbel[:, rows],
                                temp, k, p, cache_dtype))
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _chain_rows(cfg, fw, final_norm, heads, tables, last_hidden, code0_embed, gumbel,
                temperature, top_k, top_p, cache_dtype):
    """One launch of K5 (on the CPU its plain version) on these rows."""
    if last_hidden.device.type == "cpu":
        return fused_mtp_chain_batched_reference(
            cfg, fw, final_norm, heads, tables, last_hidden, code0_embed, gumbel,
            temperature, top_k, top_p, cache_dtype,
        )
    return _launch_chain_batched(
        fused_mtp_chain_batched, "qtts_mtp_chain_batched", cfg, fw, final_norm, heads, tables,
        last_hidden, code0_embed, gumbel, temperature, top_k, top_p, cache_dtype,
    )


class _BatchChainEntry:
    """The argument structs, scratch, [L, B, nk, n + 2, d] caches and plan of
    one (packs, B, cache dtype) for a batched chain entry on one stream of
    one thread: built once, then a call sets its inputs, outputs and knobs.
    ``plan``: the persistent chain's (K5), else None."""

    def __init__(self, cfg, fw, heads, tables, B, cache_dtype, device, planned):
        from ._build import ChainBatchArgs

        n, V, H = heads.q.shape
        T = n + 2
        self.kc = torch.empty((fw.wqkv.shape[0], B, cfg.num_kv_heads, T, cfg.head_dim),
                              dtype=cache_dtype, device=device)
        self.vc = torch.empty_like(self.kc)
        self.w, self.s, self.scratch = batch_structs(cfg, fw, B, T, device)
        self.buf = torch.empty(B * (2 * H + V), dtype=torch.float32, device=device)
        x, x_in, self.logits = torch.split(self.buf, [B * H, B * H, B * V])
        a = ChainBatchArgs()
        a.heads, a.head_scales, a.tables = heads.q.data_ptr(), heads.scale.data_ptr(), tables.data_ptr()
        a.x, a.x_in, a.logits = x.data_ptr(), x_in.data_ptr(), self.logits.data_ptr()
        a.k_cache, a.v_cache = self.kc.data_ptr(), self.vc.data_ptr()
        a.cache_bf16, a.B, a.n, a.V = int(cache_dtype == torch.bfloat16), B, n, V
        a.Vt = tables.shape[1]
        a.heads_bf16 = int(heads.q.dtype == torch.bfloat16)
        self.args = a
        self.plan = persistent.device_plan(cfg, device, head_rows=V, batch=B,
                                           unit_bytes=unit_bytes(fw),
                                           head_bytes=heads.q.element_size()) if planned else None


def _batch_chain_entry(entry: str, cfg, fw, heads, tables, B, cache_dtype,
                       device) -> _BatchChainEntry:
    """The cached entry of these tensors at B rows, keyed by every pointer it holds."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (entry, cfg, B, cache_dtype, device, stream, threading.get_ident(), fw.wqkv.dtype,
           heads.q.dtype, *(t.data_ptr() for t in (*fw, *heads, tables)))
    hit = _CHAIN_ENTRIES.get(key)
    if hit is None:
        hit = _BatchChainEntry(cfg, fw, heads, tables, B, cache_dtype, device,
                               planned=not entry.endswith("_multi"))
        _CHAIN_ENTRIES[key] = hit
        while len(_CHAIN_ENTRIES) > _MAX_ENTRIES:
            _CHAIN_ENTRIES.popitem(last=False)
    return hit


def _launch_chain_batched(wrapper, entry: str, cfg, fw, final_norm, heads, tables, last_hidden,
                          code0_embed, gumbel, temperature, top_k, top_p, cache_dtype):
    """Launch a batched chain entry (``qtts_mtp_chain_batched``: K5,
    persistent, with its plan; ``qtts_mtp_chain_batched_multi``: the
    launch-per-op chain) on CUDA tensors, counting the launch on ``wrapper``."""
    what = wrapper.__name__
    if last_hidden.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {last_hidden.device}")
    from ._build import check, load_kernels

    n, V, H = heads.q.shape
    B = last_hidden.shape[0]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"{what} takes 1..{MAX_BATCH} rows a launch, got {B}")
    knobs = row_knobs(temperature, top_k, top_p, B)
    greedy = [t <= 0.0 for t, _, _ in knobs]
    if gumbel is None and not all(greedy):
        raise ValueError("sampled rows need Gumbel noise [n, B, V]")
    if tables.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"embedding tables of dtype {tables.dtype}: only bf16 tables run on the card "
            "(other dtypes: ROADMAP item K2v)"
        )
    device = last_hidden.device
    planned = entry == "qtts_mtp_chain_batched"  # the _multi chain takes int8 only
    _check_chain_units(what, fw, heads, cache_dtype, planned)
    if not planned and (fw.wqkv.dtype != torch.int8 or heads.q.dtype != torch.int8):
        raise NotImplementedError(f"{what}: the launch-per-op chain takes int8 units and heads")
    e = _batch_chain_entry(entry, cfg, fw, heads, tables, B, cache_dtype, device)
    _check_cuda_inputs(fw, e.kc, e.vc, bf16_units=planned, int4_units=planned)
    for t in (heads.q, heads.scale, tables, final_norm):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous and on CUDA")
    if any(t.data_ptr() % 16 for t in heads):
        raise ValueError(f"{what}: the heads must be 16-byte aligned")
    lib = load_kernels()
    subs = torch.empty((B, n), dtype=torch.int32, device=device)
    sub_sum = torch.empty((B, H), dtype=torch.float32, device=device)
    # converted on every call: the entry is keyed by pointers only, and a
    # later model's norm may come to lie at the same address
    fn = final_norm.float().contiguous()
    lh = last_hidden.float().contiguous()
    c0 = code0_embed.float().contiguous()
    if all(greedy):
        noise, strides = e.logits, (0, 0)
    else:
        noise = gumbel if gumbel.dtype == torch.float32 else gumbel.float()
        if noise.shape != (n, B, V) or noise.stride(2) != 1 or not noise.is_cuda:
            raise ValueError(f"{what}: noise must be [n, B, V] on CUDA with a contiguous last "
                             "axis")
        strides = (noise.stride(0), noise.stride(1))
    pad = [0] * (MAX_BATCH - B)
    a = e.args
    a.final_norm, a.noise = fn.data_ptr(), noise.data_ptr()
    a.noise_step_stride, a.noise_row_stride = strides
    a.last_hidden, a.code0_embed = lh.data_ptr(), c0.data_ptr()
    a.subcodes, a.sub_sum = subs.data_ptr(), sub_sum.data_ptr()
    a.temperature = (ctypes.c_float * MAX_BATCH)(*[clamp_temperature(t) for t, _, _ in knobs], *pad)
    a.top_k = (ctypes.c_int32 * MAX_BATCH)(*[k for _, k, _ in knobs], *pad)
    a.top_p = (ctypes.c_float * MAX_BATCH)(*[p for _, _, p in knobs], *pad)
    a.greedy = (ctypes.c_int32 * MAX_BATCH)(*[int(g) for g in greedy], *pad)
    stream = torch.cuda.current_stream(device).cuda_stream
    wrapper.launches += 1
    if e.plan is None:
        err = getattr(lib, entry)(e.w, e.s, a, stream)
    else:
        err = getattr(lib, entry)(e.w, e.s, e.plan.struct, a, stream)
    check(err, what)
    return subs, sub_sum


fused_mtp_chain_batched.launches = 0  # chain launches, for chip_smoke.py's path check
