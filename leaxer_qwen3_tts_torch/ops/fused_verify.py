"""Kernel K6: the speculative verify step, S candidate inputs per stream
through every layer in one pass.

Port of ``leaxer_qwen3_tts_tpu/ops/fused_verify.py::fused_verify_step``,
generalised from one stream to B streams: candidate s of stream b runs at
position ``pos[b] + s`` and writes that slot of cache row b, and attends over
slots 0..pos[b] + s (the cache before ``pos[b]`` plus the new slots of
candidates 0..s).  That is the JAX package's S=K verify at B=1 and its
per-row-fill ``transformer_forward`` at B>1.  The result is the
PRE-final-norm hidden state, float32; the caches are updated IN PLACE.

Row (b, s) is the function one decode step of stream b at ``pos[b] + s``
computes after candidates 0..s-1 have been stepped, so the plain version,
:func:`fused_verify_step_reference`, is exactly those S steps of kernel K4's
plain version, and the CUDA kernel (``csrc/fused_verify.cu``: one persistent
cooperative launch per pass, K4's transport on a plan of B * S rows) does
K4's arithmetic for every row, op for op.  On a CUDA tensor
:func:`fused_verify_step` launches the kernel or raises; on a CPU tensor it
runs the plain version.  The units are int8, bf16 (the unquantized
config's bits=16 pack) or int4 (group-128 scales); a row equals the K1 / K4
steps of its unit type bit for bit.  At the 1.7B widths a bf16 verify plan
takes 48 KB ring slots (``persistent.make_plan``).  An int8 cache comes
with its scales (the JAX kernel's ``kvq`` mode): the slot-write phase
quantizes each row's new slot as K4 does and writes its scales before the
phase's barrier, and the scales are updated in place and returned after
the caches.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import torch

from ..config import TransformerConfig
from . import persistent
from ._build import MAX_BATCH
from .fused_step import (
    _MAX_ENTRIES,
    FusedStepWeights,
    _cache_rows,
    _check_cuda_inputs,
    _row_slice,
    _with_scales,
    batch_structs,
    fused_decode_step_batched_reference,
    scale_ptrs,
    unit_bytes,
)

MIN_S, MAX_S = 2, 8  # candidates per stream, as the JAX kernel takes them


def verify_starts(pos, B: int, S: int, T: int, device) -> torch.Tensor:
    """[B] int64 first write slots, clamped into [0, T - S] like the JAX
    wrapper (positions pos..pos+S-1 must fit in the bucket)."""
    if isinstance(pos, torch.Tensor):
        return torch.clamp(pos.to(device=device, dtype=torch.long).reshape(B), 0, T - S)
    return torch.full((B,), min(max(int(pos), 0), T - S), dtype=torch.long, device=device)


def _check_shapes(x: torch.Tensor, k_cache: torch.Tensor,
                  row0: Optional[int] = None) -> Tuple[int, int, int]:
    """B, S and T of a pass of ``x`` on the whole cache, or (``row0``: a
    launch's) on its cache rows row0 .. row0 + B - 1."""
    B, S, _ = x.shape
    T = k_cache.shape[3]
    if not MIN_S <= S <= MAX_S:
        raise ValueError(f"fused_verify_step takes {MIN_S}..{MAX_S} candidates, got {S}")
    rows_ok = k_cache.shape[1] == B if row0 is None else 0 <= row0 <= k_cache.shape[1] - B
    if not rows_ok or T < S:
        raise ValueError(f"fused_verify_step: cache {tuple(k_cache.shape)} for {B} x {S} rows")
    return B, S, T


def fused_verify_step_reference(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    x: torch.Tensor,  # [B, S, H]
    pos,  # [B] int tensor, or one int for every stream
    k_cache: torch.Tensor,  # [L, B, nk, T, d], updated in place
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # float32 [L, B, nk, T] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> tuple:
    """Plain PyTorch version of kernel K6; same contract: the S candidates
    stepped one after another through K4's plain version."""
    B, S, T = _check_shapes(x, k_cache)
    start = verify_starts(pos, B, S, T, x.device)
    rows = [
        fused_decode_step_batched_reference(cfg, fw, x[:, s], start + s, k_cache, v_cache,
                                            k_scale, v_scale)[0]
        for s in range(S)
    ]
    return _with_scales((torch.stack(rows, dim=1), k_cache, v_cache), k_scale, v_scale)


class _VerifyEntry:
    """The argument structs, scratch and plan (of B * S rows) of one (pack,
    B, S, cache bucket, cache dtype) on one stream of one thread."""

    def __init__(self, cfg: TransformerConfig, fw: FusedStepWeights, B: int, S: int, T: int,
                 device):
        self.w, self.s, self.scratch = batch_structs(cfg, fw, B * S, T, device)
        self.plan = persistent.device_plan(cfg, device, batch=B * S, unit_bytes=unit_bytes(fw))


_ENTRIES: "OrderedDict[tuple, _VerifyEntry]" = OrderedDict()


def _verify_entry(cfg: TransformerConfig, fw: FusedStepWeights, B: int, S: int, T: int, dtype,
                  device) -> _VerifyEntry:
    """The cached entry of this pack at B x S rows, keyed by every pointer it
    holds (nothing derived from a tensor's contents is cached)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (cfg, B, S, T, dtype, device, stream, threading.get_ident(), fw.wqkv.dtype,
           *(t.data_ptr() for t in fw))
    entry = _ENTRIES.get(key)
    if entry is None:
        entry = _VerifyEntry(cfg, fw, B, S, T, device)
        _ENTRIES[key] = entry
        while len(_ENTRIES) > _MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
    return entry


def fused_verify_step(
    cfg: TransformerConfig,
    fw: FusedStepWeights,
    x: torch.Tensor,  # [B, S, H]
    pos,  # [B] int tensor on x's device (per stream), or one int (every stream)
    k_cache: torch.Tensor,  # [L, B, nk, T, d]
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # float32 [L, B, nk, T] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> tuple:
    """One verify pass of S candidates per stream over all layers.

    Returns (x_out [B, S, H] float32 pre-final-norm, k_cache, v_cache[,
    k_scale, v_scale]); the caches (and scales) are updated in place.  Each
    stream's start is clamped into [0, T - S].  A start tensor stays on the
    device: the kernel reads it, so the pass needs no host sync.  Past
    ``persistent.LAUNCH_ROWS`` rows the streams run as
    :func:`~.persistent.row_launches` launches of whole streams (a stream's
    cache row and its candidates in one launch; on the CPU the plain version
    on each launch's streams): each row is what a pass of at most
    LAUNCH_ROWS rows gives it, bit for bit."""
    B, S, _ = _check_shapes(x, k_cache)
    outs = [_verify_rows(cfg, fw, x[r0 : r0 + nb], _row_slice(pos, r0, nb), k_cache, v_cache,
                         k_scale, v_scale, r0)
            for r0, nb in persistent.row_launches(B, S)]
    x_out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return _with_scales((x_out, k_cache, v_cache), k_scale, v_scale)


def _verify_rows(cfg, fw, x, pos, k_cache, v_cache, k_scale, v_scale, row0: int) -> torch.Tensor:
    """x_out [b, S, H] of one launch of K6: ``x``'s streams on cache rows
    row0 ..; on the CPU the plain version on those cache rows."""
    if x.device.type == "cpu":
        caches = (k_cache, v_cache, k_scale, v_scale)
        if row0 or x.shape[0] != k_cache.shape[1]:
            caches = _cache_rows(caches, row0, x.shape[0])
        return fused_verify_step_reference(cfg, fw, x, pos, *caches)[0]
    return launch_verify(fused_verify_step, "qtts_verify_step", cfg, fw, x, pos, k_cache,
                         v_cache, k_scale, v_scale, row0)[0]


def launch_verify(wrapper, entry: str, cfg: TransformerConfig, fw: FusedStepWeights,
                  x: torch.Tensor, pos, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  k_scale=None, v_scale=None, row0: int = 0):
    """Launch a verify entry (``qtts_verify_step``: K6, persistent, with its
    cached entry, int8, bf16 or int4 units, on cache rows row0 .. row0 + B -
    1; ``qtts_verify_step_multi``: the launch-per-op pass, int8 units on a
    bf16 or float32 cache of B rows) on CUDA tensors, counting the launch on
    ``wrapper``."""
    what = wrapper.__name__
    B, S, T = _check_shapes(x, k_cache, row0)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if B * S > MAX_BATCH:
        raise ValueError(f"{what} takes at most {MAX_BATCH} rows a launch, got {B} x {S}")
    planned = entry == "qtts_verify_step"
    if not planned and (k_scale is not None or k_cache.shape[1] != B):
        raise NotImplementedError(f"{what}: the launch-per-op pass takes no int8 cache, and a "
                                  "cache of its B streams")
    _check_cuda_inputs(fw, k_cache, v_cache, planned, k_scale, v_scale, window=True,
                       int4_units=planned)
    from ._build import check, load_kernels

    lib = load_kernels()
    if planned:
        e = _verify_entry(cfg, fw, B, S, T, k_cache.dtype, x.device)
        w, s, scratch = e.w, e.s, None
    else:
        w, s, scratch = batch_structs(cfg, fw, B * S, T, x.device)
    H = cfg.hidden_size
    x_in = x.float().reshape(B * S, H).contiguous()
    x_out = torch.empty((B * S, H), dtype=torch.float32, device=x.device)
    if isinstance(pos, torch.Tensor):
        pos_dev = pos.to(dtype=torch.long).reshape(B).contiguous()
        if pos_dev.device != x.device:
            raise ValueError(f"{what}: starts must be on the device")
        pos_ptr, pos_host = pos_dev.data_ptr(), 0
    else:
        pos_ptr, pos_host = None, min(max(int(pos), 0), T - S)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    caches = (x_in.data_ptr(), x_out.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    args = (int(k_cache.dtype == torch.bfloat16), B, S, T, pos_ptr, pos_host)
    wrapper.launches += 1
    if planned:
        err = lib.qtts_verify_step(w, s, e.plan.struct, *caches, *scale_ptrs(k_scale, v_scale),
                                   *args, k_cache.shape[1], row0, stream)
    else:
        err = lib.qtts_verify_step_multi(w, s, *caches, *args, stream)
    check(err, what)
    del scratch  # enqueued; the caching allocator orders reuse on the stream
    return _with_scales((x_out.reshape(B, S, H), k_cache, v_cache), k_scale, v_scale)


fused_verify_step.launches = 0  # kernel launches, for chip_smoke.py's path check
