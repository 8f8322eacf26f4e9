"""Kernel K3: the B=1 MTP chain with a streamed trunk and a float32 KV scratch.

Port of ``leaxer_qwen3_tts_tpu/ops/fused_mtp_stream.py::fused_mtp_chain_streamed``,
the chain the JAX package runs at B=1 when the trunk does not pass the
resident chain K2's gate: an int8 trunk too large for it (the 1.7B family:
302 MB), and every bf16 trunk (the unquantized config, both presets; bf16
units and heads with scales of one).  It computes what K2
computes, with the JAX kernel's float32 17-slot KV scratch whatever the
model dtype: at a bf16 model it equals K2 with a float32 cache, not K2 at
the config dtype.  On the TPU the trunk streams through a DMA ring whose next
position's reads start behind the current one's work; on Hopper K3
(``csrc/fused_mtp_stream.cu``) is one cooperative launch of K2's persistent
chain on a float32 cache, whose TMA weight ring runs through every trunk
pass and head of the chain (the plan of ``ops/persistent.py`` at the 1.7B
widths), so the next pass's first stages load while block 0 samples.

On a CUDA tensor :func:`fused_mtp_chain_streamed` launches the kernel; on a
CPU tensor it runs :func:`fused_mtp_chain_streamed_reference`, K2's plain
version with a float32 cache.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import TransformerConfig
from .fused_mtp import RESIDENT_MAX_BYTES, HeadPack, _launch_chain, fused_mtp_chain_reference
from .fused_step import FusedStepWeights

N_UNIT = 1024  # the JAX pack's unit width (output columns of one weight unit)
_RING = 4  # unit slots of the JAX kernel's DMA ring (its default depth)
# VMEM beyond the streamed slots: activations, caches, the embedding row block
_STREAM_FIXED = 8 * 1024 * 1024


def _unit_count(fw: FusedStepWeights) -> int:
    """Units per layer of the JAX pack of this trunk (qkv, wo, gate/up, wd)."""
    H, A = fw.attn_norm.shape[-1], fw.wqkv.shape[1]
    per_byte = 2 if fw.wqkv.dtype == torch.uint8 else 1  # int4 rows: two columns a byte
    qd, I = fw.wo.shape[2] * per_byte, fw.wd.shape[2] * per_byte
    return A // N_UNIT + (qd // H) * (H // N_UNIT) + fw.wgu.shape[1] // N_UNIT + (
        I // H) * (H // N_UNIT)


def supports_stream(fw: Optional[FusedStepWeights], V: int) -> bool:
    """The JAX package's gate of the streamed chain: the ring's units (their
    bytes by the units' type: int4 halves int8's), all the scales (H / 128
    rows per unit at int4) and the double buffer
    of the [H, V] heads (reckoned as int8, as JAX does) within the
    resident-VMEM budget (the trunk itself never needs to fit)."""
    if fw is None:
        return False
    L, H = fw.wqkv.shape[0], fw.attn_norm.shape[-1]
    U = _unit_count(fw)
    int4 = fw.wqkv.dtype == torch.uint8  # JAX's [H/2, N_UNIT] units, H/128 scale rows
    unit_b = H * N_UNIT * fw.wqkv.element_size() // (2 if int4 else 1)
    scales_b = L * U * N_UNIT * 4 * (H // 128 if int4 else 1)
    heads_b = 2 * H * V
    return _RING * unit_b + scales_b + heads_b + _STREAM_FIXED <= RESIDENT_MAX_BYTES


def fused_mtp_chain_streamed_reference(
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the chain with a float32 cache."""
    return fused_mtp_chain_reference(
        cfg, fw, final_norm, heads, tables, last_hidden, code0_embed, gumbel, temperature,
        top_k, top_p, cache_dtype=torch.float32,
    )


def fused_mtp_chain_streamed(
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the whole sub-code chain, prefix included, with a float32 cache.

    Returns (subcodes [1, n] int32, sub_sum [1, H] float32).  ``gumbel`` may
    be None under greedy decoding (temperature <= 0)."""
    if last_hidden.device.type == "cpu":
        return fused_mtp_chain_streamed_reference(
            cfg, fw, final_norm, heads, tables, last_hidden, code0_embed, gumbel,
            temperature, top_k, top_p,
        )
    return _launch_chain(
        fused_mtp_chain_streamed, "qtts_mtp_chain_streamed", cfg, fw, final_norm, heads,
        tables, last_hidden, code0_embed, gumbel, temperature, top_k, top_p, torch.float32,
    )


fused_mtp_chain_streamed.launches = 0  # chain launches, for chip_smoke.py's path check
