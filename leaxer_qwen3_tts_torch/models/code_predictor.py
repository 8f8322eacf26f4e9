"""Code predictor: the MTP head emitting sub-codebooks 1..15 per frame.

Port of ``leaxer_qwen3_tts_tpu/models/code_predictor.py``.  Contract: the
input sequence starts [talker_last_hidden, codec_embed(code0)]; step j emits
logits from its step-indexed head; the token sampled at step j is embedded
with the step-j table and appended for step j+1; the sum of all sub-embeddings
feeds the next talker input.

Paths: the cached path (plain layers, a ``sample_fn`` per step) and, with
a packed ``fused_step`` and the resident chain on (:func:`resident_enabled`:
``cfg.resident``, else ``QTTS_MTP_RESIDENT`` as the JAX package reads it, else
on), the whole chain as one kernel.  At B=1 the route is the
JAX package's with its TPU defaults: kernel K2
(:func:`~leaxer_qwen3_tts_torch.ops.fused_mtp.fused_mtp_chain`) on the pack
:func:`resident_pack` gives (the primary ``fused_step`` where it passes the
residency gate: the 0.6B int8 and int4 trunks; else the int4
``fused_step_alt`` of ``mtp_quantize="auto"`` where that passes: the 0.6B
chain of an unquantized talker), else kernel K3
(:func:`~leaxer_qwen3_tts_torch.ops.fused_mtp_stream.fused_mtp_chain_streamed`,
float32 KV scratch) when the stream gate passes (the 1.7B trunk) and the
streamed chain is on (:func:`stream_enabled`: ``QTTS_MTP_STREAM``, else on).
At B >= 2 it is kernel K5 (past 32 rows as launches of at most 32)
(:func:`~leaxer_qwen3_tts_torch.ops.fused_mtp.fused_mtp_chain_batched`),
which takes every pack, on :func:`resident_pack`'s pack at that batch (the
int4 ``fused_step_alt`` where the primary fails the gate, JAX's B=32
serving pack) or else the primary.  A bf16 trunk (the unquantized config)
fails the residency gate, as in JAX, so its B=1 chain is K3; wherever the
B=1 chain is K3 (bf16 trunks, the 1.7B trunks) K5 runs on K3's float32
cache (:func:`chain_cache_dtype`), so that each row equals K3 on it.  Under a
tensor-parallel mesh with a ``fused_tp`` pack (the engine attaches one where
the JAX package's ``supports_tp_resident`` passes) a B=1 chain is kernel K10
(:func:`predict_subcodes_tp_resident`), ahead of every other route, as in
the JAX package.  On a CUDA device a chain the kernels cannot take raises;
only the CPU runs the cached path.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from ..config import CodePredictorConfig
from ..ops.fused_mtp import (
    fused_mtp_chain,
    fused_mtp_chain_batched,
    pack_heads,
    supports_resident,
)
from ..ops.fused_mtp_stream import fused_mtp_chain_streamed, supports_stream
from ..ops.fused_mtp_tp import fused_mtp_chain_tp
from ..ops.fused_step import pack_fused_weights, supports
from ..ops.quant import QuantizedLinear, dense
from ..runtime.sampling import SamplingParams
from .layers import _normal, init_kv_cache, init_transformer_params, transformer_forward


def init_code_predictor_params(cfg: CodePredictorConfig, gen: torch.Generator, device) -> dict:
    if cfg.head_mode != "per_step":
        raise NotImplementedError("the shared-head topology is not ported yet (ROADMAP M6)")
    t = cfg.transformer
    h = t.hidden_size
    return {
        "transformer": init_transformer_params(t, gen, device),
        "heads": _normal(gen, (cfg.num_steps, h, cfg.subcode_vocab_size), h ** -0.5,
                         t.torch_dtype, device),
    }


def _head(heads, j: int):
    if isinstance(heads, QuantizedLinear):
        return QuantizedLinear(heads.q[j], heads.scale[j])
    return heads[j]


def prepare_fused_step(cfg: CodePredictorConfig, cp_params: dict, bits: int = 8,
                       alt: bool = False) -> dict:
    """Attach the packed trunk (``fused_step``) and heads (``fused_heads``)
    for the chain kernel when the architecture qualifies: int8 (bits=8,
    quantized or raw params), bf16 (bits=16, raw params) or int4 units
    (bits=4, raw params), the heads as they stand (int8 rows of quantized
    heads, bf16 rows of raw ones).  ``alt=True`` writes the trunk to
    ``fused_step_alt`` instead, heads untouched: the engine's
    ``mtp_quantize="auto"`` int4 trunk, which :func:`resident_pack` takes
    where the primary pack fails the residency gate (JAX's)."""
    if not supports(cfg.transformer) or cfg.head_mode != "per_step":
        return cp_params
    out = dict(cp_params)
    out["fused_step_alt" if alt else "fused_step"] = pack_fused_weights(
        cfg.transformer, cp_params["transformer"]["layers"], bits=bits
    )
    return out if alt else attach_heads(cfg, out)


def attach_heads(cfg: CodePredictorConfig, cp_params: dict) -> dict:
    """The chain kernels' heads (``fused_heads``) packed from ``heads`` as
    they stand: the engine packs them after the last ``quantize_params``,
    whatever the trunk's precision, since the chains read the heads the
    plain path reads (JAX's chains take ``params["heads"]`` at call time)."""
    if cfg.head_mode != "per_step":
        return cp_params
    return dict(cp_params, fused_heads=pack_heads(cp_params["heads"]))


def resident_pack(params: dict, batch: int):
    """The trunk pack the resident chain takes at this batch, or None (JAX
    ``models/code_predictor.py::resident_pack``): the primary ``fused_step``
    where it passes the residency gate at ``batch`` rows, else the int4
    ``fused_step_alt`` where that passes."""
    fw = params.get("fused_step")
    if fw is not None and supports_resident(fw, batch):
        return fw
    alt = params.get("fused_step_alt")
    if alt is not None and supports_resident(alt, batch):
        return alt
    return None


def resident_enabled(cfg: CodePredictorConfig) -> bool:
    """The resident chain's switch, as the JAX package resolves it
    (``models/code_predictor.py::_resident_enabled``): ``cfg.resident`` when
    set, else ``QTTS_MTP_RESIDENT`` (on unless "0"), else on, the JAX
    package's default on its accelerator."""
    if cfg.resident is not None:
        return bool(cfg.resident)
    env = os.environ.get("QTTS_MTP_RESIDENT")
    return True if env is None else env != "0"


def stream_enabled() -> bool:
    """The streamed chain's switch, as the JAX package resolves it
    (``models/code_predictor.py::_stream_enabled``): ``QTTS_MTP_STREAM``
    when set (on unless "0"), else on, the JAX package's default on its
    accelerator."""
    env = os.environ.get("QTTS_MTP_STREAM")
    return True if env is None else env != "0"


def chain_kernel(cfg: CodePredictorConfig, params: dict, rows: int):
    """The wrapper of the kernel that runs a chain of ``rows`` rows (K2, K3
    or K5; on the CPU its plain version), or None for the cached plain path.
    At B=1: K2 when :func:`resident_pack` gives a pack, else K3 on the
    primary pack when the streamed chain is on and it passes the stream
    gate (JAX's ``predict_subcodes``); :func:`chain_pack` says which pack."""
    if not (cfg.impl == "fused" and resident_enabled(cfg) and "fused_step" in params
            and cfg.head_mode == "per_step"):
        return None
    if rows > 1:
        return fused_mtp_chain_batched
    if resident_pack(params, 1) is not None:
        return fused_mtp_chain
    if stream_enabled() and supports_stream(params["fused_step"], cfg.subcode_vocab_size):
        return fused_mtp_chain_streamed
    return None


def chain_pack(params: dict, chain, rows: int = 1):
    """The trunk pack ``chain`` (a :func:`chain_kernel` result) reads at
    ``rows`` rows: K2's and K5's is :func:`resident_pack`'s at that batch (as
    JAX's resident chains take it), K3's and, where no pack passes the gate,
    K5's the primary pack (the port's batched chain runs at any residency:
    ROADMAP Queue 3)."""
    if chain is fused_mtp_chain:
        return resident_pack(params, 1)
    if chain is fused_mtp_chain_batched:
        return resident_pack(params, rows) or params["fused_step"]
    return params["fused_step"]


def chain_cache_dtype(cfg: CodePredictorConfig, params: dict, fw) -> torch.dtype:
    """The KV cache dtype of a K2 or K5 chain on pack ``fw``: K3's float32
    scratch where this engine's B=1 chain is K3 (no pack passes the
    residency gate: the 1.7B trunks, a bf16 trunk without an alt), so that a
    batched row (a pool slot, a spec candidate) equals K3's chain on it bit
    for bit, and on any bf16 trunk; else the model dtype, K2's."""
    if fw.wqkv.dtype == torch.bfloat16 or resident_pack(params, 1) is None:
        return torch.float32
    return cfg.transformer.torch_dtype


def subcode_embed_sum(
    cfg: CodePredictorConfig,
    params: dict,
    pred_embed_tables: torch.Tensor,  # [num_steps, subcode_vocab, H]
    subcodes: torch.Tensor,  # [..., num_steps] int
    rows: int,  # the rows of the chain these codes stand in for
    dtype: torch.dtype,
) -> torch.Tensor:
    """The ``sub_embed_sum`` :func:`predict_subcodes` returns for these
    sub-codes, bit for bit: the chain kernels' float32 running sum
    (``sum = e_0``, then ``sum + e_j`` in step order, as ``csrc/fused_mtp*.cu``
    and their plain versions add), or the cached path's grouping (the first
    n-1 embeddings summed, then the last added), cast to ``dtype``."""
    embs = [pred_embed_tables[j][subcodes[..., j]] for j in range(subcodes.shape[-1])]
    if chain_kernel(cfg, params, rows) is not None:
        total = embs[0].float()
        for e in embs[1:]:
            total = total + e.float()
    else:
        total = torch.stack(embs[:-1]).sum(dim=0) + embs[-1]
    return total.to(dtype)


def predict_subcodes(
    cfg: CodePredictorConfig,
    params: dict,
    pred_embed_tables: torch.Tensor,  # [num_steps, subcode_vocab, H]
    last_hidden: torch.Tensor,  # [B, H]
    code0_embed: torch.Tensor,  # [B, H]
    sample_fn: Callable[[torch.Tensor, int], torch.Tensor],  # (logits [B, V], j) -> [B]
    sp: Optional[SamplingParams] = None,  # enables the chain kernels
    noise_fn: Optional[Callable[[], Optional[torch.Tensor]]] = None,
    mesh=None,  # a tensor-parallel mesh: enables the sharded chain (fused_tp pack)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs the MTP loop for one frame.

    ``noise_fn()`` draws the chain's Gumbel noise ([n, B, V]; None when every
    row is greedy).  Returns (subcodes [B, n] int, sub_embed_sum [B, H] in
    last_hidden's dtype)."""
    t = cfg.transformer
    B, H = last_hidden.shape
    if (cfg.impl == "fused" and mesh is not None and sp is not None and resident_enabled(cfg)
            and cfg.head_mode == "per_step" and "fused_tp" in params and B == 1):
        return predict_subcodes_tp_resident(cfg, params, pred_embed_tables, last_hidden,
                                            code0_embed, sp, noise_fn, mesh)
    chain = None if sp is None else chain_kernel(cfg, params, B)
    if chain is not None:
        noise = None if sp.greedy else noise_fn()
        knobs = sp.rows(1)[0] if B == 1 else sp
        fw = chain_pack(params, chain, B)
        # K3 keeps its float32 scratch whatever the model dtype
        dtype = ({} if chain is fused_mtp_chain_streamed
                 else {"cache_dtype": chain_cache_dtype(cfg, params, fw)})
        subcodes, sub_sum = chain(
            t, fw, params["transformer"]["final_norm"],
            params["fused_heads"], pred_embed_tables, last_hidden, code0_embed,
            noise, knobs.temperature, knobs.top_k, knobs.top_p, **dtype,
        )
        return subcodes, sub_sum.to(last_hidden.dtype)
    if last_hidden.device.type == "cuda":
        raise RuntimeError(
            f"MTP chain at B={B}: the chain kernels take a packed trunk with per-step "
            "heads; the plain path does not run on the card"
        )

    n = cfg.num_steps
    device = last_hidden.device
    cache = init_kv_cache(t, B, cfg.max_seq_len, device)
    valid = torch.zeros((B, cfg.max_seq_len), dtype=torch.bool, device=device)
    prefix = torch.stack([last_hidden.to(t.torch_dtype), code0_embed.to(t.torch_dtype)], dim=1)
    positions = torch.arange(2, device=device)[None, :].expand(B, 2)
    hidden, cache, valid = transformer_forward(
        t, params["transformer"], prefix, positions, cache, valid
    )
    h = hidden[:, 1]
    subcodes, embs = [], []
    for j in range(n):
        logits = dense(h, _head(params["heads"], j))
        sub = sample_fn(logits, j)
        emb = pred_embed_tables[j][sub]  # [B, H]
        subcodes.append(sub)
        embs.append(emb)
        if j < n - 1:
            pos = torch.full((B, 1), 2 + j, dtype=torch.long, device=device)
            hidden, cache, valid = transformer_forward(
                t, params["transformer"], emb[:, None, :].to(t.torch_dtype), pos, cache, valid,
            )
            h = hidden[:, 0]
    # the reference sums the first n-1 embeddings, then adds the last
    sub_sum = torch.stack(embs[:-1]).sum(dim=0) + embs[-1]
    return torch.stack(subcodes, dim=1), sub_sum.to(last_hidden.dtype)


def predict_subcodes_tp_resident(
    cfg: CodePredictorConfig,
    params: dict,
    pred_embed_tables: torch.Tensor,
    last_hidden: torch.Tensor,  # [1, H]
    code0_embed: torch.Tensor,  # [1, H]
    sp: SamplingParams,
    noise_fn: Callable[[], Optional[torch.Tensor]],
    mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-parallel chain (kernel K10) on the mesh's model ranks: the
    ``fused_tp`` trunk shards and the ``fused_tp_heads`` row shards (the
    engine attaches both), every rank sampling from the same noise.  The
    noise [n, 1, V] is the draw the single-device chain (K2 / K3) makes for
    this frame from the same generator, so the sampled stream is the one
    that chain would sample on the same logits."""
    knobs = sp.rows(1)[0]
    noise = None if sp.greedy else noise_fn()
    subcodes, sub_sum = fused_mtp_chain_tp(
        cfg.transformer, mesh.shape["model"], mesh, params["fused_tp"],
        params["transformer"]["final_norm"], params["fused_tp_heads"], pred_embed_tables,
        last_hidden, code0_embed, noise, knobs.temperature, knobs.top_k, knobs.top_p,
    )
    return subcodes, sub_sum.to(last_hidden.dtype)
