"""Code predictor: the MTP head emitting sub-codebooks 1..15 per frame.

Port of ``leaxer_qwen3_tts_tpu/models/code_predictor.py``.  Contract: the
input sequence starts [talker_last_hidden, codec_embed(code0)]; step j emits
logits from its step-indexed head (``head_mode="per_step"``) or from one
shared head with a learned step embedding added to the input that produces
them (``head_mode="shared"``: :func:`_head_fn`, :func:`_step_cond`); the
token sampled at step j is embedded with the step-j table and appended for
step j+1; the sum of all sub-embeddings feeds the next talker input.

:func:`chain_route` is the JAX package's ``predict_subcodes`` dispatch, read
from the config, the packs and the batch alone:

* ``impl="dense"``: :func:`predict_subcodes_dense`, every step a cache-free
  forward of the whole sequence (``transformer_forward_nocache``);
* the resident chain, where it is on (:func:`resident_enabled`:
  ``cfg.resident``, else ``QTTS_MTP_RESIDENT``, else on, JAX's default on
  its accelerator) with per-step heads, a packed ``fused_step`` and sampling
  knobs: under a tensor-parallel mesh with a ``fused_tp`` pack a B=1 chain
  is kernel K10 (:func:`predict_subcodes_tp_resident`); at B=1 kernel K2
  (:func:`~leaxer_qwen3_tts_torch.ops.fused_mtp.fused_mtp_chain`) on the
  pack :func:`resident_pack` gives (the primary ``fused_step`` where it
  passes the residency gate: the 0.6B int8 and int4 trunks; else the int4
  ``fused_step_alt`` of ``mtp_quantize="auto"``), else kernel K3
  (:func:`~leaxer_qwen3_tts_torch.ops.fused_mtp_stream.fused_mtp_chain_streamed`,
  float32 KV scratch) where the stream gate passes (the 1.7B trunk) and the
  streamed chain is on (:func:`stream_enabled`); at B >= 2 kernel K5
  (:func:`~leaxer_qwen3_tts_torch.ops.fused_mtp.fused_mtp_chain_batched`,
  past 32 rows as launches of at most 32), which takes every pack at any
  residency (ROADMAP Queue 3's standing difference), on :func:`chain_pack`'s
  pack, with K3's float32 cache wherever the B=1 chain is K3 or the trunk is
  bf16 (:func:`chain_cache_dtype`);
* the per-step chain with a packed ``fused_step`` where the resident chain
  is off, the heads are shared, or (B=1) the trunk fails both gates:
  :func:`predict_subcodes_fused`, its 2-token prefix on the plain layers and
  each later position one kernel K1 step (B=1) or one K4 step (2-32 rows) on
  the 17-slot cache, the final norm, heads and draws outside the kernels;
* else the cached plain chain (:func:`predict_subcodes_cached`): an
  unpacked trunk (``impl="cached"``, JAX's default, or an architecture the
  step kernels do not take), past 32 rows without the resident chain, and
  every chain under a mesh but K10's (a mesh packs no ``fused_step``: more
  than one row, no ``fused_tp`` pack as for the 1.7B trunk at tp=2, or no
  sampling knobs).

Every route runs on the card and on the CPU; on the CPU the kernel wrappers
run their plain versions.
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
from ..ops.fused_step import (
    fused_decode_step,
    fused_decode_step_batched,
    pack_fused_weights,
    supports,
)
from ..ops.quant import QuantizedLinear, dense
from ..runtime.sampling import SamplingParams
from .layers import (
    _normal,
    init_kv_cache,
    init_transformer_params,
    rms_norm,
    transformer_forward,
    transformer_forward_nocache,
)

PER_STEP_MAX_ROWS = 32  # the JAX package's batched per-step chain takes 2..32 rows
# the routes whose chain runs in one kernel launch (their sub-embedding sum
# is the kernels' float32 running sum)
KERNEL_ROUTES = ("tp", "resident", "streamed")


def init_code_predictor_params(cfg: CodePredictorConfig, gen: torch.Generator, device) -> dict:
    """Random parameters of either head topology (JAX
    ``init_code_predictor_params``): per-step heads [n, H, V], or one shared
    head [H, V] with a step embedding [n, H] (std 0.02)."""
    t = cfg.transformer
    h = t.hidden_size
    tr = init_transformer_params(t, gen, device)
    if cfg.head_mode == "shared":
        return {
            "transformer": tr,
            "head": _normal(gen, (h, cfg.subcode_vocab_size), h ** -0.5, t.torch_dtype, device),
            "step_embed": _normal(gen, (cfg.num_steps, h), 0.02, t.torch_dtype, device),
        }
    return {
        "transformer": tr,
        "heads": _normal(gen, (cfg.num_steps, h, cfg.subcode_vocab_size), h ** -0.5,
                         t.torch_dtype, device),
    }


def _head(heads, j: int):
    if isinstance(heads, QuantizedLinear):
        return QuantizedLinear(heads.q[j], heads.scale[j])
    return heads[j]


def _head_fn(cfg: CodePredictorConfig, params: dict) -> Callable:
    """(h [B, H], j) -> logits [B, V] under either head topology."""
    if cfg.head_mode == "shared":
        w = params["head"]
        return lambda h, j: dense(h, w)
    heads = params["heads"]
    return lambda h, j: dense(h, _head(heads, j))


def _step_cond(cfg: CodePredictorConfig, params: dict):
    """The shared-head topology's additive step conditioning (JAX
    ``_step_cond``): (c0_add, cond), ``c0_add`` (float32 [H], or None) added
    to the code0 prefix token, whose hidden gives step 0's logits, and
    ``cond(emb, j)`` the embedding of step j's token as it enters the trunk
    (plus step embedding min(j + 1, n - 1), in the embedding's dtype).  The
    raw table embedding still feeds the sub-embedding sum.  Per-step heads:
    (None, identity)."""
    if cfg.head_mode == "shared":
        se = params["step_embed"]
        n = se.shape[0]
        return se[0].float(), lambda emb, j: emb + se[min(j + 1, n - 1)].to(emb.dtype)
    return None, lambda emb, j: emb


def _prefix_token(t, code0_embed: torch.Tensor, c0_add) -> torch.Tensor:
    """codec_embed(code0) as the prefix's second token: plus ``c0_add`` in
    float32 (shared heads), in the trunk's dtype."""
    if c0_add is None:
        return code0_embed.to(t.torch_dtype)
    return (code0_embed.float() + c0_add).to(t.torch_dtype)


def prepare_fused_step(cfg: CodePredictorConfig, cp_params: dict, bits: int = 8,
                       alt: bool = False) -> dict:
    """Attach the packed trunk (``fused_step``) and, per-step heads, the
    heads (``fused_heads``) for the chain kernels when the architecture
    qualifies: int8 (bits=8, quantized or raw params), bf16 (bits=16, raw
    params) or int4 units (bits=4, raw params), the heads as they stand
    (int8 rows of quantized heads, bf16 rows of raw ones).  A shared head
    packs the trunk too, as JAX's ``prepare_fused_step`` does: its chain is
    the per-step one, the head a plain product.  ``alt=True`` writes the
    trunk to ``fused_step_alt`` instead, heads untouched: the engine's
    ``mtp_quantize="auto"`` int4 trunk, which :func:`resident_pack` takes
    where the primary pack fails the residency gate (JAX's)."""
    if not supports(cfg.transformer):
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


def chain_route(cfg: CodePredictorConfig, params: dict, rows: int, sampled: bool = True,
                mesh=None) -> str:
    """The route of a chain of ``rows`` rows (JAX ``predict_subcodes``'s
    dispatch; ``sampled``: sampling knobs are given, which the one-launch
    chains need): "dense", "tp" (K10), "resident" (K2 at B=1, K5 at B >= 2),
    "streamed" (K3), "per_step" (K1 or K4 per chain position) or "cached"
    (the plain layers).  The port's K5 takes any residency and any rows where
    the resident chain is on (ROADMAP Queue 3)."""
    if cfg.impl == "dense":
        return "dense"
    resident_on = resident_enabled(cfg) and cfg.head_mode == "per_step"
    fused = cfg.impl == "fused"
    if (fused and mesh is not None and sampled and resident_on and "fused_tp" in params
            and rows == 1):
        return "tp"
    if not (fused and "fused_step" in params):
        return "cached"
    if sampled and resident_on:
        if rows > 1 or resident_pack(params, 1) is not None:
            return "resident"
        if stream_enabled() and supports_stream(params["fused_step"], cfg.subcode_vocab_size):
            return "streamed"
    return "per_step" if rows <= PER_STEP_MAX_ROWS else "cached"


def chain_kernel(cfg: CodePredictorConfig, params: dict, rows: int):
    """The wrapper of the kernel that runs a whole chain of ``rows`` rows
    (K2, K3 or K5; on the CPU its plain version) on one device, or None
    where the chain is per-step, cached or dense (:func:`chain_route`);
    :func:`chain_pack` says which pack it reads."""
    return _route_kernel(chain_route(cfg, params, rows), rows)


def _route_kernel(route: str, rows: int):
    """The wrapper that runs ``route``'s whole chain at ``rows`` rows, or None."""
    if route == "resident":
        return fused_mtp_chain_batched if rows > 1 else fused_mtp_chain
    return fused_mtp_chain_streamed if route == "streamed" else None


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
    mesh=None,
) -> torch.Tensor:
    """The ``sub_embed_sum`` :func:`predict_subcodes` returns for these
    sub-codes on this chain's route (:func:`chain_route`), bit for bit: the
    chain kernels' float32 running sum (``sum = e_0``, then ``sum + e_j`` in
    step order, as ``csrc/fused_mtp*.cu`` and their plain versions add), the
    dense chain's sum of all n embeddings at once, or the cached and
    per-step chains' grouping (the first n-1 embeddings summed, then the
    last added), cast to ``dtype``."""
    embs = [pred_embed_tables[j][subcodes[..., j]] for j in range(subcodes.shape[-1])]
    route = chain_route(cfg, params, rows, mesh=mesh)
    if route in KERNEL_ROUTES:
        total = embs[0].float()
        for e in embs[1:]:
            total = total + e.float()
    elif route == "dense":
        total = torch.stack(embs).sum(dim=0)
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
    sp: Optional[SamplingParams] = None,  # enables the one-launch chains
    noise_fn: Optional[Callable[[], Optional[torch.Tensor]]] = None,
    mesh=None,  # a tensor-parallel mesh: enables the sharded chain (fused_tp pack)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs the MTP loop for one frame on :func:`chain_route`'s route.

    ``noise_fn()`` draws the one-launch chains' Gumbel noise ([n, B, V];
    None when every row is greedy); the other routes draw through
    ``sample_fn``.  Returns (subcodes [B, n] int, sub_embed_sum [B, H] in
    last_hidden's dtype)."""
    t = cfg.transformer
    B, H = last_hidden.shape
    route = chain_route(cfg, params, B, sp is not None, mesh)
    if route == "tp":
        return predict_subcodes_tp_resident(cfg, params, pred_embed_tables, last_hidden,
                                            code0_embed, sp, noise_fn, mesh)
    if route == "dense":
        return predict_subcodes_dense(cfg, params, pred_embed_tables, last_hidden, code0_embed,
                                      sample_fn)
    if route == "per_step":
        return predict_subcodes_fused(cfg, params, pred_embed_tables, last_hidden, code0_embed,
                                      sample_fn)
    if route == "cached":
        return predict_subcodes_cached(cfg, params, pred_embed_tables, last_hidden,
                                       code0_embed, sample_fn)
    chain = _route_kernel(route, B)
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


def _plain_chain(cfg, params, pred_embed_tables, last_hidden, code0_embed, sample_fn, step):
    """The chain with its 2-token prefix on the plain layers and each later
    position through ``step(x [B, H], j, cache, valid) -> (hidden [B, H],
    valid)`` on the 17-slot cache.  Returns (subcodes [B, n], sub_embed_sum
    [B, H]: the first n-1 embeddings summed, then the last added)."""
    t = cfg.transformer
    B = last_hidden.shape[0]
    n = cfg.num_steps
    device = last_hidden.device
    head = _head_fn(cfg, params)
    c0_add, cond = _step_cond(cfg, params)
    cache = init_kv_cache(t, B, cfg.max_seq_len, device)
    valid = torch.zeros((B, cfg.max_seq_len), dtype=torch.bool, device=device)
    prefix = torch.stack([last_hidden.to(t.torch_dtype), _prefix_token(t, code0_embed, c0_add)],
                         dim=1)
    positions = torch.arange(2, device=device)[None, :].expand(B, 2)
    hidden, cache, valid = transformer_forward(
        t, params["transformer"], prefix, positions, cache, valid
    )
    h = hidden[:, 1]  # the code0 position's hidden: step 0's logits
    subcodes, embs = [], []
    for j in range(n):
        sub = sample_fn(head(h, j), j)
        emb = pred_embed_tables[j][sub]  # [B, H]
        subcodes.append(sub)
        embs.append(emb)
        if j < n - 1:
            h, cache, valid = step(cond(emb, j).to(t.torch_dtype), j, cache, valid)
    sub_sum = torch.stack(embs[:-1]).sum(dim=0) + embs[-1]
    return torch.stack(subcodes, dim=1), sub_sum.to(last_hidden.dtype)


def predict_subcodes_cached(cfg, params, pred_embed_tables, last_hidden, code0_embed,
                            sample_fn) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cached plain chain (JAX ``predict_subcodes``' own loop): every
    position a plain forward of one token on the 17-slot cache."""
    t = cfg.transformer
    B = last_hidden.shape[0]

    def step(x, j, cache, valid):
        pos = torch.full((B, 1), 2 + j, dtype=torch.long, device=x.device)
        hidden, cache, valid = transformer_forward(t, params["transformer"], x[:, None, :], pos,
                                                   cache, valid)
        return hidden[:, 0], cache, valid

    return _plain_chain(cfg, params, pred_embed_tables, last_hidden, code0_embed, sample_fn,
                        step)


def predict_subcodes_fused(cfg, params, pred_embed_tables, last_hidden, code0_embed,
                           sample_fn) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step chain (JAX ``predict_subcodes_fused`` at B=1 and
    ``predict_subcodes_fused_batched`` at 2-32 rows): the prefix on the
    plain layers, then each position one kernel K1 step (B=1) or one K4 step
    (every row at position 2 + j) of the packed trunk on the 17-slot cache,
    the final norm after the kernel."""
    t = cfg.transformer
    B = last_hidden.shape[0]
    fw = params["fused_step"]
    fnorm = params["transformer"]["final_norm"]

    def step(x, j, cache, valid):
        kernel = fused_decode_step if B == 1 else fused_decode_step_batched
        x_out = kernel(t, fw, x, 2 + j, cache.k, cache.v)[0]
        return rms_norm(x_out, fnorm, t.rms_norm_eps).to(x.dtype), cache, valid

    return _plain_chain(cfg, params, pred_embed_tables, last_hidden, code0_embed, sample_fn,
                        step)


def predict_subcodes_dense(cfg, params, pred_embed_tables, last_hidden, code0_embed,
                           sample_fn) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache-free chain (JAX ``predict_subcodes_dense``): step j runs
    the whole n + 2 slot sequence through ``transformer_forward_nocache``
    with the slots past 2 + j masked as keys, and reads the hidden at slot
    1 + j.  Its sub-embedding sum adds all n embeddings at once."""
    t = cfg.transformer
    B, H = last_hidden.shape
    n = cfg.num_steps
    S = n + 2
    device = last_hidden.device
    head = _head_fn(cfg, params)
    c0_add, cond = _step_cond(cfg, params)
    seq = torch.zeros((B, S, H), dtype=t.torch_dtype, device=device)
    seq[:, 0] = last_hidden.to(t.torch_dtype)
    seq[:, 1] = _prefix_token(t, code0_embed, c0_add)
    slots = torch.arange(S, device=device)
    subcodes, embs = [], []
    for j in range(n):
        valid = (slots < 2 + j)[None, :].expand(B, S)
        hidden = transformer_forward_nocache(t, params["transformer"], seq, valid=valid)
        sub = sample_fn(head(hidden[:, 1 + j], j), j)
        emb = pred_embed_tables[j][sub]
        subcodes.append(sub)
        embs.append(emb)
        seq[:, 2 + j] = cond(emb, j).to(t.torch_dtype)
    return torch.stack(subcodes, dim=1), torch.stack(embs).sum(dim=0).to(last_hidden.dtype)


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
