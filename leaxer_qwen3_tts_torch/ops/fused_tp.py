"""Kernel K9: the tensor-parallel decode step, two half-kernels per layer and rank.

Port of ``leaxer_qwen3_tts_tpu/ops/fused_tp.py``.  One B=1 decode step over
all layers on a mesh's "model" axis (``parallel/mesh.py``), Megatron's two
reductions per layer:

    for each layer:
        x += allreduce(attn_half(x) on each rank's shard)   # K9a
        x += allreduce(mlp_half(x) on each rank's shard)    # K9b

Each rank holds its shard of the qkv / gate-up columns and of the wo / down
rows, and its own kv heads of the cache ([L, 1, nk / tp, T, d], rank r
holding kv heads r nk/tp .. (r+1) nk/tp - 1, as the JAX package's
``P(None, None, "model")`` places them).  The all-reduce is a fixed-order
sum of the ranks' [1, H] partials (rank 0 first) on the mesh's first device,
copied back to each rank: the counterpart of JAX's ``psum``, an XLA
collective outside any Pallas kernel.

The pack (:func:`pack_fused_tp`) is the JAX package's leaf for leaf: per
rank, int8 units of NU columns with float32 per-column scales; a K-split
product (wo, down) in K-major tiles of KC rows whose scales are taken over
the shard's rows (not the whole tensor's).  The leaves are per-rank lists,
each rank's tensors on its device.

On a CUDA tensor :func:`attn_half` and :func:`mlp_half` launch the
hand-written halves (``csrc/fused_tp.cu``); on a CPU tensor they run their
plain versions, :func:`attn_half_reference` and :func:`mlp_half_reference`
(bf16-rounded lhs upcast to float32 before each unit product, which equals a
bf16 dot with float32 accumulation, then times the unit's scales).  The
caches are updated IN PLACE.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..config import TransformerConfig
from ..models.layers import rope_inv_freq
from .fused_step import _attend_slots, _bf16, _rms, _rope, _store_slot, attn_scale
from .quant import quantize_weight


class FusedTPWeights(NamedTuple):
    """Per-rank packed weights: every leaf a list over the model ranks, rank
    r's tensor on its device (the norms and rotary frequencies are the same
    values on every rank).

    qkv_u [L, Uq, H, NU] int8; qkv_s [L, Uq, 1, NU] f32
    wo_u  [L, Uo, KCo, NU];    wo_s  [L, Uo, 1, NU]
    gu_u  [L, Ug, H, NU];      gu_s  [L, Ug, 1, NU]
    wd_u  [L, Ud, KCd, NU];    wd_s  [L, Ud, 1, NU]
    attn_norm / mlp_norm [L, 1, H], q_norm / k_norm [L, 1, d] f32; inv_freq [d/2]
    """

    qkv_u: List[torch.Tensor]
    qkv_s: List[torch.Tensor]
    wo_u: List[torch.Tensor]
    wo_s: List[torch.Tensor]
    gu_u: List[torch.Tensor]
    gu_s: List[torch.Tensor]
    wd_u: List[torch.Tensor]
    wd_s: List[torch.Tensor]
    attn_norm: List[torch.Tensor]
    mlp_norm: List[torch.Tensor]
    q_norm: List[torch.Tensor]
    k_norm: List[torch.Tensor]
    inv_freq: List[torch.Tensor]

    @property
    def tp(self) -> int:
        return len(self.qkv_u)


def _dims(cfg: TransformerConfig, tp: int):
    d = cfg.head_dim
    nq_s = cfg.num_heads // tp
    nk_s = cfg.num_kv_heads // tp
    qd_s, kvd_s = nq_s * d, nk_s * d
    A_s = qd_s + 2 * kvd_s
    I_s = cfg.intermediate_size // tp
    H = cfg.hidden_size
    NU = math.gcd(1024, math.gcd(A_s, math.gcd(2 * I_s, H)))
    KCo = math.gcd(qd_s, H)
    KCd = math.gcd(I_s, H)
    return H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd


def supports_tp(cfg: TransformerConfig, tp: int) -> bool:
    """The JAX package's gate: heads and the MLP split over tp, and the
    tile schedule has NU, KCo, KCd >= 256."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        return False
    if cfg.intermediate_size % tp:
        return False
    H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = _dims(cfg, tp)
    return NU >= 256 and KCo >= 256 and KCd >= 256 and H % NU == 0


def pack_fused_tp(cfg: TransformerConfig, layer_params: dict, tp: int, mesh=None,
                  devices: Sequence = None) -> FusedTPWeights:
    """Pack raw (unquantized, unfused) stacked layer params into per-rank
    int8 units, bit for bit the JAX package's pack.  Per-output-column scales
    are taken over the shard's rows for the K-split groups.  The ranks'
    tensors go to the mesh's model devices (or ``devices``), else stay where
    the params are."""
    assert supports_tp(cfg, tp)
    H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = _dims(cfg, tp)
    p = layer_params
    if devices is None:
        devices = mesh.model_devices() if mesh is not None else [p["wq"].device] * tp

    def units_n(w_s):  # [L, H, W] -> ([L, U, H, NU], [L, U, 1, NU])
        qs = [quantize_weight(w_s[..., i * NU : (i + 1) * NU]) for i in range(w_s.shape[-1] // NU)]
        return torch.stack([q.q for q in qs], dim=1), torch.stack([q.scale for q in qs], dim=1)

    def units_k(w_s, KC):  # [L, K, H] -> k-major tiles [L, U, KC, NU]
        full = quantize_weight(w_s)  # per-column scale over the FULL shard K
        us, ss = [], []
        for i in range(w_s.shape[-2] // KC):
            for j in range(w_s.shape[-1] // NU):
                us.append(full.q[:, i * KC : (i + 1) * KC, j * NU : (j + 1) * NU])
                ss.append(full.scale[..., j * NU : (j + 1) * NU])
        return torch.stack(us, dim=1).contiguous(), torch.stack(ss, dim=1).contiguous()

    shards = {k: [] for k in ("qkv_u", "qkv_s", "wo_u", "wo_s", "gu_u", "gu_s", "wd_u", "wd_s")}
    for s, dev in enumerate(devices):
        qkv = torch.cat([p["wq"][..., s * qd_s : (s + 1) * qd_s],
                         p["wk"][..., s * kvd_s : (s + 1) * kvd_s],
                         p["wv"][..., s * kvd_s : (s + 1) * kvd_s]], dim=-1)
        gu = torch.cat([p["wg"][..., s * I_s : (s + 1) * I_s],
                        p["wu"][..., s * I_s : (s + 1) * I_s]], dim=-1)
        for name, (u, sc) in (
            ("qkv", units_n(qkv)),
            ("wo", units_k(p["wo"][:, s * qd_s : (s + 1) * qd_s, :], KCo)),
            ("gu", units_n(gu)),
            ("wd", units_k(p["wd"][:, s * I_s : (s + 1) * I_s, :], KCd)),
        ):
            shards[name + "_u"].append(u.to(dev))
            shards[name + "_s"].append(sc.to(dev))
    inv_freq = rope_inv_freq(d, cfg.rope_theta, p["wq"].device)

    def norm(name):
        return p[name].float()[:, None, :].contiguous()

    return FusedTPWeights(
        **shards,
        **{k: [norm(k).to(dev) for dev in devices]
           for k in ("attn_norm", "mlp_norm", "q_norm", "k_norm")},
        inv_freq=[inv_freq.to(dev) for dev in devices],
    )


# ---------------------------------------------------------------------------
# The KV cache's head shards
# ---------------------------------------------------------------------------


def split_heads(cache: torch.Tensor, devices: Sequence) -> Tuple[torch.Tensor, ...]:
    """[L, B, nk, T, d] -> per-rank [L, B, nk / tp, T, d], rank r's kv heads
    on its device (contiguous copies)."""
    tp = len(devices)
    nk_s = cache.shape[2] // tp
    return tuple(cache[:, :, r * nk_s : (r + 1) * nk_s].contiguous().to(dev)
                 for r, dev in enumerate(devices))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _unit(lhs: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[1, K] f32 @ unit [K, NU] int8 -> [1, NU] f32: bf16 lhs, then x scale."""
    return torch.matmul(_bf16(lhs), w.float()) * s


def _ksplit(lhs: torch.Tensor, units: torch.Tensor, scales: torch.Tensor, KC: int, NU: int,
            H: int) -> torch.Tensor:
    """The K-split product: chunk i of output block j is unit i * (H / NU) +
    j; the chunks' scaled products summed in chunk order."""
    out = torch.zeros((1, H), dtype=torch.float32, device=lhs.device)
    nn = H // NU
    for u in range(units.shape[0]):
        i, j = divmod(u, nn)
        out[:, j * NU : (j + 1) * NU] = out[:, j * NU : (j + 1) * NU] + _unit(
            lhs[:, i * KC : (i + 1) * KC], units[u], scales[u])
    return out


def attn_half_reference(cfg: TransformerConfig, tp: int, fw: FusedTPWeights, r: int, l: int,
                        x: torch.Tensor, pos: int, k_cache: torch.Tensor,
                        v_cache: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K9a: rank r's attention half of layer l on x
    [1, H] f32; writes the new slot of the rank's cache [L, 1, nk_s, T, d] at
    ``pos`` in the cache dtype.  Returns the rank's partial dx [1, H]."""
    H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = _dims(cfg, tp)
    eps = cfg.rms_norm_eps
    angles = torch.tensor(float(pos), dtype=torch.float32, device=x.device) * fw.inv_freq[r]
    cos, sin = torch.cos(angles)[None, :], torch.sin(angles)[None, :]
    h = _rms(x, fw.attn_norm[r][l, 0], eps)
    qkv = torch.cat([_unit(h, fw.qkv_u[r][l, u], fw.qkv_s[r][l, u])
                     for u in range(A_s // NU)], dim=-1)[0]
    q = _rms(qkv[:qd_s].reshape(nq_s, d), fw.q_norm[r][l, 0], eps)
    k = _rms(qkv[qd_s : qd_s + kvd_s].reshape(nk_s, d), fw.k_norm[r][l, 0], eps)
    v = qkv[qd_s + kvd_s :].reshape(nk_s, d)
    q = _rope(q, cos, sin)
    k = _rope(k, cos, sin)
    caches = (k_cache[l], v_cache[l], None, None)
    _store_slot(caches, (0, slice(None), pos), k, v)
    attn = _attend_slots(q.reshape(nk_s, nq_s // nk_s, d), caches, 0, pos + 1,
                         attn_scale(d)).reshape(1, qd_s)
    return _ksplit(attn, fw.wo_u[r][l], fw.wo_s[r][l], KCo, NU, H)


def mlp_half_reference(cfg: TransformerConfig, tp: int, fw: FusedTPWeights, r: int, l: int,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K9b: rank r's MLP half of layer l on x [1, H]
    f32.  Returns the rank's partial dm [1, H]."""
    H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = _dims(cfg, tp)
    h = _rms(x, fw.mlp_norm[r][l, 0], cfg.rms_norm_eps)
    gu = torch.cat([_unit(h, fw.gu_u[r][l, u], fw.gu_s[r][l, u])
                    for u in range(2 * I_s // NU)], dim=-1)
    gate, up = gu[:, :I_s], gu[:, I_s:]
    act = gate * (1.0 / (1.0 + torch.exp(-gate))) * up
    return _ksplit(act, fw.wd_u[r][l], fw.wd_s[r][l], KCd, NU, H)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _weights_struct(cfg: TransformerConfig, tp: int, fw: FusedTPWeights, r: int):
    from ._build import TpWeights

    H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = _dims(cfg, tp)
    ptrs = [getattr(fw, name)[r].data_ptr() for name in (
        "qkv_u", "qkv_s", "wo_u", "wo_s", "gu_u", "gu_s", "wd_u", "wd_s", "attn_norm",
        "mlp_norm", "q_norm", "k_norm", "inv_freq")]
    return TpWeights(*ptrs, fw.qkv_u[r].shape[0], H, nq_s, nk_s, d, I_s, NU, KCo, KCd,
                     cfg.rms_norm_eps, attn_scale(d))


def check_pack(fw: FusedTPWeights, r: int, what: str) -> None:
    """Rank r's pack as the kernels take it: int8 units, contiguous, on CUDA."""
    if any(u[r].dtype != torch.int8 for u in (fw.qkv_u, fw.wo_u, fw.gu_u, fw.wd_u)):
        raise NotImplementedError(f"{what}: the tensor-parallel kernels take int8 units")
    for leaf in fw:
        t = leaf[r]
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: the pack's tensors must be contiguous, 16-byte aligned "
                             "and on CUDA")


class _HalfEntry:
    """The argument structs and scratch of rank r's halves at one cache
    bucket on one stream of one thread: built once, reused by every layer
    and step there."""

    def __init__(self, cfg: TransformerConfig, tp: int, fw: FusedTPWeights, r: int, T: int,
                 device):
        from ._build import TpScratch, load_kernels

        H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = _dims(cfg, tp)
        check_pack(fw, r, "fused_decode_step_tp")
        chunk = load_kernels().qtts_attn_chunk()
        max_splits = (T + chunk - 1) // chunk
        sizes = [A_s, qd_s, 2 * I_s, nq_s * max_splits * (d + 2)]
        self.scratch = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        qkv, attn, gu, part = torch.split(self.scratch, sizes)
        self.w = _weights_struct(cfg, tp, fw, r)
        self.s = TpScratch(qkv.data_ptr(), attn.data_ptr(), gu.data_ptr(), part.data_ptr(),
                           max_splits)


_ENTRIES: "OrderedDict[tuple, _HalfEntry]" = OrderedDict()
_MAX_ENTRIES = 64


def _half_entry(cfg, tp: int, fw: FusedTPWeights, r: int, T: int, device) -> _HalfEntry:
    """The cached entry of rank r of this pack, keyed by every pointer it holds."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (cfg, tp, r, T, device, stream, threading.get_ident(),
           *(leaf[r].data_ptr() for leaf in fw))
    entry = _ENTRIES.get(key)
    if entry is None:
        entry = _HalfEntry(cfg, tp, fw, r, T, device)
        _ENTRIES[key] = entry
        while len(_ENTRIES) > _MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
    return entry


def _check_half_inputs(x: torch.Tensor, k_cache=None, v_cache=None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_step_tp: unsupported device {x.device}")
    for t in (k_cache, v_cache):
        if t is None:
            continue
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != k_cache.dtype:
            raise NotImplementedError(f"KV cache dtype {t.dtype}: the tensor-parallel step "
                                      "takes bfloat16 and float32 caches")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_decode_step_tp: a rank's caches must be contiguous and on "
                             "its device")


def attn_half(cfg: TransformerConfig, tp: int, fw: FusedTPWeights, r: int, l: int,
              x: torch.Tensor, pos: int, k_cache: torch.Tensor,
              v_cache: torch.Tensor) -> torch.Tensor:
    """Kernel K9a: rank r's attention half of layer l (see
    :func:`attn_half_reference`); x, the caches and the result on the rank's
    device."""
    if x.device.type == "cpu":
        return attn_half_reference(cfg, tp, fw, r, l, x, pos, k_cache, v_cache)
    _check_half_inputs(x, k_cache, v_cache)
    from ._build import check, load_kernels

    T = k_cache.shape[3]
    e = _half_entry(cfg, tp, fw, r, T, x.device)
    x_in = x.float().reshape(-1).contiguous()
    dx = torch.empty((1, cfg.hidden_size), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    attn_half.launches += 1
    err = load_kernels().qtts_tp_attn_half(
        e.w, e.s, l, x_in.data_ptr(), dx.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        int(k_cache.dtype == torch.bfloat16), T, pos, stream)
    check(err, "fused_decode_step_tp attention half")
    return dx


attn_half.launches = 0  # kernel launches, for chip_smoke.py's path check


def mlp_half(cfg: TransformerConfig, tp: int, fw: FusedTPWeights, r: int, l: int,
             x: torch.Tensor) -> torch.Tensor:
    """Kernel K9b: rank r's MLP half of layer l (see :func:`mlp_half_reference`)."""
    if x.device.type == "cpu":
        return mlp_half_reference(cfg, tp, fw, r, l, x)
    _check_half_inputs(x)
    from ._build import check, load_kernels

    e = _half_entry(cfg, tp, fw, r, 1, x.device)
    x_in = x.float().reshape(-1).contiguous()
    dm = torch.empty((1, cfg.hidden_size), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mlp_half.launches += 1
    err = load_kernels().qtts_tp_mlp_half(e.w, e.s, l, x_in.data_ptr(), dm.data_ptr(), stream)
    check(err, "fused_decode_step_tp MLP half")
    return dm


mlp_half.launches = 0  # kernel launches, for chip_smoke.py's path check


def allreduce(parts: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The ranks' partials summed in rank order on ``lead``."""
    total = parts[0].to(lead)
    for p in parts[1:]:
        total = total + p.to(lead)
    return total


def fused_decode_step_tp(
    cfg: TransformerConfig,
    fw: FusedTPWeights,
    x: torch.Tensor,  # [1, H]
    pos: int,
    k_cache: Sequence[torch.Tensor],  # per rank [L, 1, nk / tp, T, d], updated in place
    v_cache: Sequence[torch.Tensor],
    mesh,
    halves=None,
) -> tuple:
    """One decode step over all layers on the mesh's model ranks (the
    pre-final-norm output).  ``pos`` is clamped to the last slot like the
    reference.  ``halves`` (the checks' hook): the (attention, MLP) half
    functions, K9a and K9b by default.

    Returns (x_out [1, H] float32 on the mesh's first device, k_cache,
    v_cache)."""
    attn_fn, mlp_fn = halves or (attn_half, mlp_half)
    tp = mesh.shape["model"]
    devices = mesh.model_devices()
    lead = devices[0]
    T = k_cache[0].shape[3]
    pos = min(int(pos), T - 1)
    x = x.float().to(lead)
    for l in range(fw.qkv_u[0].shape[0]):
        dx = [attn_fn(cfg, tp, fw, r, l, x.to(dev), pos, k_cache[r], v_cache[r])
              for r, dev in enumerate(devices)]
        x = x + allreduce(dx, lead)
        dm = [mlp_fn(cfg, tp, fw, r, l, x.to(dev)) for r, dev in enumerate(devices)]
        x = x + allreduce(dm, lead)
    return x, k_cache, v_cache


def fused_decode_step_tp_reference(cfg, fw, x, pos, k_cache, v_cache, mesh) -> tuple:
    """The step on the plain halves, whatever the tensors' device."""
    return fused_decode_step_tp(cfg, fw, x, pos, k_cache, v_cache, mesh,
                                halves=(attn_half_reference, mlp_half_reference))
