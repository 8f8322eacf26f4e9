"""Kernel K9: the tensor-parallel decode step, one persistent launch per device.

Port of ``leaxer_qwen3_tts_tpu/ops/fused_tp.py``.  One B=1 decode step over
all layers on a mesh's "model" axis (``parallel/mesh.py``), Megatron's two
reductions per layer:

    for each layer:
        x += allreduce(attn_half(x) on each rank's shard)
        x += allreduce(mlp_half(x) on each rank's shard)

Each rank holds its shard of the qkv / gate-up columns and of the wo / down
rows, and its own kv heads of the cache ([L, 1, nk / tp, T, d], rank r
holding kv heads r nk/tp .. (r+1) nk/tp - 1, as the JAX package's
``P(None, None, "model")`` places them).  The all-reduce sums the ranks'
[1, H] partials in the hypercube's order (:func:`hypercube_sum`), so every
rank holds the same bits: the counterpart of JAX's ``psum``.

The JAX package's pack (:func:`pack_fused_tp`, leaf for leaf: per rank,
int8 units of NU columns with float32 per-column scales; a K-split product
(wo, down) in K-major tiles of KC rows whose scales are taken over the
shard's rows) is what the engine builds first.  :func:`pack_rows` turns it
into each rank's row pack, a :class:`~leaxer_qwen3_tts_torch.ops.fused_step.FusedStepWeights`
at the shard's widths (:func:`shard_config`) holding the same int8 values
and scales, which the kernel and its plain version take; the engine keeps
only the rows.

On CUDA tensors :func:`fused_decode_step_tp` launches the hand-written
kernel (``csrc/fused_tp.cu``: per device one cooperative launch whose block
groups run K1's persistent step phases on their ranks' shards, the partials
all-reduced inside the kernel); on CPU tensors it runs
:func:`fused_decode_step_tp_reference`, the plain version (per rank and
layer :func:`attn_half_reference` and :func:`mlp_half_reference`: K1's plain
math on the rank's rows, each unit's product as the JAX pack's units take it,
then the partials summed in the hypercube's order).  The
caches are updated IN PLACE.  A step whose exchange timed out raises at
:func:`check_timeouts`, which the engine calls after each chunk's sync (the
status words are read behind the launch).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import TransformerConfig
from ..models.layers import rope_inv_freq
from . import persistent
from .fused_step import (FusedStepWeights, _attend_slots, _bf16, _rms, _rope, _store_slot,
                         attn_scale, step_structs)
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
# The row pack
# ---------------------------------------------------------------------------


def shard_config(cfg: TransformerConfig, tp: int) -> TransformerConfig:
    """One rank's shard as a transformer of its own: nq / tp and nk / tp
    heads, I / tp (H, the head dim and the layers as ``cfg``'s)."""
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)


def supports_shard(cfg: TransformerConfig, tp: int) -> bool:
    """What the kernels' ring step takes of one rank's shard (tp a power of
    two: the exchange's hypercube): every GEMV
    input K (H, nq d / tp, I / tp) a multiple of 16 (the lane walk's
    16-column runs) and at most persistent.MAX_K, every product's rows in
    quads of 4, head_dim 128, a power-of-two group of at most 8 q heads per
    kv head (K1's attention items) and at most persistent.MAX_KV_HEADS kv
    heads.  Unlike :func:`supports_tp` (the JAX package's unit gate) it
    does not ask for unit tiles."""
    if tp < 1 or tp & (tp - 1) or cfg.num_heads % tp or cfg.num_kv_heads % tp or (
            cfg.intermediate_size % tp):
        return False
    s = shard_config(cfg, tp)
    ks = (s.hidden_size, s.q_dim, s.intermediate_size)
    ns = (s.q_dim + 2 * s.kv_dim, s.hidden_size, 2 * s.intermediate_size)
    g = s.num_heads // s.num_kv_heads if s.num_kv_heads else 0
    return (s.num_kv_heads > 0 and s.num_heads % s.num_kv_heads == 0 and g in (1, 2, 4, 8)
            and s.head_dim == 128 and s.num_kv_heads <= persistent.MAX_KV_HEADS
            and all(k % 16 == 0 and k <= persistent.MAX_K for k in ks)
            and all(n % persistent.ROW_QUANTUM == 0 for n in ns))


class FusedTPRows(NamedTuple):
    """Per-rank row packs: rank r's shard as K1's layout at the shard's
    widths (int8 rows [N, K] with one float32 scale per row), on its device."""

    ranks: List[FusedStepWeights]

    @property
    def tp(self) -> int:
        return len(self.ranks)


def _n_rows(u: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An N-split product's units [L, U, K, NU] and scales [L, U, 1, NU] ->
    rows [L, U NU, K] and scales [L, U NU]."""
    L, U, K, NU = u.shape
    return (u.permute(0, 1, 3, 2).reshape(L, U * NU, K).contiguous(),
            s.reshape(L, U * NU).float().contiguous())


def _k_rows(u: torch.Tensor, s: torch.Tensor, N: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A K-split product's units [L, (K / KC) (N / NU), KC, NU] (unit
    i (N / NU) + j: rows [i KC, (i + 1) KC) of columns [j NU, (j + 1) NU))
    and scales -> rows [L, N, K] and scales [L, N].  The JAX pack's scales
    are per column over the whole shard K, the same for every chunk; a pack
    whose chunks carry other scales has no row form and raises."""
    L, U, KC, NU = u.shape
    nn = N // NU
    nc = U // nn
    rows = u.reshape(L, nc, nn, KC, NU).permute(0, 2, 4, 1, 3).reshape(L, N, nc * KC)
    sc = s.reshape(L, nc, N).float()
    if not bool((sc == sc[:, :1]).all()):
        raise ValueError("pack_rows: a K-split product's chunks carry different scales")
    return rows.contiguous(), sc[:, 0].contiguous()


def pack_rows(cfg: TransformerConfig, tp: int, fw: FusedTPWeights) -> FusedTPRows:
    """Each rank's row pack from the JAX package's units (``pack_fused_tp``):
    the same int8 values and scales, transposed into rows, on the rank's
    device."""
    H = cfg.hidden_size
    ranks = []
    for r in range(tp):
        wqkv, sqkv = _n_rows(fw.qkv_u[r], fw.qkv_s[r])
        wo, so = _k_rows(fw.wo_u[r], fw.wo_s[r], H)
        wgu, sgu = _n_rows(fw.gu_u[r], fw.gu_s[r])
        wd, sd = _k_rows(fw.wd_u[r], fw.wd_s[r], H)
        ranks.append(FusedStepWeights(
            wqkv=wqkv, sqkv=sqkv, wo=wo, so=so, wgu=wgu, sgu=sgu, wd=wd, sd=sd,
            attn_norm=fw.attn_norm[r][:, 0].contiguous(),
            mlp_norm=fw.mlp_norm[r][:, 0].contiguous(),
            q_norm=fw.q_norm[r][:, 0].contiguous(), k_norm=fw.k_norm[r][:, 0].contiguous(),
            inv_freq=fw.inv_freq[r]))
    return FusedTPRows(ranks)


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
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _unit(lhs: torch.Tensor, rows: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[1, K] f32 @ the unit of ``rows`` [NU, K] int8 -> [1, NU] f32: bf16
    lhs, then x scale; the unit as the JAX pack holds it ([K, NU])."""
    return torch.matmul(_bf16(lhs), rows.t().contiguous().float()) * s


def _nsplit(lhs: torch.Tensor, rows: torch.Tensor, scales: torch.Tensor, NU: int) -> torch.Tensor:
    """An N-split product on rows [N, K]: one unit per NU output rows."""
    return torch.cat([_unit(lhs, rows[u : u + NU], scales[u : u + NU])
                      for u in range(0, rows.shape[0], NU)], dim=-1)


def _ksplit(lhs: torch.Tensor, rows: torch.Tensor, scales: torch.Tensor, KC: int,
            NU: int) -> torch.Tensor:
    """The K-split product on rows [N, K]: unit (i, j) holds inputs [i KC,
    (i + 1) KC) of output rows [j NU, (j + 1) NU); the chunks' scaled
    products summed in chunk order."""
    N, K = rows.shape
    out = torch.zeros((1, N), dtype=torch.float32, device=lhs.device)
    for i in range(K // KC):
        for j in range(N // NU):
            cols, ks = slice(j * NU, (j + 1) * NU), slice(i * KC, (i + 1) * KC)
            out[:, cols] = out[:, cols] + _unit(lhs[:, ks], rows[cols, ks], scales[cols])
    return out


def attn_half_reference(cfg: TransformerConfig, tp: int, rows: FusedTPRows, r: int, l: int,
                        x: torch.Tensor, pos: int, k_cache: torch.Tensor,
                        v_cache: torch.Tensor) -> torch.Tensor:
    """Rank r's attention half of layer l on x [1, H] f32 (the JAX halves'
    math on the rank's rows, unit by unit); writes the new slot of the
    rank's cache [L, 1, nk_s, T, d] at ``pos`` in the cache dtype.  Returns
    the rank's partial dx [1, H]."""
    s = shard_config(cfg, tp)
    NU, KCo = _dims(cfg, tp)[8:10]
    w = rows.ranks[r]
    nq, nk, d, qd, kvd = s.num_heads, s.num_kv_heads, s.head_dim, s.q_dim, s.kv_dim
    eps = cfg.rms_norm_eps
    angles = torch.tensor(float(pos), dtype=torch.float32, device=x.device) * w.inv_freq
    cos, sin = torch.cos(angles)[None, :], torch.sin(angles)[None, :]
    h = _rms(x, w.attn_norm[l], eps)
    qkv = _nsplit(h, w.wqkv[l], w.sqkv[l], NU)[0]
    q = _rope(_rms(qkv[:qd].reshape(nq, d), w.q_norm[l], eps), cos, sin)
    k = _rope(_rms(qkv[qd : qd + kvd].reshape(nk, d), w.k_norm[l], eps), cos, sin)
    v = qkv[qd + kvd :].reshape(nk, d)
    caches = (k_cache[l], v_cache[l], None, None)
    _store_slot(caches, (0, slice(None), pos), k, v)
    attn = _attend_slots(q.reshape(nk, nq // nk, d), caches, 0, pos + 1, attn_scale(d))
    return _ksplit(attn.reshape(1, qd), w.wo[l], w.so[l], KCo, NU)


def mlp_half_reference(cfg: TransformerConfig, tp: int, rows: FusedTPRows, r: int, l: int,
                       x: torch.Tensor) -> torch.Tensor:
    """Rank r's MLP half of layer l on x [1, H] f32.  Returns the rank's
    partial dm [1, H]."""
    dims = _dims(cfg, tp)
    I_s, NU, KCd = dims[7], dims[8], dims[10]
    w = rows.ranks[r]
    gu = _nsplit(_rms(x, w.mlp_norm[l], cfg.rms_norm_eps), w.wgu[l], w.sgu[l], NU)
    gate, up = gu[:, :I_s], gu[:, I_s:]
    return _ksplit(gate * (1.0 / (1.0 + torch.exp(-gate))) * up, w.wd[l], w.sd[l], KCd, NU)


def hypercube_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernels' all-reduce on the ranks' values (one device): round r
    gives rank i its value plus rank i ^ (1 << r)'s; every rank ends with
    the same bits.  Returns rank 0's."""
    vals = list(parts)
    step = 1
    while step < len(vals):
        vals = [vals[i] + vals[i ^ step] for i in range(len(vals))]
        step <<= 1
    return vals[0]


def allreduce(parts: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The ranks' partials summed on ``lead`` in the kernel's order
    (:func:`hypercube_sum`: every rank computes this sum)."""
    return hypercube_sum([p.to(lead) for p in parts])


def fused_decode_step_tp_reference(cfg: TransformerConfig, rows: FusedTPRows, x: torch.Tensor,
                                   pos: int, k_cache: Sequence[torch.Tensor],
                                   v_cache: Sequence[torch.Tensor], mesh) -> tuple:
    """Plain PyTorch version of kernel K9 on the rows, whatever the tensors'
    device; same contract as :func:`fused_decode_step_tp`."""
    tp = mesh.shape["model"]
    devices = mesh.model_devices()
    lead = devices[0]
    T = k_cache[0].shape[3]
    pos = min(int(pos), T - 1)
    x = x.float().to(lead)
    for l in range(rows.ranks[0].wqkv.shape[0]):
        dx = [attn_half_reference(cfg, tp, rows, r, l, x.to(dev), pos, k_cache[r], v_cache[r])
              for r, dev in enumerate(devices)]
        x = x + allreduce(dx, lead)
        dm = [mlp_half_reference(cfg, tp, rows, r, l, x.to(dev)) for r, dev in enumerate(devices)]
        x = x + allreduce(dm, lead)
    return x, k_cache, v_cache


# ---------------------------------------------------------------------------
# Timeouts of the exchange (K9 and K10)
# ---------------------------------------------------------------------------


def raise_on_timeout(status: Sequence[torch.Tensor], what: str = "fused_mtp_chain_tp") -> None:
    """Raise if a rank's status word is set: one of its exchange waits timed
    out, and the rank added whatever its receive slots held."""
    words = torch.cat([s.reshape(-1).to(status[0].device) for s in status]).tolist()  # one sync
    late = [r for r, w in enumerate(words) if w]
    if late:
        raise RuntimeError(f"{what}: an exchange wait timed out on rank(s) {late}; its results "
                           "are not valid")


# The status words of this thread's launches not yet read: each copied to
# pinned host memory behind its launch, with an event, so that reading them
# waits for that launch and not for the work queued after it.
_tracked = threading.local()


def track(status: Sequence[torch.Tensor], what: str = "fused_mtp_chain_tp") -> None:
    """Queue a launch's status words (every rank's, in rank order) for
    :func:`check_timeouts`."""
    words = torch.cat([s.reshape(-1).to(status[0].device) for s in status])
    done = None
    if words.is_cuda:
        host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
        host.copy_(words, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(words.device))
        words = host
    _tracked.__dict__.setdefault("pending", []).append((words, done, what))


def check_timeouts(wait: bool = True) -> None:
    """Raise if a launch that K9 or K10 made on this thread since the last
    check timed out (:func:`raise_on_timeout`).  ``wait``: read every
    tracked launch's words, waiting for the launches; else only those of the
    launches done by now (the chain's check before each launch, which must
    not wait for the step queued just before it).  The engine calls it after
    each chunk's sync, so no result of a timed-out launch leaves the engine."""
    pending = getattr(_tracked, "pending", [])
    ready = [p for p in pending if wait or p[1] is None or p[1].query()]
    _tracked.pending = [p for p in pending if not any(p is q for q in ready)]
    for _, done, _ in ready:
        if done is not None:
            done.synchronize()
    for words, _, what in ready:
        raise_on_timeout(words.split(1), what)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

ONE_DEVICE_TIMEOUT_NS = 1_000_000_000  # co-resident ranks: a wait this long is a fault
CROSS_DEVICE_TIMEOUT_NS = 10_000_000_000  # ranks on other cards may start later


def check_rows(rows: FusedTPRows, r: int, what: str) -> None:
    """Rank r's row pack as the kernels take it: int8 rows, contiguous,
    16-byte aligned, on CUDA."""
    w = rows.ranks[r]
    if any(t.dtype != torch.int8 for t in (w.wqkv, w.wo, w.wgu, w.wd)):
        raise NotImplementedError(f"{what}: the tensor-parallel kernels take int8 units")
    for t in w:
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: the pack's tensors must be contiguous, 16-byte aligned "
                             "and on CUDA")


def device_groups(devices: Sequence, what: str) -> "OrderedDict":
    """The ranks of each device, in rank order (one launch per device; a
    device's ranks must be consecutive)."""
    groups = OrderedDict()
    for r, dev in enumerate(devices):
        groups.setdefault(dev, []).append(r)
    for ranks in groups.values():
        if ranks != list(range(ranks[0], ranks[0] + len(ranks))):
            raise ValueError(f"{what}: a device's ranks must be consecutive")
    return groups


def blocks_per_rank(groups: "OrderedDict") -> int:
    """The blocks of every rank: a device's SMs over its ranks, the least
    over the devices (block b of every rank owns the same rows, so every
    rank's plan takes the same grid)."""
    return min(persistent.grid_size(dev) // len(ranks) for dev, ranks in groups.items())


class Exchange:
    """Every rank's receive slots, flags, barrier counter and status word
    (``QttsTpLink``) for ``sites`` exchanges of ``W`` floats a call, each
    rank's on its device; ``status``: one tensor per device, its ranks'
    words in rank order."""

    def __init__(self, tp: int, sites: int, W: int, bpr: int, groups: "OrderedDict"):
        from ._build import TpLink

        self.recv, self.flags, self.bars, self.status = [], [], [], []
        self.links = []
        for dev, ranks in groups.items():
            words = torch.zeros(len(ranks), dtype=torch.int32, device=dev)  # zeroed per launch
            self.status.append(words)
            for i, r in enumerate(ranks):
                recv = torch.empty(sites * tp * W, dtype=torch.float32, device=dev)
                # flags start at 0; a call waits for its generation (>= 1)
                flags = torch.zeros(sites * tp * bpr, dtype=torch.int32, device=dev)
                bar = torch.zeros(1, dtype=torch.int32, device=dev)
                self.recv.append(recv)
                self.flags.append(flags)
                self.bars.append(bar)
                self.links.append(TpLink(recv.data_ptr(), flags.data_ptr(), bar.data_ptr(),
                                         words[i:].data_ptr()))
        self.gen = 0

    def next_gen(self) -> int:
        self.gen = (self.gen + 1) & 0xFFFFFFFF or 1
        return self.gen

    def zero_status(self) -> None:
        for words in self.status:
            words.zero_()


def enable_peers(groups: "OrderedDict", what: str) -> int:
    """Peer access between the mesh's distinct cards; returns 1 if there is
    more than one (the exchange then runs at system scope)."""
    distinct = sorted({dev.index for dev in groups})
    if len(distinct) < 2:
        return 0
    from ._build import check, load_kernels

    ids = (ctypes.c_int * len(distinct))(*distinct)
    check(load_kernels().qtts_tp_enable_peers(ids, len(distinct)),
          f"{what}: peer access between the mesh's cards")
    return 1


class _StepEntry:
    """The argument struct, plans, scratch and exchange buffers of one row
    pack at one cache bucket on one set of streams of one thread: built
    once; each call sets its input, caches, position and generation."""

    def __init__(self, cfg: TransformerConfig, rows: FusedTPRows, T: int, devices):
        from ._build import TpStepArgs

        tp = rows.tp
        s = shard_config(cfg, tp)
        H = cfg.hidden_size
        self.groups = device_groups(devices, "fused_decode_step_tp")
        self.bpr = blocks_per_rank(self.groups)
        self.ex = Exchange(tp, 2 * rows.ranks[0].wqkv.shape[0], H, self.bpr, self.groups)
        a = TpStepArgs()
        self.keep, self.plans, self.xs = [], [], []
        for r, dev in enumerate(devices):
            check_rows(rows, r, "fused_decode_step_tp")
            w, sc, scratch = step_structs(s, rows.ranks[r], T, dev)
            plan = persistent.device_plan(s, dev, grid=self.bpr)
            buf = torch.empty(2 * H, dtype=torch.float32, device=dev)  # x, part
            self.keep += [scratch, buf]
            self.plans.append(plan)
            self.xs.append(buf[:H])
            k = a.rank[r]
            k.w, k.s, k.p = w, sc, plan.struct
            k.x, k.part = buf[:H].data_ptr(), buf[H:].data_ptr()
            a.link[r] = self.ex.links[r]
        a.tp = tp
        a.cross_device = enable_peers(self.groups, "fused_decode_step_tp")
        self.timeout_ns = CROSS_DEVICE_TIMEOUT_NS if a.cross_device else ONE_DEVICE_TIMEOUT_NS
        self.args = a


_ENTRIES: "OrderedDict[tuple, _StepEntry]" = OrderedDict()
_MAX_ENTRIES = 8


def step_entry(cfg: TransformerConfig, rows: FusedTPRows, T: int, devices) -> _StepEntry:
    """The cached entry of this row pack, keyed by every pointer it holds."""
    streams = tuple(torch.cuda.current_stream(d).cuda_stream for d in devices)
    key = (cfg, T, tuple(devices), streams, threading.get_ident(),
           *(t.data_ptr() for w in rows.ranks for t in w))
    entry = _ENTRIES.get(key)
    if entry is None:
        entry = _StepEntry(cfg, rows, T, devices)
        _ENTRIES[key] = entry
        while len(_ENTRIES) > _MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
    return entry


class TPStepRun(NamedTuple):
    """One K9 call: rank 0's output and every rank's (for the checks)."""

    x: torch.Tensor  # [1, H] float32 (rank 0's residual)
    xs: List[torch.Tensor]  # per rank [H]
    status: List[torch.Tensor]  # per device: its ranks' words (nonzero: a wait timed out)


def _check_inputs(cfg: TransformerConfig, rows: FusedTPRows, x, k_cache, v_cache,
                  devices) -> None:
    """x [1, H] and each rank's caches [L, 1, nk / tp, T, d] (bf16 or
    float32, contiguous, on the rank's device; L the rows' layers), as the
    kernel reads them."""
    tp = len(devices)
    if x.numel() != cfg.hidden_size or len(k_cache) != tp or len(v_cache) != tp:
        raise ValueError(f"fused_decode_step_tp: x of {x.numel()} values and {len(k_cache)} "
                         f"cache shards for H={cfg.hidden_size} and {tp} ranks")
    shape = (rows.ranks[0].wqkv.shape[0], 1, cfg.num_kv_heads // tp, k_cache[0].shape[3],
             cfg.head_dim)
    for r, dev in enumerate(devices):
        for t in (k_cache[r], v_cache[r]):
            if tuple(t.shape) != shape:
                raise ValueError(f"fused_decode_step_tp: a cache shard of shape "
                                 f"{tuple(t.shape)}, not {shape}")
            if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != k_cache[0].dtype:
                raise NotImplementedError(f"KV cache dtype {t.dtype}: the tensor-parallel step "
                                          "takes bfloat16 and float32 caches")
            if t.device != dev or not t.is_contiguous():
                raise ValueError("fused_decode_step_tp: a rank's caches must be contiguous and "
                                 "on its device")


def launch_step_tp(cfg: TransformerConfig, rows: FusedTPRows, x: torch.Tensor, pos: int,
                   k_cache: Sequence[torch.Tensor], v_cache: Sequence[torch.Tensor], mesh,
                   stall_ns: int = 0, timeout_ns: Optional[int] = None) -> TPStepRun:
    """Launch K9 on CUDA tensors (counted on :func:`fused_decode_step_tp`,
    one per device's launch): one C call per device, every status word
    zeroed first; the run's status words are the entry's, valid until its
    next call.  ``stall_ns``:
    odd ranks hold each exchange's send back that long; ``timeout_ns``: a
    wait's limit (None: the entry's; both knobs are the checks')."""
    from ._build import check, load_kernels

    devices = mesh.model_devices()
    if any(dev.type != "cuda" for dev in devices) or x.device.type != "cuda":
        raise ValueError(f"fused_decode_step_tp: the mesh's devices must be CUDA, got {devices}")
    if rows.tp != len(devices):
        raise ValueError(f"fused_decode_step_tp: a pack of {rows.tp} ranks on {len(devices)}")
    _check_inputs(cfg, rows, x, k_cache, v_cache, devices)
    T = k_cache[0].shape[3]
    pos = min(int(pos), T - 1)
    H = cfg.hidden_size
    lib = load_kernels()
    e = step_entry(cfg, rows, T, devices)
    a = e.args
    a.gen = e.ex.next_gen()
    a.T, a.pos, a.cache_bf16 = T, pos, int(k_cache[0].dtype == torch.bfloat16)
    a.stall_ns = int(stall_ns)
    a.timeout_ns = e.timeout_ns if timeout_ns is None else int(timeout_ns)
    x_out = torch.empty((1, H), dtype=torch.float32, device=devices[0])
    inputs = {}
    for r, dev in enumerate(devices):
        if dev not in inputs:
            inputs[dev] = x.float().reshape(-1).to(dev).contiguous()
        k = a.rank[r]
        k.x_in, k.k_cache, k.v_cache = (inputs[dev].data_ptr(), k_cache[r].data_ptr(),
                                        v_cache[r].data_ptr())
        k.p = e.plans[r].struct  # a trace may have been switched on or off
    a.rank[0].x = x_out.data_ptr()
    e.ex.zero_status()
    for dev, ranks in e.groups.items():
        a.rank0, a.n_local, a.bpr = ranks[0], len(ranks), e.bpr
        fused_decode_step_tp.launches += 1
        with torch.cuda.device(dev):
            err = lib.qtts_tp_decode_step(ctypes.byref(a),
                                          torch.cuda.current_stream(dev).cuda_stream)
        check(err, "fused_decode_step_tp")
    return TPStepRun(x_out, [x_out.reshape(-1)] + e.xs[1:], e.ex.status)


def fused_decode_step_tp(
    cfg: TransformerConfig,
    rows: FusedTPRows,
    x: torch.Tensor,  # [1, H]
    pos: int,
    k_cache: Sequence[torch.Tensor],  # per rank [L, 1, nk / tp, T, d], updated in place
    v_cache: Sequence[torch.Tensor],
    mesh,
) -> tuple:
    """One decode step over all layers on the mesh's model ranks (the
    pre-final-norm output).  ``pos`` is clamped to the last slot like the
    reference.

    Returns (x_out [1, H] float32 on the mesh's first device, k_cache,
    v_cache)."""
    if x.device.type == "cpu":
        return fused_decode_step_tp_reference(cfg, rows, x, pos, k_cache, v_cache, mesh)
    run = launch_step_tp(cfg, rows, x, pos, k_cache, v_cache, mesh)
    track(run.status, "fused_decode_step_tp")
    return run.x, k_cache, v_cache


fused_decode_step_tp.launches = 0  # launches (one per device and step), for chip_smoke.py
