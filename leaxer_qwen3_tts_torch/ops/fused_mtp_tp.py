"""Kernel K10: the tensor-parallel MTP sub-code chain, its exchange inside the kernel.

Port of ``leaxer_qwen3_tts_tpu/ops/fused_mtp_tp.py``.  Each model rank runs
the whole chain of one frame on its shard of the trunk (the row pack of
:func:`~leaxer_qwen3_tts_torch.ops.fused_tp.pack_rows`: qkv and gate-up
rows, wo and down columns, its own kv heads of a float32 scratch) and its
slice of every step head's rows ([n, V, H / tp]: the rank's columns of the
head's [V, H] rows); the [1, H] partial sums after wo and down and the
[1, V] head partials (before the scale) are all-reduced, the ranks' values
summed by the hypercube (log2(tp) rounds, in round r rank me adds the value
of rank me ^ (1 << r) after its own).  The noise is replicated, so every rank draws the
same sub-code.  Returns (subcodes [1, n] int32, sub_sum [1, H] float32).

On CUDA tensors :func:`fused_mtp_chain_tp` launches the hand-written kernel
(``csrc/fused_mtp_tp.cu``: one persistent cooperative launch per device for
every rank placed there, each rank's rows streamed through the TMA weight
ring, the exchange through flags in device memory); on CPU tensors it runs
:func:`fused_mtp_chain_tp_reference`, the plain version, which rounds every
product and sum as the kernel does and sums in its order (the norms' trees,
the row products' slices and chunks, the attention's lanes, the
hypercube), so
that the two agree bit for bit on the card.  A chain whose exchange timed
out raises at :func:`check_timeouts` (the next chain's check, or the
engine's after each chunk's sync): its status words are read behind the
launch, so the host does not wait for the chain.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..config import TransformerConfig
from . import persistent
from .fused_mtp import RESIDENT_MAX_BYTES, gumbel_topk_topp_sample
from .fused_step import _bf16, _weights_struct, attn_scale
from .fused_tp import (CROSS_DEVICE_TIMEOUT_NS, ONE_DEVICE_TIMEOUT_NS, Exchange, FusedTPRows,
                       _dims, blocks_per_rank, check_rows, check_timeouts, device_groups,
                       enable_peers, hypercube_sum, raise_on_timeout, shard_config, supports_tp,
                       track)
from .quant import QuantizedLinear

# the exchange's, shared with K9
__all__ = ["check_timeouts", "hypercube_sum", "raise_on_timeout", "track"]

# The JAX package's fixed VMEM beyond the resident trunk shard (head double
# buffer, exchange slots, activations, the KV scratch), kept with
# RESIDENT_MAX_BYTES as the routing rule: the port takes K10 exactly where
# the JAX package does.  Hopper holds no shard resident; the bytes are the TPU's.
_TP_FIXED = 16 * 1024 * 1024


def supports_tp_resident(cfg: TransformerConfig, tp: int, n_steps: int, V: int) -> bool:
    """The JAX package's gate for the sharded chain: a power-of-two tp, the
    tile schedule, lane-aligned head row shards, and the int8 trunk shard
    plus fixed buffers within the resident budget."""
    if tp < 2 or tp & (tp - 1):
        return False  # hypercube all-reduce: power-of-two only
    if not supports_tp(cfg, tp):
        return False
    H = cfg.hidden_size
    if (H // tp) % 128:
        return False  # head row-shard slice must be lane-aligned
    per_layer = (
        H * (cfg.q_dim + 2 * cfg.kv_dim)  # qkv
        + cfg.q_dim * H  # wo
        + H * 2 * cfg.intermediate_size  # gate+up
        + cfg.intermediate_size * H  # down
    )
    shard = cfg.num_layers * per_layer // tp  # int8 = 1 byte/weight
    heads_buf = 2 * (H // tp) * V  # int8 double buffer
    return shard + heads_buf + _TP_FIXED <= RESIDENT_MAX_BYTES


class TPHeads(NamedTuple):
    """The step heads sharded over the ranks along H: rank r's inputs
    [r H / tp, (r + 1) H / tp) of every head, as rows (one per output
    column, the rank's H / tp inputs contiguous), and the heads' scales."""

    q: List[torch.Tensor]  # per rank [n, V, H / tp], int8 or bf16
    scale: List[torch.Tensor]  # per rank [n, V] f32 (ones for bf16 heads)


def shard_heads(heads: Union[QuantizedLinear, torch.Tensor], devices: Sequence) -> TPHeads:
    """Shard step heads [n, H, V] over the ranks along H, as rows: int8
    ``QuantizedLinear`` heads with their scales, or raw heads as bf16 with
    scales of one (the JAX chain's two branches)."""
    if isinstance(heads, QuantizedLinear):
        q, scale = heads.q, heads.scale.float()
    else:
        q = heads.to(torch.bfloat16)
        scale = torch.ones((q.shape[0], 1, q.shape[2]), dtype=torch.float32, device=q.device)
    n, H, V = q.shape
    Hs = H // len(devices)
    scale = scale.reshape(n, V).contiguous()
    return TPHeads(q=[q[:, r * Hs : (r + 1) * Hs].transpose(1, 2).contiguous().to(d)
                      for r, d in enumerate(devices)],
                   scale=[scale.to(d) for d in devices])


def _as_heads(heads, devices) -> TPHeads:
    return heads if isinstance(heads, TPHeads) else shard_heads(heads, devices)


# The kernel's block and the slices of its row products (QTTS_P_THREADS,
# tp_stage_rows' 16 slices): the plain version sums in the kernel's order.
_THREADS = 256
_SLICES = 16


def _tree(x: torch.Tensor) -> torch.Tensor:
    """[..., 2^m] -> [...]: K10's halving tree (``tp_tree``, and the warp's
    xor tree: round o adds element t + o to element t, t < o)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _inv_rms(ss: torch.Tensor, K: int, eps: float) -> torch.Tensor:
    return 1.0 / torch.sqrt(ss / K + eps)


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of x [..., K] times w as K10's ``tp_prologue`` sums it: thread
    t of 256 adds the squares of k = t, t + 256, ... in order, the halving
    tree adds the 256 sums."""
    K = x.shape[-1]
    sq = F.pad(x * x, (0, (-K) % _THREADS))
    sq = sq.reshape(*x.shape[:-1], -1, _THREADS)
    ss = torch.zeros_like(sq[..., 0, :])
    for m in range(sq.shape[-2]):
        ss = ss + sq[..., m, :]
    return (x * _inv_rms(_tree(ss), K, eps)[..., None]) * w


def _head_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of heads x [..., D] times w: the squares added by the tree."""
    return (x * _inv_rms(_tree(x * x), x.shape[-1], eps)[..., None]) * w


def _units(h: torch.Tensor, rows: torch.Tensor, scales: Optional[torch.Tensor],
           KC: int) -> torch.Tensor:
    """The row product of R ranks as ``tp_stage_rows`` sums it: h [R, K]
    (bf16 values), rows [R, N, K] (int8 or bf16) and scales [R, N] (or
    None) -> [R, N].  Per KC-column chunk, 16 slices of columns s, s + 16,
    ... summed in column order (each bf16 x int8 or bf16 product is exact in
    float32), the slices added in order, times the row's scale; the chunks
    added in order (the JAX pack's units: chunk i of a K-split product is
    its unit row i)."""
    R, K = h.shape
    N, nc = rows.shape[1], K // KC
    w = rows.reshape(R, N, nc, KC // _SLICES, _SLICES).float()
    hh = h.reshape(R, 1, nc, KC // _SLICES, _SLICES)
    acc = torch.zeros((R, N, nc, _SLICES), dtype=torch.float32, device=h.device)
    for m in range(KC // _SLICES):
        acc = acc + hh[:, :, :, m] * w[:, :, :, m]
    d = acc[..., 0]
    for s in range(1, _SLICES):
        d = d + acc[..., s]
    if scales is not None:
        d = d * scales[..., None]
    out = d[..., 0]
    for i in range(1, nc):
        out = out + d[..., i]
    return out


def _attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, scale: float) -> torch.Tensor:
    """q [R, nk, g, D] over the slots kc, vc [R, nk, S, D] -> [R, nk, g, D],
    as K10's attention item sums: 4-wide lane dots in order, the warp's
    tree over the 32 lanes, times the scale; exp(s - max) summed in slot
    order; the weighted values summed in slot order."""
    R, nk, g, D = q.shape
    S = kc.shape[2]
    prod = q.reshape(R, nk, g, 1, D // 4, 4) * kc.reshape(R, nk, 1, S, D // 4, 4)
    dot = torch.zeros_like(prod[..., 0])
    for e in range(4):
        dot = dot + prod[..., e]
    sc = _tree(dot) * scale  # [R, nk, g, S]
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    total = torch.zeros_like(e[..., 0])
    for s in range(S):
        total = total + e[..., s]
    wt = e / total[..., None]
    out = torch.zeros_like(q)
    for s in range(S):
        out = out + wt[..., s, None] * vc[:, :, None, s]
    return out


def rope_table(inv_freq: torch.Tensor, T: int) -> torch.Tensor:
    """[T, 2, D / 2]: cos and sin of position x inv_freq for positions 0..T-1,
    the table K10 reads (made on the device it is read on)."""
    ang = torch.arange(T, dtype=torch.float32, device=inv_freq.device)[:, None] * inv_freq
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=1).contiguous()


def _rope_at(x: torch.Tensor, table: torch.Tensor, pos: int) -> torch.Tensor:
    half = x.shape[-1] // 2
    c, s = table[pos, 0], table[pos, 1]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def fused_mtp_chain_tp_reference(
    cfg: TransformerConfig,
    tp: int,
    rows: FusedTPRows,
    final_norm: torch.Tensor,  # [H]
    heads: TPHeads,
    tables: torch.Tensor,  # [n, Vt, H]
    last_hidden: torch.Tensor,  # [1, H]
    code0_embed: torch.Tensor,  # [1, H]
    gumbel: Optional[torch.Tensor],  # [n, 1, V] f32 (unused when greedy)
    temperature: float,
    top_k: int,
    top_p: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K10, every rank's arithmetic on
    last_hidden's device, each sum in the kernel's order; same contract."""
    subcodes, sub_sum, _ = chain_tp_plain(cfg, tp, rows, final_norm, heads, tables, last_hidden,
                                          code0_embed, gumbel, temperature, top_k, top_p)
    return subcodes, sub_sum


def chain_tp_plain(cfg, tp, rows, final_norm, heads, tables, last_hidden, code0_embed, gumbel,
                   temperature, top_k, top_p):
    """:func:`fused_mtp_chain_tp_reference` and the residual [H] after the
    last trunk pass (the same on every rank; the checks compare each rank's)."""
    H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = _dims(cfg, tp)
    eps = cfg.rms_norm_eps
    dev = last_hidden.device
    n, V, Hs = heads.q[0].shape
    T = n + 2
    L = rows.ranks[0].wqkv.shape[0]
    u = {name: torch.stack([getattr(w, name).to(dev) for w in rows.ranks]) for name in (
        "wqkv", "sqkv", "wo", "so", "wgu", "sgu", "wd", "sd")}  # [tp, L, ...]
    w0 = rows.ranks[0]
    an, mn = w0.attn_norm.to(dev), w0.mlp_norm.to(dev)
    qn, kn = w0.q_norm.to(dev), w0.k_norm.to(dev)
    rope = rope_table(w0.inv_freq.to(dev), T)
    hq = torch.stack([q.to(dev) for q in heads.q])  # [tp, n, V, Hs]
    hs = heads.scale[0].to(dev)
    kc = torch.zeros((tp, L, nk_s, T, d), dtype=torch.float32, device=dev)
    vc = torch.zeros_like(kc)
    fn = final_norm.float().to(dev)
    g = nq_s // nk_s

    def allreduce(parts):
        return hypercube_sum(list(parts))

    def trunk_pass(x, pos):
        for l in range(L):
            h = _bf16(_norm(x, an[l], eps)).expand(tp, H)
            qkv = _units(h, u["wqkv"][:, l], u["sqkv"][:, l], H)
            q = _head_norm(qkv[:, :qd_s].reshape(tp, nq_s, d), qn[l], eps)
            k = _head_norm(qkv[:, qd_s : qd_s + kvd_s].reshape(tp, nk_s, d), kn[l], eps)
            kc[:, l, :, pos] = _rope_at(k, rope, pos)
            vc[:, l, :, pos] = qkv[:, qd_s + kvd_s :].reshape(tp, nk_s, d)
            attn = _attend(_rope_at(q, rope, pos).reshape(tp, nk_s, g, d),
                           kc[:, l, :, : pos + 1], vc[:, l, :, : pos + 1], attn_scale(d))
            x = x + allreduce(_units(_bf16(attn.reshape(tp, qd_s)), u["wo"][:, l], u["so"][:, l],
                                     KCo))
            h = _bf16(_norm(x, mn[l], eps)).expand(tp, H)
            gu = _units(h, u["wgu"][:, l], u["sgu"][:, l], H)
            gate, up = gu[:, :I_s], gu[:, I_s:]
            act = _bf16(gate * (1.0 / (1.0 + torch.exp(-gate))) * up)
            x = x + allreduce(_units(act, u["wd"][:, l], u["sd"][:, l], KCd))
        return x

    subs = []
    ssum = None
    inp = last_hidden.float().reshape(H).to(dev)
    x = inp
    for it in range(n + 2):
        if it == 1:
            inp = code0_embed.float().reshape(H).to(dev)
        if it >= 2:
            j = it - 2
            hp = _bf16(_norm(x, fn, eps)).reshape(tp, Hs)
            logits = (allreduce(_units(hp, hq[:, j], None, Hs)) * hs[j])[None]
            sub = gumbel_topk_topp_sample(logits, None if gumbel is None else gumbel[j].to(dev),
                                          temperature, top_k, top_p)
            subs.append(sub)
            inp = tables[j][sub[0]].float().to(dev)
            ssum = inp if ssum is None else ssum + inp
        if it <= n:
            x = trunk_pass(inp, it)
    return torch.stack(subs, dim=1).to(torch.int32), ssum[None], x


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


class TPChainRun(NamedTuple):
    """One K10 call: rank 0's outputs and every rank's (for the checks)."""

    subcodes: torch.Tensor  # [1, n] int32 (rank 0's)
    sub_sum: torch.Tensor  # [1, H] float32 (rank 0's)
    codes: List[torch.Tensor]  # per rank [n] int32
    x: List[torch.Tensor]  # per rank [H] float32: the residual after the last pass
    status: List[torch.Tensor]  # per device: its ranks' words (nonzero: a wait timed out)


class _RankBuffers:
    """Rank r's activations, scratch cache and outputs on its device."""

    def __init__(self, cfg, tp, L, n, V, W, device):
        s = shard_config(cfg, tp)
        H, d, T = cfg.hidden_size, cfg.head_dim, n + 2
        A_s = s.q_dim + 2 * s.kv_dim
        sizes = [H, H, A_s, s.q_dim, 2 * s.intermediate_size, W, V,
                 L * s.num_kv_heads * T * d, L * s.num_kv_heads * T * d, H]
        self.buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        (self.x, self.x_in, self.qkv, self.attn, self.gu, self.part, self.logits, self.kc,
         self.vc, self.sub_sum) = torch.split(self.buf, sizes)
        self.codes = torch.zeros(n, dtype=torch.int32, device=device)


class _ChainEntry:
    """The argument struct, plans and every rank's buffers of one (row pack,
    heads, tables) on one set of streams of one thread: built once; each
    call sets its inputs, knobs and generation."""

    def __init__(self, cfg, tp, rows, heads, tables, devices):
        from ._build import TpChainArgs

        n, V, Hs = heads.q[0].shape
        H, L = cfg.hidden_size, rows.ranks[0].wqkv.shape[0]
        s = shard_config(cfg, tp)
        self.devices = list(devices)
        self.groups = device_groups(devices, "fused_mtp_chain_tp")
        self.bpr = blocks_per_rank(self.groups)
        sites = (n + 1) * 2 * L + n
        W = max(H, V)
        self.ex = Exchange(tp, sites, W, self.bpr, self.groups)
        self.ranks = [_RankBuffers(cfg, tp, L, n, V, W, dev) for dev in devices]
        self.rope = [rope_table(rows.ranks[r].inv_freq, n + 2) for r in range(tp)]
        self.plans = []
        a = TpChainArgs()
        for r, (b, dev) in enumerate(zip(self.ranks, devices)):
            plan = persistent.device_plan(s, dev, head_rows=V, grid=self.bpr, head_k=Hs,
                                          head_bytes=heads.q[r].element_size())
            self.plans.append(plan)
            k = a.rank[r]
            k.w, k.p = _weights_struct(s, rows.ranks[r]), plan.struct
            k.heads, k.head_scales = heads.q[r].data_ptr(), heads.scale[r].data_ptr()
            k.rope = self.rope[r].data_ptr()
            for name in ("x", "x_in", "qkv", "attn", "gu", "part", "logits", "codes", "sub_sum"):
                setattr(k, name, getattr(b, name).data_ptr())
            k.k_cache, k.v_cache = b.kc.data_ptr(), b.vc.data_ptr()
            a.link[r] = self.ex.links[r]
        a.tp, a.n, a.V, a.Vt, a.W = tp, n, V, tables.shape[1], W
        a.KCo, a.KCd = _dims(cfg, tp)[9:]
        a.heads_bf16 = int(heads.q[0].dtype == torch.bfloat16)
        a.cross_device = enable_peers(self.groups, "fused_mtp_chain_tp")
        self.timeout_ns = CROSS_DEVICE_TIMEOUT_NS if a.cross_device else ONE_DEVICE_TIMEOUT_NS
        self.args = a


_ENTRIES: "OrderedDict[tuple, _ChainEntry]" = OrderedDict()
_MAX_ENTRIES = 8


def chain_entry(cfg, tp, rows, heads, tables, devices) -> _ChainEntry:
    """The cached entry of these tensors, keyed by every pointer it holds."""
    streams = tuple(torch.cuda.current_stream(d).cuda_stream for d in devices)
    key = (cfg, tp, tuple(devices), streams, threading.get_ident(), heads.q[0].dtype,
           tables.data_ptr(), *(t.data_ptr() for w in rows.ranks for t in w),
           *(t.data_ptr() for leaf in heads for t in leaf))
    entry = _ENTRIES.get(key)
    if entry is None:
        entry = _ChainEntry(cfg, tp, rows, heads, tables, devices)
        _ENTRIES[key] = entry
        while len(_ENTRIES) > _MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
    return entry


def launch_chain_tp(cfg, tp, mesh, rows, final_norm, heads, tables, last_hidden, code0_embed,
                    gumbel, temperature, top_k, top_p, stall_ns: int = 0,
                    timeout_ns: Optional[int] = None) -> TPChainRun:
    """Launch K10 on CUDA tensors (counted on :func:`fused_mtp_chain_tp`, one
    per device's launch);
    every rank's status word is zeroed first.  ``stall_ns``: odd ranks hold
    each exchange's send back that long; ``timeout_ns``: a wait's limit
    (None: the entry's; both knobs are the checks')."""
    from ._build import check, load_kernels
    from ..runtime.sampling import clamp_temperature

    devices = mesh.model_devices()
    if any(dev.type != "cuda" for dev in devices):
        raise ValueError(f"fused_mtp_chain_tp: the mesh's devices must be CUDA, got {devices}")
    heads = _as_heads(heads, devices)
    n, V, Hs = heads.q[0].shape
    H = cfg.hidden_size
    greedy = temperature <= 0.0
    if gumbel is None and not greedy:
        raise ValueError("sampled chain needs Gumbel noise [n, 1, V]")
    if tables.dtype != torch.bfloat16:
        raise NotImplementedError(f"embedding tables of dtype {tables.dtype}: the chain "
                                  "kernels take bf16 tables")
    if heads.q[0].dtype not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(f"{heads.q[0].dtype} heads: K10 takes int8 and bf16 heads")
    for r in range(tp):
        check_rows(rows, r, "fused_mtp_chain_tp")
        if not heads.q[r].is_contiguous() or heads.q[r].data_ptr() % 16:
            raise ValueError("fused_mtp_chain_tp: the head rows must be contiguous and 16-byte "
                             "aligned")
    lib = load_kernels()
    e = chain_entry(cfg, tp, rows, heads, tables, devices)
    a = e.args
    a.gen = e.ex.next_gen()
    a.temperature, a.top_k, a.top_p = clamp_temperature(temperature), int(top_k), float(top_p)
    a.greedy, a.stall_ns = int(greedy), int(stall_ns)
    a.timeout_ns = e.timeout_ns if timeout_ns is None else int(timeout_ns)
    keep = []  # the inputs' device copies, alive until the launches are enqueued
    for r, dev in enumerate(devices):
        lh = last_hidden.float().reshape(-1).to(dev).contiguous()
        c0 = code0_embed.float().reshape(-1).to(dev).contiguous()
        fn = final_norm.float().reshape(-1).to(dev).contiguous()
        tab = tables.to(dev).contiguous()
        noise = e.ranks[r].logits if greedy else gumbel.float().reshape(n, V).to(dev).contiguous()
        keep += [lh, c0, fn, tab, noise]
        k = a.rank[r]
        k.last_hidden, k.code0_embed, k.final_norm = lh.data_ptr(), c0.data_ptr(), fn.data_ptr()
        k.tables, k.gumbel = tab.data_ptr(), noise.data_ptr()
        k.p = e.plans[r].struct  # a trace may have been switched on or off
    e.ex.zero_status()
    for dev, ranks in e.groups.items():
        a.rank0, a.n_local, a.bpr = ranks[0], len(ranks), e.bpr
        fused_mtp_chain_tp.launches += 1
        with torch.cuda.device(dev):
            err = lib.qtts_tp_mtp_chain(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        check(err, "fused_mtp_chain_tp")
    b0 = e.ranks[0]
    return TPChainRun(b0.codes.clone().reshape(1, n), b0.sub_sum.clone().reshape(1, H),
                      [b.codes.clone() for b in e.ranks], [b.x.clone() for b in e.ranks],
                      [w.clone() for w in e.ex.status])


def fused_mtp_chain_tp(
    cfg: TransformerConfig,
    tp: int,
    mesh,
    rows: FusedTPRows,
    final_norm: torch.Tensor,  # [H]
    heads,  # TPHeads, or QuantizedLinear / raw [n, H, V] (sharded here)
    tables: torch.Tensor,  # [n, Vt, H] (replicated)
    last_hidden: torch.Tensor,  # [1, H]
    code0_embed: torch.Tensor,  # [1, H]
    gumbel: Optional[torch.Tensor],  # [n, 1, V] f32, replicated noise (None when greedy)
    temperature: float,
    top_k: int,
    top_p: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain on the mesh's model ranks.  Returns (subcodes [1, n] int32,
    sub_sum [1, H] float32) on rank 0's device."""
    if last_hidden.device.type == "cpu":
        return fused_mtp_chain_tp_reference(
            cfg, tp, rows, final_norm, _as_heads(heads, mesh.model_devices()), tables,
            last_hidden, code0_embed, gumbel, temperature, top_k, top_p)
    check_timeouts(wait=False)  # the launches done by now: no wait for the step just queued
    run = launch_chain_tp(cfg, tp, mesh, rows, final_norm, heads, tables, last_hidden,
                          code0_embed, gumbel, temperature, top_k, top_p)
    track(run.status)
    return run.subcodes, run.sub_sum


fused_mtp_chain_tp.launches = 0  # launches (one per device and chain), for chip_smoke.py
