"""Kernel K10: the tensor-parallel MTP sub-code chain, its exchange inside the kernel.

Port of ``leaxer_qwen3_tts_tpu/ops/fused_mtp_tp.py``.  Each model rank runs
the whole chain of one frame on its shard of the trunk (the
:class:`~leaxer_qwen3_tts_torch.ops.fused_tp.FusedTPWeights` pack: qkv and
gate-up columns, wo and down rows, its own kv heads of a float32 scratch)
and its rows of every step head; the [1, H] partial sums after wo and down
and the [1, V] head partials (before the scale) are all-reduced by a
hypercube (log2(tp) rounds, in round r rank me adds the value of rank
me ^ (1 << r) after its own).  The noise is replicated, so every rank draws
the same sub-code.  Returns (subcodes [1, n] int32, sub_sum [1, H] float32).

On CUDA tensors :func:`fused_mtp_chain_tp` launches the hand-written kernel
(``csrc/fused_mtp_tp.cu``: one persistent cooperative launch per device for
every rank placed there, the exchange through flags in device memory); on
CPU tensors it runs :func:`fused_mtp_chain_tp_reference`, the plain version,
which rounds every product and sum as the kernel does and sums in its order
(the norms' trees, the units' row slices, the attention's lanes, the
hypercube), so that the two agree bit for bit on the card.  A chain whose
exchange timed out raises at the next chain or at :func:`check_timeouts`,
which the engine calls after each chunk's sync: its status words are read
behind the launch, so the host does not wait for the chain.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..config import TransformerConfig
from .fused_mtp import RESIDENT_MAX_BYTES, gumbel_topk_topp_sample
from .fused_step import _bf16, attn_scale
from .fused_tp import FusedTPWeights, _dims, check_pack, supports_tp
from .quant import QuantizedLinear

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
    """The step heads row-sharded over the ranks: rank r's rows
    [r H / tp, (r + 1) H / tp) of every head, and the heads' scales."""

    q: List[torch.Tensor]  # per rank [n, H / tp, V], int8 or bf16
    scale: List[torch.Tensor]  # per rank [n, V] f32 (ones for bf16 heads)


def shard_heads(heads: Union[QuantizedLinear, torch.Tensor], devices: Sequence) -> TPHeads:
    """Row-shard step heads [n, H, V]: int8 ``QuantizedLinear`` heads with
    their scales, or raw heads as bf16 with scales of one (the JAX chain's
    two branches)."""
    if isinstance(heads, QuantizedLinear):
        q, scale = heads.q, heads.scale.float()
    else:
        q = heads.to(torch.bfloat16)
        scale = torch.ones((q.shape[0], 1, q.shape[2]), dtype=torch.float32, device=q.device)
    n, H, V = q.shape
    Hs = H // len(devices)
    scale = scale.reshape(n, V).contiguous()
    return TPHeads(q=[q[:, r * Hs : (r + 1) * Hs].contiguous().to(d)
                      for r, d in enumerate(devices)],
                   scale=[scale.to(d) for d in devices])


def _as_heads(heads, devices) -> TPHeads:
    return heads if isinstance(heads, TPHeads) else shard_heads(heads, devices)


def hypercube_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's all-reduce on the ranks' values (one device): round r
    gives rank i its value plus rank i ^ (1 << r)'s; every rank ends with
    the same bits.  Returns rank 0's."""
    vals = list(parts)
    step = 1
    while step < len(vals):
        vals = [vals[i] + vals[i ^ step] for i in range(len(vals))]
        step <<= 1
    return vals[0]


# The kernel's block and the row slices of its unit products (QTTS_TP_THREADS,
# QTTS_TP_SLICES): the plain version sums in the kernel's order.
_THREADS = 256
_SLICES = 16


def _tree(x: torch.Tensor) -> torch.Tensor:
    """[..., 2^m] -> [...]: K10's halving tree (``tp_tree``: round o adds
    element t + o to element t, t < o)."""
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


def _units(h: torch.Tensor, units: torch.Tensor, scales: Optional[torch.Tensor], KC: int, NU: int,
           N: int) -> torch.Tensor:
    """The unit product of R ranks as ``qtts_tp_tile`` sums it: h [R, nc KC]
    (bf16 values), units [R, nc N / NU, KC, NU] and scales [R, nc N / NU, NU]
    (or None) -> [R, N].  Per chunk, 16 slices of rows s, s + 16, ... summed
    in row order (each bf16 x int8 or bf16 product is exact in float32), the
    slices added in order, times the unit column's scale; the chunks added
    in order."""
    R, nc, nn = h.shape[0], h.shape[1] // KC, N // NU
    w = units.reshape(R, nc, nn, KC, NU).permute(0, 1, 3, 2, 4).reshape(
        R, nc, KC // _SLICES, _SLICES, N).float()
    hh = h.reshape(R, nc, KC // _SLICES, _SLICES, 1)
    acc = torch.zeros((R, nc, _SLICES, N), dtype=torch.float32, device=h.device)
    for m in range(KC // _SLICES):
        acc = acc + hh[:, :, m] * w[:, :, m]
    d = acc[:, :, 0]
    for s in range(1, _SLICES):
        d = d + acc[:, :, s]
    if scales is not None:
        d = d * scales.reshape(R, nc, N)
    out = d[:, 0]
    for i in range(1, nc):
        out = out + d[:, i]
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
    fw: FusedTPWeights,
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
    subcodes, sub_sum, _ = chain_tp_plain(cfg, tp, fw, final_norm, heads, tables, last_hidden,
                                          code0_embed, gumbel, temperature, top_k, top_p)
    return subcodes, sub_sum


def chain_tp_plain(cfg, tp, fw, final_norm, heads, tables, last_hidden, code0_embed, gumbel,
                   temperature, top_k, top_p):
    """:func:`fused_mtp_chain_tp_reference` and the residual [H] after the
    last trunk pass (the same on every rank; the checks compare each rank's)."""
    H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = _dims(cfg, tp)
    eps = cfg.rms_norm_eps
    dev = last_hidden.device
    n, Hs, V = heads.q[0].shape
    T = n + 2
    L = fw.qkv_u[0].shape[0]
    u = {name: torch.stack([t.to(dev) for t in getattr(fw, name)]) for name in (
        "qkv_u", "qkv_s", "wo_u", "wo_s", "gu_u", "gu_s", "wd_u", "wd_s")}  # [tp, L, ...]
    an, mn = fw.attn_norm[0].to(dev)[:, 0], fw.mlp_norm[0].to(dev)[:, 0]
    qn, kn = fw.q_norm[0].to(dev)[:, 0], fw.k_norm[0].to(dev)[:, 0]
    rope = rope_table(fw.inv_freq[0].to(dev), T)
    hq = torch.stack([q.to(dev) for q in heads.q])  # [tp, n, Hs, V]
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
            qkv = _units(h, u["qkv_u"][:, l], u["qkv_s"][:, l], H, NU, A_s)
            q = _head_norm(qkv[:, :qd_s].reshape(tp, nq_s, d), qn[l], eps)
            k = _head_norm(qkv[:, qd_s : qd_s + kvd_s].reshape(tp, nk_s, d), kn[l], eps)
            kc[:, l, :, pos] = _rope_at(k, rope, pos)
            vc[:, l, :, pos] = qkv[:, qd_s + kvd_s :].reshape(tp, nk_s, d)
            attn = _attend(_rope_at(q, rope, pos).reshape(tp, nk_s, g, d),
                           kc[:, l, :, : pos + 1], vc[:, l, :, : pos + 1], attn_scale(d))
            x = x + allreduce(_units(_bf16(attn.reshape(tp, qd_s)), u["wo_u"][:, l],
                                     u["wo_s"][:, l], KCo, NU, H))
            h = _bf16(_norm(x, mn[l], eps)).expand(tp, H)
            gu = _units(h, u["gu_u"][:, l], u["gu_s"][:, l], H, NU, 2 * I_s)
            gate, up = gu[:, :I_s], gu[:, I_s:]
            act = _bf16(gate * (1.0 / (1.0 + torch.exp(-gate))) * up)
            x = x + allreduce(_units(act, u["wd_u"][:, l], u["wd_s"][:, l], KCd, NU, H))
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
            logits = allreduce(_units(hp, hq[:, j].reshape(tp, 1, Hs, V), None, Hs, V, V))
            logits = (logits * hs[j])[None]
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

ONE_DEVICE_TIMEOUT_NS = 1_000_000_000  # co-resident ranks: a wait this long is a fault
CROSS_DEVICE_TIMEOUT_NS = 10_000_000_000  # ranks on other cards may start later


class TPChainRun(NamedTuple):
    """One K10 call: rank 0's outputs and every rank's (for the checks)."""

    subcodes: torch.Tensor  # [1, n] int32 (rank 0's)
    sub_sum: torch.Tensor  # [1, H] float32 (rank 0's)
    codes: List[torch.Tensor]  # per rank [n] int32
    x: List[torch.Tensor]  # per rank [H] float32: the residual after the last pass
    status: List[torch.Tensor]  # per rank [1] int32: nonzero if an exchange timed out


class _RankBuffers:
    """Rank r's scratch, receive slots and flags on its device."""

    def __init__(self, cfg, tp, L, n, V, H, sites, W, device):
        _, d, nq_s, nk_s, qd_s, _, A_s, I_s, _, _, _ = _dims(cfg, tp)
        T = n + 2
        rounds = tp.bit_length() - 1
        sizes = [H, H, A_s, qd_s, 2 * I_s, V, L * nk_s * T * d, L * nk_s * T * d,
                 sites * rounds * W, H]
        self.buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        (self.x, self.x_in, self.qkv, self.attn, self.gu, self.logits, self.kc, self.vc,
         self.recv, self.sub_sum) = torch.split(self.buf, sizes)
        # flags start at 0; a call waits for its generation (>= 1)
        self.flags = torch.zeros(sites * rounds * (W // 64), dtype=torch.int32, device=device)
        self.codes = torch.zeros(n, dtype=torch.int32, device=device)
        self.status = torch.zeros(1, dtype=torch.int32, device=device)  # zeroed per launch


class _ChainEntry:
    """The argument struct and every rank's buffers of one (pack, heads,
    tables) on one set of streams of one thread: built once; each call sets
    its inputs, knobs and generation."""

    def __init__(self, cfg, tp, fw, heads, tables, devices):
        from ._build import TpChainArgs, load_kernels
        from .fused_tp import _weights_struct

        n, Hs, V = heads.q[0].shape
        H, L = cfg.hidden_size, fw.qkv_u[0].shape[0]
        self.devices = list(devices)
        self.sites = (n + 1) * 2 * L + n
        self.W = max(H, V)
        self.ranks = [_RankBuffers(cfg, tp, L, n, V, H, self.sites, self.W, dev)
                      for dev in devices]
        self.rope = [rope_table(fw.inv_freq[r], n + 2) for r in range(tp)]
        a = TpChainArgs()
        for r, b in enumerate(self.ranks):
            k = a.rank[r]
            k.w = _weights_struct(cfg, tp, fw, r)
            k.heads, k.head_scales = heads.q[r].data_ptr(), heads.scale[r].data_ptr()
            for name in ("x", "x_in", "qkv", "attn", "gu", "logits", "recv", "flags", "codes",
                         "sub_sum", "status"):
                setattr(k, name, getattr(b, name).data_ptr())
            k.k_cache, k.v_cache = b.kc.data_ptr(), b.vc.data_ptr()
            k.rope = self.rope[r].data_ptr()
        a.tp, a.n, a.V, a.Vt, a.sites, a.W = tp, n, V, tables.shape[1], self.sites, self.W
        a.heads_bf16 = int(heads.q[0].dtype == torch.bfloat16)
        distinct = sorted({dev.index for dev in devices})
        a.cross_device = int(len(distinct) > 1)
        self.timeout_ns = CROSS_DEVICE_TIMEOUT_NS if a.cross_device else ONE_DEVICE_TIMEOUT_NS
        if a.cross_device:
            from ._build import check

            ids = (ctypes.c_int * len(distinct))(*distinct)
            check(load_kernels().qtts_tp_enable_peers(ids, len(distinct)),
                  "fused_mtp_chain_tp: peer access between the mesh's cards")
        self.args = a
        self.gen = 0
        # the ranks of each device, in rank order: one launch per device
        self.groups = OrderedDict()
        for r, dev in enumerate(devices):
            self.groups.setdefault(dev, []).append(r)
        for dev, ranks in self.groups.items():
            if ranks != list(range(ranks[0], ranks[0] + len(ranks))):
                raise ValueError("fused_mtp_chain_tp: a device's ranks must be consecutive")
        self.bpr = {}
        for dev, ranks in self.groups.items():
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            tiles = max(H, 2 * cfg.intermediate_size // tp,
                        cfg.q_dim // tp + 2 * cfg.kv_dim // tp, V) // 64
            self.bpr[dev] = max(1, min(sms // len(ranks), tiles))


_ENTRIES: "OrderedDict[tuple, _ChainEntry]" = OrderedDict()
_MAX_ENTRIES = 8


def _chain_entry(cfg, tp, fw, heads, tables, devices) -> _ChainEntry:
    """The cached entry of these tensors, keyed by every pointer it holds."""
    streams = tuple(torch.cuda.current_stream(d).cuda_stream for d in devices)
    key = (cfg, tp, tuple(devices), streams, threading.get_ident(), heads.q[0].dtype,
           tables.data_ptr(), *(t.data_ptr() for leaf in fw for t in leaf),
           *(t.data_ptr() for leaf in heads for t in leaf))
    entry = _ENTRIES.get(key)
    if entry is None:
        entry = _ChainEntry(cfg, tp, fw, heads, tables, devices)
        _ENTRIES[key] = entry
        while len(_ENTRIES) > _MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
    return entry


def launch_chain_tp(cfg, tp, mesh, fw, final_norm, heads, tables, last_hidden, code0_embed,
                    gumbel, temperature, top_k, top_p, stall_ns: int = 0,
                    timeout_ns: Optional[int] = None) -> TPChainRun:
    """Launch K10 on CUDA tensors (counted on :func:`fused_mtp_chain_tp`);
    every rank's status word is zeroed first.  ``stall_ns``: odd ranks hold
    each exchange's send back that long; ``timeout_ns``: a wait's limit
    (None: the entry's; both knobs are the checks')."""
    from ._build import check, load_kernels
    from ..runtime.sampling import clamp_temperature

    devices = mesh.model_devices()
    if any(dev.type != "cuda" for dev in devices):
        raise ValueError(f"fused_mtp_chain_tp: the mesh's devices must be CUDA, got {devices}")
    heads = _as_heads(heads, devices)
    n, Hs, V = heads.q[0].shape
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
        check_pack(fw, r, "fused_mtp_chain_tp")
    lib = load_kernels()
    e = _chain_entry(cfg, tp, fw, heads, tables, devices)
    a = e.args
    e.gen = (e.gen + 1) & 0xFFFFFFFF or 1
    a.gen = e.gen
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
    for b in e.ranks:
        b.status.zero_()
    fused_mtp_chain_tp.launches += 1
    for dev, ranks in e.groups.items():
        a.rank0, a.n_local, a.bpr = ranks[0], len(ranks), e.bpr[dev]
        with torch.cuda.device(dev):
            err = lib.qtts_tp_mtp_chain(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        check(err, "fused_mtp_chain_tp")
    b0 = e.ranks[0]
    return TPChainRun(b0.codes.clone().reshape(1, n), b0.sub_sum.clone().reshape(1, H),
                      [b.codes.clone() for b in e.ranks], [b.x.clone() for b in e.ranks],
                      [b.status.clone() for b in e.ranks])


def fused_mtp_chain_tp(
    cfg: TransformerConfig,
    tp: int,
    mesh,
    fw: FusedTPWeights,
    final_norm: torch.Tensor,  # [H]
    heads,  # TPHeads, or QuantizedLinear / raw [n, H, V] (row-sharded here)
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
            cfg, tp, fw, final_norm, _as_heads(heads, mesh.model_devices()), tables,
            last_hidden, code0_embed, gumbel, temperature, top_k, top_p)
    check_timeouts()  # the earlier chains', done by now: no wait for this one
    run = launch_chain_tp(cfg, tp, mesh, fw, final_norm, heads, tables, last_hidden,
                          code0_embed, gumbel, temperature, top_k, top_p)
    track(run.status)
    return run.subcodes, run.sub_sum


def raise_on_timeout(status: Sequence[torch.Tensor]) -> None:
    """Raise if a rank's status word is set: one of its exchange waits timed
    out, and the rank added whatever its receive slots held."""
    words = torch.cat([s.to(status[0].device) for s in status]).tolist()  # one sync
    late = [r for r, w in enumerate(words) if w]
    if late:
        raise RuntimeError(f"fused_mtp_chain_tp: an exchange wait timed out on rank(s) {late}; "
                           "the chain's sub-codes are not valid")


# The status words of this thread's chains not yet read: each copied to
# pinned host memory behind its launch, with an event, so that reading them
# waits for that chain and not for the work queued after it.
_tracked = threading.local()


def track(status: Sequence[torch.Tensor]) -> None:
    """Queue a launch's status words for :func:`check_timeouts`."""
    words = torch.cat([s.to(status[0].device) for s in status])
    done = None
    if words.is_cuda:
        host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
        host.copy_(words, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(words.device))
        words = host
    _tracked.__dict__.setdefault("pending", []).append((words, done))


def check_timeouts() -> None:
    """Raise if a chain that :func:`fused_mtp_chain_tp` launched on this
    thread since the last check timed out (:func:`raise_on_timeout`).  The
    chain calls it before each launch and the engine after each chunk's
    sync, so no sub-code of a timed-out chain leaves the engine."""
    pending, _tracked.pending = getattr(_tracked, "pending", []), []
    for words, done in pending:
        if done is not None:
            done.synchronize()
    for words, _ in pending:
        raise_on_timeout(words.split(1))


fused_mtp_chain_tp.launches = 0  # chain calls (one launch per device), for chip_smoke.py
