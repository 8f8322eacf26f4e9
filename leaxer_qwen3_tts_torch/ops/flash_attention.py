"""Kernel K8: GQA flash attention with an online softmax and a boolean mask.

Port of ``leaxer_qwen3_tts_tpu/ops/flash_attention.py::flash_attend``, the
attention that ``attn_impl="pallas"`` selects for the prefill (and for every
cached forward of such a config).  Its arithmetic, which differs from
:func:`~leaxer_qwen3_tts_torch.ops.attention.attend_xla`'s:

* q is scaled by 1/sqrt(d) in float32 before the score product; scores and
  P.V are float32 and the softmax weights are never rounded to bf16;
* keys are taken in tiles of ``block_t = min(128, max(8, T))``, with T padded
  to a multiple of it by zero keys that the mask leaves out; each tile updates
  the running max m, sum l and accumulator acc of every query row;
* a masked score is NEG_INF = -1e30, a finite value: in a row whose scores
  so far are all masked, exp(s - m) = 1, so a row that is masked everywhere
  ends with l = Tp (the padded key count) and acc = the sum of V, and its
  output acc / max(l, 1e-30) is the sum of V over Tp, not zeros;
* the q/kv head of q head h is h // (nq / nk); the output is cast to q.dtype.

The kernel takes every head_dim up to 256 (zero-padded in its tiles to 64,
128 or 256 values; the scale stays 1/sqrt(d) of the true d) and every number
of q heads per kv head (past 16 a kv head's q heads spread over several
blocks), as the JAX kernel takes any; a wider head raises (ROADMAP item K8w).

On a CUDA tensor :func:`flash_attend` launches the hand-written kernel
(``csrc/flash_attention.cu``; tensor cores for bf16 inputs, CUDA cores for
float32 ones); on a CPU tensor it runs the plain version
:func:`flash_attend_reference`.  The kernel's schedule is here too: the
query positions per block (:func:`query_tile`), each block's key-tile range
and the rows that allow no key (:func:`key_schedule`), the plain version run
over only that range (:func:`flash_attend_scheduled`), and its P.V with P
split into two bf16 terms (:func:`split_pv`).

K8 has no gradient, as the JAX flash kernel has none (``jax.grad`` through
it fails to linearize).  So :func:`flash_attend` refuses to run where
autograd records and q, k or v requires grad, on every device: training
takes ``attn_impl="xla"``, and a frozen pass (the draft trainer's teacher)
runs K8 under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30
MAX_ROWS = 16  # stacked rows (q heads x query positions) of a kernel block: one m16 tile
MAX_HEAD_DIM = 256  # the kernel's widest padded head_dim (64, 128 or 256 values a row)
# keys per tile of the kernel: 64 on the tensor cores (bf16), 32 on the CUDA
# cores (float32: a lane per key)
KEY_TILE = {torch.bfloat16: 64, torch.float32: 32}


def block_t(T: int) -> int:
    """The key tile of the reference kernel."""
    return min(128, max(8, T))


def padded_keys(T: int) -> int:
    """T rounded up to a whole number of key tiles: the keys every query row
    visits (the ones past T masked, with zero values)."""
    bt = block_t(T)
    return -(-T // bt) * bt


def query_tile(g: int, B: int, nk: int, S: int, sms: int) -> int:
    """Query positions per kernel block, whose gb * qt rows are gb = min(g,
    16) q heads of its kv head at qt positions (a kv head of more than 16 q
    heads spreads them over ceil(g / 16) blocks): 16 // gb (a full m16 tile)
    when that gives every one of the ``sms`` SMs a block, else 8 // gb (half
    a tile, twice the blocks).  The 1.7B prefill (B=1, nk=8, g=2, S=57)
    takes 4: 120 blocks."""
    if g < 1:
        raise ValueError(f"q heads per kv head must be positive, got {g}")
    gb = min(g, MAX_ROWS)
    full = MAX_ROWS // gb
    if B * nk * -(-g // gb) * -(-S // full) >= sms:
        return full
    return max(1, MAX_ROWS // 2 // gb)


def key_schedule(mask: torch.Tensor, qt: int, key_tile: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's key range, from the mask [B, S, T] alone: for each block
    of qt query positions (and every head), the first and last key tile in
    which any of its positions allows a key (lo, hi [B, ceil(S / qt)]; hi <
    lo where none does), and per position whether it allows any key (alive
    [B, S]).  The block visits tiles lo .. hi only; a position that is not
    alive takes the closed form sum_{t<T} v_t / Tp."""
    B, S, T = mask.shape
    n = -(-S // qt)
    m = torch.nn.functional.pad(mask.bool(), (0, 0, 0, n * qt - S))
    blk = m.view(B, n, qt, T).any(dim=2)  # [B, n, T]: keys any position of the block allows
    keys = torch.arange(T, device=mask.device)
    some = blk.any(dim=-1)
    first = torch.where(blk, keys, T).amin(dim=-1)
    last = torch.where(blk, keys, -1).amax(dim=-1)
    lo = torch.where(some, first // key_tile, 0)
    hi = torch.where(some, last // key_tile, -1)
    return lo, hi, mask.bool().any(dim=-1)


def flash_attend_scheduled(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, Nk, T, D]
    v: torch.Tensor,  # [B, Nk, T, D]
    mask: torch.Tensor,  # [B, S, T] bool
    qt: int,
    key_tile: int,
) -> torch.Tensor:
    """The plain version run as the kernel schedules it: per block of qt
    query positions, the float32 online softmax over key tiles lo .. hi of
    :func:`key_schedule` only (keys past T masked, with zero values), and
    sum_{t<T} v_t / Tp for a position that allows no key.  Float32
    arithmetic throughout; returns [B, S, Nq, D] in q.dtype."""
    B, S, nq, d = q.shape
    nk, T = k.shape[1], k.shape[2]
    g = nq // nk
    lo, hi, alive = key_schedule(mask, qt, key_tile)
    nt = -(-T // key_tile)
    pad = nt * key_tile - T
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    mp = torch.nn.functional.pad(mask.bool(), (0, pad))
    closed = v.float().sum(dim=2) / padded_keys(T)  # [B, nk, d]
    qs = q.float() * (1.0 / d ** 0.5)
    out = torch.empty((B, S, nq, d), dtype=torch.float32, device=q.device)
    for b in range(B):
        for i in range(lo.shape[1]):
            s0, s1 = i * qt, min(S, (i + 1) * qt)
            qh = qs[b, s0:s1].reshape(s1 - s0, nk, g, d).permute(1, 0, 2, 3)  # [nk, P, g, d]
            acc = torch.zeros((nk, s1 - s0, g, d), device=q.device)
            m = torch.full((nk, s1 - s0, g, 1), NEG_INF, device=q.device)
            l = torch.zeros((nk, s1 - s0, g, 1), device=q.device)
            for j in range(int(lo[b, i]), int(hi[b, i]) + 1):
                t0, t1 = j * key_tile, (j + 1) * key_tile
                sc = torch.einsum("npgd,ntd->npgt", qh, kp[b, :, t0:t1])
                sc = torch.where(mp[b, s0:s1, None, None, t0:t1].transpose(0, 1), sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                p = torch.exp(sc - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.einsum("npgt,ntd->npgd", p, vp[b, :, t0:t1])
                m = m_new
            o = torch.where(alive[b, s0:s1, None, None, None].transpose(0, 1),
                            acc / torch.clamp(l, min=1e-30), closed[b, :, None, None, :])
            out[b, s0:s1] = o.permute(1, 0, 2, 3).reshape(s1 - s0, nq, d)
    return out.to(q.dtype)


def split_pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P.V as the tensor-core kernel forms it: P (float32) split into hi =
    bf16(P) and lo = bf16(P - hi), each times bf16 V with float32 sums; the
    weights keep ~16 bits (|P - hi - lo| <= 2^-17 |P|)."""
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    vb = v.to(torch.bfloat16).float()
    return torch.matmul(hi.float(), vb) + torch.matmul(lo.float(), vb)


def flash_attend_reference(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, Nk, T, D] head-major
    v: torch.Tensor,  # [B, Nk, T, D]
    mask: torch.Tensor,  # [B, S, T] bool
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, tile by tile; same contract."""
    B, S, nq, d = q.shape
    nk, T = k.shape[1], k.shape[2]
    g = nq // nk
    bt, Tp = block_t(T), padded_keys(T)
    pad = Tp - T
    qh = q.transpose(1, 2).float() * (1.0 / d ** 0.5)  # [B, nq, S, d]
    kh = torch.nn.functional.pad(k.float(), (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    vh = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    mk = torch.nn.functional.pad(mask.bool(), (0, pad))[:, None]  # [B, 1, S, Tp]
    acc = torch.zeros((B, nq, S, d), dtype=torch.float32, device=q.device)
    m = torch.full((B, nq, S, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nq, S, 1), dtype=torch.float32, device=q.device)
    for t0 in range(0, Tp, bt):
        s = torch.matmul(qh, kh[:, :, t0 : t0 + bt].transpose(-1, -2))  # [B, nq, S, bt]
        s = torch.where(mk[..., t0 : t0 + bt], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vh[:, :, t0 : t0 + bt])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).transpose(1, 2)


def flash_attend(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, Nk, T, D] head-major (KV-cache layout)
    v: torch.Tensor,  # [B, Nk, T, D]
    mask: torch.Tensor,  # [B, S, T] bool
) -> torch.Tensor:
    """Flash attention; returns [B, S, Nq, D] in q.dtype.  Raises where
    autograd would record it (see the module's docstring)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attend has no gradient: the JAX flash kernel has none, so kernel K8 has "
            "none; train with attn_impl='xla', or run this pass under torch.no_grad()"
        )
    if q.device.type == "cpu":
        return flash_attend_reference(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attend: unsupported device {q.device}")
    from ._build import check, load_kernels
    from .persistent import grid_size

    B, S, nq, d = q.shape
    nk, T = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_attend takes q, k and v all bf16 or all float32, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attend takes head_dim 1..{MAX_HEAD_DIM}, got {d} (wider heads: "
                         "ROADMAP item K8w)")
    if nq % nk != 0:
        raise ValueError(f"flash_attend takes nq % nk == 0 ({nq}/{nk})")
    if k.shape != (B, nk, T, d) or v.shape != k.shape or mask.shape != (B, S, T):
        raise ValueError(f"flash_attend: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} mask {tuple(mask.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    m8 = mask.to(torch.bool).contiguous()
    for t in (k, v, m8):
        if not t.is_cuda:
            raise ValueError("flash_attend: every tensor must be on CUDA")
    # the tensor-core kernel copies 16-byte runs of q, k and v where d % 8 == 0
    if d % 8 == 0 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attend: q, k and v must be 16-byte aligned")
    qt = query_tile(nq // nk, B, nk, S, grid_size(q.device))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flash_attend.launches += 1
    err = load_kernels().qtts_flash_attend(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(), out.data_ptr(),
        B, S, nq, nk, T, padded_keys(T), qt, d, int(q.dtype == torch.bfloat16), stream,
    )
    check(err, "flash_attend")
    return out


flash_attend.launches = 0  # kernel launches, for chip_smoke.py's path check
