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

On a CUDA tensor :func:`flash_attend` launches the hand-written kernel
(``csrc/flash_attention.cu``); on a CPU tensor it runs the plain version
:func:`flash_attend_reference`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def block_t(T: int) -> int:
    """The key tile of the reference kernel."""
    return min(128, max(8, T))


def padded_keys(T: int) -> int:
    """T rounded up to a whole number of key tiles: the keys every query row
    visits (the ones past T masked, with zero values)."""
    bt = block_t(T)
    return -(-T // bt) * bt


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
    """Flash attention; returns [B, S, Nq, D] in q.dtype."""
    if q.device.type == "cpu":
        return flash_attend_reference(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attend: unsupported device {q.device}")
    from ._build import check, load_kernels

    B, S, nq, d = q.shape
    nk, T = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_attend takes q, k and v all bf16 or all float32, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    if d != 128 or nq % nk != 0:
        raise ValueError(f"flash_attend takes head_dim 128 and nq % nk == 0 (d={d}, {nq}/{nk})")
    if k.shape != (B, nk, T, d) or v.shape != k.shape or mask.shape != (B, S, T):
        raise ValueError(f"flash_attend: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} mask {tuple(mask.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    m8 = mask.to(torch.bool).contiguous()
    for t in (k, v, m8):
        if not t.is_cuda:
            raise ValueError("flash_attend: every tensor must be on CUDA")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flash_attend.launches += 1
    err = load_kernels().qtts_flash_attend(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(), out.data_ptr(),
        B, S, nq, nk, T, padded_keys(T), int(q.dtype == torch.bfloat16), stream,
    )
    check(err, "flash_attend")
    return out


flash_attend.launches = 0  # kernel launches, for chip_smoke.py's path check
