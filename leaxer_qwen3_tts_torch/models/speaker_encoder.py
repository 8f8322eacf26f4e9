"""Speaker encoder for voice cloning: log-mel frames -> speaker embedding.

Port of ``leaxer_qwen3_tts_tpu/models/speaker_encoder.py``.  I/O contract per
the reference's speaker_encoder.onnx (tts_onnx.cpp:367-403): mel f32
[B, num_frames, 128] -> embedding [B, output_dim].  Two topologies, selected
by ``cfg.topology``:

  * ``"transformer"``: linear mel projection -> bidirectional (full-context,
    padding-masked) transformer encoder -> masked attentive statistics
    pooling -> output projection;
  * ``"ecapa"``: the ECAPA-TDNN fallback: a conv frontend, three SE-Res2Net
    blocks at dilations 2/3/4 with symmetric "same" padding, multi-layer
    feature aggregation, context-aware attentive statistics pooling and
    inference-mode BatchNorm (eps 1e-5).

``mel_len`` masks ragged batches: frames past a row's length change nothing.
The attention is the plain one (``ops.attention.attend_xla``); the JAX
package runs no Pallas kernel here either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import SpeakerEncoderConfig
from ..ops.attention import attend_xla
from .layers import _normal


def _bn_init(c: int, device) -> dict:
    """Inference-mode BatchNorm1d as its four torch leaves."""
    return {
        "g": torch.ones((c,), device=device),
        "b": torch.zeros((c,), device=device),
        "m": torch.zeros((c,), device=device),
        "v": torch.ones((c,), device=device),
    }


def _bn(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    return (x - p["m"]) * torch.rsqrt(p["v"] + eps) * p["g"] + p["b"]


def init_ecapa_params(cfg: SpeakerEncoderConfig, gen: torch.Generator, device) -> dict:
    """ECAPA-TDNN fallback topology: the JAX package's shapes, float32."""
    C, s = cfg.ecapa_channels, cfg.ecapa_scale
    w, mfa, att = C // s, cfg.ecapa_mfa_dim, cfg.ecapa_att_dim

    def conv(k, cin, cout):
        return _normal(gen, (k, cin, cout), (k * cin) ** -0.5, torch.float32, device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    params = {
        "frontend": {"w": conv(5, cfg.num_mels, C), "b": zeros(C), "bn": _bn_init(C, device)},
        "blocks": [],
    }
    for _dil in (2, 3, 4):
        params["blocks"].append({
            "in_w": conv(1, C, C), "in_b": zeros(C), "in_bn": _bn_init(C, device),
            # Res2Net: s-1 dilated k=3 convs over C/s-wide splits
            "res_w": torch.stack([conv(3, w, w) for _ in range(s - 1)]),
            "res_b": zeros(s - 1, w), "res_bn": _bn_init(C, device),
            "out_w": conv(1, C, C), "out_b": zeros(C), "out_bn": _bn_init(C, device),
            # squeeze-excitation bottleneck (C -> C//8 -> C)
            "se_w1": conv(1, C, C // 8)[0], "se_b1": zeros(C // 8),
            "se_w2": conv(1, C // 8, C)[0], "se_b2": zeros(C),
        })
    params["mfa_w"] = conv(1, 3 * C, mfa)[0]
    params["mfa_b"] = zeros(mfa)
    # context-aware attentive stats pooling: attention input [x, mean, std]
    params["asp_w1"] = conv(1, 3 * mfa, att)[0]
    params["asp_b1"] = zeros(att)
    params["asp_w2"] = conv(1, att, mfa)[0]
    params["asp_b2"] = zeros(mfa)
    params["post_bn"] = _bn_init(2 * mfa, device)
    params["out_w"] = conv(1, 2 * mfa, cfg.output_dim)[0]
    params["out_b"] = zeros(cfg.output_dim)
    return params


def init_speaker_encoder_params(cfg: SpeakerEncoderConfig, gen: torch.Generator, device) -> dict:
    if cfg.topology == "ecapa":
        return init_ecapa_params(cfg, gen, device)
    dt, d, I = cfg.torch_dtype, cfg.d_model, cfg.intermediate_size

    def dense(fan_in, shape):
        return _normal(gen, shape, fan_in ** -0.5, dt, device)

    params = {
        "in_proj": dense(cfg.num_mels, (cfg.num_mels, d)),
        "in_bias": torch.zeros((d,), dtype=dt, device=device),
        "layers": [],
        "pool_w": dense(d, (d, d)),
        "pool_v": dense(d, (d, 1)),
        "out_proj": dense(2 * d, (2 * d, cfg.output_dim)),
        "out_bias": torch.zeros((cfg.output_dim,), dtype=dt, device=device),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1_s": torch.ones((d,), device=device),
            "ln1_b": torch.zeros((d,), device=device),
            "wq": dense(d, (d, d)),
            "wk": dense(d, (d, d)),
            "wv": dense(d, (d, d)),
            "wo": dense(d, (d, d)),
            "ln2_s": torch.ones((d,), device=device),
            "ln2_b": torch.zeros((d,), device=device),
            "w1": dense(d, (d, I)),
            "b1": torch.zeros((I,), dtype=dt, device=device),
            "w2": dense(I, (I, d)),
            "b2": torch.zeros((d,), dtype=dt, device=device),
        })
    return params


def _ln(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * s + b).to(x.dtype)


def _conv1d_same(x: torch.Tensor, w: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """"Same"-padded 1-D conv, channels-last: x [B, T, Cin], w [K, Cin, Cout].

    Symmetric (non-causal) padding, the extra tap on the right when the
    dilated kernel's span is even, as XLA's SAME padding places it: the whole
    reference clip is available, so there is no causality constraint."""
    K = w.shape[0]
    total = (K - 1) * dilation
    xc = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(xc, w.permute(2, 1, 0), dilation=dilation)
    return y.transpose(1, 2)


def _masked_mean_std(x: torch.Tensor, valid: torch.Tensor):
    """Masked per-utterance mean/std over time: x [B, T, C], valid [B, T]."""
    m = valid[..., None].to(x.dtype)
    n = m.sum(dim=1).clamp(min=1.0)
    mean = (x * m).sum(dim=1) / n
    var = ((x - mean[:, None, :]).square() * m).sum(dim=1) / n
    return mean, var.clamp(min=1e-9).sqrt()


def _valid(mel: torch.Tensor, mel_len: Optional[torch.Tensor]) -> torch.Tensor:
    B, T, _ = mel.shape
    if mel_len is None:
        mel_len = torch.full((B,), T, device=mel.device)
    return torch.arange(T, device=mel.device)[None, :] < mel_len.to(mel.device)[:, None]


def ecapa_forward(
    cfg: SpeakerEncoderConfig,
    params: dict,
    mel: torch.Tensor,  # [B, T, num_mels] f32
    mel_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ECAPA-TDNN fallback topology: [B, T, mels] -> [B, output_dim]."""
    valid = _valid(mel, mel_len)  # [B, T]
    mask = valid[..., None].float()

    fe = params["frontend"]
    # mask the input first: every conv then reads zeros past mel_len (masked
    # again after each block so BN offsets in the padded region don't build up)
    x = mel.float() * mask
    x = F.relu(_bn(_conv1d_same(x, fe["w"]) + fe["b"], fe["bn"])) * mask

    s = cfg.ecapa_scale
    w_split = cfg.ecapa_channels // s
    feats = []
    for blk, dil in zip(params["blocks"], (2, 3, 4)):
        res = x
        h = F.relu(_bn(_conv1d_same(x, blk["in_w"]) + blk["in_b"], blk["in_bn"]))
        # Res2Net: group 0 passes through; group i >= 1 goes through a
        # dilated k=3 conv after adding the previous group's output
        groups = [h[..., i * w_split:(i + 1) * w_split] for i in range(s)]
        outs = [groups[0]]
        prev = None
        for i in range(1, s):
            g = groups[i] if prev is None else groups[i] + prev
            prev = F.relu(_conv1d_same(g, blk["res_w"][i - 1], dilation=dil)
                          + blk["res_b"][i - 1])
            outs.append(prev)
        h = _bn(torch.cat(outs, dim=-1), blk["res_bn"])
        h = F.relu(_bn(_conv1d_same(h, blk["out_w"]) + blk["out_b"], blk["out_bn"]))
        # squeeze-excitation: masked global average -> bottleneck -> sigmoid gate
        n = mask.sum(dim=1).clamp(min=1.0)
        se = (h * mask).sum(dim=1) / n  # [B, C]
        se = F.relu(se @ blk["se_w1"] + blk["se_b1"])
        se = torch.sigmoid(se @ blk["se_w2"] + blk["se_b2"])
        x = (res + h * se[:, None, :]) * mask
        feats.append(x)

    # multi-layer feature aggregation over the three block outputs
    h = F.relu(torch.cat(feats, dim=-1) @ params["mfa_w"] + params["mfa_b"])  # [B, T, mfa]

    # context-aware attentive stats pooling: attention input [x, mean, std]
    mean, std = _masked_mean_std(h, valid)
    ctx = torch.cat([h, mean[:, None, :].expand_as(h), std[:, None, :].expand_as(h)], dim=-1)
    a = torch.tanh(ctx @ params["asp_w1"] + params["asp_b1"])
    a = a @ params["asp_w2"] + params["asp_b2"]  # [B, T, mfa]
    a = torch.where(valid[..., None], a, torch.full_like(a, -1e30))
    a = torch.softmax(a, dim=1)
    amean = (a * h).sum(dim=1)
    avar = (a * (h - amean[:, None, :]).square()).sum(dim=1)
    stats = torch.cat([amean, avar.clamp(min=1e-9).sqrt()], dim=-1)

    stats = _bn(stats, params["post_bn"])
    return stats @ params["out_w"] + params["out_b"]


def speaker_encoder_forward(
    cfg: SpeakerEncoderConfig,
    params: dict,
    mel: torch.Tensor,  # [B, T, num_mels] f32
    mel_len: Optional[torch.Tensor] = None,  # [B] int
) -> torch.Tensor:
    """Speaker embeddings [B, output_dim] (float32)."""
    if cfg.topology == "ecapa":
        return ecapa_forward(cfg, params, mel, mel_len)
    B, T, _ = mel.shape
    valid = _valid(mel, mel_len)  # [B, T]

    x = torch.matmul(mel.to(params["in_proj"].dtype), params["in_proj"]) + params["in_bias"]
    h = cfg.num_heads
    hd = cfg.d_model // h
    full_mask = valid[:, None, :].expand(B, T, T)  # non-causal

    for lp in params["layers"]:
        y = _ln(x, lp["ln1_s"], lp["ln1_b"])
        q = (y @ lp["wq"]).reshape(B, T, h, hd)
        k = (y @ lp["wk"]).reshape(B, T, h, hd).transpose(1, 2)
        v = (y @ lp["wv"]).reshape(B, T, h, hd).transpose(1, 2)
        o = attend_xla(q, k, v, full_mask).reshape(B, T, cfg.d_model)
        x = x + o @ lp["wo"]
        y = _ln(x, lp["ln2_s"], lp["ln2_b"])
        y = F.gelu(y @ lp["w1"] + lp["b1"], approximate="tanh")  # jax.nn.gelu's default
        x = x + y @ lp["w2"] + lp["b2"]

    # attentive statistics pooling (masked)
    xf = x.float()
    att = torch.tanh(xf @ params["pool_w"].float())
    att = (att @ params["pool_v"].float())[..., 0]  # [B, T]
    att = torch.where(valid, att, torch.full_like(att, -1e30))
    w = torch.softmax(att, dim=-1)[..., None]  # [B, T, 1]
    mean = (w * xf).sum(dim=1)
    var = (w * (xf - mean[:, None, :]).square()).sum(dim=1)
    stats = torch.cat([mean, var.clamp(min=1e-9).sqrt()], dim=-1)  # [B, 2D]
    return stats @ params["out_proj"].float() + params["out_bias"].float()
