"""12 Hz neural codec decoder (vocoder): 16 codebooks/frame -> 24 kHz waveform.

Port of ``leaxer_qwen3_tts_tpu/models/codec12hz.py``, both heads: the conv
head (sub-pixel upsampling stages, residual blocks, a final conv) and the
iSTFT head (``head="istft"``, :func:`_istft_head`: a LayerNorm and a product
to magnitude and phase per frame, an inverse real FFT in float32, a
periodic Hann window and overlap-add).  The public functions keep the JAX
package's channels-last layouts: activations [B, T, C], conv weights [K,
Cin, Cout], depthwise weights [K, C].  Every op is causal, so chunked
decoding with ``left_context_frames`` of context is exact.  GELU uses the
tanh approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import VocoderConfig
from .layers import _normal


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """x [B, T, Cin], w [K, Cin, Cout] -> [B, T, Cout]; left-padded (causal)."""
    k = w.shape[0]
    xt = F.pad(x.float().transpose(1, 2), ((k - 1) * dilation, 0))
    out = F.conv1d(xt, w.float().permute(2, 1, 0), dilation=dilation)
    return out.transpose(1, 2).to(x.dtype)


def causal_dwconv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B, T, C], w [K, C] -> [B, T, C]."""
    k, c = w.shape
    xt = F.pad(x.float().transpose(1, 2), (k - 1, 0))
    out = F.conv1d(xt, w.float().t()[:, None, :], groups=c)
    return out.transpose(1, 2).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def init_vocoder_params(cfg: VocoderConfig, gen: torch.Generator, device) -> dict:
    """Random parameters of the JAX package's shapes: the codebooks, the
    prenet, and the conv head's stages or (``head="istft"``) the iSTFT
    head's LayerNorm (``head_ln_*``) and its product to n_fft + 2 channels
    (``istft_out_*``; n_fft = istft_overlap x samples_per_frame)."""
    dt = cfg.torch_dtype
    d = cfg.d_model

    def conv(k, cin, cout):
        return _normal(gen, (k, cin, cout), (k * cin) ** -0.5, dt, device)

    def zeros(n, dtype=dt):
        return torch.zeros((n,), dtype=dtype, device=device)

    params = {
        "codebooks": _normal(gen, (cfg.num_codebooks, cfg.codebook_size, d), 0.02, dt, device),
        "prenet": [],
    }
    for _ in range(cfg.num_prenet_blocks):
        params["prenet"].append({
            "dw": _normal(gen, (cfg.prenet_kernel_size, d), 1.0 / cfg.prenet_kernel_size,
                          dt, device),
            "ln_scale": torch.ones((d,), dtype=torch.float32, device=device),
            "ln_bias": zeros(d, torch.float32),
            "w1": conv(1, d, 3 * d)[0],
            "b1": zeros(3 * d),
            "w2": conv(1, 3 * d, d)[0],
            "b2": zeros(d),
        })
    if cfg.head == "istft":
        n_bins = cfg.istft_overlap * cfg.samples_per_frame // 2 + 1
        params["head_ln_scale"] = torch.ones((d,), dtype=torch.float32, device=device)
        params["head_ln_bias"] = zeros(d, torch.float32)
        params["istft_out_w"] = conv(1, d, 2 * n_bins)[0]
        params["istft_out_b"] = zeros(2 * n_bins)
        return params
    params["stages"] = []
    cin = d
    for rate, cout in zip(cfg.upsample_rates, cfg.upsample_channels):
        stage = {"up_w": conv(3, cin, cout * rate), "up_b": zeros(cout * rate), "res": []}
        for _ in cfg.resblock_dilations:
            stage["res"].append({
                "w1": conv(cfg.resblock_kernel_size, cout, cout), "b1": zeros(cout),
                "w2": conv(cfg.resblock_kernel_size, cout, cout), "b2": zeros(cout),
            })
        params["stages"].append(stage)
        cin = cout
    params["final_w"] = conv(cfg.final_kernel_size, cin, 1)
    params["final_b"] = zeros(1)
    return params


def embed_codes(cfg: VocoderConfig, params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, F, 16] int -> summed codebook embeddings [B, F, D]."""
    books = params["codebooks"]
    per_book = [books[i][codes[..., i].long()] for i in range(codes.shape[-1])]
    return torch.stack(per_book).sum(dim=0)


def _istft_head(cfg: VocoderConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The Vocos-style inverse-STFT head (JAX ``_istft_head``): frame-rate
    features [B, F, D] -> audio [B, F * hop].  Per frame a LayerNorm and a
    float32 product to log-magnitudes (clipped to [-30, 12]) and phases of
    n_fft / 2 + 1 bins, an inverse real FFT of n_fft = overlap x hop
    samples, a periodic Hann window; frame f covers samples [f hop, f hop +
    n_fft), so output block t sums windowed frames t - overlap + 1 .. t
    (strictly left context, as the conv head), normalised by the window's
    squared sum as ``torch.istft`` does, clamped at 1e-6 at the onset."""
    B, nf, _ = x.shape
    hop = cfg.samples_per_frame
    ov = cfg.istft_overlap
    n_fft = ov * hop
    n_bins = n_fft // 2 + 1
    x = layer_norm(x, params["head_ln_scale"], params["head_ln_bias"])
    h = torch.matmul(x.float(), params["istft_out_w"].float()) + params["istft_out_b"].float()
    mag = torch.exp(torch.clamp(h[..., :n_bins], -30.0, 12.0))
    phase = h[..., n_bins:]
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1).float()  # [B, F, n_fft]
    win = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi * torch.arange(n_fft, dtype=torch.float32, device=x.device) / n_fft)
    fw = (frames * win).reshape(B, nf, ov, hop)
    acc = None
    for r in range(ov):  # chunk r of frame f lands on block f + r
        contrib = F.pad(fw[:, :, r], (0, 0, r, ov - 1 - r))
        acc = contrib if acc is None else acc + contrib
    blocks = acc[:, :nf]  # [B, nf, hop]: blocks nf .. nf + ov - 2 are future tails
    cums = torch.cumsum((win * win).reshape(ov, hop), dim=0)  # chunks 0..t of the window
    if nf <= ov - 1:
        wsum = cums[:nf]
    else:
        wsum = torch.cat([cums[: ov - 1], cums[ov - 1].expand(nf - ov + 1, hop)])
    return (blocks / torch.clamp(wsum, min=1e-6)).reshape(B, nf * hop)


def vocoder_forward(cfg: VocoderConfig, params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, F, 16] int -> audio f32 [B, F * samples_per_frame]."""
    x = embed_codes(cfg, params, codes)
    for blk in params["prenet"]:
        h = causal_dwconv1d(x, blk["dw"])
        h = layer_norm(h, blk["ln_scale"], blk["ln_bias"])
        h = torch.matmul(h.float(), blk["w1"].float()).to(x.dtype) + blk["b1"]
        h = F.gelu(h, approximate="tanh")
        h = torch.matmul(h.float(), blk["w2"].float()).to(x.dtype) + blk["b2"]
        x = x + h
    if cfg.head == "istft":
        return _istft_head(cfg, params, x)
    for rate, stage in zip(cfg.upsample_rates, params["stages"]):
        B, T, _ = x.shape
        h = causal_conv1d(x, stage["up_w"]) + stage["up_b"]
        x = h.reshape(B, T * rate, h.shape[-1] // rate)  # sub-pixel upsample (causal)
        x = F.silu(x)
        for blk, dil in zip(stage["res"], cfg.resblock_dilations):
            r = causal_conv1d(F.silu(x), blk["w1"], dilation=dil) + blk["b1"]
            r = causal_conv1d(F.silu(r), blk["w2"]) + blk["b2"]
            x = x + r
    audio = causal_conv1d(x, params["final_w"]) + params["final_b"]
    return torch.tanh(audio.float())[..., 0]


def vocode_chunk(
    cfg: VocoderConfig,
    params: dict,
    codes_with_context: torch.Tensor,  # [B, ctx + F, 16]
    context_frames: int,
) -> torch.Tensor:
    """Streaming vocode: decode [ctx + F] frames, return the last F frames'
    audio.  Exact when ``context_frames >= cfg.left_context_frames``."""
    audio = vocoder_forward(cfg, params, codes_with_context)
    return audio[:, context_frames * cfg.samples_per_frame :]
