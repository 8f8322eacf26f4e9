"""Log-mel spectrogram frontend (the voice-clone path's input).

Port of ``leaxer_qwen3_tts_tpu/frontend/mel.py``, with the reference
MelExtractor's semantics (src/io/mel.cpp):
  * symmetric Hann window 0.5*(1-cos(2*pi*i/(N-1)))          (mel.cpp:13-22)
  * NO center padding; frames = (len - win)/hop + 1, min 1   (mel.cpp:182-191)
  * rFFT of the zero-padded window, power spectrum
  * HTK mel scale 2595*log10(1+hz/700), fmin 0 / fmax 12000  (mel.cpp:24-30)
  * integer-bin triangular filters via floor((n_fft+1)*hz/sr) (mel.cpp:50-79)
  * log(mel_energy + 1e-10)                                   (mel.cpp:231)

:func:`log_mel` frames the audio with one gather (taps past the end read
zero), then a float32 ``torch.fft.rfft`` and the [n_bins, n_mels] filterbank
product over all frames, on the caller's device.  Output layout is
[num_frames, num_mels], the speaker encoder's input layout.  The numpy
helpers are this package's own copies of the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import MelConfig


def hann_window_symmetric(win_size: int) -> np.ndarray:
    i = np.arange(win_size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (win_size - 1)))).astype(np.float32)


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (np.power(10.0, np.asarray(mel, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """[n_fft//2+1, num_mels] triangular filterbank (integer-bin, HTK scale)."""
    n_bins = cfg.n_fft // 2 + 1
    mel_lo, mel_hi = hz_to_mel(cfg.fmin), hz_to_mel(cfg.fmax)
    mels = mel_lo + (mel_hi - mel_lo) * np.arange(cfg.num_mels + 2) / (cfg.num_mels + 1)
    hz = mel_to_hz(mels)
    bins = np.floor((cfg.n_fft + 1) * hz / cfg.sample_rate).astype(np.int64)
    bins = np.minimum(bins, n_bins - 1)

    fb = np.zeros((n_bins, cfg.num_mels), np.float32)
    for m in range(cfg.num_mels):
        left, center, right = bins[m], bins[m + 1], bins[m + 2]
        if center > left:
            k = np.arange(left, center)
            fb[k, m] = (k - left) / (center - left)
        if right > center:
            k = np.arange(center, right)
            fb[k, m] = (right - k) / (right - center)
    return fb


def num_frames(audio_len: int, cfg: MelConfig) -> int:
    if audio_len < cfg.win_size:
        return 1
    return (audio_len - cfg.win_size) // cfg.hop_size + 1


def log_mel(audio, cfg: MelConfig, device) -> torch.Tensor:
    """audio [T] (numpy or tensor) -> float32 log-mel [num_frames, num_mels]
    on ``device``."""
    audio = torch.as_tensor(audio, dtype=torch.float32).to(device).reshape(-1)
    n = audio.shape[0]
    if n == 0:
        return torch.zeros((0, cfg.num_mels), dtype=torch.float32, device=device)
    frames = num_frames(n, cfg)
    window = torch.from_numpy(hann_window_symmetric(cfg.win_size)).to(device)
    fb = torch.from_numpy(mel_filterbank(cfg)).to(device)

    # frame gather [frames, win]; out-of-range taps read zero (short audio)
    starts = torch.arange(frames, device=device) * cfg.hop_size
    idx = starts[:, None] + torch.arange(cfg.win_size, device=device)[None, :]
    framed = torch.where(idx < n, audio[idx.clamp(max=n - 1)], 0.0) * window[None, :]
    spec = torch.fft.rfft(framed, n=cfg.n_fft, dim=-1)  # zero-pads past win
    power = spec.real.square() + spec.imag.square()  # [frames, n_bins]
    return torch.log(power @ fb + 1e-10)
