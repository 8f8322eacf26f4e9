"""WAV read/write + resample: native C++ backend with a numpy fallback.

Mirrors the reference's io::read_wav / io::write_wav / io::resample capability
(src/io/wav_reader.{h,cpp}, wav_writer.cpp) including both writer variants:
``normalize_peak=0`` reproduces the CLI's clamp-only writer
(main_onnx.cpp:15-58); ``normalize_peak=0.95`` the library's peak-normalized
one (wav_writer.cpp:37-48).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Tuple

import numpy as np

from . import native as _native


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read any supported WAV -> (mono float32 [-1,1], sample_rate)."""
    lib = _native.load_native()
    if lib is not None:
        sr = ctypes.c_int32(0)
        n = lib.qtts_wav_read(path.encode(), None, 0, ctypes.byref(sr))
        if n < 0:
            raise ValueError(f"read_wav({path}): {_native.last_error()}")
        buf = np.empty(n, np.float32)
        lib.qtts_wav_read(
            path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            ctypes.byref(sr),
        )
        return buf, int(sr.value)
    return _read_wav_py(path)


def write_wav(
    path: str,
    samples: np.ndarray,
    sample_rate: int = 24000,
    normalize_peak: float = 0.0,
) -> None:
    """Write mono 16-bit PCM.  normalize_peak<=0: clamp only (CLI-compatible)."""
    samples = np.ascontiguousarray(np.asarray(samples, np.float32).reshape(-1))
    lib = _native.load_native()
    if lib is not None:
        rc = lib.qtts_wav_write(
            path.encode(),
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(samples),
            sample_rate,
            float(normalize_peak),
        )
        if rc != 0:
            raise ValueError(f"write_wav({path}): {_native.last_error()}")
        return
    _write_wav_py(path, samples, sample_rate, normalize_peak)


def resample(audio: np.ndarray, src_sr: int, dst_sr: int) -> np.ndarray:
    """Linear-interpolation resample (reference wav_reader.cpp:145-164)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    if src_sr == dst_sr or audio.size == 0:
        return audio
    ratio = dst_sr / src_sr
    out_len = int(audio.size * ratio)
    pos = np.arange(out_len, dtype=np.float64) / ratio
    i0 = pos.astype(np.int64)
    i1 = np.minimum(i0 + 1, audio.size - 1)
    frac = pos - i0
    return (audio[i0] * (1.0 - frac) + audio[i1] * frac).astype(np.float32)


# ---------------------------------------------------------------------------
# Pure-Python fallback implementations
# ---------------------------------------------------------------------------


def _read_wav_py(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    fmt_tag = channels = bits = 0
    sample_rate = 0
    payload = None
    pos = 12
    while pos + 8 <= len(data):
        tag = data[pos : pos + 4]
        (length,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if tag == b"fmt " and length >= 16:
            fmt_tag, channels, sample_rate, _, _, bits = struct.unpack_from(
                "<HHIIHH", data, body
            )
            if fmt_tag == 0xFFFE and length >= 40:
                (fmt_tag,) = struct.unpack_from("<H", data, body + 24)
        elif tag == b"data":
            payload = data[body : body + length]
        pos = body + length + (length & 1)
    if payload is None or channels == 0 or sample_rate == 0:
        raise ValueError(f"missing fmt/data chunk: {path}")

    if fmt_tag == 3 and bits == 32:
        arr = np.frombuffer(payload, "<f4").astype(np.float32)
    elif fmt_tag == 3 and bits == 64:
        arr = np.frombuffer(payload, "<f8").astype(np.float32)
    elif fmt_tag == 1 and bits == 16:
        arr = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
    elif fmt_tag == 1 and bits == 8:
        arr = (np.frombuffer(payload, "u1").astype(np.float32) - 128.0) / 128.0
    elif fmt_tag == 1 and bits == 32:
        arr = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
    elif fmt_tag == 1 and bits == 24:
        raw = np.frombuffer(payload, "u1")
        raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3).astype(np.int32)
        val = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
        val = np.where(val & 0x800000, val - (1 << 24), val)
        arr = val.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV format tag={fmt_tag} bits={bits}")

    n = (len(arr) // channels) * channels
    mono = arr[:n].reshape(-1, channels).mean(axis=1).astype(np.float32)
    return mono, int(sample_rate)


def _write_wav_py(
    path: str, samples: np.ndarray, sample_rate: int, normalize_peak: float
) -> None:
    if normalize_peak > 0 and samples.size:
        peak = float(np.max(np.abs(samples)))
        if peak > 0:
            samples = samples * (normalize_peak / peak)
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    data_size = pcm.nbytes
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(pcm.tobytes())


class StreamingWavWriter:
    """Incremental mono 16-bit PCM writer for streaming synthesis.

    Writes a placeholder header up front, appends PCM as chunks arrive, and
    patches the RIFF/data sizes on close — a player tailing the file hears
    audio while synthesis is still running (CLI ``--stream``).  Same sample
    format as :func:`write_wav` with ``normalize_peak<=0`` (clamp only);
    peak normalization is impossible before the audio is complete.
    """

    def __init__(self, path: str, sample_rate: int = 24000):
        self._f = open(path, "wb")
        self._samples = 0
        self._f.write(b"RIFF")
        self._f.write(struct.pack("<I", 36))  # patched on close
        self._f.write(b"WAVE")
        self._f.write(b"fmt ")
        self._f.write(
            struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
        )
        self._f.write(b"data")
        self._f.write(struct.pack("<I", 0))  # patched on close

    def write(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
        self._f.write(pcm.tobytes())
        self._f.flush()
        self._samples += len(pcm)

    def close(self) -> None:
        data_size = self._samples * 2
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + data_size))
        self._f.seek(40)
        self._f.write(struct.pack("<I", data_size))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
