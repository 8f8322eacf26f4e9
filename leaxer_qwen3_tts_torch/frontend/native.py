"""ctypes loader for the native host library (native/build/libqtts.so).

The compute path is PyTorch; the host-side frontend (BPE tokenizer, WAV I/O)
is C++ like the reference's (src/io/), exposed through a minimal C ABI
(native/src/c_api.cpp, shared with the JAX package).  The
library is auto-built with `make` on first use if a toolchain is present;
callers fall back to the pure-Python implementations when it is not
(set QTTS_NO_AUTOBUILD=1 to disable the build attempt).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
# installed wheel location first, then the in-tree build
_LIB_CANDIDATES = (
    os.path.join(_PKG_ROOT, "_native", "libqtts.so"),
    os.path.join(_NATIVE_DIR, "build", "libqtts.so"),
)
_LIB_PATH = next(
    (p for p in _LIB_CANDIDATES if os.path.exists(p)), _LIB_CANDIDATES[-1]
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.qtts_last_error.restype = c.c_char_p

    lib.qtts_tok_create.restype = c.c_void_p
    lib.qtts_tok_create.argtypes = [c.c_char_p, c.c_char_p, c.c_int]
    lib.qtts_tok_destroy.argtypes = [c.c_void_p]
    lib.qtts_tok_encode.restype = c.c_int64
    lib.qtts_tok_encode.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, c.POINTER(c.c_int32), c.c_int64,
    ]
    lib.qtts_tok_decode.restype = c.c_int64
    lib.qtts_tok_decode.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int64, c.c_char_p, c.c_int64,
    ]
    lib.qtts_tok_token_to_string.restype = c.c_int64
    lib.qtts_tok_token_to_string.argtypes = [c.c_void_p, c.c_int32, c.c_char_p, c.c_int64]
    lib.qtts_tok_string_to_token.restype = c.c_int32
    lib.qtts_tok_string_to_token.argtypes = [c.c_void_p, c.c_char_p]
    lib.qtts_tok_vocab_size.restype = c.c_int64
    lib.qtts_tok_vocab_size.argtypes = [c.c_void_p]
    lib.qtts_tok_merges_size.restype = c.c_int64
    lib.qtts_tok_merges_size.argtypes = [c.c_void_p]

    lib.qtts_wav_read.restype = c.c_int64
    lib.qtts_wav_read.argtypes = [
        c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.POINTER(c.c_int32),
    ]
    lib.qtts_wav_write.restype = c.c_int32
    lib.qtts_wav_write.argtypes = [
        c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int32, c.c_float,
    ]
    lib.qtts_resample.restype = c.c_int64
    lib.qtts_resample.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int32, c.c_int32,
        c.POINTER(c.c_float), c.c_int64,
    ]
    return lib


def _try_build() -> bool:
    if os.environ.get("QTTS_NO_AUTOBUILD"):
        return False
    if not os.path.isdir(_NATIVE_DIR):
        return False
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=180,
        )
        return os.path.exists(_LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return False


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, or None if unavailable (callers must fall back)."""
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if not os.path.exists(_LIB_PATH):
            if not _try_build():
                return None
        try:
            _lib = _configure(ctypes.CDLL(_LIB_PATH))
        except OSError:
            _lib = None
        return _lib


def native_available() -> bool:
    return load_native() is not None


def last_error() -> str:
    lib = load_native()
    if lib is None:
        return "native library not available"
    return lib.qtts_last_error().decode("utf-8", errors="replace")
