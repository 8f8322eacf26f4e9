"""ctypes loader for the native host library (libqtts.so).

The compute path is PyTorch; the host-side frontend (BPE tokenizer, WAV I/O)
is C++ like the reference's (src/io/), exposed through a minimal C ABI
(native/src/c_api.cpp, shared with the JAX package).  The library is built
with `make` on first use if a toolchain is present; callers fall back to the
pure-Python implementations when it is not (set QTTS_NO_AUTOBUILD=1 to
disable the build attempt).

The port builds its OWN copy into ``build/torch_native/`` (``BUILD_DIR``) and
never writes the JAX package's ``native/build/``, so the two packages cannot
race on one object directory.  Concurrent loaders (pytest workers, server
processes) are serialized by an ``fcntl`` lock on the build directory; each
build runs in a private temporary directory and the finished library is
moved into place with ``os.replace``, so no process ever opens a half-linked
file.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_WHEEL_LIB = os.path.join(_PKG_ROOT, "_native", "libqtts.so")  # installed wheel
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")

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


def library_path() -> str:
    """Where the library is loaded from: an installed wheel's copy, else the
    port's own build."""
    if os.path.exists(_WHEEL_LIB):
        return _WHEEL_LIB
    return os.path.join(BUILD_DIR, "libqtts.so")


def _try_build(path: str) -> bool:
    """Build ``path`` unless it exists, holding an exclusive lock on the build
    directory: the first process builds, the others wait and find it."""
    if os.environ.get("QTTS_NO_AUTOBUILD") or not os.path.isdir(_NATIVE_DIR):
        return os.path.exists(path)
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(path):
                return True
            tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, f"BUILD={tmp}"],
                    check=True, capture_output=True, timeout=180,
                )
                os.replace(os.path.join(tmp, "libqtts.so"), path)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, or None if unavailable (callers must fall back)."""
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        path = library_path()
        if not os.path.exists(path) and not _try_build(path):
            return None
        try:
            _lib = _configure(ctypes.CDLL(path))
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
