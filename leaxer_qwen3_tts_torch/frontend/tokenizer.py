"""Unified BPE tokenizer: native C++ engine when available, Python fallback.

Equivalent of the reference's io::load_vocab / tokenize / token_to_string API
(src/io/tokenizer.h:13-28) minus the global-singleton design — tokenizers here
are plain objects so multiple models / vocabularies coexist in one process.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

from . import native as _native
from ._bpe_py import PyBpeTokenizer

_MODE_IDS = {"qwen2": 0, "reference": 1}


class Tokenizer:
    """Byte-level BPE over vocab.json + merges.txt.

    mode="qwen2" (default) uses the full HF Qwen2 pre-tokenizer pattern;
    mode="reference" byte-exactly emulates the reference's simplified ASCII
    regex (tokenizer.cpp:357-384) for parity testing.
    """

    def __init__(
        self,
        vocab_path: str,
        merges_path: str = "",
        mode: str = "qwen2",
        backend: str = "auto",
    ):
        if mode not in _MODE_IDS:
            raise ValueError(f"unknown mode {mode!r}")
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        self.mode = mode
        self._handle = None
        self._lib = None
        self._py: Optional[PyBpeTokenizer] = None

        lib = _native.load_native() if backend in ("auto", "native") else None
        if lib is not None:
            handle = lib.qtts_tok_create(
                vocab_path.encode(), merges_path.encode(), _MODE_IDS[mode]
            )
            if handle:
                self._lib = lib
                self._handle = handle
            elif backend == "native":
                raise RuntimeError(f"native tokenizer load failed: {_native.last_error()}")
        if self._handle is None:
            if backend == "native":
                raise RuntimeError("native tokenizer backend unavailable")
            self._py = PyBpeTokenizer(vocab_path, merges_path, mode)

    @property
    def backend(self) -> str:
        return "native" if self._handle is not None else "python"

    def __del__(self):
        if self._handle is not None and self._lib is not None:
            self._lib.qtts_tok_destroy(self._handle)
            self._handle = None

    def encode(self, text: str) -> List[int]:
        if self._py is not None:
            return self._py.encode(text)
        raw = text.encode("utf-8")
        cap = max(16, len(raw) + 8)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.qtts_tok_encode(self._handle, raw, len(raw), buf, cap)
        if n < 0:
            raise RuntimeError(f"tokenize failed: {_native.last_error()}")
        if n > cap:
            buf = (ctypes.c_int32 * n)()
            n = self._lib.qtts_tok_encode(self._handle, raw, len(raw), buf, n)
        return list(buf[:n])

    def decode(self, ids) -> str:
        if self._py is not None:
            return self._py.decode(ids)
        ids = [int(i) for i in ids]
        arr = (ctypes.c_int32 * len(ids))(*ids)
        cap = max(16, len(ids) * 8)
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.qtts_tok_decode(self._handle, arr, len(ids), buf, cap)
        if n < 0:
            raise RuntimeError(f"detokenize failed: {_native.last_error()}")
        if n > cap:
            buf = ctypes.create_string_buffer(n)
            n = self._lib.qtts_tok_decode(self._handle, arr, len(ids), buf, n)
        return buf.raw[:n].decode("utf-8", errors="replace")

    def token_to_string(self, tid: int) -> str:
        if self._py is not None:
            return self._py.token_to_string(tid)
        buf = ctypes.create_string_buffer(512)
        n = self._lib.qtts_tok_token_to_string(self._handle, tid, buf, 512)
        return buf.raw[: max(n, 0)].decode("utf-8", errors="replace")

    def string_to_token(self, token: str) -> int:
        if self._py is not None:
            return self._py.string_to_token(token)
        return int(self._lib.qtts_tok_string_to_token(self._handle, token.encode()))

    @property
    def vocab_size(self) -> int:
        if self._py is not None:
            return self._py.vocab_size
        return int(self._lib.qtts_tok_vocab_size(self._handle))

    @property
    def num_merges(self) -> int:
        if self._py is not None:
            return self._py.num_merges
        return int(self._lib.qtts_tok_merges_size(self._handle))


def find_tokenizer_files(model_dir: str) -> Optional[tuple]:
    """Locate (vocab.json, merges.txt) for a model dir.

    Searches the model dir itself, then the reference's relative convention
    `<model_dir>/../models/Qwen3-TTS-12Hz-0.6B-Base/` (tts_onnx.cpp:110-121).
    """
    candidates = [
        model_dir,
        os.path.join(model_dir, os.pardir, "models", "Qwen3-TTS-12Hz-0.6B-Base"),
    ]
    for d in candidates:
        vocab = os.path.join(d, "vocab.json")
        merges = os.path.join(d, "merges.txt")
        if os.path.exists(vocab):
            return vocab, merges if os.path.exists(merges) else ""
    return None
