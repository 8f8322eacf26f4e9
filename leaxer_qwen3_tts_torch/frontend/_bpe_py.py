"""Pure-Python byte-level BPE — fallback when the native library isn't built.

Implements the same semantics as native/src/bpe.cpp: GPT-2 byte proxy alphabet,
vocab.json + merges.txt, and the two pre-tokenizer modes ("qwen2": full HF
Qwen2 pattern with Unicode letter/number classes; "reference": byte-level
emulation of the reference's simplified ASCII regex, tokenizer.cpp:357-384).
The native and Python paths are cross-checked in tests/test_tokenizer.py.
"""

from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple


@lru_cache(maxsize=1)
def byte_to_proxy() -> Dict[int, str]:
    """GPT-2 byte -> printable-unicode proxy char."""
    direct = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    mapping = {}
    next_cp = 0
    for b in range(256):
        if b in direct:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + next_cp)
            next_cp += 1
    return mapping


@lru_cache(maxsize=1)
def proxy_to_byte() -> Dict[str, int]:
    return {v: k for k, v in byte_to_proxy().items()}


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_space(ch: str) -> bool:
    return ch.isspace() or unicodedata.category(ch) == "Zs"


_CONTRACTIONS_2 = ("s", "t", "m", "d")
_CONTRACTIONS_3 = ("re", "ve", "ll")


def _match_contraction(text: str, i: int, ci: bool) -> int:
    if text[i] != "'":
        return 0
    rest = text[i + 1 : i + 3]
    if ci:
        rest = rest.lower()
    if rest[:2] in _CONTRACTIONS_3:
        return 3
    if rest[:1] in _CONTRACTIONS_2:
        return 2
    return 0


def pretokenize_qwen2(text: str) -> List[str]:
    """Full Qwen2 pattern semantics over codepoints (see bpe.cpp pre_tokenize)."""
    chunks: List[str] = []
    n = len(text)
    i = 0
    while i < n:
        c = text[i]
        m = _match_contraction(text, i, ci=True)
        if m:
            chunks.append(text[i : i + m])
            i += m
            continue
        if _is_letter(c):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
            chunks.append(text[i:j])
            i = j
            continue
        if (
            c not in "\r\n"
            and not _is_number(c)
            and i + 1 < n
            and _is_letter(text[i + 1])
        ):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
            chunks.append(text[i:j])
            i = j
            continue
        if _is_number(c):
            chunks.append(c)
            i += 1
            continue

        def is_punct(ch: str) -> bool:
            return not (_is_space(ch) or _is_letter(ch) or _is_number(ch))

        j = i
        if c == " " and i + 1 < n and is_punct(text[i + 1]):
            j = i + 1
        if j < n and is_punct(text[j]):
            k = j
            while k < n and is_punct(text[k]):
                k += 1
            while k < n and text[k] in "\r\n":
                k += 1
            chunks.append(text[i:k])
            i = k
            continue
        if _is_space(c):
            j = i
            while j < n and _is_space(text[j]):
                j += 1
            last_crlf = -1
            for k in range(j - 1, i - 1, -1):
                if text[k] in "\r\n":
                    last_crlf = k
                    break
            if last_crlf >= 0:
                chunks.append(text[i : last_crlf + 1])
                i = last_crlf + 1
                continue
            if j < n and j - i > 1:
                chunks.append(text[i : j - 1])
                i = j - 1
                continue
            chunks.append(text[i:j])
            i = j
            continue
        i += 1
    return chunks


def pretokenize_reference(data: bytes) -> List[bytes]:
    """Byte-level emulation of the reference's simplified ASCII regex."""
    def is_al(b: int) -> bool:
        return 0x41 <= b <= 0x5A or 0x61 <= b <= 0x7A

    def is_dg(b: int) -> bool:
        return 0x30 <= b <= 0x39

    def is_ws(b: int) -> bool:
        return b in (0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D)

    def is_special(b: int) -> bool:
        return not is_ws(b) and not (is_al(b) or is_dg(b) or b == 0x5F)

    chunks: List[bytes] = []
    n = len(data)
    i = 0
    while i < n:
        b = data[i]
        m = 0
        if b == ord("'"):
            rest = data[i + 1 : i + 3]
            if rest[:2] in (b"re", b"ve", b"ll"):
                m = 3
            elif rest[:1] in (b"s", b"t", b"m", b"d"):
                m = 2
        if m == 0:
            if is_al(b) or (b == 0x20 and i + 1 < n and is_al(data[i + 1])):
                j = i + (1 if b == 0x20 else 0)
                while j < n and is_al(data[j]):
                    j += 1
                m = j - i
            elif is_dg(b):
                j = i
                while j < n and is_dg(data[j]):
                    j += 1
                m = j - i
            elif is_special(b) or (
                b == 0x20 and i + 1 < n and is_special(data[i + 1])
            ):
                j = i + (1 if b == 0x20 else 0)
                while j < n and is_special(data[j]):
                    j += 1
                m = j - i
            elif is_ws(b):
                j = i
                while j < n and is_ws(data[j]):
                    j += 1
                m = j - i
        if m == 0:
            i += 1
        else:
            chunks.append(data[i : i + m])
            i += m
    return chunks


class PyBpeTokenizer:
    """vocab.json + merges.txt byte-level BPE (Python reference implementation)."""

    def __init__(self, vocab_path: str, merges_path: str = "", mode: str = "qwen2"):
        if mode not in ("qwen2", "reference"):
            raise ValueError(f"unknown pre-tokenizer mode {mode!r}")
        self.mode = mode
        with open(vocab_path, encoding="utf-8") as f:
            self.token_id: Dict[str, int] = json.load(f)
        self.id_token: Dict[int, str] = {v: k for k, v in self.token_id.items()}
        self.ranks: Dict[Tuple[str, str], int] = {}
        self.num_merges = 0
        if merges_path:
            with open(merges_path, encoding="utf-8") as f:
                rank = 0
                for line in f:
                    line = line.rstrip("\n").rstrip("\r")
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split(" ")
                    if len(parts) == 2:
                        self.ranks[(parts[0], parts[1])] = rank
                    rank += 1
                self.num_merges = rank
        proxy = byte_to_proxy()
        self._byte_sym = {b: self.token_id.get(proxy[b], -1) for b in range(256)}

    @property
    def vocab_size(self) -> int:
        return len(self.token_id)

    def _bpe_chunk(self, chunk: bytes) -> List[int]:
        proxy = byte_to_proxy()
        word = [proxy[b] for b in chunk]
        raw = [self._byte_sym[b] < 0 for b in chunk]
        # merge loop: lowest rank first, leftmost on ties (reference semantics);
        # raw-byte (OOV) positions never participate in merges.
        while len(word) > 1:
            best_rank = None
            best_pos = -1
            for i in range(len(word) - 1):
                if raw[i] or raw[i + 1]:
                    continue
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    merged = word[i] + word[i + 1]
                    if merged in self.token_id:
                        best_rank = r
                        best_pos = i
            if best_pos < 0:
                break
            word[best_pos] = word[best_pos] + word[best_pos + 1]
            del word[best_pos + 1]
            del raw[best_pos + 1]
        out = []
        for w, is_raw in zip(word, raw):
            if is_raw:
                out.append(proxy_to_byte()[w])
            else:
                tid = self.token_id.get(w, -1)
                if tid >= 0:
                    out.append(tid)
                else:  # multi-byte token absent from vocab: emit raw bytes
                    for ch in w:
                        out.append(proxy_to_byte().get(ch, 0))
        return out

    def encode(self, text: str) -> List[int]:
        if not text:
            return []
        ids: List[int] = []
        if self.mode == "reference":
            for chunk in pretokenize_reference(text.encode("utf-8")):
                ids.extend(self._bpe_chunk(chunk))
        else:
            for chunk in pretokenize_qwen2(text):
                ids.extend(self._bpe_chunk(chunk.encode("utf-8")))
        return ids

    def decode(self, ids) -> str:
        inv = proxy_to_byte()
        out = bytearray()
        for tid in ids:
            tok = self.id_token.get(int(tid))
            if tok is None:
                continue
            for ch in tok:
                b = inv.get(ch)
                if b is not None:
                    out.append(b)
        return out.decode("utf-8", errors="replace")

    def token_to_string(self, tid: int) -> str:
        return self.id_token.get(int(tid), "")

    def string_to_token(self, token: str) -> int:
        return self.token_id.get(token, -1)
