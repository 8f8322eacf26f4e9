"""Profiling in the PyTorch port (the JAX package's tests/test_profiling.py
for ``torch.profiler``): with QTTS_PROFILE set every synthesis writes a
Chrome trace holding its ``synthesize`` range; without it nothing is
written and ``annotate`` is a no-op."""

import json
import os
import types

import torch

from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.utils import profiling
from test_torch_slice import _port

torch.set_num_threads(2)


def _engine(tiny_model, tiny_vocab_files):
    cfg, params = _port(tiny_model)
    vocab_path, merges_path, _ = tiny_vocab_files
    return TTSEngine(config=cfg, params=params, tokenizer=Tokenizer(vocab_path, merges_path),
                     max_frames=3, chunk_len=3, device="cpu")


def test_profile_trace_written(tiny_model, tiny_vocab_files, tmp_path, monkeypatch):
    """One trace directory per synthesis (``synthesize-<ms>/trace.json``),
    whose events hold the ``synthesize`` range and the CPU ops under it."""
    eng = _engine(tiny_model, tiny_vocab_files)
    monkeypatch.setenv("QTTS_PROFILE", str(tmp_path))
    eng.synthesize("hello", temperature=0.0)
    list(eng.synthesize_stream("hello", temperature=0.0))
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2 and all(d.startswith("synthesize-") for d in dirs)
    with open(tmp_path / dirs[0] / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "synthesize" in names
    assert any(n and n.startswith("aten::") for n in names)


def test_no_profile_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv("QTTS_PROFILE", raising=False)
    with profiling.maybe_trace("x"):
        with profiling.annotate("y"):
            pass  # no-op without the env var
    assert list(tmp_path.iterdir()) == []


def test_profile_trace_survives_a_dropped_stream(tiny_model, tiny_vocab_files, tmp_path,
                                                 monkeypatch):
    """A stream closed after its first chunk (a client that hangs up) still
    writes its trace; warmup writes none."""
    eng = _engine(tiny_model, tiny_vocab_files)
    monkeypatch.setenv("QTTS_PROFILE", str(tmp_path))
    assert eng.warmup() > 0
    assert list(tmp_path.iterdir()) == []
    stream = eng.synthesize_stream("hello", temperature=0.0)
    next(stream)
    stream.close()
    (d,) = os.listdir(tmp_path)
    with open(tmp_path / d / profiling.TRACE_FILE) as f:
        assert "synthesize" in {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profile_regions_get_their_own_directories(tmp_path, monkeypatch):
    """Two regions in the same millisecond write two directories; a region
    that starts inside a traced one is recorded in it and writes none."""
    monkeypatch.setenv("QTTS_PROFILE", str(tmp_path))
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time=lambda: 1.0))
    for _ in range(2):
        with profiling.maybe_trace("x"):
            with profiling.maybe_trace("inner"):
                torch.ones(2).sum()
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2 and all(d.startswith("x-1000-") for d in dirs)
    with open(tmp_path / dirs[0] / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "x" in names and "inner" in names
