"""The port's engine construction contract and environment switches against
the JAX engine's, on the CPU.

JAX ``TTSEngine.__init__`` records a construction error instead of raising
(``is_ready()``, ``get_error()``, ``has_speaker_encoder()``; synthesis then
raises ``engine not ready: ...``), and raises at once only for a ``spec_k``
outside [2, 8].  It refuses ``frame_fused=True`` with ``spec_k`` only as an
argument: a config with ``frame_fused`` set and ``spec_k`` builds a ready
engine that decodes speculatively and runs the whole-frame kernel on the
fallback's sequential frames where it is eligible.  With the config fields
None, ``QTTS_FRAME_FUSED`` and ``QTTS_MTP_RESIDENT`` decide."""

import dataclasses

import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.api.engine import EngineError as JEngineError
from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.models import code_predictor as jcp
from leaxer_qwen3_tts_tpu.runtime import generate as jgen
from leaxer_qwen3_tts_tpu.serve.pool import ContinuousBatcher as JBatcher
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.runtime import generate as tgen
from leaxer_qwen3_tts_torch.serve import ContinuousBatcher
from test_torch_speculative import _port
from test_torch_voice import _kernel_width

torch.set_num_threads(2)

BASE = dict(max_frames=12, chunk_len=4, first_chunk_len=2)


def _pair(tiny_model, tiny_vocab_files, cfg_edit=None, **kw):
    """The JAX engine and the port's on the same tiny model and knobs."""
    cfg, params = tiny_model
    if cfg_edit:
        cfg = dataclasses.replace(cfg, **cfg_edit)
    tc, tp = _port(cfg, params)
    vocab_path, merges_path, _ = tiny_vocab_files
    j = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path),
                **BASE, **kw)
    t = TTSEngine(config=tc, params=tp, tokenizer=Tokenizer(vocab_path, merges_path),
                  device="cpu", **BASE, **kw)
    return j, t


@pytest.mark.parametrize("case,kw,words", [
    ("frame_fused argument with spec_k", dict(frame_fused=True, spec_k=3),
     ("sequential-only", "sequential-only")),
    ("unknown quantize mode", dict(quantize="int3"), ("quantize", "quantize")),
])
def test_construction_error_recorded_like_jax(tiny_model, tiny_vocab_files, case, kw, words):
    """Both engines construct, are not ready, report the error, refuse every
    synthesis call and a pool with ``engine not ready: ...``."""
    jeng, teng = _pair(tiny_model, tiny_vocab_files, **kw)
    assert not jeng.is_ready() and not teng.is_ready()
    assert words[0] in jeng.get_error() and words[1] in teng.get_error()
    assert not jeng.has_speaker_encoder() and not teng.has_speaker_encoder()
    with pytest.raises(JEngineError, match="engine not ready"):
        jeng.synthesize("hello world", temperature=0.0)
    for call in (lambda: teng.synthesize("hello world", temperature=0.0),
                 lambda: list(teng.synthesize_stream("hello world", temperature=0.0)),
                 lambda: teng.synthesize_batch(["hello", "world"], temperature=0.0),
                 lambda: teng.synthesize_tokens([5, 6, 7], temperature=0.0),
                 lambda: teng.synthesize_speaker("hello", "serena", temperature=0.0)):
        with pytest.raises(EngineError, match="engine not ready: "):
            call()
    with pytest.raises(JEngineError, match="engine not ready"):
        JBatcher(jeng, pool_size=2)
    with pytest.raises(EngineError, match="engine not ready"):
        ContinuousBatcher(teng, pool_size=2)


@pytest.mark.parametrize("spec_k", [1, 9])
def test_spec_k_range_raises_like_jax(tiny_model, tiny_vocab_files, spec_k):
    """A spec_k outside [2, 8] raises at once in both engines."""
    with pytest.raises(ValueError, match="spec_k"):
        _pair(tiny_model, tiny_vocab_files, spec_k=spec_k)


def test_ready_engine_reports_like_jax(tiny_model, tiny_vocab_files):
    """A good construction is ready with no error in both engines, and both
    report the same speaker-encoder presence."""
    jeng, teng = _pair(tiny_model, tiny_vocab_files)
    assert jeng.is_ready() and teng.is_ready()
    assert jeng.get_error() == teng.get_error() == ""
    assert jeng.has_speaker_encoder() == teng.has_speaker_encoder()


@pytest.mark.parametrize("knobs", [
    dict(spec_k=3, spec_iters=2),
    dict(spec_k=3, spec_iters=1, spec_accept_floor=1.01, spec_adapt_window=1),  # fallback
])
def test_config_frame_fused_with_spec_k_decodes_like_jax(tiny_model, tiny_vocab_files, knobs):
    """A config with frame_fused set plus spec_k: both engines are ready and
    decode speculatively, greedy codes and spec counters equal."""
    jeng, teng = _pair(tiny_model, tiny_vocab_files, cfg_edit=dict(frame_fused=True), **knobs)
    assert jeng.is_ready(), jeng.get_error()
    assert teng.is_ready(), teng.get_error()
    want = jeng.synthesize("hello world", temperature=0.0, seed=5)
    got = teng.synthesize("hello world", temperature=0.0, seed=5)
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
    assert got.metrics.spec_iterations == want.metrics.spec_iterations > 0
    assert got.metrics.spec_fallback == want.metrics.spec_fallback == (
        "spec_accept_floor" in knobs)


def test_config_frame_fused_spec_fallback_runs_the_frame_kernel(tiny_vocab_files, monkeypatch):
    """At kernel width, with packs (the JAX engine packs on its accelerator
    only): spec iterations first, then the fallback's sequential frames go
    through the whole-frame kernel's gate, as JAX's ``_frame_step`` routes
    them."""
    tc, params, tok = _kernel_width(tiny_vocab_files)
    eng = TTSEngine(config=dataclasses.replace(tc, frame_fused=True), params=params,
                    tokenizer=tok, quantize="int8", device="cpu", max_frames=10, chunk_len=2,
                    first_chunk_len=2, spec_k=3, spec_iters=1, spec_accept_floor=1.01,
                    spec_adapt_window=1)
    assert eng.is_ready(), eng.get_error()
    calls = []
    real = tgen.fused_frame_step
    monkeypatch.setattr(tgen, "fused_frame_step",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    r = eng.synthesize("hello world", temperature=0.0, max_tokens=8)
    assert r.metrics.spec_fallback and r.metrics.spec_iterations > 0
    assert calls and np.isfinite(r.audio).all()


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("field", [None, False, True])
def test_frame_fused_switch_resolves_like_jax(monkeypatch, env, field):
    """cfg.frame_fused when set, else QTTS_FRAME_FUSED (off unless not "0"):
    the port's switch equals JAX's resolution in ``_frame_fused_eligible``."""
    if env is None:
        monkeypatch.delenv("QTTS_FRAME_FUSED", raising=False)
    else:
        monkeypatch.setenv("QTTS_FRAME_FUSED", env)
    jax_on = field if field is not None else jgen._frame_fused_enabled()
    cfg = _kernel_width_cfg(frame_fused=field)
    assert tgen.frame_fused_enabled(cfg) == jax_on


@pytest.mark.parametrize("env", ["0", "1"])
@pytest.mark.parametrize("field", [None, False, True])
def test_mtp_resident_switch_resolves_like_jax(monkeypatch, env, field):
    """code_predictor.resident when set, else QTTS_MTP_RESIDENT: the port's
    switch equals JAX's (``predict_subcodes``' ``resident``).  With neither,
    JAX takes its accelerator's default (on) only on the TPU; the port's
    default is on, its card's path."""
    monkeypatch.setenv("QTTS_MTP_RESIDENT", env)
    jax_on = field if field is not None else jcp._resident_enabled()
    cp = dataclasses.replace(_kernel_width_cfg().code_predictor, resident=field)
    assert tcp.resident_enabled(cp) == jax_on


def _kernel_width_cfg(**edit):
    """test_torch_slice's kernel-width model, as the port's config."""
    from leaxer_qwen3_tts_torch import config as tcfg
    from test_torch_slice import _kernel_width_cfg as kw_cfg

    return dataclasses.replace(tcfg.TTSModelConfig.from_json(kw_cfg().to_json()), **edit)


def test_environment_routes_the_engine(tiny_vocab_files, monkeypatch):
    """With the config fields None: QTTS_FRAME_FUSED=1 runs every B=1 frame
    through the whole-frame kernel, "0" through K1 / K2; QTTS_MTP_RESIDENT=0
    sends the chain to the per-step chain (one K1 step per chain position,
    as JAX's ``predict_subcodes_fused``), which the card's gate lets pass
    (the engine then stops only where it moves tensors to a card this
    machine lacks)."""
    tc, params, tok = _kernel_width(tiny_vocab_files, resident=None)
    assert tc.frame_fused is None and tc.code_predictor.resident is None
    kw = dict(params=params, tokenizer=tok, quantize="int8", device="cpu", max_frames=4,
              chunk_len=2)
    for env, fused in (("1", True), ("0", False)):
        monkeypatch.setenv("QTTS_FRAME_FUSED", env)
        r = TTSEngine(config=tc, **kw).synthesize("hello", temperature=0.0, max_tokens=4)
        assert (r.metrics.frame_fused_frames == r.metrics.decoded_frames > 0) == fused
        assert fused or r.metrics.frame_fused_frames == 0
    monkeypatch.setenv("QTTS_FRAME_FUSED", "0")
    monkeypatch.setenv("QTTS_MTP_RESIDENT", "0")
    eng = TTSEngine(config=tc, **kw)
    assert tcp.chain_kernel(tc.code_predictor, eng.params["code_predictor"], 1) is None
    assert tcp.chain_route(tc.code_predictor, eng.params["code_predictor"], 1) == "per_step"
    assert np.isfinite(eng.synthesize("hello", temperature=0.0, max_tokens=4).audio).all()
    card = TTSEngine(config=tc, params=params, quantize="int8", device="cuda")
    assert "CUDA kernel path" not in card.get_error() and "RESIDENT" not in card.get_error()
