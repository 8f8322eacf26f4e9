"""The voice-design and preset-speaker slice of the PyTorch port, on the CPU:
``build_prompt`` with a speaker splice and an instruction segment, the
engine's ``instruct`` and ``synthesize_speaker`` against the JAX engine, the
talker prefill under ``attn_impl="pallas"`` (kernel K8's plain version)
against the JAX prefill with its interpret-mode kernel, the K3 route on a
kernel-width engine, and the configuration knobs the port does not take."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.models import talker as jtalker
from leaxer_qwen3_tts_tpu.runtime import prompt as jprompt
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.models import talker as ttalker
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params
from leaxer_qwen3_tts_torch.runtime import prompt as tprompt
from leaxer_qwen3_tts_torch.runtime.weights import init_params, params_from_jax

torch.set_num_threads(2)

ATOL = 2e-4  # the regression fixture's tolerance (test_regression.py)
INSTRUCT = "hello world hello"
ENGINE = dict(max_frames=8, chunk_len=4)


@pytest.fixture(scope="module")
def voiced(tiny_model):
    """The tiny model with a [9, H] speaker table, in both packages' forms."""
    cfg, params = tiny_model
    jp = dict(params)
    rng = np.random.default_rng(0)
    jp["speaker_table"] = rng.standard_normal((9, cfg.talker.hidden_size)).astype(np.float32)
    tp = params_from_jax(flatten_params(jax.device_get(jp)))
    return cfg, jp, tcfg.TTSModelConfig.from_json(cfg.to_json()), tp


@pytest.fixture(scope="module")
def engines(voiced, tiny_vocab_files):
    cfg, jp, tc, tp = voiced
    vocab_path, merges_path, _ = tiny_vocab_files
    jeng = JEngine(config=cfg, params=jp, tokenizer=JTokenizer(vocab_path, merges_path), **ENGINE)
    teng = TTSEngine(config=tc, params=tp, tokenizer=Tokenizer(vocab_path, merges_path),
                     device="cpu", **ENGINE)
    return jeng, teng


def test_17b_preset_and_speakers_match_jax():
    """The 1.7B preset round-trips through the JSON form to the JAX preset,
    and the preset speakers are the JAX package's."""
    from leaxer_qwen3_tts_tpu import config as jcfg

    assert tcfg.TTSModelConfig.from_json(jcfg.QWEN3_TTS_17B.to_json()) == tcfg.QWEN3_TTS_17B
    assert tcfg.QWEN3_TTS_17B.to_json() == jcfg.QWEN3_TTS_17B.to_json()
    assert tcfg.PRESET_SPEAKERS == jcfg.PRESET_SPEAKERS


def test_params_from_jax_carries_speaker_table(voiced):
    """The table crosses over as it is, and the int8 transforms leave it
    alone (it is no matmul weight of the talker or the MTP)."""
    _, jp, _, tp = voiced
    np.testing.assert_array_equal(tp["speaker_table"].numpy(), jp["speaker_table"])
    assert quantize_params(fuse_params(tp))["speaker_table"] is tp["speaker_table"]


@pytest.mark.parametrize("speaker,instruct,lang", [
    (True, False, None), (False, True, None), (True, True, tcfg.LANG_ENGLISH),
])
def test_build_prompt_segments_match_jax(voiced, speaker, instruct, lang):
    """prompt_embeds, trailing and prompt_len with a speaker splice and an
    instruction segment whose slots past instruct_len carry TTS_PAD."""
    _, jp, _, tp = voiced
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1000, (2, 6))
    lens = np.array([6, 3])
    spk = jp["speaker_table"][[0, 4]] if speaker else None
    instr = rng.integers(0, 1000, (2, 5)) if instruct else None
    instr_len = np.array([5, 2]) if instruct else None
    jb = jprompt.build_prompt(
        jax.device_get(jp["embeddings"]), jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32),
        lang, None if spk is None else jnp.asarray(spk),
        None if instr is None else jnp.asarray(instr, jnp.int32),
        None if instr_len is None else jnp.asarray(instr_len, jnp.int32))

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a))

    tb = tprompt.build_prompt(tp["embeddings"], t(ids), t(lens), lang, t(spk), t(instr),
                              t(instr_len))
    np.testing.assert_allclose(tb.prompt_embeds.numpy(), np.asarray(jb.prompt_embeds), atol=1e-6)
    np.testing.assert_allclose(tb.trailing.numpy(), np.asarray(jb.trailing), atol=1e-6)
    P = tprompt.prompt_length(lang, speaker, 5 if instruct else 0)
    assert tb.prompt_len == P == int(np.asarray(jb.prompt_len)[0]) == jprompt.prompt_length(
        lang, speaker, 5 if instruct else 0)


def test_instruct_and_speaker_match_jax(engines):
    """Greedy codes with an instruction, with a preset speaker and with both
    equal the JAX engine's; the audio to the fixture's tolerance."""
    jeng, teng = engines
    runs = [
        (lambda e: e.synthesize("hello world", temperature=0.0, instruct=INSTRUCT)),
        (lambda e: e.synthesize_speaker("hello", "Serena", temperature=0.0)),
        (lambda e: e.synthesize_speaker("hello world", "ono_anna", language="en",
                                        temperature=0.0, instruct="world")),
    ]
    for run in runs:
        want, got = run(jeng), run(teng)
        np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
        np.testing.assert_allclose(got.audio, np.asarray(want.audio), atol=ATOL)
    plain = teng.synthesize("hello world", temperature=0.0)
    assert not np.array_equal(runs[0](teng).codes, plain.codes)  # the segment conditions


def test_speaker_fallback_and_unknown_name(engines, voiced, tiny_vocab_files, caplog):
    """Without a table: a warning and plain synthesis; an unknown preset
    name raises."""
    _, teng = engines
    _, _, tc, tp = voiced
    bare = TTSEngine(config=tc, params={k: v for k, v in tp.items() if k != "speaker_table"},
                     tokenizer=teng.tokenizer, device="cpu", **ENGINE)
    with caplog.at_level(logging.WARNING):
        r = bare.synthesize_speaker("hello", "serena", temperature=0.0)
    assert "speaker_table" in caplog.text
    np.testing.assert_array_equal(r.codes, bare.synthesize("hello", temperature=0.0).codes)
    with pytest.raises(EngineError, match="unknown speaker"):
        teng.synthesize_speaker("hello", "not-a-speaker")


def test_instruct_stream_across_a_ladder_rung_matches_jax(voiced, tiny_vocab_files):
    """The instruction lengthens the prompt to 24 positions: the first rung
    (32 slots) holds the first chunks, the cache grows to 56 mid-request, and
    the codes equal the JAX engine's; the streamed chunks make up the final
    audio.  A prompt past the top rung raises in both engines."""
    cfg, jp, tc, tp = voiced
    vocab_path, merges_path, _ = tiny_vocab_files
    kw = dict(max_frames=24, chunk_len=4, first_chunk_len=2, kv_buckets=(32,))
    jeng = JEngine(config=cfg, params=jp, tokenizer=JTokenizer(vocab_path, merges_path), **kw)
    teng = TTSEngine(config=tc, params=tp, tokenizer=Tokenizer(vocab_path, merges_path),
                     device="cpu", **kw)
    assert teng.kv_ladder == (32, 56)
    assert tprompt.prompt_length(None, False, 16) == 24
    want = list(jeng.synthesize_stream("hello world", temperature=0.0, max_tokens=20,
                                       instruct=INSTRUCT))[-1]
    chunks = list(teng.synthesize_stream("hello world", temperature=0.0, max_tokens=20,
                                         instruct=INSTRUCT))
    got = chunks[-1]
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
    assert got.metrics.decoded_frames > 32 - 24  # decoding went past the first rung
    np.testing.assert_array_equal(np.concatenate(chunks[:-1])[: got.audio.shape[0]], got.audio)
    long = " ".join(["hello"] * 40)
    for eng, err in ((jeng, Exception), (teng, EngineError)):
        with pytest.raises(err, match="too long"):
            eng.synthesize("hello", temperature=0.0, instruct=long)


def test_spec_with_segments_matches_sequential(voiced, tiny_vocab_files):
    """spec_k with an instruction and a preset speaker: greedy codes equal
    sequential decoding's."""
    _, _, tc, tp = voiced
    vocab_path, merges_path, _ = tiny_vocab_files
    eng = TTSEngine(config=tc, params=tp, tokenizer=Tokenizer(vocab_path, merges_path),
                    device="cpu", spec_k=3, spec_iters=2, **ENGINE)
    got = eng.synthesize_speaker("hello world", "dylan", temperature=0.0, instruct=INSTRUCT)
    assert got.metrics.spec_iterations > 0
    eng.spec_k = None
    seq = eng.synthesize_speaker("hello world", "dylan", temperature=0.0, instruct=INSTRUCT)
    np.testing.assert_array_equal(got.codes, seq.codes)


def test_pallas_talker_prefill_matches_jax(voiced):
    """talker_prefill with attn_impl="pallas": the port's K8 plain version
    against the JAX prefill with its interpret-mode flash kernel, two rows
    of different prompt lengths."""
    cfg, jp, tc, tp = voiced
    jt = dataclasses.replace(cfg.talker, transformer=dataclasses.replace(
        cfg.talker.transformer, attn_impl="pallas"))
    tt = dataclasses.replace(tc.talker, transformer=dataclasses.replace(
        tc.talker.transformer, attn_impl="pallas"))
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 10, cfg.talker.hidden_size)) * 0.5).astype(np.float32)
    lens = np.array([10, 7])
    jl, jh, jc, jv = jtalker.talker_prefill(jt, jp["talker"], jnp.asarray(x),
                                            jnp.asarray(lens, jnp.int32),
                                            jtalker.talker_init_cache(jt, 2, 32))
    tl, th, tcache, tv = ttalker.talker_prefill(tt, tp["talker"], torch.from_numpy(x),
                                                torch.from_numpy(lens),
                                                ttalker.talker_init_cache(tt, 2, 32, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _kernel_width(tiny_vocab_files, **cp):
    """The kernel-width model (test_torch_slice) as a port engine, int8."""
    from test_torch_slice import _kernel_width_cfg

    jc = _kernel_width_cfg()
    tc = tcfg.TTSModelConfig.from_json(jc.to_json())
    tc = dataclasses.replace(tc, code_predictor=dataclasses.replace(tc.code_predictor, **cp))
    vocab_path, merges_path, _ = tiny_vocab_files
    return tc, init_params(tc, seed=0), Tokenizer(vocab_path, merges_path)


def test_k3_route_matches_k2_at_float32(tiny_vocab_files, monkeypatch):
    """With the residency gate failing, the B=1 chain takes K3 (one call per
    frame); at a float32 model its greedy codes equal K2's."""
    tc, params, tok = _kernel_width(tiny_vocab_files)
    eng = TTSEngine(config=tc, params=params, tokenizer=tok, quantize="int8", device="cpu",
                    max_frames=4, chunk_len=2)
    k2 = eng.synthesize("hello", temperature=0.0, max_tokens=4)
    calls = []
    real = tcp.fused_mtp_chain_streamed
    monkeypatch.setattr(tcp, "supports_resident", lambda *a, **k: False)
    monkeypatch.setattr(tcp, "fused_mtp_chain_streamed",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    k3 = eng.synthesize("hello", temperature=0.0, max_tokens=4)
    assert len(calls) == k3.metrics.decoded_frames > 0
    np.testing.assert_array_equal(k3.codes, k2.codes)


def test_untaken_knobs_raise(voiced, tiny_vocab_files, monkeypatch):
    """The argument frame_fused=True (the whole-frame kernel K7) is
    sequential-only: with spec_k the engine is not ready, as the JAX engine
    is.  code_predictor.resident=False (the per-step MTP path) is a route
    now, on the card as on the CPU: the card's gate lets it pass (the
    engine then stops only where it moves tensors to a card this machine
    lacks), and on the CPU its chain takes one K1 step per chain position
    past the prefix."""
    _, _, tc, tp = voiced
    eng = TTSEngine(config=tc, params=tp, device="cpu", frame_fused=True, spec_k=4)
    assert not eng.is_ready() and "sequential-only" in eng.get_error()
    with pytest.raises(EngineError, match="sequential-only"):
        eng.synthesize("hello", temperature=0.0)
    kc, params, tok = _kernel_width(tiny_vocab_files, resident=False)
    eng = TTSEngine(config=kc, params=params, quantize="int8", device="cuda")
    assert "resident" not in eng.get_error() and "CUDA kernel path" not in eng.get_error()
    eng = TTSEngine(config=kc, params=params, tokenizer=tok, quantize="int8", device="cpu",
                    max_frames=4, chunk_len=2)
    calls = []
    real = tcp.fused_decode_step
    monkeypatch.setattr(tcp, "fused_decode_step",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    r = eng.synthesize("hello", temperature=0.0, max_tokens=4)
    steps = kc.code_predictor.num_steps - 1
    assert r.metrics.decoded_frames > 0 and len(calls) == steps * r.metrics.decoded_frames
