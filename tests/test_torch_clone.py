"""Voice cloning in the PyTorch port, on the CPU: ``log_mel`` and both
speaker-encoder topologies against the JAX package's, the regression
fixture's ``mel`` and ``speaker_embed``, and greedy ``synthesize_clone``
against the JAX engine's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.config import MelConfig as JMel
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.frontend.mel import log_mel as j_log_mel
from leaxer_qwen3_tts_tpu.models import speaker_encoder as jse
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer, write_wav
from leaxer_qwen3_tts_torch.frontend import mel as tmel
from leaxer_qwen3_tts_torch.models import speaker_encoder as tse
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from test_torch_slice import FIXTURE, TOL, _port

torch.set_num_threads(2)

MEL = tcfg.MelConfig()
# log_mel: both take float32 rFFTs of the same frames (XLA's and PocketFFT's
# rounding); on audio with energy in every bin the logs agree to ~1.2e-5
MEL_LOG_ABS = 1e-4
# a pure tone leaves bins at the float32 FFT's rounding floor, whose logs
# differ between FFTs (up to 0.2 in the log at energies near 1e-10, 2.7e-3
# at -15, 2.8e-5 above -5); there, compare energies to the JAX package's own
# oracle tolerance (tests/test_wav_mel.py: rtol 5e-3, atol 1e-8) and the logs
# of the bins above LOUD_LOG to MEL_LOG_ABS
MEL_ENERGY = dict(rtol=5e-3, atol=1e-8)
LOUD_LOG = -5.0
EMB_ABS = 1e-5  # the encoders on the same mel: the same float32 ops, summed in other orders
# the embedding of a reference WAV: the two mels' rounding-floor bins (the
# tone's quiet bands) move it by up to 5.3e-4 of values up to ~20 (measured)
CLONE_EMB_ABS = 2e-3


def _sine(n=2400, freq=440.0):
    t = np.arange(n) / 24000.0
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.mark.parametrize("n", [24000, 5000, 1024, 1000, 3])
def test_log_mel_matches_jax_on_noise(n):
    """Random audio of 1 s, a few frames, exactly one window, and shorter
    than a window (taps past the end read zero: one frame)."""
    audio = (np.random.default_rng(n).standard_normal(n) * 0.3).astype(np.float32)
    want = np.asarray(j_log_mel(audio, JMel()))
    got = tmel.log_mel(audio, MEL, "cpu").numpy()
    assert got.shape == want.shape == (tmel.num_frames(n, MEL), MEL.num_mels)
    np.testing.assert_allclose(got, want, atol=MEL_LOG_ABS, rtol=0)


@pytest.mark.parametrize("freq", [440.0, 4000.0])
def test_log_mel_matches_jax_on_tones(freq):
    audio = _sine(6000, freq)
    want = np.asarray(j_log_mel(audio, JMel()))
    got = tmel.log_mel(torch.from_numpy(audio), MEL, "cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(np.exp(got), np.exp(want), **MEL_ENERGY)
    loud = want > LOUD_LOG
    assert loud.mean() > 0.03
    np.testing.assert_allclose(got[loud], want[loud], atol=MEL_LOG_ABS, rtol=0)


def test_log_mel_empty_and_oracle():
    """Empty audio gives [0, num_mels] as in JAX; the JAX package's numpy
    oracle agrees with the torch version; the port's filterbank and window
    are JAX's."""
    from leaxer_qwen3_tts_tpu.frontend import mel as jmel

    assert tmel.log_mel(np.zeros((0,), np.float32), MEL, "cpu").shape == (0, MEL.num_mels)
    audio = (np.random.default_rng(0).standard_normal(3000) * 0.3).astype(np.float32)
    np.testing.assert_allclose(tmel.log_mel(audio, MEL, "cpu").numpy(),
                               jmel.log_mel_reference_np(audio, JMel()), atol=MEL_LOG_ABS,
                               rtol=0)

    np.testing.assert_array_equal(tmel.mel_filterbank(MEL), jmel.mel_filterbank(JMel()))
    np.testing.assert_array_equal(tmel.hann_window_symmetric(1024),
                                  jmel.hann_window_symmetric(1024))


def _encoders(tiny_model, topology):
    cfg, _ = tiny_model
    se = dataclasses.replace(cfg.speaker_encoder, topology=topology, ecapa_channels=32,
                             ecapa_scale=4, ecapa_mfa_dim=48, ecapa_att_dim=16)
    jp = jse.init_speaker_encoder_params(se, jax.random.PRNGKey(7))
    tp = params_from_jax(flatten_params(jax.device_get(jp)))
    return se, jp, tcfg.SpeakerEncoderConfig(**dataclasses.asdict(se)), tp


@pytest.mark.parametrize("topology", ["transformer", "ecapa"])
def test_speaker_encoder_matches_jax(tiny_model, topology):
    """A ragged batch (mel_len 40, 17, 3) and the full-length default: the
    JAX forward's embeddings within EMB_ABS; frames past a row's length
    change nothing."""
    jc, jp, tc, tp = _encoders(tiny_model, topology)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((3, 40, 128)).astype(np.float32)
    lens = np.array([40, 17, 3], np.int32)
    want = np.asarray(jse.speaker_encoder_forward(jc, jp, jnp.asarray(mel), jnp.asarray(lens)))
    got = tse.speaker_encoder_forward(tc, tp, torch.from_numpy(mel), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == (3, tc.output_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=EMB_ABS, rtol=0)
    full = np.asarray(jse.speaker_encoder_forward(jc, jp, jnp.asarray(mel[:1])))
    np.testing.assert_allclose(tse.speaker_encoder_forward(tc, tp, torch.from_numpy(mel[:1]))
                               .numpy(), full, atol=EMB_ABS, rtol=0)
    noisy = mel.copy()
    noisy[1, 17:] = 9.0
    again = tse.speaker_encoder_forward(tc, tp, torch.from_numpy(noisy), torch.from_numpy(lens))
    np.testing.assert_allclose(again[1].numpy(), got[1].numpy(), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def recorded():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in ("mel", "speaker_embed")}


def test_fixture_mel_and_speaker_embed(tiny_model, recorded):
    """The regression fixture's 440 Hz tone: its mel (energies, and the logs
    above the rounding floor), and the tiny encoder's embedding of the
    fixture's mel to the fixture's tolerance.  (A pure tone leaves most bins
    at the FFT's rounding floor, logs between -23 and -15 that differ between
    FFTs, and the random tiny encoder weighs those bins like any other.)"""
    mel = tmel.log_mel(_sine(), MEL, "cpu")
    want = recorded["mel"]
    assert tuple(mel.shape) == want.shape
    np.testing.assert_allclose(np.exp(mel.numpy()), np.exp(want), **MEL_ENERGY)
    loud = want > LOUD_LOG
    np.testing.assert_allclose(mel.numpy()[loud], want[loud], **TOL)
    cfg, params = _port(tiny_model)
    emb = tse.speaker_encoder_forward(cfg.speaker_encoder, params["speaker_encoder"],
                                      torch.from_numpy(want)[None])
    np.testing.assert_allclose(emb.numpy(), recorded["speaker_embed"], **TOL)


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    """A 3 s reference at 16 kHz (the engine resamples it to 24 kHz)."""
    t = np.arange(48000) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    path = str(tmp_path_factory.mktemp("ref") / "ref.wav")
    write_wav(path, audio.astype(np.float32), 16000)
    return path


def test_synthesize_clone_matches_jax(tiny_model, tiny_vocab_files, ref_wav):
    """The embedding of the reference WAV within CLONE_EMB_ABS of the JAX
    engine's (and the port's encoder on the JAX mel within EMB_ABS), and
    greedy synthesize_clone codes equal to its (also through
    synthesize_stream(speaker_wav=)); without an encoder both refuse."""
    cfg, params = tiny_model
    tc, tp = _port(tiny_model)
    vocab_path, merges_path, _ = tiny_vocab_files
    kw = dict(max_frames=8, chunk_len=4, first_chunk_len=2)
    jeng = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path), **kw)
    teng = TTSEngine(config=tc, params=tp, tokenizer=Tokenizer(vocab_path, merges_path),
                     device="cpu", **kw)
    want_emb = jeng.extract_speaker_embedding(ref_wav)
    np.testing.assert_allclose(teng.extract_speaker_embedding(ref_wav), want_emb,
                               atol=CLONE_EMB_ABS, rtol=0)
    from leaxer_qwen3_tts_tpu.frontend import read_wav, resample

    audio, sr = read_wav(ref_wav)
    jmel = np.array(j_log_mel(resample(audio, sr, 24000), JMel()))
    emb = tse.speaker_encoder_forward(tc.speaker_encoder, teng.params["speaker_encoder"],
                                      torch.from_numpy(jmel)[None])
    np.testing.assert_allclose(emb[0].numpy(), want_emb, atol=EMB_ABS, rtol=0)
    want = jeng.synthesize_clone("hello world", ref_wav, temperature=0.0, max_tokens=8)
    got = teng.synthesize_clone("hello world", ref_wav, temperature=0.0, max_tokens=8)
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
    streamed = list(teng.synthesize_stream("hello world", temperature=0.0, max_tokens=8,
                                           speaker_wav=ref_wav))
    np.testing.assert_array_equal(streamed[-1].codes, got.codes)
    plain = teng.synthesize("hello world", temperature=0.0, max_tokens=8)
    assert plain.codes.shape != got.codes.shape or (plain.codes != got.codes).any()
    no_enc = dict(tp)
    del no_enc["speaker_encoder"]
    bare = TTSEngine(config=tc, params=no_enc, tokenizer=teng.tokenizer, device="cpu", **kw)
    assert not bare.has_speaker_encoder()
    with pytest.raises(EngineError, match="model has no speaker encoder"):
        bare.synthesize_clone("hello world", ref_wav)
