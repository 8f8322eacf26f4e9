"""The PyTorch port's main path as a whole, on the CPU (the kernels' plain
versions): (a) the tiny model against the committed regression fixture,
(b) a kernel-width model whose talker step and MTP chain are packed, against
the JAX package's generate loop with its interpret-mode Pallas kernels,
(c) the engine end to end, (d) the port imports no JAX."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest_util import build_tiny_cfg
from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models.code_predictor import prepare_fused_step
from leaxer_qwen3_tts_torch.models.codec12hz import vocoder_forward
from leaxer_qwen3_tts_torch.models.talker import prepare_fused_talker
from leaxer_qwen3_tts_torch.ops import (
    flash_attention,
    fused_frame,
    fused_mtp,
    fused_mtp_stream,
    fused_step,
    fused_verify,
)
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params
from leaxer_qwen3_tts_torch.runtime.generate import make_generate_fns
from leaxer_qwen3_tts_torch.runtime.prompt import build_prompt
from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.tools import a8_probe, w8a8_probe

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "regression_tiny.npz")
TOL = dict(rtol=2e-4, atol=2e-4)  # the fixture's own tolerance (test_regression.py)


def _port(tiny_model):
    cfg, params = tiny_model
    return (
        tcfg.TTSModelConfig.from_json(cfg.to_json()),
        params_from_jax(flatten_params(jax.device_get(params))),
    )


@pytest.fixture(scope="module")
def recorded():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port_outputs(tiny_model):
    """The regression fixture's stages through the port (same ids, greedy)."""
    cfg, params = _port(tiny_model)
    ids = torch.tensor([[101, 2002, 30303, 4, 55555]])
    lens = torch.tensor([5])
    bundle = build_prompt(params["embeddings"], ids, lens, None)
    fns = make_generate_fns(cfg, batch=1, max_len=32, chunk_len=4)
    state, bundle2 = fns.prefill(params, ids, lens)
    prefill_logits = state.last_logits.numpy().copy()
    state, frames, valid = fns.decode(
        params, state, bundle2.trailing, bundle2.trailing_len, bundle2.tts_pad_embed,
        SamplingParams.create(temperature=0.0),
    )
    audio = vocoder_forward(cfg.vocoder, params["vocoder"], frames)
    return {
        "prompt_embeds": bundle.prompt_embeds.numpy(),
        "trailing": bundle.trailing.numpy(),
        "prefill_logits": prefill_logits,
        "greedy_frames": frames.numpy(),
        "frame_valid": valid.numpy(),
        "audio_head": audio[:, :4000].numpy(),
    }


@pytest.mark.parametrize("key", ["prompt_embeds", "trailing", "prefill_logits", "audio_head"])
def test_tiny_matches_regression_fixture(recorded, port_outputs, key):
    assert port_outputs[key].shape == recorded[key].shape, key
    np.testing.assert_allclose(port_outputs[key], recorded[key], **TOL, err_msg=key)


def test_tiny_greedy_frames_exact(recorded, port_outputs):
    np.testing.assert_array_equal(port_outputs["greedy_frames"], recorded["greedy_frames"])
    np.testing.assert_array_equal(port_outputs["frame_valid"], recorded["frame_valid"])


def _kernel_width_cfg():
    """Talker 1 layer at H=1024 with the fused step; MTP 1 layer, int8,
    packed, resident chain on; a tiny vocoder (the loop never vocodes)."""
    t = jcfg.TransformerConfig(
        hidden_size=1024, num_layers=1, num_heads=8, num_kv_heads=4, head_dim=128,
        intermediate_size=1024, dtype="float32",
    )
    tiny = build_tiny_cfg()
    return jcfg.TTSModelConfig(
        name="kernel-width-test",
        talker=jcfg.TalkerConfig(transformer=t, text_embed_dim=64, decode_impl="fused"),
        code_predictor=jcfg.CodePredictorConfig(
            transformer=dataclasses.replace(t, intermediate_size=3072),
            num_steps=3, subcode_vocab_size=256, max_seq_len=5, impl="fused", resident=True,
        ),
        vocoder=tiny.vocoder,
        speaker_encoder=None,
    )


def test_kernel_width_generate_matches_jax():
    """Greedy frames over 2 decode chunks equal the JAX loop's exactly: its
    talker step and MTP chain are the Pallas kernels (interpret mode), the
    port's are K1 and K2's plain versions."""
    from leaxer_qwen3_tts_tpu.models.code_predictor import prepare_fused_step as j_prep_cp
    from leaxer_qwen3_tts_tpu.models.talker import prepare_fused_talker as j_prep_talker
    from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
    from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns as j_make
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init

    cfg = _kernel_width_cfg()
    raw = j_init(cfg, jax.random.PRNGKey(0))
    jp = j_quant(j_fuse(raw))
    jp["code_predictor"] = j_prep_cp(cfg.code_predictor, jp["code_predictor"])
    jp["talker"] = j_prep_talker(cfg.talker, jp["talker"])
    assert "fused_step" in jp["talker"] and "fused_step" in jp["code_predictor"]

    ids = np.array([[5, 6, 7, 8]], np.int32)
    lens = np.array([4], np.int32)
    jfns = j_make(cfg, batch=1, max_len=64, chunk_len=2, donate=False)
    st, bd = jfns.prefill(jp, jnp.asarray(ids), jnp.asarray(lens), jax.random.PRNGKey(1))
    jframes = []
    for _ in range(2):
        st, fr, vd = jfns.decode(jp, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed,
                                 JSP.create(temperature=0.0))
        jframes.append(np.asarray(fr))

    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = quantize_params(fuse_params(params_from_jax(flatten_params(jax.device_get(raw)))))
    tp["code_predictor"] = prepare_fused_step(tc.code_predictor, tp["code_predictor"])
    tp["talker"] = prepare_fused_talker(tc.talker, tp["talker"])
    tfns = make_generate_fns(tc, batch=1, max_len=64, chunk_len=2)
    state, bundle = tfns.prefill(tp, torch.from_numpy(ids).long(), torch.from_numpy(lens))
    tframes = []
    for _ in range(2):
        state, fr, vd = tfns.decode(tp, state, bundle.trailing, bundle.trailing_len,
                                    bundle.tts_pad_embed, SamplingParams.create(0.0))
        tframes.append(fr.numpy())
    np.testing.assert_array_equal(np.concatenate(tframes, 1), np.concatenate(jframes, 1))


def test_engine_synthesize_tiny(tiny_model, tiny_vocab_files):
    """synthesize on the tiny model: finite audio of frames x 2000 samples,
    identical for the same seed, the cache grown across a ladder rung, and
    the streamed chunks equal to the final audio."""
    cfg, params = _port(tiny_model)
    vocab_path, merges_path, _ = tiny_vocab_files
    eng = TTSEngine(
        config=cfg, params=params, tokenizer=Tokenizer(vocab_path, merges_path),
        max_frames=24, chunk_len=4, first_chunk_len=2, kv_buckets=(24,), device="cpu",
    )
    assert eng.kv_ladder == (24, 56)
    runs = [eng.synthesize("hello world", temperature=0.8, seed=3, max_tokens=20)
            for _ in range(2)]
    r = runs[0]
    assert r.audio.dtype == np.float32 and np.isfinite(r.audio).all()
    assert r.audio.shape == (r.codes.shape[0] * 2000,)
    assert r.codes.shape[1] == 16 and 0 < r.codes.shape[0] <= 20
    np.testing.assert_array_equal(runs[1].audio, r.audio)
    np.testing.assert_array_equal(runs[1].codes, r.codes)
    assert r.metrics.ttfa_seconds is not None and r.metrics.frames == r.codes.shape[0]
    chunks = list(eng.synthesize_stream("hello world", temperature=0.8, seed=3, max_tokens=20))
    assert chunks[-1].codes.tolist() == r.codes.tolist()
    streamed = np.concatenate(chunks[:-1])
    np.testing.assert_array_equal(streamed[: r.audio.shape[0]], r.audio)
    g = eng.synthesize_tokens([5, 6, 7], temperature=0.0, max_tokens=6, language="en")
    assert g.codes.shape[0] <= 6 and np.isfinite(g.audio).all()
    # growing the cache across a rung changes nothing: same greedy codes as
    # one bucket big enough from the start
    grown = eng.synthesize("hello world", temperature=0.0, max_tokens=20)
    flat = TTSEngine(
        config=cfg, params=params, tokenizer=eng.tokenizer, max_frames=24, chunk_len=4,
        first_chunk_len=2, kv_buckets=(), device="cpu",
    )
    assert flat.kv_ladder == (56,)
    np.testing.assert_array_equal(
        flat.synthesize("hello world", temperature=0.0, max_tokens=20).codes, grown.codes
    )
    # construction records its error (the JAX engine's contract) and every
    # synthesis call then raises it
    bad = TTSEngine(config=cfg, params=params, quantize="int8", frame_fused=True, spec_k=4,
                    device="cpu")
    assert not bad.is_ready() and "sequential-only" in bad.get_error()
    with pytest.raises(EngineError, match="engine not ready: .*sequential-only"):
        bad.synthesize("hello world", temperature=0.0)
    # on a CUDA device a config that JAX's fused step takes and the step
    # kernels do not (head_dim 64) is refused by name (checked before
    # anything touches the device); one that JAX's unit gate refuses (this
    # tiny one) decodes on the plain layers there, as in JAX, and passes
    kw = _kernel_width_cfg()
    narrow = dataclasses.replace(kw, talker=dataclasses.replace(kw.talker, transformer=(
        dataclasses.replace(kw.talker.transformer, num_heads=16, num_kv_heads=8, head_dim=64))))
    bad = TTSEngine(config=tcfg.TTSModelConfig.from_json(narrow.to_json()), params={},
                    quantize="int8", device="cuda")
    assert not bad.is_ready() and "ROADMAP item K1a" in bad.get_error()
    plain = TTSEngine(config=cfg, params=params, quantize="int8", device="cuda")
    assert "CUDA kernel path" not in plain.get_error()


def test_engine_without_device_needs_cuda(tiny_model):
    """With no device the engine runs on the card: where there is none it is
    not ready, and synthesis raises, instead of running on the CPU
    (device="cpu" asks for that)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine would run there")
    cfg, params = _port(tiny_model)
    eng = TTSEngine(config=cfg, params=params)
    assert not eng.is_ready() and "device='cpu'" in eng.get_error()
    with pytest.raises(EngineError, match="engine not ready: .*device='cpu'"):
        eng.synthesize("hello world")


def test_port_imports_no_jax():
    """Every module of the port, the serving layer, the entry points (the
    CLI, the server's main) and the report tools included, imports with
    neither JAX nor the JAX package (nor the root tools, which import it)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import leaxer_qwen3_tts_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k in ('jax', 'tools')\n"
        "       or k.startswith(('jax.', 'leaxer_qwen3_tts_tpu', 'tools.'))]\n"
        "assert not bad, bad\n"
        "print(' '.join(k for k in sys.modules if k.startswith('leaxer_qwen3_tts_torch')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    modules = set(out.stdout.split())
    assert len(modules) >= 20
    assert {"leaxer_qwen3_tts_torch.serve.pool", "leaxer_qwen3_tts_torch.serve.server",
            "leaxer_qwen3_tts_torch.runtime.speculative", "leaxer_qwen3_tts_torch.ops.fused_verify",
            "leaxer_qwen3_tts_torch.models.draft", "leaxer_qwen3_tts_torch.ops.fused_mtp_stream",
            "leaxer_qwen3_tts_torch.ops.flash_attention", "leaxer_qwen3_tts_torch.ops.fused_frame",
            "leaxer_qwen3_tts_torch.tools.a8_probe", "leaxer_qwen3_tts_torch.tools.w8a8_probe",
            "leaxer_qwen3_tts_torch.cli.main", "leaxer_qwen3_tts_torch.cli.__main__",
            "leaxer_qwen3_tts_torch.serve.__main__", "leaxer_qwen3_tts_torch.models.speaker_encoder",
            "leaxer_qwen3_tts_torch.frontend.mel", "leaxer_qwen3_tts_torch.utils.profiling",
            "leaxer_qwen3_tts_torch.utils.logging", "leaxer_qwen3_tts_torch.runtime.weights",
            "leaxer_qwen3_tts_torch.parallel.mesh", "leaxer_qwen3_tts_torch.ops.fused_tp",
            "leaxer_qwen3_tts_torch.ops.fused_mtp_tp", "leaxer_qwen3_tts_torch.training",
            "leaxer_qwen3_tts_torch.training.loss", "leaxer_qwen3_tts_torch.training.train_step",
            "leaxer_qwen3_tts_torch.training.draft_loss",
            "leaxer_qwen3_tts_torch.training.checkpoint",
            "leaxer_qwen3_tts_torch.tools.train_draft",
            "leaxer_qwen3_tts_torch.tools.parity_check",
            "leaxer_qwen3_tts_torch.tools.make_parity_fixtures",
            "leaxer_qwen3_tts_torch.tools.quality_report",
            "leaxer_qwen3_tts_torch.tools.spec_report"} <= modules
    # no kernel ran on the CPU
    assert fused_step.fused_decode_step.launches == 0
    assert fused_mtp.fused_mtp_chain.launches == 0
    assert fused_step.fused_decode_step_batched.launches == 0
    assert fused_mtp.fused_mtp_chain_batched.launches == 0
    assert fused_verify.fused_verify_step.launches == 0
    assert fused_mtp_stream.fused_mtp_chain_streamed.launches == 0
    assert flash_attention.flash_attend.launches == 0
    assert fused_frame.fused_frame_step.launches == 0
    assert a8_probe.chain.launches == w8a8_probe.chain.launches == 0
