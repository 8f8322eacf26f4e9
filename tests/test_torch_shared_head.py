"""M6, the shared-head topology of the code predictor (PyTorch port): one
2048-way head for every step and a learned step embedding added to the
trunk's input (JAX ``init_code_predictor_params``' shared branch,
``_head_fn``, ``_step_cond``).  Against the JAX package on the same raw
weights: the parameters' keys, shapes and dtypes, the cached chain (greedy),
the engine (greedy codes and audio), ``prepare_fused_step``'s pack (the
trunk only, no heads pack), int4 quantization keeping the head int8, and a
checkpoint round trip between the two packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest_util import build_tiny_cfg
from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.models import code_predictor as jcp
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init
from leaxer_qwen3_tts_tpu.runtime.weights import load_checkpoint as j_load
from leaxer_qwen3_tts_tpu.runtime.weights import save_checkpoint as j_save
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.ops.quant import QuantizedLinear, QuantizedLinear4, quantize_params
from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams
from leaxer_qwen3_tts_torch.runtime.weights import (
    _leaves,
    init_params,
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
)
from test_torch_slice import _kernel_width_cfg

torch.set_num_threads(2)

ATOL = 2e-4  # the regression fixture's audio tolerance (test_regression.py)


def _shared(cfg):
    return dataclasses.replace(cfg, code_predictor=dataclasses.replace(
        cfg.code_predictor, head_mode="shared"))


@pytest.fixture(scope="module")
def shared():
    cfg = _shared(build_tiny_cfg())
    raw = j_init(cfg, jax.random.PRNGKey(9), with_speaker_encoder=False)
    return cfg, raw, tcfg.TTSModelConfig.from_json(cfg.to_json()), params_from_jax(
        flatten_params(jax.device_get(raw)))


def test_init_matches_jax_shapes(shared):
    """The port's random init has JAX's members, shapes and dtypes (bf16 in
    a bf16 trunk; the step embedding's std 0.02)."""
    cfg, raw, tc, _ = shared
    want = {k: (v.shape, str(v.dtype)) for k, v in flatten_params(
        jax.device_get(raw["code_predictor"])).items()}
    got = init_params(tc, seed=0, with_speaker_encoder=False)["code_predictor"]
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _leaves(got)}
    assert got == want and "head" in got and "step_embed" in got and "heads" not in got
    cp = dataclasses.replace(tc.code_predictor, transformer=dataclasses.replace(
        tc.code_predictor.transformer, dtype="bfloat16"))
    p = tcp.init_code_predictor_params(cp, torch.Generator().manual_seed(0), "cpu")
    assert p["head"].dtype == p["step_embed"].dtype == torch.bfloat16
    assert 0.015 < float(p["step_embed"].float().std()) < 0.025  # JAX's 0.02


def test_cached_chain_matches_jax(shared):
    """The cached chain with the shared head (step j's embedding conditioned
    by step embedding j + 1, the code0 token by step embedding 0): greedy
    codes exact, the sum within 1e-5."""
    cfg, raw, tc, tp = shared
    cp = cfg.code_predictor
    H = cp.transformer.hidden_size
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, H)).astype(np.float32)
    c0e = (0.1 * rng.standard_normal((2, H))).astype(np.float32)
    j_subs, j_sum = jcp.predict_subcodes(
        cp, raw["code_predictor"], raw["embeddings"]["pred_embed"], jnp.asarray(hidden),
        jnp.asarray(c0e), jax.random.PRNGKey(0), lambda k, lg: jnp.argmax(lg, -1))
    assert tcp.chain_route(tc.code_predictor, tp["code_predictor"], 2) == "cached"
    t_subs, t_sum = tcp.predict_subcodes(
        tc.code_predictor, tp["code_predictor"], tp["embeddings"]["pred_embed"],
        torch.from_numpy(hidden), torch.from_numpy(c0e), lambda lg, j: lg.argmax(-1),
        sp=SamplingParams.create(0.0))
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), atol=1e-5, rtol=1e-5)


def test_engine_matches_jax(shared, tiny_vocab_files):
    """A shared-head engine: greedy codes equal the JAX engine's, the audio
    within the fixture's tolerance."""
    cfg, raw, tc, tp = shared
    vocab_path, merges_path, _ = tiny_vocab_files
    jeng = JEngine(config=cfg, params=raw, tokenizer=JTokenizer(vocab_path, merges_path),
                   max_frames=8, chunk_len=4)
    teng = TTSEngine(config=tc, params=tp, tokenizer=Tokenizer(vocab_path, merges_path),
                     max_frames=8, chunk_len=4, device="cpu")
    want = jeng.synthesize("hello world", temperature=0.0, max_tokens=8)
    got = teng.synthesize("hello world", temperature=0.0, max_tokens=8)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_allclose(got.audio, want.audio, atol=ATOL)


def test_pack_and_int4_quantization():
    """``prepare_fused_step`` packs a shared-head trunk (JAX packs it too;
    its chain is the per-step one) and no heads pack; ``quantize_params``
    at int4 keeps the head int8, as JAX's ``_INT8_ONLY_KEYS`` has it."""
    kc = _shared(_kernel_width_cfg())
    tc = tcfg.TTSModelConfig.from_json(kc.to_json())
    p = init_params(tc, seed=0)
    cp = tcp.prepare_fused_step(tc.code_predictor, p["code_predictor"])
    assert "fused_step" in cp and "fused_heads" not in tcp.attach_heads(tc.code_predictor, cp)
    assert tcp.chain_route(tc.code_predictor, cp, 1) == "per_step"
    q4 = quantize_params(p, bits=4)["code_predictor"]
    assert isinstance(q4["head"], QuantizedLinear) and not isinstance(q4["head"], QuantizedLinear4)
    assert isinstance(q4["transformer"]["layers"]["wq"], QuantizedLinear4)
    assert torch.is_tensor(q4["step_embed"])


def test_checkpoint_round_trip(shared, tmp_path):
    """``save_checkpoint`` writes ``head`` and ``step_embed`` member for
    member with the JAX writer; each package loads the other's."""
    cfg, raw, tc, tp = shared
    j_save(str(tmp_path / "jax"), cfg, raw)
    save_checkpoint(str(tmp_path / "port"), tc, tp)
    with np.load(tmp_path / "jax" / "params.npz") as a, np.load(
            tmp_path / "port" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in ("code_predictor/head", "code_predictor/step_embed"):
            np.testing.assert_array_equal(a[k], b[k])
    c2, p2 = load_checkpoint(str(tmp_path / "jax"))
    assert c2.code_predictor.head_mode == "shared"
    assert torch.equal(p2["code_predictor"]["step_embed"], tp["code_predictor"]["step_embed"])
    jc2, jp2 = j_load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(jp2["code_predictor"]["head"]),
                                  tp["code_predictor"]["head"].numpy())
