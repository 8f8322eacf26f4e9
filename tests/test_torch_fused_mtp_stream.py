"""Kernel K3 (PyTorch port): the plain version of the streamed-trunk chain
against the JAX package's ``fused_mtp_chain_streamed`` in interpret mode on
the same int8 weights and Gumbel noise, and the B=1 route between K2 and K3
by the JAX package's residency and stream gates."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.models.code_predictor import init_code_predictor_params, prepare_fused_step
from leaxer_qwen3_tts_tpu.ops import fused_mtp as j_fm
from leaxer_qwen3_tts_tpu.ops import fused_mtp_stream as j_stream
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params, quantize_params
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.ops import fused_mtp as tfm
from leaxer_qwen3_tts_torch.ops import fused_mtp_stream as tstream
from leaxer_qwen3_tts_torch.ops import quant as tquant
from leaxer_qwen3_tts_torch.ops.fused_step import meta_pack
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

SUM_ABS = 1e-5  # sub_sum: sums of the same table rows in the same order


def _models(dtype):
    """The shapes of the JAX package's streamed-chain test (two H=1024
    layers, 3 steps, V=256), int8 trunk and heads, in ``dtype``."""
    t = jcfg.TransformerConfig(
        hidden_size=1024, num_layers=2, num_heads=8, num_kv_heads=4, head_dim=128,
        intermediate_size=3072, dtype=dtype,
    )
    cfg = jcfg.CodePredictorConfig(transformer=t, num_steps=3, subcode_vocab_size=256,
                                   max_seq_len=5, impl="fused")
    raw = init_code_predictor_params(cfg, jax.random.PRNGKey(0))
    jq = prepare_fused_step(cfg, quantize_params(fuse_params({"code_predictor": raw}))[
        "code_predictor"])
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = tcfg.TransformerConfig(**fields["transformer"])
    tc = tcfg.CodePredictorConfig(**fields)
    traw = params_from_jax(flatten_params({"code_predictor": jax.device_get(raw)}))
    tq = tcp.prepare_fused_step(tc, tquant.quantize_params(tquant.fuse_params(traw))[
        "code_predictor"])
    rng = np.random.default_rng(0)
    tables = (rng.standard_normal((3, 256, 1024)) * 0.02).astype(np.float32)
    return cfg, jq, tc, tq, tables


@pytest.fixture(scope="module")
def models_f32():
    return _models("float32")


@pytest.fixture(scope="module")
def models_bf16():
    return _models("bfloat16")


def _chains(models, knobs, dtype, seed):
    cfg, jq, tc, tq, tables = models
    temp, top_k, top_p = knobs
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((1, 1024)) * 0.5).astype(np.float32)
    c0e = (rng.standard_normal((1, 1024)) * 0.02).astype(np.float32)
    gumbel = rng.gumbel(size=(3, 1, 256)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    j_subs, j_sum = j_stream.fused_mtp_chain_streamed(
        cfg.transformer, jq["fused_step"], jq["transformer"]["final_norm"], jq["heads"],
        jnp.asarray(tables, jd), jnp.asarray(hidden, jd), jnp.asarray(c0e, jd),
        jnp.asarray(gumbel), jnp.float32(temp), jnp.int32(top_k), jnp.float32(top_p),
        interpret=True,
    )
    args = (tc.transformer, tq["fused_step"], tq["transformer"]["final_norm"], tq["fused_heads"],
            torch.from_numpy(tables).to(td), torch.from_numpy(hidden).to(td),
            torch.from_numpy(c0e).to(td), torch.from_numpy(gumbel), temp, top_k, top_p)
    t_subs, t_sum = tstream.fused_mtp_chain_streamed(*args)
    return (np.asarray(j_subs), np.asarray(j_sum)), (t_subs, t_sum), args


@pytest.mark.parametrize("knobs", [(0.0, 50, 0.9), (0.8, 50, 0.9), (1.0, 0, 0.5)])
def test_streamed_chain_matches_jax(models_f32, knobs):
    """Sub-codes equal and sub_sum within SUM_ABS, greedy and sampled on the
    same noise; the plain version equals K2's with a float32 cache."""
    (j_subs, j_sum), (t_subs, t_sum), args = _chains(models_f32, knobs, "f32", 7)
    assert t_subs.tolist() == j_subs.tolist()
    np.testing.assert_allclose(t_sum.numpy(), j_sum, atol=SUM_ABS, rtol=0)
    k2_subs, k2_sum = tfm.fused_mtp_chain(*args, cache_dtype=torch.float32)
    assert torch.equal(k2_subs, t_subs) and torch.equal(k2_sum, t_sum)


@pytest.mark.parametrize("knobs", [(0.0, 50, 0.9), (0.8, 50, 0.95)])
def test_streamed_chain_bf16_model_matches_jax(models_bf16, knobs):
    """A bf16 model: the JAX kernel keeps its float32 KV scratch, and so
    does the port's K3 (it is K2 with a float32 cache, not at the bf16
    config dtype)."""
    (j_subs, j_sum), (t_subs, t_sum), args = _chains(models_bf16, knobs, "bf16", 8)
    assert t_subs.tolist() == j_subs.tolist()
    np.testing.assert_allclose(t_sum.numpy(), j_sum, atol=SUM_ABS, rtol=0)
    k2_subs, _ = tfm.fused_mtp_chain(*args, cache_dtype=torch.float32)
    assert torch.equal(k2_subs, t_subs)


def _jax_pack(t, bits=8):
    """The JAX pack's shapes as zero-stride numpy views (no allocation):
    int8 units (bits=8) or bf16 (bits=16)."""
    n_qkv, n_wo, n_gu, n_wd = (t.q_dim + 2 * t.kv_dim) // 1024, (t.q_dim // t.hidden_size) * (
        t.hidden_size // 1024), 2 * t.intermediate_size // 1024, (
        t.intermediate_size // t.hidden_size) * (t.hidden_size // 1024)
    U = n_qkv + n_wo + n_gu + n_wd
    L, H = t.num_layers, t.hidden_size

    def z(shape, dtype):
        return np.broadcast_to(np.zeros((), dtype), shape)

    return types.SimpleNamespace(
        units=z((L, U, H, 1024), np.int8 if bits == 8 else jnp.bfloat16),
        scales=z((L, U, 1, 1024), np.float32),
        attn_norm=z((L, 1, H), np.float32),
    )


@pytest.mark.parametrize("preset,bits,route", [
    ("QWEN3_TTS_06B", 8, "K2"), ("QWEN3_TTS_17B", 8, "K3"),
    ("QWEN3_TTS_06B", 16, "K3"), ("QWEN3_TTS_17B", 16, "K3"),
])
def test_b1_route_by_the_jax_gates(preset, bits, route):
    """The port's copies of the residency, stream and frame gates agree
    with the JAX package's on the preset's MTP trunk (int8, 0.6B: 78 MB,
    resident; 1.7B: 302 MB, streamed; bf16 units, the unquantized config:
    never resident, streamed at both presets, no whole frame), and route B=1
    to K2 or K3; B>1 stays on K5, and ``resident=False`` leaves the chains."""
    from leaxer_qwen3_tts_tpu.ops import fused_frame as j_ff
    from leaxer_qwen3_tts_torch.ops import fused_frame as t_ff

    cp = getattr(tcfg, preset).code_predictor
    jcp = getattr(jcfg, preset).code_predictor
    fw, jfw = meta_pack(cp.transformer, bits), _jax_pack(jcp.transformer, bits)
    n, V = cp.num_steps, cp.subcode_vocab_size
    assert tfm.trunk_bytes(fw) == jfw.units.nbytes
    assert tfm.supports_resident(fw) == j_fm.supports_resident(jfw) == (route == "K2")
    assert tstream.supports_stream(fw, V) == j_stream.supports_stream(jfw, n, V) is True
    talker = getattr(tcfg, preset).talker.transformer
    jtalker = getattr(jcfg, preset).talker.transformer
    for T in (256, 2560):
        assert t_ff.supports_frame(fw, T, talker) == j_ff.supports_frame(jfw, T, jtalker)
    assert t_ff.supports_frame(fw, 256, talker) == (preset == "QWEN3_TTS_06B" and bits == 8)
    want = tfm.fused_mtp_chain if route == "K2" else tstream.fused_mtp_chain_streamed
    assert tcp.chain_kernel(cp, {"fused_step": fw}, 1) is want
    assert tcp.chain_kernel(cp, {"fused_step": fw}, 8) is tfm.fused_mtp_chain_batched
    off = dataclasses.replace(cp, resident=False)
    assert tcp.chain_kernel(off, {"fused_step": fw}, 1) is None


@pytest.mark.parametrize("env", ["1", "0"])
def test_stream_switch_routes_b1_like_jax(models_f32, env, monkeypatch):
    """QTTS_MTP_STREAM with the residency gate patched out (the 1.7B case,
    as the JAX package's own routing test simulates it): "1" runs the
    streamed chain in both packages (the JAX kernel in interpret mode, the
    port's K3 plain version); "0" runs the JAX package's per-step chain and
    the port's cached plain path (the per-step chain is not ported).  Greedy
    sub-codes are equal and sub_sum within SUM_ABS in both settings."""
    import leaxer_qwen3_tts_tpu.models.code_predictor as jcp
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP
    from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams

    cfg, jq, tc, tq, tables = models_f32
    cfg = dataclasses.replace(cfg, resident=True)
    monkeypatch.delenv("QTTS_MTP_RESIDENT", raising=False)
    monkeypatch.setenv("QTTS_MTP_STREAM", env)
    monkeypatch.setattr(jcp, "resident_pack", lambda params, batch: None)
    monkeypatch.setattr(tcp, "resident_pack", lambda params, batch: None)
    rng = np.random.default_rng(11)
    hidden = (rng.standard_normal((1, 1024)) * 0.5).astype(np.float32)
    c0e = (rng.standard_normal((1, 1024)) * 0.02).astype(np.float32)
    j_subs, j_sum = jcp.predict_subcodes(
        cfg, jq, jnp.asarray(tables), jnp.asarray(hidden), jnp.asarray(c0e),
        jax.random.PRNGKey(0), sample_fn=lambda key, logits: jnp.argmax(logits, -1),
        sp=JSP.create(temperature=0.0))
    want = tstream.fused_mtp_chain_streamed if env == "1" else None
    assert tcp.chain_kernel(tc, tq, 1) is want
    t_subs, t_sum = tcp.predict_subcodes(
        tc, tq, torch.from_numpy(tables), torch.from_numpy(hidden), torch.from_numpy(c0e),
        sample_fn=lambda logits, j: logits.argmax(-1), sp=SamplingParams.create(0.0))
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), atol=SUM_ABS, rtol=0)


def test_stream_switch_default_is_the_accelerators(monkeypatch):
    """Unset, the switch is on: the JAX package's default on its accelerator
    (its ``_stream_enabled`` with the backend read as "tpu"); set, both read
    it alike.  "0" with a trunk past the residency gate (the 1.7B preset)
    routes the B=1 chain to the per-step chain (one K1 step per chain
    position), as JAX's ``predict_subcodes`` does, on the card too: the
    engine passes its gate and stops only at the params."""
    import leaxer_qwen3_tts_tpu.models.code_predictor as jcp
    from leaxer_qwen3_tts_torch.api.engine import TTSEngine

    monkeypatch.delenv("QTTS_MTP_STREAM", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert tcp.stream_enabled() is jcp._stream_enabled() is True
    for env, on in (("0", False), ("1", True), ("2", True)):
        monkeypatch.setenv("QTTS_MTP_STREAM", env)
        assert tcp.stream_enabled() is jcp._stream_enabled() is on
    cp = tcfg.QWEN3_TTS_17B.code_predictor
    monkeypatch.setenv("QTTS_MTP_STREAM", "0")
    assert tcp.chain_kernel(cp, {"fused_step": meta_pack(cp.transformer)}, 1) is None
    assert tcp.chain_kernel(cp, {"fused_step": meta_pack(cp.transformer)}, 8) is (
        tfm.fused_mtp_chain_batched)
    assert tcp.chain_route(cp, {"fused_step": meta_pack(cp.transformer)}, 1) == "per_step"
    eng = TTSEngine(config=tcfg.QWEN3_TTS_17B, params={}, quantize="int8", device="cuda")
    assert not eng.is_ready() and "CUDA kernel path" not in eng.get_error()
    assert "code_predictor" in eng.get_error()
