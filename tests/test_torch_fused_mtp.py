"""Kernel K2 (PyTorch port) and the samplers: the port's plain versions
against the JAX package on the same seed-made logits, Gumbel noise and int8
weights.  Sampled draws compare index for index because both sides are fed
the same noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.config import CodePredictorConfig, TransformerConfig
from leaxer_qwen3_tts_tpu.models.code_predictor import (
    init_code_predictor_params,
    prepare_fused_step,
)
from leaxer_qwen3_tts_tpu.ops.fused_mtp import fused_mtp_chain as j_chain
from leaxer_qwen3_tts_tpu.ops.fused_mtp import gumbel_topk_topp_sample
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params, quantize_params
from leaxer_qwen3_tts_tpu.runtime import sampling as jsampling
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.ops import fused_mtp as tfm
from leaxer_qwen3_tts_torch.ops import quant as tquant
from leaxer_qwen3_tts_torch.runtime import sampling as tsampling
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

# one compile serves every knob setting (the knobs are traced arguments)
j_gumbel_sample = jax.jit(gumbel_topk_topp_sample)

KNOBS = [  # (temperature, top_k, top_p)
    (0.0, 50, 0.9),  # greedy
    (0.8, 50, 0.95),
    (1.0, 0, 0.5),  # top-k off
    (0.7, 300, 1.0),  # top-p off, top_k past the vocab
    (1.3, 1, 0.95),
    (0.9, 20, 0.3),
]


@pytest.mark.parametrize("knobs", KNOBS)
def test_gumbel_topk_topp_sample_matches_jax(knobs):
    temp, top_k, top_p = knobs
    for seed in range(6):
        rng = np.random.default_rng(seed)
        logits = (rng.standard_normal((1, 257)) * 3.0).astype(np.float32)
        gumbel = rng.gumbel(size=(1, 257)).astype(np.float32)
        want = j_gumbel_sample(
            jnp.asarray(logits), jnp.asarray(gumbel), jnp.float32(temp),
            jnp.int32(top_k), jnp.float32(top_p),
        )
        got = tfm.gumbel_topk_topp_sample(
            torch.from_numpy(logits), torch.from_numpy(gumbel), temp, top_k, top_p
        )
        assert got.tolist() == np.asarray(want).tolist(), (seed, knobs)


@pytest.mark.parametrize("knobs", [(0.0, 50, 0.95), (0.8, 50, 0.95), (1.1, 0, 0.9),
                                   (0.7, 200, 0.8)])
def test_sample_token_matches_jax(knobs):
    """Greedy, the K_CAP subset path (top_k <= 128) and the full-vocab path.
    The port gets the noise ``jax.random.categorical`` draws: Gumbel over the
    subset's [B, K_CAP] (or the vocab's [B, V]) from the same key."""
    temp, top_k, top_p = knobs
    sp_j = jsampling.SamplingParams.create(temp, top_k, top_p)
    sp_t = tsampling.SamplingParams.create(temp, top_k, top_p)
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        logits = (rng.standard_normal((2, 3072)) * 2.5).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsampling.sample_token(key, jnp.asarray(logits), sp_j))
        width = tsampling.noise_width(3072, sp_t)
        noise = np.array(jax.random.gumbel(key, (2, width), jnp.float32))
        got = tsampling.sample_token(
            torch.from_numpy(logits), sp_t, None if sp_t.greedy else torch.from_numpy(noise)
        )
        assert got.tolist() == want.tolist(), (seed, knobs)


def test_codec_suppress_mask_matches_jax():
    np.testing.assert_array_equal(
        tsampling.make_codec_suppress_mask(3072).numpy(),
        np.asarray(jsampling.make_codec_suppress_mask(3072)),
    )


@pytest.fixture(scope="module")
def chain_models():
    t = TransformerConfig(
        hidden_size=1024, num_layers=2, num_heads=8, num_kv_heads=4,
        head_dim=128, intermediate_size=3072, dtype="float32",
    )
    cfg = CodePredictorConfig(
        transformer=t, num_steps=4, subcode_vocab_size=256, max_seq_len=6, impl="fused",
    )
    raw = init_code_predictor_params(cfg, jax.random.PRNGKey(0))
    jq = prepare_fused_step(cfg, quantize_params(fuse_params({"code_predictor": raw}))[
        "code_predictor"
    ])
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = tcfg.TransformerConfig(**fields["transformer"])
    tcfg_cp = tcfg.CodePredictorConfig(**fields)
    traw = params_from_jax(flatten_params({"code_predictor": jax.device_get(raw)}))
    tq = tcp.prepare_fused_step(
        tcfg_cp, tquant.quantize_params(tquant.fuse_params(traw))["code_predictor"]
    )
    rng = np.random.default_rng(0)
    tables = (rng.standard_normal((4, 256, 1024)) * 0.02).astype(np.float32)
    return cfg, jq, tcfg_cp, tq, tables


@pytest.mark.parametrize("knobs", [(0.0, 50, 0.9), (0.8, 50, 0.9)])
def test_fused_mtp_chain_matches_jax(chain_models, knobs):
    """The plain chain vs the JAX chain kernel in interpret mode, same noise:
    sub-codes exact, sub_sum within 1e-3 (sums of identical table rows)."""
    cfg, jq, tc, tq, tables = chain_models
    temp, top_k, top_p = knobs
    rng = np.random.default_rng(7)
    hidden = (rng.standard_normal((1, 1024)) * 0.5).astype(np.float32)
    c0e = (rng.standard_normal((1, 1024)) * 0.02).astype(np.float32)
    gumbel = rng.gumbel(size=(4, 1, 256)).astype(np.float32)
    j_subs, j_sum = j_chain(
        cfg.transformer, jq["fused_step"], jq["transformer"]["final_norm"], jq["heads"],
        jnp.asarray(tables), jnp.asarray(hidden), jnp.asarray(c0e), jnp.asarray(gumbel),
        jnp.float32(temp), jnp.int32(top_k), jnp.float32(top_p), interpret=True,
    )
    t_subs, t_sum = tfm.fused_mtp_chain(
        tc.transformer, tq["fused_step"], tq["transformer"]["final_norm"], tq["fused_heads"],
        torch.from_numpy(tables), torch.from_numpy(hidden), torch.from_numpy(c0e),
        torch.from_numpy(gumbel), temp, top_k, top_p,
    )
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), atol=1e-3, rtol=1e-3)


def test_chain_route_and_heads_pack(chain_models, monkeypatch):
    """predict_subcodes routes B=1 with a pack to the chain; the head pack
    dequantizes to the quantized heads exactly."""
    _, _, tc, tq, tables = chain_models
    hp = tq["fused_heads"]
    deq = hp.q.float() * hp.scale[:, :, None]  # [n, V, H]
    ref = (tq["heads"].q.float() * tq["heads"].scale).transpose(1, 2)
    assert torch.equal(deq, ref)
    calls = []
    real = tcp.fused_mtp_chain
    monkeypatch.setattr(
        tcp, "fused_mtp_chain", lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    )
    sp = tsampling.SamplingParams.create(0.0)
    h = torch.randn(1, 1024, generator=torch.Generator().manual_seed(0)) * 0.5
    subs, _ = tcp.predict_subcodes(
        tc, tq, torch.from_numpy(tables), h, h * 0.04, lambda lg, j: lg.argmax(-1), sp=sp,
    )
    assert calls and subs.shape == (1, 4)
