"""Kernel K5 (PyTorch port): the plain version of ``fused_mtp_chain_batched``
against the JAX Pallas kernel in interpret mode, with mixed per-row knobs
and the same Gumbel noise on both sides; row b against the port's B=1 chain
on row b's noise; and the per-row sampler against the JAX package's."""

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
from leaxer_qwen3_tts_tpu.ops.fused_mtp import fused_mtp_chain_batched as j_chain_b
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

N, V, H = 4, 256, 1024
# per-row (temperature, top_k, top_p): greedy; the engine defaults; no masks; top_k = 1
ROWS = [(0.0, 50, 0.9), (0.8, 50, 0.95), (1.0, 0, 1.0), (0.7, 1, 0.9)]


@pytest.fixture(scope="module")
def chain_models():
    t = TransformerConfig(
        hidden_size=H, num_layers=2, num_heads=8, num_kv_heads=4,
        head_dim=128, intermediate_size=3072, dtype="float32",
    )
    cfg = CodePredictorConfig(
        transformer=t, num_steps=N, subcode_vocab_size=V, max_seq_len=N + 2, impl="fused",
    )
    raw = init_code_predictor_params(cfg, jax.random.PRNGKey(0))
    jq = prepare_fused_step(cfg, quantize_params(fuse_params({"code_predictor": raw}))[
        "code_predictor"
    ])
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = tcfg.TransformerConfig(**fields["transformer"])
    tc = tcfg.CodePredictorConfig(**fields)
    traw = params_from_jax(flatten_params({"code_predictor": jax.device_get(raw)}))
    tq = tcp.prepare_fused_step(
        tc, tquant.quantize_params(tquant.fuse_params(traw))["code_predictor"]
    )
    rng = np.random.default_rng(0)
    tables = (rng.standard_normal((N, V, H)) * 0.02).astype(np.float32)
    return cfg, jq, tc, tq, tables


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0e = (rng.standard_normal((B, H)) * 0.02).astype(np.float32)
    gumbel = rng.gumbel(size=(N, B, V)).astype(np.float32)
    return hidden, c0e, gumbel


def _torch_chain(tc, tq, tables, hidden, c0e, gumbel, knobs):
    temps, ks, ps = zip(*knobs)
    return tfm.fused_mtp_chain_batched(
        tc.transformer, tq["fused_step"], tq["transformer"]["final_norm"], tq["fused_heads"],
        torch.from_numpy(tables), torch.from_numpy(hidden), torch.from_numpy(c0e),
        torch.from_numpy(gumbel), temps, ks, ps,
    )


def test_fused_mtp_chain_batched_matches_jax(chain_models):
    """Sub-codes exact, sub_sum within 1e-3 (sums of identical table rows),
    with each row sampling by its own knobs from the same noise."""
    cfg, jq, tc, tq, tables = chain_models
    knobs = ROWS + ROWS[1:2]  # B = 5
    hidden, c0e, gumbel = _inputs(len(knobs), 7)
    temps, ks, ps = (np.asarray(v) for v in zip(*knobs))
    j_subs, j_sum = j_chain_b(
        cfg.transformer, jq["fused_step"], jq["transformer"]["final_norm"], jq["heads"],
        jnp.asarray(tables), jnp.asarray(hidden), jnp.asarray(c0e), jnp.asarray(gumbel),
        jnp.asarray(temps, jnp.float32), jnp.asarray(ks, jnp.int32),
        jnp.asarray(ps, jnp.float32), interpret=True,
    )
    t_subs, t_sum = _torch_chain(tc, tq, tables, hidden, c0e, gumbel, knobs)
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), atol=1e-3, rtol=1e-3)


def test_rows_match_single_stream_chain(chain_models):
    """Row b of the batched chain is the B=1 chain on row b's inputs, knobs
    and noise, bit for bit."""
    _, _, tc, tq, tables = chain_models
    hidden, c0e, gumbel = _inputs(len(ROWS), 11)
    subs, ssum = _torch_chain(tc, tq, tables, hidden, c0e, gumbel, ROWS)
    for b, (t, k, p) in enumerate(ROWS):
        s1, sum1 = tfm.fused_mtp_chain(
            tc.transformer, tq["fused_step"], tq["transformer"]["final_norm"], tq["fused_heads"],
            torch.from_numpy(tables), torch.from_numpy(hidden[b : b + 1]),
            torch.from_numpy(c0e[b : b + 1]), torch.from_numpy(gumbel[:, b : b + 1]), t, k, p,
        )
        assert torch.equal(s1[0], subs[b]) and torch.equal(sum1[0], ssum[b])


def test_chain_route_batched(chain_models, monkeypatch):
    """predict_subcodes takes the batched chain at B >= 2 with a pack, and
    hands it the noise ``noise_fn`` draws ([n, B, V])."""
    _, _, tc, tq, tables = chain_models
    calls = []
    real = tcp.fused_mtp_chain_batched
    monkeypatch.setattr(
        tcp, "fused_mtp_chain_batched", lambda *a, **k: (calls.append(a[7].shape), real(*a, **k))[1]
    )
    sp = tsampling.SamplingParams.create((0.0, 0.8, 0.9), 50, 0.95)
    h = torch.randn(3, H, generator=torch.Generator().manual_seed(0)) * 0.5
    noise = tsampling.NoiseSource([torch.Generator().manual_seed(s) for s in range(3)], "cpu")
    subs, _ = tcp.predict_subcodes(
        tc, tq, torch.from_numpy(tables), h, h * 0.04, lambda lg, j: lg.argmax(-1), sp=sp,
        noise_fn=lambda: noise.draw_chain(N, V, [False, True, True]),
    )
    assert calls == [(N, 3, V)] and subs.shape == (3, N)


@pytest.mark.parametrize("top_ks", [(50, 50, 20), (50, 300, 0)])
def test_sample_token_per_row_knobs_matches_jax(top_ks):
    """Per-row knobs ([B] vectors in JAX): a greedy row, and sampled rows on
    the top-K_CAP subset path, or (with top_k past K_CAP or off) the
    full-vocab path, each fed the noise jax.random.categorical draws."""
    temps, top_ps = (0.0, 0.8, 1.2), (0.9, 0.95, 0.7)
    sp_j = jsampling.SamplingParams.create(jnp.asarray(temps), jnp.asarray(top_ks),
                                           jnp.asarray(top_ps))
    sp_t = tsampling.SamplingParams.create(temps, top_ks, top_ps)
    subset = all(0 < k <= tsampling.K_CAP for k in top_ks)
    for seed in range(3):
        rng = np.random.default_rng(200 + seed)
        logits = (rng.standard_normal((3, 3072)) * 2.5).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsampling.sample_token(key, jnp.asarray(logits), sp_j))
        width = tsampling.K_CAP if subset else 3072
        noise = np.array(jax.random.gumbel(key, (3, width), jnp.float32))
        got = tsampling.sample_token(torch.from_numpy(logits), sp_t, torch.from_numpy(noise))
        assert got.tolist() == want.tolist(), (seed, top_ks)


def test_noise_source_rows_are_their_own_streams():
    """Per-row generators: row b's draws equal a B=1 draw from the same seed,
    whatever the other rows are (the occupancy invariance of the pool)."""
    def source(seeds):
        return tsampling.NoiseSource([torch.Generator().manual_seed(s) for s in seeds], "cpu")

    a = source([3, 4, 5]).draw([128, 0, 3072])
    b = source([9, 4, 3]).draw([64, 0, 128])
    solo = tsampling.gumbel_noise((1, 128), torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a[0, :128], solo[0]) and torch.equal(b[2, :128], solo[0])
    chain = source([7, 8]).draw_chain(N, V, [True, False])
    solo = tsampling.gumbel_noise((N, 1, V), torch.Generator().manual_seed(7), "cpu")
    assert chain.shape == (N, 2, V) and torch.equal(chain[:, 0], solo[:, 0])
    assert source([1, 2]).draw([0, 0]) is None
