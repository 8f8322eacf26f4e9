"""The per-step MTP chain (PyTorch port) against the JAX package's
``predict_subcodes_fused`` (B=1, one fused step kernel per chain position)
and ``predict_subcodes_fused_batched`` (2-32 rows), their Pallas kernels in
interpret mode, at the kernel-width config (H=1024, one layer, int8 packs):
the same raw weights, last hidden and code0 embeddings from a seeded numpy
generator, and for sampled knobs the same Gumbel noise (the JAX draws of
each step's key, handed to the port's sampler).  Per-step and shared heads.
Codes exact; the sub-embedding sum within 1e-5 (both sum the same float32
table rows in the same grouping)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.models import code_predictor as jcp
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
from leaxer_qwen3_tts_tpu.runtime import sampling as jsamp
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params
from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams, noise_width, sample_token
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from test_torch_slice import _kernel_width_cfg

torch.set_num_threads(2)

SUM_TOL = dict(atol=1e-5, rtol=1e-5)
# (temperature, top_k, top_p): greedy, the top-128 subset path, the full-vocab path
KNOBS = {"greedy": (0.0, 50, 1.0), "subset": (0.9, 40, 0.9), "full": (1.1, 0, 0.8)}


def _cfg(head_mode):
    cfg = _kernel_width_cfg()
    return dataclasses.replace(cfg, code_predictor=dataclasses.replace(
        cfg.code_predictor, head_mode=head_mode, resident=False))


_MODELS = {}


def _models(head_mode):
    """(JAX cfg, JAX MTP params, port cfg, port MTP params, tables): int8,
    the trunk packed on both sides."""
    if head_mode not in _MODELS:
        cfg = _cfg(head_mode)
        raw = j_init(cfg, jax.random.PRNGKey(3))
        jp = j_quant(j_fuse(raw))
        jcpp = jcp.prepare_fused_step(cfg.code_predictor, jp["code_predictor"])
        tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
        tp = quantize_params(fuse_params(params_from_jax(flatten_params(jax.device_get(raw)))))
        tcpp = tcp.prepare_fused_step(tc.code_predictor, tp["code_predictor"])
        assert "fused_step" in jcpp and "fused_step" in tcpp
        assert ("fused_heads" in tcpp) == (head_mode == "per_step")
        _MODELS[head_mode] = (cfg, jcpp, jp["embeddings"]["pred_embed"], tc, tcpp,
                              tp["embeddings"]["pred_embed"])
    return _MODELS[head_mode]


def _step_keys(key, n):
    """The per-step sampling keys the JAX chain splits off ``key``."""
    subs = []
    for _ in range(n):
        key, sub = jsamp.split_keys(key, 2)
        subs.append(sub)
    return subs


@pytest.mark.parametrize("head_mode", ["per_step", "shared"])
@pytest.mark.parametrize("B,knobs", [(1, "greedy"), (1, "subset"), (4, "greedy"), (4, "full")])
def test_per_step_chain_matches_jax(head_mode, B, knobs):
    cfg, jcpp, jtables, tc, tcpp, ttables = _models(head_mode)
    cp, tcp_cfg = cfg.code_predictor, tc.code_predictor
    H, n, V = cp.transformer.hidden_size, cp.num_steps, cp.subcode_vocab_size
    rng = np.random.default_rng(11 + B)
    hidden = rng.standard_normal((B, H)).astype(np.float32)
    c0e = (0.05 * rng.standard_normal((B, H))).astype(np.float32)
    temp, top_k, top_p = KNOBS[knobs]
    jsp = jsamp.SamplingParams.create(temperature=temp, top_k=top_k, top_p=top_p)
    tsp = SamplingParams.create(temperature=temp, top_k=top_k, top_p=top_p)
    key = jax.random.PRNGKey(21)
    fn = jcp.predict_subcodes_fused if B == 1 else jcp.predict_subcodes_fused_batched
    j_subs, j_sum = fn(cp, jcpp, jtables, jnp.asarray(hidden), jnp.asarray(c0e), key,
                       lambda k, lg: jsamp.sample_token(k, lg, jsp))
    width = noise_width(V, tsp)
    noise = [torch.from_numpy(np.array(jax.random.gumbel(k, (B, width), jnp.float32)))
             for k in _step_keys(key, n)]
    assert tcp.chain_route(tcp_cfg, tcpp, B) == "per_step"
    t_subs, t_sum = tcp.predict_subcodes(
        tcp_cfg, tcpp, ttables, torch.from_numpy(hidden), torch.from_numpy(c0e),
        lambda lg, j: sample_token(lg, tsp, noise[j]), sp=tsp, noise_fn=lambda: None)
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), **SUM_TOL)


@pytest.mark.parametrize("B", [1, 3])
def test_per_step_chain_launches_per_position(B, monkeypatch):
    """The per-step chain takes one step kernel call per chain position past
    the prefix (K1 at B=1, K4 at 2-32 rows): n - 1 a frame."""
    _, _, _, tc, tcpp, ttables = _models("per_step")
    cp = tc.code_predictor
    calls = []
    for name in ("fused_decode_step", "fused_decode_step_batched"):
        real = getattr(tcp, name)
        monkeypatch.setattr(tcp, name, lambda *a, _r=real, _n=name, **k: (calls.append(_n),
                                                                          _r(*a, **k))[1])
    H = cp.transformer.hidden_size
    gen = torch.Generator().manual_seed(0)
    subs, _ = tcp.predict_subcodes(cp, tcpp, ttables, torch.randn(B, H, generator=gen),
                                   torch.randn(B, H, generator=gen) * 0.05,
                                   lambda lg, j: lg.argmax(-1), sp=SamplingParams.create(0.0))
    want = "fused_decode_step" if B == 1 else "fused_decode_step_batched"
    assert calls == [want] * (cp.num_steps - 1) and subs.shape == (B, cp.num_steps)


def test_sub_embed_sum_follows_the_route(monkeypatch):
    """``subcode_embed_sum`` gives, per route, the sum the chain returns: the
    per-step and cached chains' grouping, the dense chain's single sum, the
    kernels' float32 running sum."""
    _, _, _, tc, tcpp, ttables = _models("per_step")
    cp = tc.code_predictor
    H = cp.transformer.hidden_size
    gen = torch.Generator().manual_seed(1)
    last, c0e = torch.randn(2, H, generator=gen), torch.randn(2, H, generator=gen) * 0.05
    for impl, resident in (("fused", False), ("cached", None), ("dense", None),
                           ("fused", True)):
        c = dataclasses.replace(cp, impl=impl, resident=resident)
        subs, total = tcp.predict_subcodes(c, tcpp, ttables, last, c0e,
                                           lambda lg, j: lg.argmax(-1),
                                           sp=SamplingParams.create(0.0), noise_fn=lambda: None)
        again = tcp.subcode_embed_sum(c, tcpp, ttables, subs, 2, total.dtype)
        assert torch.equal(again, total), (impl, resident)
