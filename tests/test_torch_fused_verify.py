"""Kernel K6 (PyTorch port): the plain version of ``fused_verify_step``
against the JAX Pallas verify kernel in interpret mode, on the same int8
weights and seed-made inputs in both of the JAX kernel's cache modes; and at
R = B x S rows against the port's own single-stream steps, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.config import TransformerConfig
from leaxer_qwen3_tts_tpu.models.layers import init_transformer_params
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.ops.fused_verify import fused_verify_step as j_verify
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import fused_verify as tfv
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

# Against the JAX kernel: the bounds the K1 port test of the first slice held
# (both sides round the same operands to bf16 and sum in float32 in other
# orders; 2 layers let a bf16 rounding flip reach x): x within 1e-2, each
# written slot within 1.6e-2, every other slot carried bit for bit.
X_TOL = dict(atol=1e-2, rtol=1e-2)
SLOT_ATOL = 1.6e-2
L, NK, D, S = 2, 4, 128, 4


@pytest.fixture(scope="module")
def packs():
    t = TransformerConfig(
        hidden_size=1024, num_layers=L, num_heads=8, num_kv_heads=NK,
        head_dim=D, intermediate_size=3072, dtype="float32",
    )
    params = init_transformer_params(t, jax.random.PRNGKey(0))
    jfw = jfs.pack_fused_weights(t, params["layers"])
    tt = tcfg.TransformerConfig(**{f: getattr(t, f) for f in t.__dataclass_fields__})
    layers = params_from_jax(flatten_params(jax.device_get(params["layers"])))
    return t, jfw, tt, tfs.pack_fused_weights(tt, layers)


def _inputs(B, S_, T, starts, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S_, 1024)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((L, B, NK, T, D)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((L, B, NK, T, D)) * 0.2).astype(np.float32)
    for b, p in enumerate(starts):  # slots from each stream's start on are empty
        kc[:, b, :, min(p, T - S_):] = 0.0
        vc[:, b, :, min(p, T - S_):] = 0.0
    return x, kc, vc


@pytest.mark.parametrize("T,pos", [(512, 137), (1024, 509)])  # "vmem"; "win" across a window
def test_fused_verify_step_matches_jax(packs, T, pos):
    t, jfw, tt, tfw = packs
    x, kc, vc = _inputs(1, S, T, [pos], T + pos)
    jx, jk, jv = j_verify(t, jfw, jnp.asarray(x[0]), jnp.asarray(pos, jnp.int32),
                          jnp.asarray(kc), jnp.asarray(vc), interpret=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tx, tk2, tv2 = tfv.fused_verify_step(tt, tfw, torch.from_numpy(x), pos, tk, tv)
    assert tk2 is tk and tv2 is tv  # updated in place
    jk, jv = np.asarray(jk), np.asarray(jv)
    tk, tv = tk.numpy(), tv.numpy()
    new = np.zeros(T, bool)
    new[pos : pos + S] = True
    np.testing.assert_array_equal(tk[:, :, :, ~new], jk[:, :, :, ~new])
    np.testing.assert_array_equal(tv[:, :, :, ~new], jv[:, :, :, ~new])
    np.testing.assert_array_equal(tk[:, :, :, ~new], kc[:, :, :, ~new])
    np.testing.assert_allclose(tx.numpy()[0], np.asarray(jx), **X_TOL)
    np.testing.assert_allclose(tk[:, :, :, new], jk[:, :, :, new], atol=SLOT_ATOL)
    np.testing.assert_allclose(tv[:, :, :, new], jv[:, :, :, new], atol=SLOT_ATOL)


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_rows_match_single_stream_steps(packs, cache):
    """Row (b, s) of the plain verify at R = B x S rows is S successive plain
    K1 steps of stream b alone, bit for bit: x, the written slots and every
    other slot; a start past T - S is clamped there."""
    _, _, tt, tfw = packs
    T, S_, starts = 256, 3, [0, 62, 200, 300]
    x, kc, vc = _inputs(len(starts), S_, T, starts, 5)
    dt = tcfg.torch_dtype(cache)
    tk, tv = torch.from_numpy(kc).to(dt), torch.from_numpy(vc).to(dt)
    k0, v0 = tk.clone(), tv.clone()
    tx, _, _ = tfv.fused_verify_step(tt, tfw, torch.from_numpy(x), torch.tensor(starts), tk, tv)
    for b, p in enumerate(starts):
        k1, v1 = k0[:, b : b + 1].clone(), v0[:, b : b + 1].clone()
        for s in range(S_):
            x1, _, _ = tfs.fused_decode_step(tt, tfw, torch.from_numpy(x[b, s][None]),
                                             min(p, T - S_) + s, k1, v1)
            assert torch.equal(tx[b, s][None], x1), (b, s)
        assert torch.equal(tk[:, b : b + 1], k1) and torch.equal(tv[:, b : b + 1], v1)


def test_bad_calls_raise(packs):
    """Out-of-range candidate counts and foreign devices raise (no silent
    fallback)."""
    _, _, tt, tfw = packs
    kc = torch.zeros((L, 1, NK, 16, D))
    with pytest.raises(ValueError, match="candidates"):
        tfv.fused_verify_step(tt, tfw, torch.zeros((1, 9, 1024)), 0, kc, kc.clone())
    with pytest.raises(ValueError, match="unsupported device"):
        tfv.fused_verify_step(tt, tfw, torch.zeros((1, 4, 1024), device="meta"), 0,
                              kc, kc.clone())
    assert tfv.fused_verify_step.launches == 0
