"""Kernel K4 (PyTorch port): the plain version of ``fused_decode_step_batched``
against the JAX Pallas kernel in interpret mode, on the same int8 weights and
the same seed-made inputs, in both of the JAX kernel's cache modes, with each
stream at its own position; and row b against the port's B=1 step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.config import TransformerConfig
from leaxer_qwen3_tts_tpu.models.layers import init_transformer_params
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

# x_out and the caches agree to 1e-3: both sides round the same operands to
# bf16 and accumulate in float32, in different orders (test_torch_fused_step.py)
TOL = dict(atol=1e-3, rtol=1e-3)
L, NK, D = 2, 4, 128


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


def _inputs(B, T, pos, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, 1024)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((L, B, NK, T, D)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((L, B, NK, T, D)) * 0.2).astype(np.float32)
    for b, p in enumerate(pos):  # slots past each stream's position are empty
        kc[:, b, :, min(p, T - 1):] = 0.0
        vc[:, b, :, min(p, T - 1):] = 0.0
    return x, kc, vc


@pytest.mark.parametrize(
    "T,pos",
    [
        (64, [0, 37, 70]),  # "bvmem" (T <= 64), one position past the bucket
        (256, [0, 130, 255, 300]),  # "bwin", W = 128 at B = 4; last slot and an overflow
    ],
)
def test_fused_decode_step_batched_matches_jax(packs, T, pos):
    t, jfw, tt, tfw = packs
    B = len(pos)
    x, kc, vc = _inputs(B, T, pos, T + B)
    jx, jk, jv = jfs.fused_decode_step_batched(
        t, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jnp.asarray(kc), jnp.asarray(vc),
        interpret=True,
    )
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    tx, tk2, tv2 = tfs.fused_decode_step_batched(
        tt, tfw, torch.from_numpy(x), torch.tensor(pos), tk, tv
    )
    assert tk2 is tk and tv2 is tv  # updated in place
    jk, jv = np.asarray(jk), np.asarray(jv)
    tk, tv = tk.numpy(), tv.numpy()
    for b, p in enumerate(pos):
        others = np.arange(T) != min(p, T - 1)
        # untouched slots are carried bit for bit
        np.testing.assert_array_equal(tk[:, b][:, :, others], jk[:, b][:, :, others])
        np.testing.assert_array_equal(tv[:, b][:, :, others], jv[:, b][:, :, others])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tk, jk, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)


def test_rows_match_single_stream_step(packs):
    """Row b of the batched plain step is the B=1 plain step on row b, bit for
    bit: x, the written slot and every other slot."""
    _, _, tt, tfw = packs
    T, pos = 64, [5, 0, 63]
    x, kc, vc = _inputs(len(pos), T, pos, 1)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    tx, _, _ = tfs.fused_decode_step_batched(tt, tfw, torch.from_numpy(x), torch.tensor(pos),
                                             tk, tv)
    for b, p in enumerate(pos):
        k1, v1 = torch.from_numpy(kc[:, b : b + 1].copy()), torch.from_numpy(vc[:, b : b + 1].copy())
        x1, _, _ = tfs.fused_decode_step(tt, tfw, torch.from_numpy(x[b : b + 1]), p, k1, v1)
        assert torch.equal(tx[b : b + 1], x1)
        assert torch.equal(tk[:, b : b + 1], k1) and torch.equal(tv[:, b : b + 1], v1)


def test_uniform_position_and_foreign_device(packs):
    """One host position serves every row like a [B] tensor of it; a tensor
    on neither the CPU nor a CUDA device raises (no silent fallback)."""
    _, _, tt, tfw = packs
    x, kc, vc = _inputs(2, 16, [9, 9], 3)
    a = tfs.fused_decode_step_batched(tt, tfw, torch.from_numpy(x), 9,
                                      torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    b = tfs.fused_decode_step_batched(tt, tfw, torch.from_numpy(x), torch.tensor([9, 9]),
                                      torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.fused_decode_step_batched(tt, tfw, torch.zeros((33, 1024), device="meta"), 0,
                                      torch.zeros((L, 33, NK, 8, D)), torch.zeros((L, 33, NK, 8, D)))
