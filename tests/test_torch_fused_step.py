"""Kernel K1 (PyTorch port): the plain version of ``fused_decode_step``
against the JAX Pallas kernel in interpret mode, on the same int8 weights and
the same seed-made inputs, in every cache mode the JAX kernel has."""

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
from leaxer_qwen3_tts_torch.ops import quant as tquant
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

# x_out and the caches agree to 1e-3: both sides round the same operands to
# bf16 and accumulate in float32, in different orders
TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def packs():
    t = TransformerConfig(
        hidden_size=1024, num_layers=2, num_heads=8, num_kv_heads=4,
        head_dim=128, intermediate_size=3072, dtype="float32",
    )
    params = init_transformer_params(t, jax.random.PRNGKey(0))
    jfw = jfs.pack_fused_weights(t, params["layers"])
    tt = tcfg.TransformerConfig(**{
        f: getattr(t, f) for f in t.__dataclass_fields__
    })
    layers = params_from_jax(flatten_params(jax.device_get(params["layers"])))
    tfw = tfs.pack_fused_weights(tt, layers)
    return t, jfw, tt, tfw


@pytest.mark.parametrize(
    "T,mode,pos,cache",
    [
        (64, None, 37, "bfloat16"),  # manual vmem kernel, bf16 cache
        (1024, "hbm", 300, "float32"),  # whole-cache DMA mode
        (1024, "win", 700, "float32"),  # streamed windows, pos past the first 512
    ],
)
def test_fused_decode_step_matches_jax(packs, T, mode, pos, cache):
    t, jfw, tt, tfw = packs
    rng = np.random.default_rng(T + pos)
    L, nk, d = 2, 4, 128
    x = (rng.standard_normal((1, 1024)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((L, 1, nk, T, d)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((L, 1, nk, T, d)) * 0.2).astype(np.float32)
    kc[:, :, :, pos:] = 0.0
    vc[:, :, :, pos:] = 0.0
    jdt = jnp.bfloat16 if cache == "bfloat16" else jnp.float32
    tdt = tcfg.torch_dtype(cache)
    kwargs = {} if mode is None else {"mode": mode}
    jx, jk, jv = jfs.fused_decode_step(
        t, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
        jnp.asarray(kc).astype(jdt), jnp.asarray(vc).astype(jdt),
        interpret=True, **kwargs,
    )
    tk = torch.from_numpy(kc).to(tdt)
    tv = torch.from_numpy(vc).to(tdt)
    tx, tk2, tv2 = tfs.fused_decode_step(tt, tfw, torch.from_numpy(x), pos, tk, tv)
    assert tk2 is tk and tv2 is tv  # updated in place
    jk = np.asarray(jk.astype(jnp.float32))
    jv = np.asarray(jv.astype(jnp.float32))
    tk, tv = tk.float().numpy(), tv.float().numpy()
    # untouched slots are carried bit for bit
    others = np.arange(T) != pos
    np.testing.assert_array_equal(tk[:, :, :, others], jk[:, :, :, others])
    np.testing.assert_array_equal(tv[:, :, :, others], jv[:, :, :, others])
    if cache == "float32":
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        np.testing.assert_allclose(tk, jk, **TOL)
        np.testing.assert_allclose(tv, jv, **TOL)
    else:
        # A bf16 cache rounds the new slot's k/v.  The two sides' float32 sums
        # differ in order (~1e-7), which flips the bf16 rounding of a few
        # activation / k / v elements; a flipped cache element moves by one
        # bf16 ulp (0.0078 at magnitude 1), and the next layer's x by up to
        # ~4e-3.  So: the written slot within 2 ulps, x_out within 1e-2.
        np.testing.assert_allclose(tk[:, :, :, pos], jk[:, :, :, pos], atol=1.6e-2)
        np.testing.assert_allclose(tv[:, :, :, pos], jv[:, :, :, pos], atol=1.6e-2)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-2)


def test_pos_clamped_to_last_slot(packs):
    """An overflowing position writes the last slot, as the JAX wrapper clamps it."""
    _, _, tt, tfw = packs
    T = 8
    k = torch.zeros((2, 1, 4, T, 128))
    v = torch.zeros_like(k)
    tfs.fused_decode_step(tt, tfw, torch.ones((1, 1024)) * 0.1, T + 5, k, v)
    assert bool(k[:, :, :, T - 1].abs().sum() > 0)
    assert float(k[:, :, :, : T - 1].abs().sum()) == 0.0


def test_unported_variants_raise(packs):
    """A pack of unit bits the kernels do not take raises, and an int4 pack
    (test_torch_int4.py) needs raw weights: the quantized layers of the int8
    pack are refused at bits=4, as the JAX pack refuses them."""
    _, _, tt, _ = packs
    layers = {"wqkv": torch.zeros((1, 1024, 2048))}
    with pytest.raises(ValueError, match="bits must be 4, 8 or 16"):
        tfs.pack_fused_weights(tt, layers, bits=2)
    q = tquant.quantize_weight(torch.zeros((1, 1024, 2048)))
    with pytest.raises(ValueError, match="raw weights"):
        tfs.pack_fused_weights(tt, {"wqkv": q, "wo": q, "wgu": q, "wd": q}, bits=4)
