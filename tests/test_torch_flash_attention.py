"""Kernel K8 (PyTorch port): the plain version of ``flash_attend`` against
the JAX package's Pallas kernel in interpret mode on the same seed-made
inputs, and the ``attend`` dispatch on the config's ``attn_impl``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.ops.flash_attention import flash_attend as j_flash
from leaxer_qwen3_tts_torch.ops import attention as tattn
from leaxer_qwen3_tts_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

# both sides run the same float32 online softmax over the same key tiles;
# only the order of the dot products' sums differs
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 outputs: one bf16 ulp (2^-8 relative) where a float32 difference
# crosses a rounding edge
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _inputs(seed, B, S, T, nq, nk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, nq, d)).astype(np.float32)
    k = rng.standard_normal((B, nk, T, d)).astype(np.float32)
    v = rng.standard_normal((B, nk, T, d)).astype(np.float32)
    return q, k, v


def _causal(B, S, T):
    """Queries at positions T-S..T-1 over a T-long key history."""
    qpos = np.arange(S) + (T - S)
    return np.broadcast_to(np.arange(T)[None, None, :] <= qpos[None, :, None], (B, S, T)).copy()


def _both(q, k, v, mask, dtype="f32"):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = j_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                   jnp.asarray(mask), interpret=True)
    got = tflash.flash_attend(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                              torch.from_numpy(v).to(td), torch.from_numpy(mask))
    assert got.dtype == td and got.shape == q.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize(
    "B,S,T,nq,nk,d",
    [
        (1, 16, 16, 4, 2, 16),  # GQA 2:1
        (2, 8, 32, 4, 4, 16),  # MHA, longer keys
        (1, 5, 23, 8, 2, 16),  # non-multiple-of-block sizes (padding path)
        (2, 1, 17, 4, 2, 16),  # decode shape
        (1, 7, 300, 4, 2, 16),  # three 128-key tiles, the last one padded
    ],
)
def test_flash_matches_jax(B, S, T, nq, nk, d):
    q, k, v = _inputs(0, B, S, T, nq, nk, d)
    got, want = _both(q, k, v, _causal(B, S, T))
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_flash_invalid_keys_match_jax():
    """A right-padded prompt: some cache slots are invalid for every query."""
    B, S, T, nq, nk, d = 2, 8, 24, 4, 2, 16
    q, k, v = _inputs(1, B, S, T, nq, nk, d)
    valid = np.arange(T)[None, :] < np.array([20, 13])[:, None]
    got, want = _both(q, k, v, _causal(B, S, T) & valid[:, None, :])
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("T", [16, 23, 200])
def test_flash_fully_masked_rows_match_jax(T):
    """A row masked everywhere: every score is the finite -1e30, so each
    visited key weighs exp(0) = 1 and the row's output is the sum of V over
    the padded key count -- the JAX kernel's value, not zeros."""
    B, S, nq, nk, d = 1, 4, 2, 2, 16
    q, k, v = _inputs(2, B, S, T, nq, nk, d)
    mask = np.zeros((B, S, T), bool)
    mask[:, :2] = True
    got, want = _both(q, k, v, mask)
    np.testing.assert_allclose(got, want, **F32_TOL)
    Tp = tflash.padded_keys(T)
    np.testing.assert_allclose(got[0, 2:, 0], np.broadcast_to(v[0, 0].sum(0) / Tp, (2, d)),
                               **F32_TOL)


def test_flash_bf16_matches_jax():
    """bf16 q, k and v (the talker's prefill dtype): float32 arithmetic
    inside, the output rounded to bf16."""
    B, S, T, nq, nk, d = 1, 12, 40, 4, 2, 32
    q, k, v = _inputs(3, B, S, T, nq, nk, d)
    mask = _causal(B, S, T)
    mask[:, :, 30:] = False
    got, want = _both(q, k, v, mask, "bf16")
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_attend_dispatch():
    """``attend`` runs attend_xla for "xla", K8 for "pallas" and raises on
    any other impl, as the JAX dispatch does."""
    q, k, v = _inputs(4, 1, 6, 20, 4, 2, 16)
    q, k, v = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    mask = torch.from_numpy(_causal(1, 6, 20))
    assert torch.equal(tattn.attend(q, k, v, mask), tattn.attend_xla(q, k, v, mask))
    assert torch.equal(tattn.attend(q, k, v, mask, impl="pallas"),
                       tflash.flash_attend_reference(q, k, v, mask))
    torch.testing.assert_close(tattn.attend(q, k, v, mask, impl="pallas"),
                               tattn.attend_xla(q, k, v, mask), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attend(q, k, v, mask, impl="flash")


def test_flash_tiles():
    """The JAX kernel's key tile and padded key count."""
    assert [tflash.block_t(T) for T in (1, 8, 23, 128, 256, 300)] == [8, 8, 23, 128, 128, 128]
    assert [tflash.padded_keys(T) for T in (1, 8, 23, 128, 256, 300)] == [8, 8, 23, 128, 256, 384]
