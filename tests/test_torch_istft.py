"""M8, the iSTFT vocoder head (PyTorch port) against the JAX package's
``vocoder_forward`` on the same raw weights and seeded codes: the
parameters' members and shapes, whole decoding (within 1e-4 of the
largest sample: both run a float32 inverse real FFT, summed in other
orders), decoding shorter than the overlap, and chunked decoding
(``vocode_chunk``) at ``left_context_frames`` of left context, which equals
whole decoding (the head's window spans strictly earlier frames)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest_util import build_tiny_cfg
from leaxer_qwen3_tts_tpu.models import codec12hz as jcodec
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.models import codec12hz as tcodec
from leaxer_qwen3_tts_torch.runtime.weights import _leaves, params_from_jax

torch.set_num_threads(2)

REL = 1e-4  # of the largest sample
# the overlap-add at short hops: the tiny vocoder at a 40-sample hop
VOC = dict(upsample_rates=(5, 8), upsample_channels=(16, 8))


@pytest.fixture(scope="module")
def istft():
    jc = dataclasses.replace(build_tiny_cfg().vocoder, head="istft", **VOC)
    raw = jcodec.init_vocoder_params(jc, jax.random.PRNGKey(2))
    tc = tcfg.VocoderConfig(**{**dataclasses.asdict(jc), "upsample_rates": jc.upsample_rates,
                               "upsample_channels": jc.upsample_channels})
    return jc, raw, tc, params_from_jax(flatten_params(jax.device_get(raw)))


def _codes(seed, B, F, cfg):
    return np.random.default_rng(seed).integers(0, cfg.codebook_size,
                                                (B, F, cfg.num_codebooks)).astype(np.int32)


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=REL * scale, rtol=0)


def test_init_matches_jax(istft):
    """JAX's members and shapes: no conv stages, ``head_ln_*`` and
    ``istft_out_*`` to n_fft + 2 channels (n_fft = overlap x hop)."""
    jc, raw, tc, _ = istft
    want = {k: v.shape for k, v in flatten_params(jax.device_get(raw)).items()}
    got = {k: tuple(v.shape) for k, v in _leaves(
        tcodec.init_vocoder_params(tc, torch.Generator().manual_seed(0), "cpu"))}
    assert got == want
    n_fft = tc.istft_overlap * tc.samples_per_frame
    assert got["istft_out_w"] == (tc.d_model, n_fft + 2) and "stages" not in str(got)


@pytest.mark.parametrize("F", [2, 3, 9])
def test_whole_matches_jax(istft, F):
    """Whole decoding, also at fewer frames than the overlap (the window's
    onset normalisation)."""
    jc, raw, tc, tp = istft
    codes = _codes(F, 2, F, jc)
    want = np.asarray(jcodec.vocoder_forward(jc, raw, jnp.asarray(codes)))
    got = tcodec.vocoder_forward(tc, tp, torch.from_numpy(codes).long()).numpy()
    assert got.shape == (2, F * tc.samples_per_frame) and np.isfinite(got).all()
    _close(got, want)


def test_chunked_at_left_context_equals_whole(istft):
    """``vocode_chunk`` with ``left_context_frames`` of context gives the
    whole decoding's samples of its frames, and JAX's chunk within REL."""
    jc, raw, tc, tp = istft
    ctx = tc.left_context_frames
    assert ctx == jc.left_context_frames == tc.num_prenet_blocks * 4 + tc.istft_overlap - 1
    F = ctx + 6
    codes = torch.from_numpy(_codes(7, 1, F, jc)).long()
    whole = tcodec.vocoder_forward(tc, tp, codes)
    spf = tc.samples_per_frame
    for start in (ctx, ctx + 3):
        chunk = tcodec.vocode_chunk(tc, tp, codes[:, start - ctx:], ctx)
        np.testing.assert_allclose(chunk.numpy(), whole[:, start * spf:].numpy(), atol=1e-5,
                                   rtol=1e-5)
        want = np.asarray(jcodec.vocode_chunk(jc, raw, jnp.asarray(codes[:, start - ctx:].numpy()),
                                              ctx))
        _close(chunk.numpy(), want)
