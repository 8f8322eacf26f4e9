"""The port's ``tools/quality_report._random_engine_inputs`` against the JAX
tool's at the 0.6B preset, on the CPU: every leaf bit for bit."""

import jax
import numpy as np
import torch

from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch.runtime.weights import flatten_params as t_flatten
from leaxer_qwen3_tts_torch.tools import quality_report

torch.set_num_threads(2)

PRESET = "qwen3-tts-12hz-0.6b-base"


def test_random_engine_inputs_match_jax_bit_for_bit():
    """Every leaf of the port's fill of the 0.6B preset equals the JAX tool's,
    bit for bit, in JAX's leaf order: the text embedding's 155.6M values
    (past 2^24, where the float32 iota rounds) included."""
    from tools.quality_report import _random_engine_inputs

    jcfg, jparams = _random_engine_inputs(PRESET)
    want = flatten_params(jax.device_get(jparams))
    del jparams
    cfg, params = quality_report._random_engine_inputs(PRESET, "cpu")
    assert cfg.to_json() == jcfg.to_json()
    got = t_flatten(params)
    del params
    assert sorted(got) == sorted(want)
    assert max(v.size for v in got.values()) > 2 ** 24
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.dtype.name == "bfloat16":
            w = w.view(np.int16)
            g = g.view(np.int16)
        assert g.dtype == w.dtype, k
        assert np.array_equal(g, w), k
