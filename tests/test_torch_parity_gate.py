"""The port at the 0.6B widths on the CPU (the kernels' plain versions)
through ``tools/parity_check.gate_fixture``, against the fixtures the JAX
tools wrote from the same random fill (tests/make_torch_parity_fixtures.py):
int8 units (the main path) and bf16 units (the CLI's default).  This run's
errors set the gate's relative bounds (``REL_BOUNDS``: twice them)."""

import os

import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.config import CODEC_EOS
from leaxer_qwen3_tts_torch.tools import parity_check, quality_report

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_fill():
    return quality_report._random_engine_inputs("qwen3-tts-12hz-0.6b-base", "cpu")


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_port_passes_gate_fixture_at_full_width(port_fill, name, monkeypatch):
    """The port passes the gate; stages broken one at a time fail it: a
    prefill logit 1.5x, the first decode logits and samples off, and a code0
    pick at frame 0 at the bottom of its logits (no near tie)."""
    cfg, params = port_fill
    fx = os.path.join(REPO, "tests", "fixtures", f"parity_0p6b_{name}.npz")
    eng = TTSEngine(config=cfg, params=params, tokenizer=quality_report._tiny_tokenizer(),
                    quantize={"int8": "int8", "bf16": None}[name], device="cpu")
    real, seen = parity_check.compute_stages, []
    monkeypatch.setattr(parity_check, "compute_stages",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    lines = []
    r = parity_check.gate_fixture(eng, fx, log=lines.append)
    assert r["ok"], "\n".join(lines)
    assert r["frames_run"] == 8 and set(r["stages"]) == {
        "prompt_embeds", "prefill_logits", "decode_logits", "waveform"}

    st = seen[0]
    allowed = np.arange(st["prefill_logits"].size)
    allowed = np.where((allowed < 2048) | (allowed == CODEC_EOS), st["prefill_logits"], np.inf)
    codes = st["codes"].copy()
    codes[0, 0] = int(np.argmin(allowed))
    for stage, key, value in (
            ("prefill_logits", "prefill_logits", st["prefill_logits"] * 1.5),
            ("decode_logits", "decode_logits", st["decode_logits"] + 1e-2),
            ("waveform", "waveform", st["waveform"] + 1e-2),
            ("codes", "codes", codes)):
        bad = dict(st, **{key: value})
        monkeypatch.setattr(parity_check, "compute_stages", lambda *a, _bad=bad: _bad)
        lines = []
        r = parity_check.gate_fixture(eng, fx, log=lines.append)
        assert not r["ok"] and stage in r["failures"], (stage, lines)
