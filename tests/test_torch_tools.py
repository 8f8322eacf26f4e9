"""The port's report tools (``leaxer_qwen3_tts_torch/tools``: parity_check,
make_parity_fixtures, quality_report, spec_report) against the JAX package's
root tools on the tiny checkpoint, on the CPU: compute_stages, the parity
gate on a fixture the JAX tool writes, the fixture schema, and the refusal
without a card.  The reports' JSON is held in tests/test_torch_reports.py;
the 0.6B-width checks are in tests/test_torch_random_fill.py (the random
fill) and tests/test_torch_parity_gate.py (``gate_fixture`` on the
committed fixtures)."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.tools import parity_check, quality_report, spec_report

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "qwen3-tts-12hz-0.6b-base"  # the refusal test's --random-preset
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_slice.py's stage tolerance


@pytest.fixture(scope="module")
def model_dir(tiny_model, tiny_vocab_files, tmp_path_factory):
    from leaxer_qwen3_tts_tpu.runtime.weights import save_checkpoint

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    d = str(tmp_path_factory.mktemp("tools") / "ckpt")
    save_checkpoint(d, cfg, params)
    shutil.copy(vocab_path, os.path.join(d, "vocab.json"))
    shutil.copy(merges_path, os.path.join(d, "merges.txt"))
    return d


def test_compute_stages_matches_jax(tiny_model, tiny_vocab_files):
    """The port's compute_stages equals JAX's on the tiny model: token ids
    and greedy codes equal, the other stages within the slice's tolerance."""
    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
    from tools.parity_check import compute_stages as j_stages

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    jeng = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path),
                   max_frames=8)
    teng = TTSEngine(config=tcfg.TTSModelConfig.from_json(cfg.to_json()),
                     params=params_from_jax(flatten_params(jax.device_get(params))),
                     tokenizer=Tokenizer(vocab_path, merges_path), max_frames=8, device="cpu")
    assert teng.kv_ladder == jeng.kv_ladder
    want = j_stages(jeng, "hello world", "auto", 6)
    got = parity_check.compute_stages(teng, "hello world", "auto", 6)
    assert set(got) == set(want)
    assert str(got["text"]) == str(want["text"])
    np.testing.assert_array_equal(got["token_ids"], want["token_ids"])
    np.testing.assert_array_equal(got["codes"], want["codes"])
    assert got["codes"].shape[0] >= 1
    for k in ("prompt_embeds", "prefill_logits", "decode_logits", "waveform"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32), **TOL, err_msg=k)


def test_parity_check_passes_jax_fixture_and_fails_corrupted(model_dir, tmp_path):
    """A fixture JAX's make_parity_fixtures writes from the tiny checkpoint
    passes the port's parity_check (every stage, codes and waveform through
    synthesize); corrupted codes, then a corrupted waveform, fail it."""
    from tools.make_parity_fixtures import main as j_gen

    fx = str(tmp_path / "fx.npz")
    assert j_gen(["--model", model_dir, "--text", "hello world", "--max-frames", "4",
                  "--out", fx]) == 0
    base = ["--model", model_dir, "--device", "cpu", "--fixture"]
    assert parity_check.main(base + [fx]) == 0
    z = parity_check.load_fixture(fx)
    assert {"prompt_embeds", "prefill_logits", "decode_logits", "codes", "waveform",
            "token_ids"} <= set(z)
    for key, bad in (("codes", (z["codes"] + 1) % 2048), ("waveform", z["waveform"] + 0.5)):
        path = str(tmp_path / f"bad_{key}.npz")
        np.savez(path, **dict(z, **{key: bad}))
        assert parity_check.main(base + [path]) == 1, key


def test_port_fixture_schema_matches_jax(model_dir, tmp_path):
    """The port's make_parity_fixtures writes the JAX tool's keys, and the
    JAX gate passes the port's fixture."""
    from leaxer_qwen3_tts_torch.tools.make_parity_fixtures import main as t_gen
    from tools.make_parity_fixtures import main as j_gen
    from tools.parity_check import main as j_check

    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    args = ["--model", model_dir, "--max-frames", "3", "--out"]
    assert t_gen(args + [mine, "--device", "cpu"]) == 0
    assert j_gen(args + [theirs]) == 0
    a, b = parity_check.load_fixture(mine), parity_check.load_fixture(theirs)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    assert j_check(["--model", model_dir, "--fixture", mine]) == 0


def test_tools_refuse_without_a_card(model_dir, capsys):
    """Each tool defaults to the card: with none it fails (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tools would run there")
    assert quality_report.main(["--random-preset", PRESET]) == 1
    assert spec_report.main(["--random-preset", PRESET]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert spec_report.main(["--model", model_dir]) == 1
    fx = os.path.join(REPO, "tests", "fixtures", "parity_0p6b_int8.npz")
    assert parity_check.main(["--model", model_dir, "--fixture", fx]) == 1
