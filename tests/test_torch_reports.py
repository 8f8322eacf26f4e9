"""The port's quality_report and spec_report against the JAX package's root
tools on the tiny checkpoint, on the CPU: the JAX tools' JSON keys, integer
fields equal, float fields within REPORT_TOL."""

import json
import os
import shutil

import pytest
import torch

from leaxer_qwen3_tts_torch.tools import quality_report, spec_report

torch.set_num_threads(2)

REPORT_TOL = 1e-5  # the reports' float fields, port against JAX (measured at most 1.5e-6)


@pytest.fixture(scope="module")
def model_dir(tiny_model, tiny_vocab_files, tmp_path_factory):
    from leaxer_qwen3_tts_tpu.runtime.weights import save_checkpoint

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    d = str(tmp_path_factory.mktemp("reports") / "ckpt")
    save_checkpoint(d, cfg, params)
    shutil.copy(vocab_path, os.path.join(d, "vocab.json"))
    shutil.copy(merges_path, os.path.join(d, "merges.txt"))
    return d


def _report(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _close(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and not isinstance(w, bool):
            assert abs(g - w) <= tol, (k, g, w)
        elif isinstance(w, list):
            assert len(g) == len(w), k
            for gi, wi in zip(g, w):
                _close(gi, wi, tol)
        else:
            assert g == w, (k, g, w)


@pytest.mark.parametrize("flags", [[], ["--quantize", "int4"], ["--kv-quant"]],
                         ids=["int8", "int4", "kv_quant"])
def test_quality_report_matches_jax(model_dir, flags, capsys):
    """The port's quality_report prints the JAX tool's JSON keys, with the
    integer fields equal and the float fields within REPORT_TOL of JAX's on
    the same checkpoint."""
    from tools.quality_report import main as j_main

    argv = ["--model", model_dir, "--max-frames", "3"] + flags
    want = _report(j_main, argv, capsys)
    got = _report(quality_report.main, argv + ["--device", "cpu"], capsys)
    assert got["frames_compared"] >= 1
    _close(got, want, REPORT_TOL)


def test_spec_report_matches_jax(model_dir, capsys):
    """The port's spec_report prints the JAX tool's JSON, equal to JAX's on
    the same checkpoint (frames, iterations, acceptance), greedy parity
    against the sequential engine holding in both."""
    from tools.spec_report import main as j_main

    argv = ["--model", model_dir, "--max-frames", "6", "--k", "3"]
    want = _report(j_main, argv, capsys)
    got = _report(spec_report.main, argv + ["--device", "cpu"], capsys)
    assert got["greedy_parity_vs_sequential"] is True
    assert got["draft"] == "repeat" and got["frames"] >= 1
    _close(got, want, REPORT_TOL)
