"""The PyTorch port's CLI against the JAX package's, on the CPU: one checkpoint
directory through both ``cli.main`` functions (one-shot, ``--stream``,
``--ref``, and ``--kv-quant`` alone and with ``--quantize int8``), the error
exits, the flags whose paths are not ported, the ``--device`` flag, and
``--help`` without torch."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.cli.main import main as j_main
from leaxer_qwen3_tts_tpu.runtime.weights import save_checkpoint
from leaxer_qwen3_tts_torch.cli.main import build_parser, main, parse_language
from leaxer_qwen3_tts_torch.frontend import read_wav, write_wav

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the two engines' audio differs by float32 rounding (~1e-6); written as
# 16-bit PCM, a sample may land one step of 2^-15 apart (measured: one step)
PCM_ABS = 2.0 / 32768
ARGS = ["--temp", "0", "--max-tokens", "6", "--seed", "1", "-p", "hello world"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, tiny_model, tiny_vocab_files):
    """The tiny model written by the JAX package, with its tokenizer files."""
    cfg, params = tiny_model
    d = str(tmp_path_factory.mktemp("cli") / "model")
    save_checkpoint(d, cfg, jax.device_get(params))
    for src in tiny_vocab_files[:2]:
        with open(src) as f, open(os.path.join(d, os.path.basename(src)), "w") as g:
            g.write(f.read())
    return d


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    t = np.arange(3 * 24000) / 24000.0
    path = str(tmp_path_factory.mktemp("cli-ref") / "ref.wav")
    write_wav(path, (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), 24000)
    return path


@pytest.mark.parametrize("mode", ["one-shot", "stream", "ref"])
def test_cli_matches_jax(model_dir, ref_wav, tmp_path, mode, capsys):
    """Exit 0 in both, WAVs of equal length (24 kHz) within PCM_ABS, and the
    JAX CLI's printout."""
    extra = {"one-shot": [], "stream": ["--stream"], "ref": ["--ref", ref_wav]}[mode]
    ours, theirs = str(tmp_path / "out" / "t.wav"), str(tmp_path / "j.wav")
    assert main(["-m", model_dir, "-o", ours, "--device", "cpu"] + ARGS + extra) == 0
    out = capsys.readouterr().out
    assert j_main(["-m", model_dir, "-o", theirs] + ARGS + extra) == 0
    j_out = capsys.readouterr().out
    a, sr = read_wav(ours)
    b, j_sr = read_wav(theirs)
    assert sr == j_sr == 24000 and a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(a, b, atol=PCM_ABS, rtol=0)
    assert out.replace(ours, "X") == j_out.replace(theirs, "X")
    assert "Generated 0.50 seconds of audio" in out


def test_cli_verbose_prints_metrics(model_dir, tmp_path, capsys):
    assert main(["-m", model_dir, "-o", str(tmp_path / "v.wav"), "--device", "cpu",
                 "--verbose"] + ARGS) == 0
    assert "frames decoded" in capsys.readouterr().out


def test_cli_errors_like_jax(tmp_path):
    """A missing model flag and a missing directory exit 1 in both."""
    for argv in (["-p", "hi"], ["-m", str(tmp_path / "nope"), "-p", "hi"]):
        assert main(argv + ["--device", "cpu"]) == j_main(argv) == 1


@pytest.mark.parametrize("flags", [["--kv-quant"], ["--quantize", "int8", "--kv-quant"]])
def test_cli_kv_quant_matches_jax(model_dir, tmp_path, flags, capsys):
    """The int8 KV cache (alone and beside int8 weights) runs: exit 0 in both
    CLIs, WAVs of equal length within PCM_ABS, the JAX CLI's printout."""
    ours, theirs = str(tmp_path / "kvq.wav"), str(tmp_path / "j.wav")
    assert main(["-m", model_dir, "-o", ours, "--device", "cpu"] + ARGS + flags) == 0
    out = capsys.readouterr().out
    assert j_main(["-m", model_dir, "-o", theirs] + ARGS + flags) == 0
    j_out = capsys.readouterr().out
    a, sr = read_wav(ours)
    b, j_sr = read_wav(theirs)
    assert sr == j_sr == 24000 and a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(a, b, atol=PCM_ABS, rtol=0)
    assert out.replace(ours, "X") == j_out.replace(theirs, "X")


@pytest.mark.parametrize("flags", [
    ["--quantize", "int4", "--frame-fused", "on"],
    ["--mtp-quantize", "int4", "--frame-fused", "on"],
    ["--quantize", "int4", "--mtp-quantize", "auto", "--frame-fused", "on"],
    ["--quantize", "int8", "--mtp-quantize", "int4", "--frame-fused", "on"],
])
def test_unported_flags_exit_1(model_dir, tmp_path, flags, capsys):
    """The flag sets that exited 1 before the whole-frame kernel K7 took
    int4 units and a bf16 talker run now, as in the JAX CLI: exit 0 in both
    CLIs, WAVs of equal length within PCM_ABS, the JAX CLI's printout (the
    tiny checkpoint decodes on the plain path on both sides)."""
    ours, theirs = str(tmp_path / "u.wav"), str(tmp_path / "j.wav")
    assert main(["-m", model_dir, "-o", ours, "--device", "cpu"] + ARGS + flags) == 0
    out = capsys.readouterr().out
    assert j_main(["-m", model_dir, "-o", theirs] + ARGS + flags) == 0
    j_out = capsys.readouterr().out
    a, sr = read_wav(ours)
    b, j_sr = read_wav(theirs)
    assert sr == j_sr == 24000 and a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(a, b, atol=PCM_ABS, rtol=0)
    assert out.replace(ours, "X") == j_out.replace(theirs, "X")


@pytest.mark.parametrize("flags", [
    ["--quantize", "int4"],
    ["--quantize", "int4", "--kv-quant"],
    ["--mtp-quantize", "int8"],
    ["--mtp-quantize", "auto"],
    ["--quantize", "int8", "--mtp-quantize", "int4"],
])
def test_cli_precision_flags_match_jax(model_dir, tmp_path, flags, capsys):
    """The weight-precision flags the JAX CLI takes run: exit 0 in both CLIs,
    WAVs of equal length within PCM_ABS, the JAX CLI's printout (the tiny
    checkpoint takes the plain path on both sides: ``--mtp-quantize`` packs
    only where the kernels take the widths)."""
    ours, theirs = str(tmp_path / "p.wav"), str(tmp_path / "j.wav")
    assert main(["-m", model_dir, "-o", ours, "--device", "cpu"] + ARGS + flags) == 0
    out = capsys.readouterr().out
    assert j_main(["-m", model_dir, "-o", theirs] + ARGS + flags) == 0
    j_out = capsys.readouterr().out
    a, sr = read_wav(ours)
    b, j_sr = read_wav(theirs)
    assert sr == j_sr == 24000 and a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(a, b, atol=PCM_ABS, rtol=0)
    assert out.replace(ours, "X") == j_out.replace(theirs, "X")


def test_device_cuda_without_a_card_exits_1(model_dir, tmp_path, capsys):
    """The default device is the card; with none the CLI exits 1 and writes
    no file (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run there")
    assert build_parser().parse_args([]).device == "cuda"
    out = str(tmp_path / "c.wav")
    for device in ([], ["--device", "cuda"]):
        assert main(["-m", model_dir, "-o", out] + ARGS + device) == 1
        assert "no CUDA device" in capsys.readouterr().err
        assert not os.path.exists(out)


def test_parse_language_like_jax():
    from leaxer_qwen3_tts_tpu.cli.main import parse_language as j_parse

    for lang in ("en", "English", "zh", "ja", "ko", "korean", "fr", "", None):
        assert parse_language(lang) == j_parse(lang)


def test_flags_are_jaxs_plus_device():
    from leaxer_qwen3_tts_tpu.cli.main import build_parser as j_build

    ours = {a.dest for a in build_parser()._actions}
    assert ours == {a.dest for a in j_build()._actions} | {"device"}


def test_help_imports_no_torch():
    """``--help`` exits 0 without importing torch (the late import)."""
    code = (
        "import sys\n"
        "from leaxer_qwen3_tts_torch.cli.main import main\n"
        "try:\n"
        "    main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
    cmd = subprocess.run([sys.executable, "-m", "leaxer_qwen3_tts_torch.cli", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert cmd.returncode == 0 and "--ref" in cmd.stdout

