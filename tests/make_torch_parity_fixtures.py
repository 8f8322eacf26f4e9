"""Regenerate tests/fixtures/parity_0p6b_int8.npz and parity_0p6b_bf16.npz:
the JAX package's per-stage outputs at the 0.6B widths, written by its own
tools, which the PyTorch port's ``tools/parity_check.gate_fixture`` holds
the port's engine against (on the CPU in tests/test_torch_tools.py, on the
card in chip_smoke.py).

Each fixture is JAX ``tools.quality_report._random_engine_inputs`` on the
0.6B preset + ``_tiny_tokenizer()`` + ``TTSEngine(config=, params=,
tokenizer=, quantize=...)`` + ``tools.parity_check.compute_stages(eng,
TEXT, "auto", FRAMES)``, with the meta keys ``preset``, ``quantize`` ("int8",
or "none": bf16 units, the CLI's and the server's default) and ``frames``.
Run from the repo root (about a minute of CPU each):
    python tests/make_torch_parity_fixtures.py
and commit the fixtures.  Not collected by pytest.
"""

import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_TESTS))  # repo root (the packages, the root tools)

PRESET = "qwen3-tts-12hz-0.6b-base"
TEXT = "hello world"
FRAMES = 8
QUANTIZE = {"int8": "int8", "bf16": None}  # fixture name -> the engine's quantize


def fixture_path(name: str) -> str:
    return os.path.join(_TESTS, "fixtures", f"parity_0p6b_{name}.npz")


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    # full float32 products, as the tests pin them (tests/conftest.py)
    jax.config.update("jax_default_matmul_precision", "highest")

    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
    from tools.parity_check import compute_stages
    from tools.quality_report import _random_engine_inputs, _tiny_tokenizer

    cfg, params = _random_engine_inputs(PRESET)
    tok = _tiny_tokenizer()
    for name, quantize in QUANTIZE.items():
        eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize=quantize)
        if not eng.is_ready():
            raise SystemExit(f"engine ({name}) not ready: {eng.get_error()}")
        stages = compute_stages(eng, TEXT, "auto", FRAMES)
        stages.update(preset=PRESET, quantize=quantize or "none", frames=FRAMES)
        path = fixture_path(name)
        np.savez_compressed(path, **stages)
        print(f"wrote {path}:")
        for k, v in stages.items():
            print(f"  {k}: {getattr(v, 'shape', v)}")
        del eng


if __name__ == "__main__":
    main()
