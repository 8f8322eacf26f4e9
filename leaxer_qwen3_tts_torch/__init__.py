"""PyTorch / CUDA port of the Qwen3-TTS framework, for NVIDIA Hopper.

A second package beside ``leaxer_qwen3_tts_tpu`` (the JAX reference, which it
never imports): text -> BPE tokens -> talker transformer -> 16-codebook 12 Hz
acoustic codes -> causal codec vocoder -> 24 kHz audio.  The talker's decode
step (kernel K1 at B=1, K4 at B >= 2) and the MTP sub-code chain (K2, K5)
are hand-written CUDA kernels (``csrc/``); everything else is plain PyTorch.
Batched serving lives in ``serve`` (continuous-batching pool, batching
server, HTTP facade), fine-tuning in ``training``.  Entry points: ``python -m
leaxer_qwen3_tts_torch.cli``, ``python -m leaxer_qwen3_tts_torch.serve`` and
``python -m leaxer_qwen3_tts_torch.tools.train_draft``.  Importing the package
imports no torch (``--help`` stays fast); its attributes load on first use.
"""

import importlib

__version__ = "0.1.0"

__all__ = [
    "config",
    "TTSModelConfig",
    "QWEN3_TTS_06B",
    "QWEN3_TTS_17B",
    "TTSEngine",
    "SynthesisResult",
    "EngineError",
    "__version__",
]


def __getattr__(name):
    # torch and the engine's model stack load on first use
    if name == "config":
        return importlib.import_module(".config", __name__)
    if name in ("TTSModelConfig", "QWEN3_TTS_06B", "QWEN3_TTS_17B"):
        return getattr(importlib.import_module(".config", __name__), name)
    if name in ("TTSEngine", "SynthesisResult", "EngineError"):
        return getattr(importlib.import_module(".api", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
