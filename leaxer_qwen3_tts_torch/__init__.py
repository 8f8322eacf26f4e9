"""PyTorch / CUDA port of the Qwen3-TTS framework, for NVIDIA Hopper.

A second package beside ``leaxer_qwen3_tts_tpu`` (the JAX reference, which it
never imports): text -> BPE tokens -> talker transformer -> 16-codebook 12 Hz
acoustic codes -> causal codec vocoder -> 24 kHz audio.  The talker's decode
step (kernel K1 at B=1, K4 at B=2..32) and the MTP sub-code chain (K2, K5)
are hand-written CUDA kernels (``csrc/``); everything else is plain PyTorch.
Batched serving lives in ``serve`` (continuous-batching pool, batching
server, HTTP facade).
"""

from . import config
from .config import QWEN3_TTS_06B, QWEN3_TTS_17B, TTSModelConfig

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
    # the engine pulls in the whole model stack; import it lazily
    if name in ("TTSEngine", "SynthesisResult", "EngineError"):
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
