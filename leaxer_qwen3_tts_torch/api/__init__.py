"""Public engine API."""

from .engine import EngineError, SynthesisResult, TTSEngine

__all__ = ["TTSEngine", "SynthesisResult", "EngineError"]
