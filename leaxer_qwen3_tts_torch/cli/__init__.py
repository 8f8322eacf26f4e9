"""CLI entry point (python -m leaxer_qwen3_tts_torch.cli)."""

from .main import main

__all__ = ["main"]
