"""Structured logging with a verbosity switch.

Port of ``leaxer_qwen3_tts_tpu/utils/logging.py``: ``QTTS_LOG_LEVEL=debug|
info|warning|error`` sets the verbosity of the ``leaxer_qwen3_tts_torch``
logger, which writes to stderr; user-facing run summaries stay on stdout
(the CLI).
"""

from __future__ import annotations

import logging
import os
import sys

ROOT = "leaxer_qwen3_tts_torch"
_CONFIGURED = False


class _StderrHandler(logging.StreamHandler):
    """Writes to ``sys.stderr`` as it is at each record (a caller may have
    replaced it since the logger was configured)."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _value):
        pass


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``name``, after configuring the package's root logger once
    from ``QTTS_LOG_LEVEL`` (default warning)."""
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("QTTS_LOG_LEVEL", "warning").upper()
        handler = _StderrHandler()
        handler.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
        root = logging.getLogger(ROOT)
        root.addHandler(handler)
        root.setLevel(getattr(logging, level, logging.WARNING))
        _CONFIGURED = True
    return logging.getLogger(name)
