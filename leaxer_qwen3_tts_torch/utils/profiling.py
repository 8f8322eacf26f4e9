"""``torch.profiler`` integration.

Port of ``leaxer_qwen3_tts_tpu/utils/profiling.py``.  Set
``QTTS_PROFILE=/some/dir`` to capture a Chrome trace of every synthesis call:
:func:`maybe_trace` writes ``<dir>/<label>-<ms>-<unique>/trace.json`` (open
it in ``chrome://tracing`` or Perfetto), with the CPU's ops and, on a CUDA
device, the kernels.  Without the variable both functions do nothing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time

import torch

from .logging import get_logger

TRACE_FILE = "trace.json"

log = get_logger(__name__)
# the profiler is one per process: a region that starts while another is
# traced runs inside that trace instead of failing
_tracing = threading.Lock()


def _profiling() -> bool:
    return bool(os.environ.get("QTTS_PROFILE"))


@contextlib.contextmanager
def maybe_trace(label: str):
    """Wraps a region in ``torch.profiler.profile`` (CPU, plus CUDA where a
    device is present) and an :func:`annotate` range named ``label`` when
    QTTS_PROFILE is set.  The trace is written however the region ends (an
    exception, or a generator closed early); each region gets a directory of
    its own."""
    base = os.environ.get("QTTS_PROFILE")
    if not base:
        yield
        return
    if not _tracing.acquire(blocking=False):
        log.info("a trace is already running: %r is recorded in it", label)
        with annotate(label):
            yield
        return
    try:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(base, exist_ok=True)
        path = tempfile.mkdtemp(prefix=f"{label}-{int(time.time() * 1e3)}-", dir=base)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        try:
            with prof:
                with annotate(label):
                    yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            prof.export_chrome_trace(os.path.join(path, TRACE_FILE))
    finally:
        _tracing.release()


@contextlib.contextmanager
def annotate(name: str):
    """A named range inside a trace: a ``record_function`` range, plus an
    NVTX range on a CUDA device.  A no-op when QTTS_PROFILE is unset."""
    if not _profiling():
        yield
        return
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
