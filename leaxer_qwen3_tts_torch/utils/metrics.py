"""Per-stage timing and TTS metrics (RTF, TTFA).

Port of ``leaxer_qwen3_tts_tpu/utils/metrics.py``.  Stage times are host wall-clock; the engine ends each
device stage with a copy to the host, so they include the device's work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class SynthesisMetrics:
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    audio_seconds: float = 0.0
    frames: int = 0
    # frames the decode loop ran, post-EOS and past-max_tokens tail included
    # (each is one talker step and one MTP chain)
    decoded_frames: int = 0
    # of those, the frames the whole-frame kernel K7 decoded (frame_fused)
    frame_fused_frames: int = 0
    ttfa_seconds: Optional[float] = None  # time to first audio chunk
    total_seconds: float = 0.0
    # speculative decoding (spec_k): verify iterations run and drafted frames
    # accepted; acceptance = spec_accepted / (spec_iterations * (spec_k - 1)).
    # Iterations after a stream latched EOS count too, so the rate is a mild
    # underestimate for short utterances.
    spec_iterations: int = 0
    spec_accepted: int = 0
    # True when trailing acceptance fell below the engine's spec_accept_floor
    # and the request went on with sequential decode
    spec_fallback: bool = False

    @property
    def rtf(self) -> float:
        """Real-time factor: audio seconds generated per wall-clock second."""
        return self.audio_seconds / self.total_seconds if self.total_seconds > 0 else 0.0

    def summary(self) -> str:
        stages = ", ".join(f"{k} {v * 1e3:.1f}ms" for k, v in self.stage_seconds.items())
        ttfa = f", ttfa {self.ttfa_seconds * 1e3:.1f}ms" if self.ttfa_seconds is not None else ""
        spec = ""
        if self.spec_iterations:
            spec = (f"; spec {self.spec_iterations} iterations, {self.spec_accepted} accepted"
                    + (", fallback" if self.spec_fallback else ""))
        return (
            f"audio {self.audio_seconds:.2f}s in {self.total_seconds:.2f}s "
            f"(RTF {self.rtf:.2f}x{ttfa}; {stages}; {self.decoded_frames} frames decoded{spec})"
        )


class StageTimer:
    """Accumulates wall-clock per named stage into a SynthesisMetrics."""

    def __init__(self, metrics: SynthesisMetrics):
        self.metrics = metrics
        self._start = time.perf_counter()

    def stage(self, name: str) -> "_StageCtx":
        return _StageCtx(self, name)

    def mark_first_audio(self) -> None:
        if self.metrics.ttfa_seconds is None:
            self.metrics.ttfa_seconds = time.perf_counter() - self._start

    def finish(self) -> SynthesisMetrics:
        self.metrics.total_seconds = time.perf_counter() - self._start
        return self.metrics


class _StageCtx:
    def __init__(self, timer: StageTimer, name: str):
        self.timer = timer
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        m = self.timer.metrics.stage_seconds
        m[self.name] = m.get(self.name, 0.0) + dt
        return False
