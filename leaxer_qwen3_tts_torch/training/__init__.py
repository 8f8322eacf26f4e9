"""Training / fine-tuning: the teacher-forced TTS loss and its AdamW step
(port of ``leaxer_qwen3_tts_tpu/training``, one device; the mesh placement
is not ported)."""

from .loss import LossMetrics, tts_loss
from .train_step import (
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "tts_loss",
    "LossMetrics",
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "init_train_state",
]
