"""Training / fine-tuning: the teacher-forced TTS loss and its AdamW step
(port of ``leaxer_qwen3_tts_tpu/training``), on one device or data-parallel
over a mesh's data groups (``shard_train_state``, ``batch_sharding``)."""

from .loss import LossMetrics, tts_loss
from .train_step import (
    TrainState,
    batch_sharding,
    init_train_state,
    make_optimizer,
    make_train_step,
    shard_train_state,
)

__all__ = [
    "tts_loss",
    "LossMetrics",
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "init_train_state",
    "shard_train_state",
    "batch_sharding",
]
