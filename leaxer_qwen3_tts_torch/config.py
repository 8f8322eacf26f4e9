"""Model / runtime configuration for the PyTorch port.

The same frozen dataclasses, constants and presets as
``leaxer_qwen3_tts_tpu.config`` with no JAX import: dtype names map to
``torch.dtype`` through :func:`torch_dtype`.  ``to_json`` / ``from_json``
read and write the same JSON form as the reference package's
``TTSModelConfig``, so a checkpoint's ``config.json`` serves both packages.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# TTS special tokens (text-vocab side)
TTS_BOS = 151672
TTS_EOS = 151673
TTS_PAD = 151671

# Chat tokens
IM_START = 151644
IM_END = 151645
ASSISTANT = 77091

# Codec control tokens (codec-vocab side; ids 2048..3071 are control/special)
CODEC_BOS = 2149
CODEC_EOS = 2150
CODEC_PAD = 2148
CODEC_THINK = 2154
CODEC_NOTHINK = 2155
CODEC_THINK_BOS = 2156
CODEC_THINK_EOS = 2157

# Language IDs (codec tokens)
LANG_ENGLISH = 2050
LANG_CHINESE = 2051
LANG_JAPANESE = 2052
LANG_KOREAN = 2053

# Audio
SAMPLE_RATE = 24000
FRAME_RATE = 12  # codec frames per second
SAMPLES_PER_FRAME = SAMPLE_RATE // FRAME_RATE  # 2000

MAX_NEW_TOKENS = 2048
DEFAULT_TEMPERATURE = 0.8
DEFAULT_TOP_P = 0.95
DEFAULT_TOP_K = 50

LANGUAGES = {
    "auto": None,
    "en": LANG_ENGLISH,
    "english": LANG_ENGLISH,
    "zh": LANG_CHINESE,
    "chinese": LANG_CHINESE,
    "ja": LANG_JAPANESE,
    "japanese": LANG_JAPANESE,
    "ko": LANG_KOREAN,
    "korean": LANG_KOREAN,
}

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> ``torch.dtype``."""
    return _DTYPES[name]


def language_to_codec_id(lang: Optional[str]) -> Optional[int]:
    """Language name -> codec token id; None for auto."""
    if lang is None:
        return None
    key = lang.lower()
    if key not in LANGUAGES:
        raise ValueError(f"unknown language {lang!r}; expected one of {sorted(LANGUAGES)}")
    return LANGUAGES[key]


@dataclass(frozen=True)
class TransformerConfig:
    """A causal GQA transformer (Qwen3-style: RMSNorm, SwiGLU, RoPE, QK-norm)."""

    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    use_qk_norm: bool = True
    attn_impl: str = "xla"
    kv_cache_quant: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class TalkerConfig:
    """The autoregressive talker: codec-token LM over the 3072-way codec vocab."""

    transformer: TransformerConfig = TransformerConfig()
    codec_vocab_size: int = 3072
    text_vocab_size: int = 151936
    decode_impl: str = "xla"  # "fused": one hand-written kernel call per step
    fused_max_cache: int = 1100
    text_embed_dim: int = 1024

    @property
    def hidden_size(self) -> int:
        return self.transformer.hidden_size


@dataclass(frozen=True)
class CodePredictorConfig:
    """MTP head predicting sub-codebooks 1..15 from the talker's last hidden state."""

    transformer: TransformerConfig = TransformerConfig(
        hidden_size=1024,
        num_layers=6,
        num_heads=8,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=3072,
    )
    num_steps: int = 15
    subcode_vocab_size: int = 2048
    max_seq_len: int = 17
    head_mode: str = "per_step"  # "per_step" | "shared"
    impl: str = "cached"  # "fused": the whole B=1 chain in the chain kernel
    resident: "bool | None" = None


@dataclass(frozen=True)
class VocoderConfig:
    """12 Hz codec decoder: 16 codebooks per frame -> 24 kHz waveform."""

    num_codebooks: int = 16
    codebook_size: int = 2048
    d_model: int = 1024
    num_prenet_blocks: int = 4
    prenet_kernel_size: int = 5
    upsample_rates: Tuple[int, ...] = (10, 8, 5, 5)
    upsample_channels: Tuple[int, ...] = (512, 256, 128, 64)
    resblock_kernel_size: int = 7
    resblock_dilations: Tuple[int, ...] = (1, 3)
    final_kernel_size: int = 7
    dtype: str = "bfloat16"
    head: str = "conv"  # "conv" | "istft"
    istft_overlap: int = 4

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def samples_per_frame(self) -> int:
        total = 1
        for r in self.upsample_rates:
            total *= r
        return total

    @property
    def left_context_frames(self) -> int:
        """Frames of left context after which chunked decoding is exact
        (receptive field of the causal stack in input frames)."""
        ctx = self.num_prenet_blocks * (self.prenet_kernel_size - 1)
        if self.head == "istft":
            return ctx + self.istft_overlap - 1
        ctx += len(self.upsample_rates) * 2
        samples = 0.0
        up = 1
        for r in self.upsample_rates:
            up *= r
            per_stage = 0
            for d in self.resblock_dilations:
                per_stage += 2 * (self.resblock_kernel_size - 1) * d
            samples += per_stage / up
        samples += (self.final_kernel_size - 1) / up
        return ctx + math.ceil(samples)


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """Voice-clone speaker encoder: log-mel [T, 128] -> embedding
    (``models/speaker_encoder.py``).  ``topology``: "transformer" (the
    primary guess) or "ecapa" (the ECAPA-TDNN fallback)."""

    num_mels: int = 128
    d_model: int = 512
    num_layers: int = 4
    num_heads: int = 8
    intermediate_size: int = 2048
    output_dim: int = 1024
    dtype: str = "float32"
    topology: str = "transformer"
    ecapa_channels: int = 512
    ecapa_scale: int = 8
    ecapa_mfa_dim: int = 1536
    ecapa_att_dim: int = 128

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    num_mels: int = 128
    fmin: float = 0.0
    fmax: float = 12000.0


@dataclass(frozen=True)
class DraftConfig:
    """Trained draft head for speculative decoding (``models/draft.py``).

    Optional: when a checkpoint carries draft parameters, the engine's and
    the pool's ``spec_k`` paths draft with it instead of the repeat draft."""

    hidden_size: int = 1024  # talker hidden size it conditions on
    d_model: int = 512
    codec_vocab_size: int = 3072
    subcode_vocab_size: int = 2048
    num_codebooks: int = 16
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


_SUBCONFIGS = {
    "transformer": TransformerConfig,
    "talker": TalkerConfig,
    "code_predictor": CodePredictorConfig,
    "vocoder": VocoderConfig,
    "speaker_encoder": SpeakerEncoderConfig,
    "mel": MelConfig,
    "draft": DraftConfig,
}


@dataclass(frozen=True)
class TTSModelConfig:
    """Full model family bundle (one per variant: 0.6B-Base, 1.7B-*, ...)."""

    name: str = "qwen3-tts-12hz-0.6b-base"
    talker: TalkerConfig = TalkerConfig()
    code_predictor: CodePredictorConfig = CodePredictorConfig()
    vocoder: VocoderConfig = VocoderConfig()
    speaker_encoder: Optional[SpeakerEncoderConfig] = SpeakerEncoderConfig()
    mel: MelConfig = MelConfig()
    draft: Optional[DraftConfig] = None
    frame_fused: "bool | None" = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TTSModelConfig":
        def build(tp, data):
            if data is None:
                return None
            kwargs = {}
            for f in dataclasses.fields(tp):
                if f.name not in data:
                    continue
                v = data[f.name]
                if f.name in _SUBCONFIGS:
                    kwargs[f.name] = build(_SUBCONFIGS[f.name], v)
                elif isinstance(v, list):
                    kwargs[f.name] = tuple(v)
                else:
                    kwargs[f.name] = v
            return tp(**kwargs)

        return build(cls, json.loads(text))


# The 0.6B-Base preset: fused talker step (kernel K1) and the fused MTP chain
# (kernel K2) on the card.
QWEN3_TTS_06B = TTSModelConfig(
    talker=TalkerConfig(decode_impl="fused"),
    code_predictor=CodePredictorConfig(impl="fused"),
)

# The 1.7B family (VoiceDesign / CustomVoice): talker and MTP at H=2048.  On
# the card the B=1 chain runs kernel K3: the int8 MTP trunk (302 MB) is past
# the residency gate that keeps the 0.6B trunk (78 MB) on kernel K2.
QWEN3_TTS_17B = TTSModelConfig(
    name="qwen3-tts-12hz-1.7b",
    talker=TalkerConfig(
        transformer=TransformerConfig(
            hidden_size=2048,
            num_layers=28,
            num_heads=16,
            num_kv_heads=8,
            head_dim=128,
            intermediate_size=6144,
        ),
        text_embed_dim=2048,
        decode_impl="fused",
    ),
    code_predictor=CodePredictorConfig(
        transformer=TransformerConfig(
            hidden_size=2048,
            num_layers=6,
            num_heads=16,
            num_kv_heads=8,
            head_dim=128,
            intermediate_size=6144,
        ),
        impl="fused",
    ),
)

PRESETS = {
    QWEN3_TTS_06B.name: QWEN3_TTS_06B,
    QWEN3_TTS_17B.name: QWEN3_TTS_17B,
}

# Preset speakers of the CustomVoice models: speaker name -> row of the
# checkpoint's ``speaker_table`` ([num_speakers, hidden]).
PRESET_SPEAKERS = {
    "serena": 0,
    "vivian": 1,
    "uncle_fu": 2,
    "dylan": 3,
    "eric": 4,
    "ryan": 5,
    "aiden": 6,
    "ono_anna": 7,
    "sohee": 8,
}
