"""Embedding tables: text_project, codec_embed, code_predictor_embed.

Port of ``leaxer_qwen3_tts_tpu/models/embeddings.py``: plain gather tables
in the same parameter dict as the talker.
"""

from __future__ import annotations

import torch

from ..config import CodePredictorConfig, TalkerConfig
from .layers import _normal


def init_embedding_params(
    cfg: TalkerConfig, pred_cfg: CodePredictorConfig, gen: torch.Generator, device
) -> dict:
    dt = cfg.transformer.torch_dtype
    h = cfg.hidden_size
    return {
        "text_embed": _normal(gen, (cfg.text_vocab_size, cfg.text_embed_dim), 0.02, dt, device),
        "text_proj": _normal(
            gen, (cfg.text_embed_dim, h), cfg.text_embed_dim ** -0.5, dt, device
        ),
        "codec_embed": _normal(gen, (cfg.codec_vocab_size, h), 0.02, dt, device),
        "pred_embed": _normal(
            gen, (pred_cfg.num_steps, pred_cfg.subcode_vocab_size, h), 0.02, dt, device
        ),
    }


def text_project(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    """[...] int -> [..., hidden] — embed + project."""
    e = params["text_embed"][token_ids]
    proj = params["text_proj"]
    return torch.matmul(e.float(), proj.float()).to(proj.dtype)


def codec_embed(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    """[...] int -> [..., hidden] codec-token embedding."""
    return params["codec_embed"][token_ids]


def code_predictor_embed(params: dict, subcode: torch.Tensor, step: int) -> torch.Tensor:
    """Step-indexed sub-codebook embedding: table[step][subcode]."""
    return params["pred_embed"][step][subcode]
