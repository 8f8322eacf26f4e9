"""Parameters: random init and conversion from the JAX package's flat form.

Port of ``leaxer_qwen3_tts_tpu/runtime/weights.py`` (init and loading side).
:func:`init_params` makes random parameters of the same shapes and dtypes as
the JAX package's ``init_params`` from a seed, with no JAX.
:func:`params_from_jax` takes the JAX ``flatten_params`` form ('/'-joined
keys of numpy arrays of the RAW pytree, as checkpoints store them, the draft
head's included) and returns the port's nested parameter dict.  Inference transforms (fusing,
int8, kernel packs) are applied afterwards by the engine, in the JAX engine's
order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import TTSModelConfig
from ..models.code_predictor import init_code_predictor_params
from ..models.codec12hz import init_vocoder_params
from ..models.draft import init_draft_params
from ..models.embeddings import init_embedding_params
from ..models.talker import init_talker_params


def init_params(cfg: TTSModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random-init parameters (talker, code predictor, embeddings, vocoder,
    and the draft head when ``cfg.draft`` is set) on ``device`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    params = {
        "talker": init_talker_params(cfg.talker, gen, device),
        "code_predictor": init_code_predictor_params(cfg.code_predictor, gen, device),
        "embeddings": init_embedding_params(cfg.talker, cfg.code_predictor, gen, device),
        "vocoder": init_vocoder_params(cfg.vocoder, gen, device),
    }
    if cfg.draft is not None:
        params["draft"] = init_draft_params(cfg.draft, gen, device)
    return params


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # own, writable memory for torch
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(flat: Dict[str, np.ndarray], device="cpu") -> dict:
    """'/'-keyed numpy arrays of the JAX pytree -> nested torch params
    (all-digit key segments become lists, as ``unflatten_params`` does)."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(np.asarray(value), device)

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)
