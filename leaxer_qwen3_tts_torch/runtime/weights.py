"""Parameters: random init, checkpoints, and conversion from the JAX package's
flat form.

Port of ``leaxer_qwen3_tts_tpu/runtime/weights.py``.  :func:`init_params`
makes random parameters of the same shapes and dtypes as the JAX package's
``init_params`` from a seed, with no JAX.  A checkpoint directory holds
``config.json`` and ``params.npz`` (or ``params.safetensors``) with
'/'-joined flat keys, list indices as digit segments: :func:`save_checkpoint`
writes the files the JAX package writes for the same parameters, and
:func:`load_checkpoint` reads them back, or reads a directory the JAX package
wrote.  :func:`params_from_jax` takes the JAX ``flatten_params`` form
('/'-keyed numpy arrays of the RAW pytree, as checkpoints store them, the
draft head's included) and returns the port's nested parameter dict.
Inference transforms (fusing, int8, kernel packs) are applied afterwards by
the engine, in the JAX engine's order.

bf16 on disk: ``np.savez`` keeps a bf16 array (an ``ml_dtypes`` array, as
JAX hands them to numpy) only as the two-byte void type ``|V2``, and any
reader gets ``|V2`` back.  So both packages' npz files hold bf16 as its bits
under ``|V2``, and the loader here reads ``|V2`` as bf16.
"""

from __future__ import annotations

import os
import struct
import zipfile
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..config import TTSModelConfig
from ..models.code_predictor import init_code_predictor_params
from ..models.codec12hz import init_vocoder_params
from ..models.draft import init_draft_params
from ..models.embeddings import init_embedding_params
from ..models.speaker_encoder import init_speaker_encoder_params
from ..models.talker import init_talker_params

CONFIG_FILE = "config.json"
WEIGHTS_NPZ = "params.npz"
WEIGHTS_SAFETENSORS = "params.safetensors"
_BF16_DISK = np.dtype("V2")  # how npz keeps a bf16 array


def init_params(cfg: TTSModelConfig, seed: int = 0, device="cpu",
                with_speaker_encoder: bool = True) -> dict:
    """Random-init parameters (talker, code predictor, embeddings, vocoder,
    the draft head when ``cfg.draft`` is set, and the speaker encoder when
    ``cfg.speaker_encoder`` is set and ``with_speaker_encoder``) on
    ``device`` from ``seed``.  The speaker encoder draws last, so the other
    modules' values do not depend on it."""
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
    if with_speaker_encoder and cfg.speaker_encoder is not None:
        params["speaker_encoder"] = init_speaker_encoder_params(cfg.speaker_encoder, gen, device)
    return params


def param_count(params) -> int:
    """The number of values in ``params`` (read from the shapes: nothing is
    copied off the device)."""
    return sum(int(np.prod(np.shape(x))) for _, x in _leaves(params))


# ---------------------------------------------------------------------------
# Flatten / unflatten with '/'-joined keys (lists use numeric segments)
# ---------------------------------------------------------------------------


def _leaves(params, prefix: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], params


def _to_numpy(x) -> np.ndarray:
    """A leaf as numpy: a bf16 tensor as its bits under ``|V2``, as npz
    keeps a bf16 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(_BF16_DISK)
        return x.numpy()
    return np.asarray(x)


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested params (tensors or arrays) -> {'/'-joined key: numpy array}."""
    return {k: _to_numpy(v) for k, v in _leaves(params, prefix)}


def unflatten_params(flat: Dict[str, object]):
    """{'/'-joined key: leaf} -> nested dict, all-digit levels as lists."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _to_tensor(a: np.ndarray, device, key: str = "", copy: bool = True) -> torch.Tensor:
    """A numpy array as a tensor on ``device``: ``|V2`` and ``ml_dtypes``
    bfloat16 become bf16 through their bits; any other void type raises.
    ``copy=False`` lets the tensor share a C-contiguous, writable array."""
    bf16 = a.dtype.kind == "V" or a.dtype.name == "bfloat16"
    if a.dtype.name != "bfloat16" and a.dtype.kind == "V" and (
            a.dtype != _BF16_DISK or a.dtype.names is not None):
        raise ValueError(f"parameter {key!r}: unknown void dtype {a.dtype.str!r} "
                         "(only |V2, the bits of bf16, is read)")
    if bf16:
        a = a.view(np.int16)
    if copy or not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, copy=True, order="C")  # own, writable memory for torch
    t = torch.from_numpy(a)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def params_from_jax(flat: Dict[str, np.ndarray], device="cpu") -> dict:
    """'/'-keyed numpy arrays of the JAX pytree -> nested torch params
    (all-digit key segments become lists, as ``unflatten_params`` does)."""
    return unflatten_params({k: _to_tensor(np.asarray(v), device, k) for k, v in flat.items()})


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------


def save_checkpoint(model_dir: str, cfg: TTSModelConfig, params, fmt: str = "npz") -> None:
    """Write ``config.json`` and the flat parameters (``fmt`` "npz" or
    "safetensors") into ``model_dir``."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, CONFIG_FILE), "w") as f:
        f.write(cfg.to_json())
    if fmt == "npz":
        np.savez(os.path.join(model_dir, WEIGHTS_NPZ), **flatten_params(params))
    elif fmt == "safetensors":
        from safetensors.torch import save_file  # bf16 as BF16, as JAX's writer stores it

        save_file({k: v.detach().cpu().contiguous() if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(v)) for k, v in _leaves(params)},
                  os.path.join(model_dir, WEIGHTS_SAFETENSORS))
    else:
        raise ValueError(f"unknown checkpoint format {fmt!r}")


def load_config(model_dir: str) -> TTSModelConfig:
    with open(os.path.join(model_dir, CONFIG_FILE)) as f:
        return TTSModelConfig.from_json(f.read())


def _npz_arrays(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(key, array) of each member of an npz, in file order, as ``np.load``
    gives them.  A stored member (``np.savez``'s, both packages' writer) is
    read straight from the file at its data offset (``np.fromfile``: ~7x
    ``np.load``'s chunked reads through ``zipfile``, which also check each
    member's CRC-32; this path does not); a compressed one goes through
    ``zipfile``.  No pickled member is read."""
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        for info in zf.infolist():
            key = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as fp:
                    yield key, np.lib.format.read_array(fp, allow_pickle=False)
                continue
            raw.seek(info.header_offset)
            head = raw.read(30)  # the local file header: its name and extra lengths at 26
            if len(head) != 30 or head[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: member {info.filename!r} has no local header")
            n_name, n_extra = struct.unpack("<HH", head[26:30])
            raw.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(raw)
            shape, fortran, dtype = (np.lib.format.read_array_header_1_0(raw) if version == (1, 0)
                                     else np.lib.format.read_array_header_2_0(raw))
            if dtype.hasobject:
                raise ValueError(f"{path}: member {key!r} holds Python objects")
            count = int(np.prod(shape))
            a = np.fromfile(raw, dtype=dtype, count=count)
            if a.size != count:
                raise ValueError(f"{path}: member {key!r} is truncated")
            yield key, a.reshape(shape[::-1]).T if fortran else a.reshape(shape)


def load_checkpoint(model_dir: str) -> Tuple[TTSModelConfig, dict]:
    """(config, params) from a model directory written by
    :func:`save_checkpoint` or by the JAX package; the tensors lie on the
    CPU.  The npz members are read and converted one at a time
    (:func:`_npz_arrays`), so the host holds one member twice at most."""
    cfg = load_config(model_dir)
    npz_path = os.path.join(model_dir, WEIGHTS_NPZ)
    st_path = os.path.join(model_dir, WEIGHTS_SAFETENSORS)
    flat = {}
    if os.path.exists(npz_path):
        for k, a in _npz_arrays(npz_path):
            flat[k] = _to_tensor(a, "cpu", k, copy=False)
    elif os.path.exists(st_path):
        from safetensors.torch import load_file  # reads BF16 with no ml_dtypes

        flat = load_file(st_path)
    else:
        raise FileNotFoundError(f"no {WEIGHTS_NPZ} or {WEIGHTS_SAFETENSORS} in {model_dir}")
    return cfg, unflatten_params(flat)


def model_dir_is_checkpoint(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, CONFIG_FILE)) and (
        os.path.exists(os.path.join(model_dir, WEIGHTS_NPZ))
        or os.path.exists(os.path.join(model_dir, WEIGHTS_SAFETENSORS))
    )
