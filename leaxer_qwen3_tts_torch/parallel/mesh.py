"""Device mesh, the data axis's row split and tensor-parallel sharding rules.

Port of ``leaxer_qwen3_tts_tpu/parallel/mesh.py``.  A :class:`Mesh` is a
numpy object array of ``torch.device``s shaped ``[data, model]`` with the
axis names ``("data", "model")`` and a ``shape`` dict, as JAX's mesh has.
The "model" axis is tensor parallelism: the decode step's per-rank halves
(kernel K9, ``ops/fused_tp.py``) and the sharded MTP chain (kernel K10,
``ops/fused_mtp_tp.py``) run one shard of the attention heads and the MLP
per model rank, on the first data row's devices (:meth:`Mesh.model_devices`).
The "data" axis splits a batch's rows, a pool's slots and a train batch
over the data rows (:meth:`Mesh.data_groups`, :func:`split_rows`), as JAX's
``P("data")`` shards the batch axis: group g holds rows ``[g B/d, (g+1)
B/d)`` on its lead device (the first device of data row g), and a batch
that does not divide over the d rows stays whole on group 0, as JAX's
``P()`` replicates it.

``make_mesh(data, model)`` takes the visible CUDA devices in order, as JAX's
takes ``jax.devices()``, and raises when there are too few; it never lists a
device twice on its own.  A caller may pass ``devices`` that repeat one
device: ``[torch.device("cpu")] * (d * tp)`` on the CPU, ``[torch.device(
"cuda", 0)] * (d * tp)`` on one card.  The mesh then holds ``tp`` logical
shards on that device, each rank with its own packed weights, KV heads and
exchange buffers, so every kernel runs at full width on the one card, as the
JAX package's tests run its mesh on virtual CPU devices; its data groups
share the card and decode one after another.  Over distinct cards the same
code takes one device per rank and per group.

``shard_params`` returns each rank's slice of every leaf a rule shards, on
that rank's device (a list over the model ranks), and every other leaf as
it is.  The engine does not shard its plain path's weights: prefill, lm_head,
embeddings and vocoder run on each group's lead device with the full params
(a standing difference from the JAX engine, which lets GSPMD shard them).
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_NAMES = ("data", "model")


class Mesh:
    """A ``[data, model]`` grid of ``torch.device``s."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...] = AXIS_NAMES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} axes with names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def model_devices(self) -> List[torch.device]:
        """The model ranks' devices (the first data row): rank r on entry r."""
        return self.data_groups()[0]

    def data_groups(self) -> List[List[torch.device]]:
        """Each data row's model devices: group g's ranks on entry g."""
        rows = self.devices.reshape(-1, self.shape.get("model", 1))
        return [[torch.device(d) for d in row] for row in rows]

    def data_leads(self) -> List[torch.device]:
        """Each data group's lead device (its first model rank's): where the
        group's rows run the plain path."""
        return [group[0] for group in self.data_groups()]

    @property
    def lead(self) -> torch.device:
        """The first device: where the plain path runs and the ranks' partial
        sums are reduced."""
        return torch.device(self.devices.flat[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def split_rows(batch: int, data: int) -> List[slice]:
    """The rows each data group holds of a batch axis of ``batch`` rows, as
    JAX's ``P("data")`` shards it: ``data`` slices of ``batch / data`` rows
    where ``data`` divides ``batch``, else the whole batch as group 0's one
    slice (JAX's ``P()``: replicated, so every group computes the same rows
    and the first one's are kept)."""
    if data > 1 and batch % data == 0:
        part = batch // data
        return [slice(g * part, (g + 1) * part) for g in range(data)]
    return [slice(0, batch)]


def row_groups(mesh: Optional["Mesh"], batch: int, default: torch.device
               ) -> List[Tuple[slice, torch.device]]:
    """(rows, lead device) of each data group that holds rows of a batch of
    ``batch`` rows (:func:`split_rows`); without a mesh, the whole batch on
    ``default``."""
    if mesh is None:
        return [(slice(0, batch), torch.device(default))]
    leads = mesh.data_leads()
    return [(rows, leads[g]) for g, rows in enumerate(split_rows(batch, len(leads)))]


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = 1, model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("data", "model") mesh over the visible CUDA devices, or over
    ``devices`` (which may repeat a device: logical shards on it)."""
    if devices is None:
        devices = _visible_devices()
    n = data * model
    if n > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        arr[i] = d
    return Mesh(arr.reshape(data, model))


def auto_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """Mesh using all devices: ``model_parallel``-way TP, rest data-parallel."""
    n = n_devices if n_devices is not None else len(_visible_devices())
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return make_mesh(data=n // model_parallel, model=model_parallel)


# ---------------------------------------------------------------------------
# Tensor-parallel sharding rules, keyed on '/'-joined parameter paths.  Layer
# stacks carry a leading [num_layers] axis, hence the leading None in every
# transformer rule.  A spec is a tuple with one entry per axis of the leaf
# (JAX's PartitionSpec as a tuple): "model" shards that axis over the model
# ranks, None keeps it whole; the empty spec replicates.
# ---------------------------------------------------------------------------


def P(*axes) -> Tuple:
    return tuple(axes)


# (path regex, spec) — first match wins.
TP_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # attention: q/k/v project onto heads (shard out dim), o projects back
    (r".*/layers/wq$", P(None, None, "model")),
    (r".*/layers/wk$", P(None, None, "model")),
    (r".*/layers/wv$", P(None, None, "model")),
    (r".*/layers/wo$", P(None, "model", None)),
    # MLP: gate/up shard out dim, down shards in dim
    (r".*/layers/wg$", P(None, None, "model")),
    (r".*/layers/wu$", P(None, None, "model")),
    (r".*/layers/wd$", P(None, "model", None)),
    # output heads: shard the vocab dim
    (r".*talker/lm_head$", P(None, "model")),
    (r".*code_predictor/heads$", P(None, None, "model")),
    (r".*code_predictor/head$", P(None, "model")),  # shared-head fallback
    # text embedding: shard the embed dim; the projection consumes it sharded
    (r".*embeddings/text_embed$", P(None, "model")),
    (r".*embeddings/text_proj$", P("model", None)),
    # everything else (codec/pred embeds, norms, vocoder, speaker enc): replicate
)


def param_pspec(path: str) -> Tuple:
    for pattern, spec in TP_RULES:
        if re.match(pattern, path):
            return spec
    return P()  # replicate


class Sharding(NamedTuple):
    """Where a leaf lives on the mesh: the mesh and the leaf's spec."""

    mesh: Mesh
    spec: Tuple


def _map_with_path(fn, node, path: str = ""):
    """Apply fn(path, leaf) over a tree of dicts and lists ('/'-joined keys,
    numeric segments for list items, as the JAX package's ``_path_str``);
    any other node is a leaf."""
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in node.items()}
    if isinstance(node, list):
        return [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(node)]
    return fn(path, node)


def param_shardings(mesh: Mesh, params) -> object:
    """Tree of :class:`Sharding` matching ``params`` (TP rules; replicate default)."""
    return _map_with_path(lambda path, leaf: Sharding(mesh, param_pspec(path)), params)


def shard_leaf(mesh: Mesh, leaf: torch.Tensor, spec: Tuple) -> List[torch.Tensor]:
    """Each model rank's slice of ``leaf`` along the axis ``spec`` shards, on
    that rank's device."""
    devs = mesh.model_devices()
    axis = spec.index("model")
    size = leaf.shape[axis]
    if size % len(devs):
        raise ValueError(f"axis {axis} of size {size} does not split over {len(devs)} ranks")
    part = size // len(devs)
    return [leaf.narrow(axis, r * part, part).contiguous().to(d) for r, d in enumerate(devs)]


def shard_params(mesh: Mesh, params):
    """The parameter tree with every rule-sharded tensor leaf as a list of its
    per-rank slices (rank r on the mesh's model device r); other leaves as
    they are."""

    def place(path, leaf):
        spec = param_pspec(path)
        if "model" not in spec or not isinstance(leaf, torch.Tensor):
            return leaf
        return shard_leaf(mesh, leaf, spec)

    return _map_with_path(place, params)
