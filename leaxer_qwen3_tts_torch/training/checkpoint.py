"""Train-state checkpoints: save, restore and find the newest step.

The JAX package writes Orbax directories; this port writes a torch-native
file into the same ``base/step_<N>`` directory layout: ``train_state.pt``
holds the params ('/'-keyed tensors), the optimizer's state dict and the
step.  Restore copies them into a target state of the same structure (a
step-0 state from :func:`~.train_step.init_train_state`, or one placed on a
mesh by :func:`~.train_step.shard_train_state`) on a device.  The file does
not depend on the mesh it was saved on: a data-parallel state keeps its
params whole, so a checkpoint saved on one mesh restores onto another mesh
shape or onto none.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .train_step import TrainState, named_leaves, sync_replicas

STATE_FILE = "train_state.pt"


def save_train_state(path: str, state: TrainState) -> None:
    """Write a training checkpoint directory, atomically: the file goes into
    a temporary directory that is renamed to ``path`` once it is complete."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists")
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp)
    torch.save({
        "params": {k: p.detach().cpu() for k, p in named_leaves(state.params)},
        "opt_state": state.opt_state.state_dict(),
        "step": int(state.step),
    }, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, path)


def restore_train_state(path: str, target: TrainState, device=None) -> TrainState:
    """The state saved at ``path``, copied into ``target``'s params and
    optimizer (same structure) on ``device`` (default: where the target's
    params lie), and into its copies on a mesh's other leads."""
    leaves = dict(named_leaves(target.params))
    if device is None:
        device = next(iter(leaves.values())).device
    saved = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location=device,
                       weights_only=True)
    if set(saved["params"]) != set(leaves):
        raise ValueError(f"checkpoint {path}: its params differ from the target's "
                         f"({sorted(set(saved['params']) ^ set(leaves))[:4]} ...)")
    with torch.no_grad():
        for k, p in leaves.items():
            p.copy_(saved["params"][k])
    target.opt_state.load_state_dict(saved["opt_state"])
    sync_replicas(target)
    return target._replace(step=saved["step"])


def latest_step_dir(base: str) -> Optional[str]:
    """Convention helper: base/step_<N> directories; returns the newest."""
    if not os.path.isdir(base):
        return None
    steps = []
    for name in os.listdir(base):
        if name.startswith("step_") and name[5:].isdigit():
            steps.append((int(name[5:]), os.path.join(base, name)))
    return max(steps)[1] if steps else None
