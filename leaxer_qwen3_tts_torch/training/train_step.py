"""Training step: AdamW with global-norm clipping over the TTS loss.

Port of ``leaxer_qwen3_tts_tpu/training/train_step.py`` for one device.  The
JAX step is a jitted optax update over a mesh; here the parameters are
updated in place by a ``torch.optim`` optimizer (so JAX's buffer donation
has no counterpart), with optax's arithmetic where the two differ:

* clipping by the global norm scales every gradient by max_norm / norm when
  norm >= max_norm, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
  1e-6); the norm is summed in float32;
* AdamW updates every leaf: a leaf the loss does not reach (the vocoder, the
  speaker encoder, a draft head) gets a zero gradient and still decays by
  lr * wd * p, where ``torch.optim`` would skip a leaf whose ``.grad`` is None;
* Adam's moments are kept in the parameter dtype (optax's ``mu_dtype=None``).

GSPMD placement over a mesh (JAX's ``shard_train_state`` and
``batch_sharding``) is not ported.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import torch

from ..config import TTSModelConfig
from ..runtime.weights import _leaves
from .loss import LossMetrics, tts_loss


def named_leaves(params) -> Iterator[Tuple[str, torch.Tensor]]:
    """('/'-joined key, tensor) of every floating-point leaf of a nested
    parameter dict, in a fixed order (the optimizer's and the checkpoint's):
    the checkpoint files' keys."""
    return ((k, p) for k, p in _leaves(params)
            if isinstance(p, torch.Tensor) and p.is_floating_point())


def param_leaves(params) -> List[torch.Tensor]:
    """The floating-point tensors of a nested parameter dict, in
    :func:`named_leaves`' order."""
    return [p for _, p in named_leaves(params)]


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place and with no host sync: where
    the global norm (summed in float32) is at least ``max_norm``, each
    gradient becomes g / norm * max_norm (norm cast to g's dtype first, as
    optax casts it)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class Optimizer(NamedTuple):
    """The update rule: optax's ``chain(clip_by_global_norm(grad_clip),
    adamw(...))`` (:func:`make_optimizer`) or ``adam(lr)`` (:func:`adam`)."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None

    def init(self, params) -> torch.optim.Optimizer:
        """The optimizer state over ``params``' leaves, which from now on
        require grad and are updated in place."""
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
                                 eps=self.eps, weight_decay=self.weight_decay)

    def apply(self, opt: torch.optim.Optimizer) -> None:
        """One update from the gradients that backward left on the leaves."""
        leaves = [p for group in opt.param_groups for p in group["params"]]
        for p in leaves:
            if p.grad is None:  # a leaf the loss does not reach still decays
                p.grad = torch.zeros_like(p)
        if self.grad_clip is not None:
            clip_by_global_norm_([p.grad for p in leaves], self.grad_clip)
        opt.step()


def make_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> Optimizer:
    return Optimizer(learning_rate=learning_rate, b1=b1, b2=b2, weight_decay=weight_decay,
                     grad_clip=grad_clip)


def adam(learning_rate: float) -> Optimizer:
    """optax's ``adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8, no decay."""
    return Optimizer(learning_rate=learning_rate)


class TrainState(NamedTuple):
    params: dict
    opt_state: torch.optim.Optimizer
    step: int


def init_train_state(params: dict, tx: Optimizer) -> TrainState:
    """Step 0 over ``params``, which the state then owns (updated in place)."""
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def make_train_step(
    cfg: TTSModelConfig,
    tx: Optimizer,
    lang_id: Optional[int] = None,
    mtp_weight: float = 1.0,
) -> Callable[[TrainState, dict], Tuple[TrainState, LossMetrics]]:
    """``train_step(state, batch) -> (state, LossMetrics)``.

    batch: dict(text_ids [B, T] int, text_len [B] int, codes [B, F, 16] int,
    num_frames [B] int), on the params' device."""

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, LossMetrics]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            m = tts_loss(cfg, state.params, batch["text_ids"], batch["text_len"],
                         batch["codes"], batch["num_frames"], lang_id=lang_id,
                         mtp_weight=mtp_weight)
            m.loss.backward()
        tx.apply(opt)
        return (TrainState(state.params, opt, state.step + 1),
                LossMetrics(*(x.detach() for x in m)))

    return step
