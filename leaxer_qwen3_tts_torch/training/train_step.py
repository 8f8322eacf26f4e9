"""Training step: AdamW with global-norm clipping over the TTS loss.

Port of ``leaxer_qwen3_tts_tpu/training/train_step.py``.  The JAX step is a
jitted optax update over a mesh; here the parameters are updated in place by
a ``torch.optim`` optimizer (so JAX's buffer donation has no counterpart),
with optax's arithmetic where the two differ:

* clipping by the global norm scales every gradient by max_norm / norm when
  norm >= max_norm, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
  1e-6); the norm is summed in float32;
* AdamW updates every leaf: a leaf the loss does not reach (the vocoder, the
  speaker encoder, a draft head) gets a zero gradient and still decays by
  lr * wd * p, where ``torch.optim`` would skip a leaf whose ``.grad`` is None;
* Adam's moments are kept in the parameter dtype (optax's ``mu_dtype=None``).

Over a mesh (:func:`shard_train_state`, :func:`batch_sharding`) the step is
data-parallel: the batch's rows are split over the data groups as JAX's
``P("data")`` splits them (``parallel.split_rows``; a batch that does not
divide stays on group 0), each group computes its loss terms and their
gradients on its lead device, and the terms are combined into the loss over
the whole batch (masked sums over counts, ``loss.loss_from_terms``), whose
gradients are summed onto the first lead's params; the clip and the AdamW
update then run once there, and the params are copied to each other
distinct lead.  The params stay whole on every group where JAX shards them
over "model" by the TP rules: the same values in another placement.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import torch

from ..config import TTSModelConfig
from ..parallel import Mesh, Sharding, split_rows
from ..runtime.weights import _leaves
from .loss import LossMetrics, loss_from_terms, tts_loss, tts_loss_terms

BATCH_KEYS = ("text_ids", "text_len", "codes", "num_frames")


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
    mesh: Optional[Mesh] = None  # a data-parallel placement (shard_train_state)
    replicas: Optional[dict] = None  # lead device -> its params (the first lead's: params)


def init_train_state(params: dict, tx: Optimizer) -> TrainState:
    """Step 0 over ``params``, which the state then owns (updated in place)."""
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def _moved(node, device):
    """The parameter tree on ``device``: a leaf already there is kept, any
    other is copied (detached: a new leaf)."""
    if isinstance(node, dict):
        return {k: _moved(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_moved(v, device) for v in node)
    if isinstance(node, torch.Tensor) and node.device != torch.device(device):
        return node.detach().to(device)
    return node


def shard_train_state(mesh: Mesh, state: TrainState, tx: Optimizer) -> TrainState:
    """The state placed on ``mesh`` for the data-parallel step (JAX's
    ``shard_train_state``): the params whole on the first data group's lead
    and a copy on each other distinct lead (one card listed d x m times
    holds one), the optimizer's moments re-initialised on the placed params,
    as JAX re-initialises them (so only at step 0 or right after a restore,
    which re-places the state anyway)."""
    leads = mesh.data_leads()
    params = _moved(state.params, leads[0])
    replicas = {leads[0]: params}
    for lead in leads[1:]:
        if lead not in replicas:
            replicas[lead] = _moved(params, lead)
            for p in param_leaves(replicas[lead]):
                p.requires_grad_(True)
    return TrainState(params=params, opt_state=tx.init(params), step=state.step, mesh=mesh,
                      replicas=replicas)


def batch_sharding(mesh: Mesh) -> dict:
    """Where each batch entry lives on ``mesh`` (JAX's ``batch_sharding``):
    the batch axis over "data"; the data-parallel step splits the rows so."""
    return {k: Sharding(mesh, ("data",)) for k in BATCH_KEYS}


def sync_replicas(state: TrainState) -> None:
    """Copy the first lead's params to every other distinct lead."""
    if not state.replicas:
        return
    src = param_leaves(state.params)
    with torch.no_grad():
        for params in state.replicas.values():
            if params is not state.params:
                for a, b in zip(src, param_leaves(params)):
                    b.copy_(a)


def make_train_step(
    cfg: TTSModelConfig,
    tx: Optimizer,
    lang_id: Optional[int] = None,
    mtp_weight: float = 1.0,
) -> Callable[[TrainState, dict], Tuple[TrainState, LossMetrics]]:
    """``train_step(state, batch) -> (state, LossMetrics)``.

    batch: dict(text_ids [B, T] int, text_len [B] int, codes [B, F, 16] int,
    num_frames [B] int), on the params' device."""

    def loss(state: TrainState, batch: dict) -> LossMetrics:
        if state.mesh is None:
            return tts_loss(cfg, state.params, *(batch[k] for k in BATCH_KEYS),
                            lang_id=lang_id, mtp_weight=mtp_weight)
        # data-parallel: each group's terms on its lead, one loss over all rows
        leads = state.mesh.data_leads()
        terms = []
        for g, rows in enumerate(split_rows(int(batch["text_ids"].shape[0]), len(leads))):
            part = [batch[k][rows].to(leads[g]) for k in BATCH_KEYS]
            terms.append(tts_loss_terms(cfg, state.replicas[leads[g]], *part, lang_id=lang_id))
        return loss_from_terms(terms, mtp_weight)

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, LossMetrics]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            m = loss(state, batch)
            m.loss.backward()
        if state.replicas:
            # the other leads' gradients summed onto the first lead's
            leaves = param_leaves(state.params)
            for params in state.replicas.values():
                if params is state.params:
                    continue
                for a, b in zip(leaves, param_leaves(params)):
                    if b.grad is not None:
                        g = b.grad.to(a.device)
                        a.grad = g if a.grad is None else a.grad + g
                        b.grad = None
        tx.apply(opt)
        sync_replicas(state)
        return (state._replace(opt_state=opt, step=state.step + 1),
                LossMetrics(*(x.detach() for x in m)))

    return step
