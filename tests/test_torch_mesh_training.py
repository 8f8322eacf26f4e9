"""The port's data-parallel train step on a mesh, on the CPU: against JAX's
``shard_train_state`` / ``batch_sharding`` step on ``make_mesh(2, 2)`` over
virtual CPU devices (JAX's own tolerances for its sharded step against one
device), against the port's one-device step, on a batch whose data groups
hold unequal real frames (the loss is one masked mean over the whole batch,
not a mean of the groups' means), and a train checkpoint saved at (2, 2)
restored at (4, 1) and without a mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.parallel import make_mesh as jmake_mesh
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_tpu.training import batch_sharding as j_batch_sharding
from leaxer_qwen3_tts_tpu.training import init_train_state as j_init
from leaxer_qwen3_tts_tpu.training import make_optimizer as j_optimizer
from leaxer_qwen3_tts_tpu.training import make_train_step as j_make_step
from leaxer_qwen3_tts_tpu.training import shard_train_state as j_shard
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.parallel import make_mesh
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.training import (
    batch_sharding,
    init_train_state,
    make_optimizer,
    make_train_step,
    shard_train_state,
    tts_loss,
)
from leaxer_qwen3_tts_torch.training.checkpoint import restore_train_state, save_train_state
from leaxer_qwen3_tts_torch.training.train_step import named_leaves

torch.set_num_threads(2)

CPU = torch.device("cpu")
KEYS = ("text_ids", "text_len", "codes", "num_frames")
LR = 1e-3
SAME = 2e-5  # the mesh step against the one-device step: sums of groups' sums


def make_batch(seed, B=4, T=8, F=4):
    """JAX's test batch: num_frames < F, so the EOS target lies inside F."""
    rng = np.random.default_rng(seed)
    return {
        "text_ids": rng.integers(0, 1000, (B, T)),
        "text_len": rng.integers(2, T + 1, (B,)),
        "codes": rng.integers(0, 2048, (B, F, 16)),
        "num_frames": rng.integers(1, F, (B,)),
    }


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(b[k])) for k in KEYS}


def _mesh(d, m):
    return make_mesh(d, m, devices=[CPU] * (d * m))


@pytest.fixture(scope="module")
def model(tiny_model):
    cfg, params = tiny_model
    flat = flatten_params(jax.device_get(params))
    return cfg, params, tcfg.TTSModelConfig.from_json(cfg.to_json()), (
        lambda: params_from_jax(flat))


def _leaf(params, path):
    node = params
    for k in path.split("/"):
        node = node[k]
    return node


def test_data_parallel_step_matches_jax_sharded(model):
    """One step at (2, 2) against JAX's sharded step at make_mesh(2, 2) on
    the same batch of 4: loss within 2e-3 relative, the updated wq (TP
    sharded in JAX) and lm_head within 5e-3 (JAX's
    ``test_sharded_train_step_matches_single``)."""
    cfg, params, tc, fresh = model
    batch = make_batch(2)
    jm = jmake_mesh(2, 2, devices=jax.devices()[:4])
    jtx = j_optimizer(learning_rate=LR)
    with jax.set_mesh(jm):
        jstate = j_shard(jm, j_init(params, jtx), jtx)
        jb = jax.device_put({k: jnp.asarray(batch[k], jnp.int32) for k in KEYS},
                            j_batch_sharding(jm))
        jstate, jm_ = j_make_step(cfg, jtx, donate=False)(jstate, jb)
    tx = make_optimizer(learning_rate=LR)
    state = shard_train_state(_mesh(2, 2), init_train_state(fresh(), tx), tx)
    assert set(batch_sharding(state.mesh)) == set(KEYS)
    state, m = make_train_step(tc, tx)(state, torch_batch(batch))
    np.testing.assert_allclose(float(m.loss), float(jm_.loss), rtol=2e-3)
    assert int(m.frames) == int(batch["num_frames"].sum())
    for path in ("talker/transformer/layers/wq", "talker/lm_head"):
        got = _leaf(state.params, path).detach().numpy()
        want = np.asarray(jax.device_get(_leaf(jstate.params, path)))
        np.testing.assert_allclose(got, want, atol=5e-3, err_msg=path)


def _step_and_grads(tc, state, tx, batch):
    state, m = make_train_step(tc, tx)(state, batch)
    return state, m, {k: p.grad.clone() for k, p in named_leaves(state.params)
                      if p.grad is not None}


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_data_parallel_step_equals_one_device(model, shape):
    """The mesh step's loss, its parts and every leaf's (clipped) gradient
    equal the one-device step's within 2e-5: the same rows, summed by
    group."""
    _, _, tc, fresh = model
    batch = torch_batch(make_batch(3))
    tx = make_optimizer(learning_rate=LR)
    _, m1, g1 = _step_and_grads(tc, init_train_state(fresh(), tx), tx, batch)
    state = shard_train_state(_mesh(*shape), init_train_state(fresh(), tx), tx)
    assert state.step == 0 and list(state.replicas) == [CPU]  # one copy on the one device
    state, m2, g2 = _step_and_grads(tc, state, tx, batch)
    assert state.step == 1 and state.mesh is not None
    for a, b in zip(m1[:3], m2[:3]):
        np.testing.assert_allclose(float(b), float(a), rtol=SAME)
    assert int(m1.frames) == int(m2.frames)
    assert g1.keys() == g2.keys()
    for k in g1:
        scale = float(g1[k].abs().max()) or 1.0
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=SAME,
                                   atol=SAME * scale, err_msg=k)


def test_unequal_group_frames_take_the_whole_batch_mean(model):
    """Group 0's rows hold 3 real frames each and group 1's one: the mesh
    loss is the one-device loss (one masked mean), where the mean of the
    two groups' means is off by more than ten times the tolerance."""
    _, _, tc, fresh = model
    batch = make_batch(4)
    batch["num_frames"] = np.array([3, 3, 1, 1])
    tb = torch_batch(batch)
    params = fresh()
    with torch.no_grad():
        whole = tts_loss(tc, params, *(tb[k] for k in KEYS))
        halves = [tts_loss(tc, params, *(tb[k][rows] for k in KEYS))
                  for rows in (slice(0, 2), slice(2, 4))]
    tx = make_optimizer(learning_rate=LR)
    state = shard_train_state(_mesh(2, 1), init_train_state(params, tx), tx)
    _, m = make_train_step(tc, tx)(state, tb)
    for part in ("loss", "talker_loss", "mtp_loss"):
        got, want = float(getattr(m, part)), float(getattr(whole, part))
        of_means = np.mean([float(getattr(h, part)) for h in halves])
        np.testing.assert_allclose(got, want, rtol=SAME, err_msg=part)
        assert abs(of_means - want) > 10 * SAME * abs(want), (part, of_means, want)


def test_mesh_checkpoint_restores_onto_other_shapes(model, tmp_path):
    """A state saved after one step at (2, 2) restores at (4, 1) and without
    a mesh (JAX's ``test_restore_onto_different_mesh_topology``): the step
    count, and the next step's loss and lm_head, equal the uninterrupted
    run's."""
    _, _, tc, fresh = model
    batch = torch_batch(make_batch(1, B=8))
    tx = make_optimizer(learning_rate=LR)
    step = make_train_step(tc, tx)
    state = shard_train_state(_mesh(2, 2), init_train_state(fresh(), tx), tx)
    state, _ = step(state, batch)
    ckpt = str(tmp_path / "xt" / "step_1")
    save_train_state(ckpt, state)
    ref, m_ref = step(state, batch)
    ref_lm = ref.params["talker"]["lm_head"].detach().clone()
    targets = {
        "(4, 1)": shard_train_state(_mesh(4, 1), init_train_state(fresh(), tx), tx),
        "no mesh": init_train_state(fresh(), tx),
    }
    for name, target in targets.items():
        restored = restore_train_state(ckpt, target)
        assert restored.step == 1 and restored.mesh is target.mesh, name
        resumed, m = step(restored, batch)
        np.testing.assert_allclose(float(m.loss), float(m_ref.loss), rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(resumed.params["talker"]["lm_head"].detach().numpy(),
                                   ref_lm.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
