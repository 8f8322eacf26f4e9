"""Training in the PyTorch port, on the CPU, against the JAX package on the
tiny float32 model: ``transformer_forward_nocache`` with a validity mask,
``tts_loss``'s metrics and the gradient of every parameter leaf (the leaves
the loss does not reach included), padding invariance, three AdamW steps
with global-norm clipping against optax, the learning check, and the
refusal of gradients through ``attn_impl="pallas"`` (kernel K8 has none, as
the JAX flash kernel has none)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leaxer_qwen3_tts_tpu.models.layers import transformer_forward_nocache as j_nocache
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_tpu.training import init_train_state as j_init
from leaxer_qwen3_tts_tpu.training import make_optimizer as j_optimizer
from leaxer_qwen3_tts_tpu.training import make_train_step as j_make_step
from leaxer_qwen3_tts_tpu.training import tts_loss as j_loss
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.models.layers import transformer_forward_nocache
from leaxer_qwen3_tts_torch.ops import flash_attention as tflash
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.training import (
    init_train_state,
    make_optimizer,
    make_train_step,
    tts_loss,
)
from leaxer_qwen3_tts_torch.training.train_step import named_leaves

torch.set_num_threads(2)

KEYS = ("text_ids", "text_len", "codes", "num_frames")
LR, CLIP = 1e-3, 0.1  # the tiny model's first gradient norm is ~46: clipping triggers
STEPS = 3


def make_batch(seed, B=2, T=8, F=4):
    """JAX's test batch: num_frames < F, so the EOS target lies inside F."""
    rng = np.random.default_rng(seed)
    return {
        "text_ids": rng.integers(0, 1000, (B, T)),
        "text_len": rng.integers(2, T + 1, (B,)),
        "codes": rng.integers(0, 2048, (B, F, 16)),
        "num_frames": rng.integers(1, F, (B,)),
    }


def jax_batch(b):
    return {k: jnp.asarray(b[k], jnp.int32) for k in KEYS}


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(b[k])) for k in KEYS}


def port_params(params):
    """A fresh torch copy of JAX's params (training updates it in place)."""
    return params_from_jax(flatten_params(jax.device_get(params)))


@pytest.fixture(scope="module")
def model(tiny_model):
    cfg, params = tiny_model
    return cfg, params, tcfg.TTSModelConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def batch():
    return make_batch(0)


@pytest.fixture(scope="module")
def jax_value_and_grad(model, batch):
    """JAX's metrics and the gradient of every leaf, from one compile."""
    cfg, params, _ = model
    jb = jax_batch(batch)

    def loss(p):
        m = j_loss(cfg, p, *(jb[k] for k in KEYS))
        return m.loss, m

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return metrics, flatten_params(jax.device_get(grads))


@pytest.fixture(scope="module")
def port_value_and_grad(model, batch):
    _, params, tc = model
    tp = port_params(params)
    for _, p in named_leaves(tp):
        p.requires_grad_(True)
    m = tts_loss(tc, tp, *torch_batch(batch).values())
    m.loss.backward()
    return m, dict(named_leaves(tp))


@pytest.mark.parametrize("positions", [False, True])
def test_transformer_forward_nocache_matches_jax(model, positions):
    """The talker's stack on random embeds, with pad keys (``valid``) and
    with explicit positions: float32 on both sides, the sums' order aside."""
    cfg, params, tc = model
    rng = np.random.default_rng(1)
    B, S, H = 2, 7, cfg.talker.hidden_size
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[0, 5:] = False
    valid[1, 2] = False
    pos = (np.arange(S)[None] + np.array([[0], [3]])) if positions else None
    want = j_nocache(cfg.talker.transformer, params["talker"]["transformer"], jnp.asarray(x),
                     None if pos is None else jnp.asarray(pos, jnp.int32), jnp.asarray(valid))
    tp = port_params(params)
    got = transformer_forward_nocache(
        tc.talker.transformer, tp["talker"]["transformer"], torch.from_numpy(x),
        None if pos is None else torch.from_numpy(pos), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tts_loss_metrics_match_jax(jax_value_and_grad, port_value_and_grad):
    """All four metrics; the losses to 1e-5 relative (float32, ~3e-7 seen)."""
    jm, _ = jax_value_and_grad
    tm, _ = port_value_and_grad
    for name in ("loss", "talker_loss", "mtp_loss"):
        np.testing.assert_allclose(float(getattr(tm, name).detach()), float(getattr(jm, name)),
                                   rtol=1e-5, err_msg=name)
    assert int(tm.frames) == int(jm.frames)


def test_every_leaf_gradient_matches_jax(jax_value_and_grad, port_value_and_grad):
    """Every leaf's gradient within 1e-4 of the leaf's largest JAX gradient
    (float32: 1.3e-6 seen), a leaf the loss does not reach (vocoder, speaker
    encoder) zero on both sides (the port's .grad None)."""
    _, jgrads = jax_value_and_grad
    _, leaves = port_value_and_grad
    assert set(leaves) == set(jgrads)
    unreached = 0
    for k, p in leaves.items():
        gj = np.asarray(jgrads[k], np.float32)
        scale = float(np.abs(gj).max())
        if p.grad is None:
            assert scale == 0.0, k
            unreached += 1
            continue
        np.testing.assert_allclose(p.grad.numpy(), gj, rtol=0, atol=1e-4 * scale + 1e-12,
                                   err_msg=k)
    assert unreached and all(p.grad is None for k, p in leaves.items()
                             if k.startswith(("vocoder/", "speaker_encoder/")))


def test_loss_finite_and_masked(model):
    """JAX's ``test_loss_finite_and_masked`` on the port: finite, both parts
    near ln(vocab), the frame count, and pad frames that change nothing."""
    _, params, tc = model
    tp = port_params(params)
    b = make_batch(0)
    m = tts_loss(tc, tp, *torch_batch(b).values())
    assert np.isfinite(float(m.loss))
    assert 0 < float(m.talker_loss) < 16.0 and 0 < float(m.mtp_loss) < 16.0
    assert int(m.frames) == int(b["num_frames"].sum())
    b2 = dict(b, codes=np.concatenate([b["codes"], np.zeros((2, 3, 16), np.int64)], axis=1))
    m2 = tts_loss(tc, tp, *torch_batch(b2).values())
    # JAX's own tolerance for the padded batch
    np.testing.assert_allclose(float(m2.loss), float(m.loss), rtol=2e-4)


@pytest.fixture(scope="module")
def jax_steps(model, batch):
    """Three optax steps (clip at CLIP, AdamW at LR): the state and the losses."""
    cfg, params, _ = model
    tx = j_optimizer(learning_rate=LR, grad_clip=CLIP)
    state = j_init(params, tx)
    step = j_make_step(cfg, tx, donate=False)
    jb = jax_batch(batch)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        losses.append(float(m.loss))
    return state, losses


def test_train_steps_match_optax(model, batch, jax_steps, jax_value_and_grad):
    """Three steps of ``make_train_step`` against optax's AdamW after
    ``clip_by_global_norm`` (the gradient norm is past the clip): every
    leaf within 2e-5 absolute of JAX's (each moved ~3e-3; Adam's m / sqrt(v)
    turns float32 gradient differences on near-zero gradients into ~5e-6),
    the losses to 1e-5 relative, the step count equal; a vocoder leaf, which
    the loss does not reach, only decays: p (1 - lr wd)^3."""
    _, params, tc = model
    jstate, jlosses = jax_steps
    _, jgrads = jax_value_and_grad
    norm = float(optax.global_norm(jax.tree.map(jnp.asarray, jgrads)))
    assert norm > CLIP
    tx = make_optimizer(learning_rate=LR, grad_clip=CLIP)
    state = init_train_state(port_params(params), tx)
    step = make_train_step(tc, tx)
    tb = torch_batch(batch)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, tb)
        losses.append(float(m.loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.step == int(jstate.step) == STEPS
    jp = flatten_params(jax.device_get(jstate.params))
    leaves = dict(named_leaves(state.params))
    assert set(leaves) == set(jp)
    for k, p in leaves.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k], np.float32),
                                   rtol=0, atol=2e-5, err_msg=k)
    p0 = dict(named_leaves(port_params(params)))
    voc = next(k for k in leaves if k.startswith("vocoder/"))
    decayed = p0[voc].numpy() * np.float32(1 - LR * 0.01) ** STEPS
    np.testing.assert_allclose(leaves[voc].detach().numpy(), decayed, rtol=1e-6)
    np.testing.assert_allclose(leaves[voc].detach().numpy(), np.asarray(jp[voc]), rtol=1e-6)


def test_train_step_learns(model):
    """JAX's ``test_train_step_learns`` on the port."""
    _, params, tc = model
    tx = make_optimizer(learning_rate=3e-3)
    state = init_train_state(port_params(params), tx)
    step = make_train_step(tc, tx)
    tb = torch_batch(make_batch(1))
    losses = []
    for _ in range(5):
        state, m = step(state, tb)
        losses.append(float(m.loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert state.step == 5


def _pallas(cfg):
    t = cfg.talker
    return dataclasses.replace(cfg, talker=dataclasses.replace(
        t, transformer=dataclasses.replace(t.transformer, attn_impl="pallas")))


def test_pallas_talker_refuses_gradients(model, batch, jax_value_and_grad):
    """A talker with ``attn_impl="pallas"``: ``jax.grad`` through the JAX
    loss raises, the port raises under autograd on the same params, and
    without grad both give the xla loss (K8's plain version and the JAX
    kernel in interpret mode: float32, 1e-5 relative)."""
    cfg, params, tc = model
    jcfg, pcfg = _pallas(cfg), _pallas(tc)
    jb = jax_batch(batch)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda p: j_loss(jcfg, p, *(jb[k] for k in KEYS)).loss)(params)
    jm = j_loss(jcfg, params, *(jb[k] for k in KEYS))

    tb = torch_batch(batch)
    tp = port_params(params)
    m_free = tts_loss(pcfg, tp, *tb.values())  # params that need no grad: serving's case
    for _, p in named_leaves(tp):
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tts_loss(pcfg, tp, *tb.values())
    with torch.no_grad():
        m = tts_loss(pcfg, tp, *tb.values())
    jxla, _ = jax_value_and_grad
    for got in (m, m_free):
        np.testing.assert_allclose(float(got.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(float(got.loss), float(jxla.loss), rtol=1e-5)


def test_flash_attend_refuses_gradients():
    """K8's wrapper raises where autograd records it and q, k or v requires
    grad; under ``torch.no_grad()`` it is the plain version as before."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 3, 4, 16), generator=gen)
    k = torch.randn((1, 2, 5, 16), generator=gen)
    v = torch.randn((1, 2, 5, 16), generator=gen)
    mask = torch.ones((1, 3, 5), dtype=torch.bool)
    want = tflash.flash_attend_reference(q, k, v, mask)
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no gradient"):
            tflash.flash_attend(*args, mask)
        with torch.no_grad():
            assert torch.equal(tflash.flash_attend(*args, mask), want)
    assert torch.equal(tflash.flash_attend(q, k, v, mask), want)
