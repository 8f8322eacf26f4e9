"""Train-state checkpoints in the PyTorch port, on the CPU (JAX's
``test_train_checkpoint.py`` on the port): a run restored from step 2
continues exactly as the uninterrupted run, the newest ``step_<N>``
directory, and the checks on the target's structure and on an existing
directory."""

import jax
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.training import init_train_state, make_optimizer, make_train_step
from leaxer_qwen3_tts_torch.training.checkpoint import (
    latest_step_dir,
    restore_train_state,
    save_train_state,
)
from leaxer_qwen3_tts_torch.training.train_step import named_leaves

torch.set_num_threads(2)


def make_batch(seed, B=2, T=8, F=4):
    rng = np.random.default_rng(seed)
    return {
        "text_ids": torch.from_numpy(rng.integers(0, 1000, (B, T))),
        "text_len": torch.from_numpy(rng.integers(2, T + 1, (B,))),
        "codes": torch.from_numpy(rng.integers(0, 2048, (B, F, 16))),
        "num_frames": torch.from_numpy(rng.integers(1, F, (B,))),
    }


@pytest.fixture(scope="module")
def model(tiny_model):
    cfg, params = tiny_model
    flat = flatten_params(jax.device_get(params))
    return tcfg.TTSModelConfig.from_json(cfg.to_json()), lambda: params_from_jax(flat)


def test_save_restore_resume(model, tmp_path):
    """Two steps, save, then a third step directly and from a restored fresh
    state: the same loss and every leaf and Adam moment equal bit for bit
    (the same CPU arithmetic on the same values)."""
    cfg, fresh = model
    tx = make_optimizer(learning_rate=1e-3)
    step = make_train_step(cfg, tx)
    batch = make_batch(0)
    state = init_train_state(fresh(), tx)
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt = str(tmp_path / "ckpts" / "step_2")
    save_train_state(ckpt, state)

    cont, m_direct = step(state, batch)
    restored = restore_train_state(ckpt, init_train_state(fresh(), tx))
    assert restored.step == 2
    resumed, m_resumed = step(restored, batch)
    assert resumed.step == cont.step == 3
    assert float(m_resumed.loss) == float(m_direct.loss)
    a, b = dict(named_leaves(cont.params)), dict(named_leaves(resumed.params))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = cont.opt_state.state_dict()["state"], resumed.opt_state.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][name], sb[i][name]), (i, name)


def test_restore_refuses_another_structure(model, tmp_path):
    """A target without one of the saved leaves, and a second save into an
    existing directory, raise."""
    cfg, fresh = model
    tx = make_optimizer()
    state = init_train_state(fresh(), tx)
    ckpt = str(tmp_path / "step_0")
    save_train_state(ckpt, state)
    with pytest.raises(FileExistsError):
        save_train_state(ckpt, state)
    other = fresh()
    del other["vocoder"]
    with pytest.raises(ValueError, match="params differ"):
        restore_train_state(ckpt, init_train_state(other, tx))


def test_latest_step_dir(tmp_path):
    base = tmp_path / "runs"
    assert latest_step_dir(str(base)) is None
    for n in (1, 10, 2):
        (base / f"step_{n}").mkdir(parents=True)
    (base / "not_a_step").mkdir()
    assert latest_step_dir(str(base)).endswith("step_10")
