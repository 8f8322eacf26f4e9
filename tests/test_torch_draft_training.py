"""The draft head's trainer in the PyTorch port, on the CPU, against the JAX
package on the tiny float32 model: ``draft_forward_teacher``, ``draft_loss``
and five Adam steps of ``make_draft_train_step``; then the
``tools/train_draft`` port end to end with ``--device cpu`` on a tiny
checkpoint, and a spec engine on what it wrote, which drafts with the
trained head and still decodes the sequential engine's greedy codes."""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leaxer_qwen3_tts_tpu.config import DraftConfig as JDraftConfig
from leaxer_qwen3_tts_tpu.models import draft as jdraft
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_tpu.training.draft_loss import draft_loss as j_draft_loss
from leaxer_qwen3_tts_tpu.training.draft_loss import make_draft_train_step as j_make_step
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.models import draft as tdraft
from leaxer_qwen3_tts_torch.runtime.weights import load_checkpoint, params_from_jax, save_checkpoint
from leaxer_qwen3_tts_torch.tools.train_draft import main as train_main
from leaxer_qwen3_tts_torch.training.draft_loss import draft_loss, make_draft_train_step
from leaxer_qwen3_tts_torch.training.train_step import adam

torch.set_num_threads(2)

KEYS = ("text_ids", "text_len", "codes", "num_frames")
LR, STEPS = 3e-3, 5
METRICS = ("loss", "step1_loss", "step2_loss", "step1_code0_acc")


def _jdcfg(cfg):
    return JDraftConfig(hidden_size=cfg.talker.transformer.hidden_size, d_model=64,
                        codec_vocab_size=cfg.talker.codec_vocab_size,
                        subcode_vocab_size=cfg.code_predictor.subcode_vocab_size,
                        dtype="float32")


def _to_port(tree):
    return params_from_jax(flatten_params(jax.device_get(tree)))


@pytest.fixture(scope="module")
def model(tiny_model):
    """(JAX cfg, JAX params, JAX draft cfg, JAX draft params, port cfg with
    the draft config, port params)."""
    cfg, params = tiny_model
    jd = _jdcfg(cfg)
    dp = jdraft.init_draft_params(jd, jax.random.PRNGKey(1))
    tc = tcfg.TTSModelConfig.from_json(dataclasses.replace(cfg, draft=jd).to_json())
    return cfg, params, jd, dp, tc, _to_port(params)


@pytest.fixture(scope="module")
def batch():
    """Right-padded frames of two lengths (a pad frame in row 1)."""
    rng = np.random.default_rng(0)
    return {"text_ids": rng.integers(0, 1000, (2, 6)), "text_len": np.array([6, 3]),
            "codes": rng.integers(0, 2048, (2, 7, 16)), "num_frames": np.array([7, 5])}


def test_draft_forward_teacher_matches_jax(model):
    """Both transitions' logits, float32: 1e-5 (the sums' order aside)."""
    cfg, params, jd, dp, tc, tp = model
    rng = np.random.default_rng(2)
    H = cfg.talker.transformer.hidden_size
    h = rng.standard_normal((2, 5, H)).astype(np.float32)
    e = (rng.standard_normal((2, 5, H)) * 0.1).astype(np.float32)
    want = jdraft.draft_forward_teacher(jd, dp, params["embeddings"], jnp.asarray(h),
                                        jnp.asarray(e))
    got = tdraft.draft_forward_teacher(tc.draft, _to_port(dp), tp["embeddings"],
                                       torch.from_numpy(h), torch.from_numpy(e))
    for (g0, gs), (w0, ws), n in zip(got, want, (5, 4)):
        assert g0.shape == (2, n, cfg.talker.codec_vocab_size) and gs.shape[:3] == (2, n, 15)
        np.testing.assert_allclose(g0.numpy(), np.asarray(w0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)


def test_draft_loss_matches_jax(model, batch):
    """Every metric of ``draft_loss``: losses to 1e-5 relative, the accuracy
    and the frame count equal."""
    cfg, params, jd, dp, tc, tp = model
    jm = j_draft_loss(cfg, jd, params, dp, *(jnp.asarray(batch[k], jnp.int32) for k in KEYS))
    m = draft_loss(tc, tc.draft, tp, _to_port(dp), *(torch.from_numpy(batch[k]) for k in KEYS))
    for name in METRICS[:3]:
        np.testing.assert_allclose(float(getattr(m, name)), float(getattr(jm, name)),
                                   rtol=1e-5, err_msg=name)
    assert float(m.step1_code0_acc) == float(jm.step1_code0_acc)
    assert int(m.frames) == int(jm.frames) == 12


def test_draft_adam_steps_match_jax(model, batch):
    """Five steps of ``make_draft_train_step`` with the port's ``adam(lr)``
    against JAX's with ``optax.adam(lr)``: the losses to 1e-5 relative and
    every draft leaf within 2e-5 absolute (each moves ~1.5e-2; Adam's
    normalisation amplifies float32 differences of near-zero gradients), the
    main params untouched and needing no grad."""
    cfg, params, jd, dp, tc, tp = model
    jb = {k: jnp.asarray(batch[k], jnp.int32) for k in KEYS}
    tx = optax.adam(LR)
    jstep = j_make_step(cfg, jd, tx)
    jdp, jopt = dp, tx.init(dp)
    tdp = _to_port(dp)
    ttx = adam(LR)
    topt = ttx.init(tdp)
    tstep = make_draft_train_step(tc, tc.draft, ttx)
    tb = {k: torch.from_numpy(batch[k]) for k in KEYS}
    before = {k: v.clone() for k, v in tp["talker"]["transformer"]["layers"].items()}
    jl, tl = [], []
    for _ in range(STEPS):
        jdp, jopt, jm = jstep(jdp, jopt, params, jb)
        tdp, topt, m = tstep(tdp, topt, tp, tb)
        jl.append(float(jm.loss))
        tl.append(float(m.loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    want = flatten_params(jax.device_get(jdp))
    for k, v in tdp.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]), rtol=0, atol=2e-5,
                                   err_msg=k)
    for k, v in tp["talker"]["transformer"]["layers"].items():
        assert torch.equal(v, before[k]) and not v.requires_grad


@pytest.fixture(scope="module")
def trained(tiny_model, tiny_vocab_files, tmp_path_factory):
    """The tool run on a tiny checkpoint (the port's writer, the tokenizer
    beside it): (source dir, output dir, rc, JSON report)."""
    cfg, params = tiny_model
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    base = tmp_path_factory.mktemp("train_draft")
    d, out = str(base / "ckpt"), str(base / "ckpt_draft")
    save_checkpoint(d, tc, _to_port(params))
    vocab_path, merges_path, _ = tiny_vocab_files
    shutil.copy(vocab_path, os.path.join(d, "vocab.json"))
    shutil.copy(merges_path, os.path.join(d, "merges.txt"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_main(["--model", d, "--out", out, "--steps", "40", "--frames", "8",
                         "--d-model", "32", "--device", "cpu"])
    return d, out, rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_train_draft_tool_end_to_end(trained):
    """rc 0, JAX's report keys, the loss falling, and a checkpoint that
    carries the draft (config and params) and the tokenizer files."""
    d, out, rc, report = trained
    assert rc == 0
    assert set(report) == {"rollouts", "frames", "steps", "loss_before", "loss_after",
                           "step1_code0_acc", "out"}
    assert report["out"] == out and report["steps"] == 40 and report["rollouts"] >= 1
    assert report["loss_after"] < report["loss_before"]
    cfg2, params2 = load_checkpoint(out)
    assert cfg2.draft is not None and cfg2.draft.d_model == 32 and cfg2.draft.dtype == "float32"
    assert set(params2["draft"]) == {"w_in", "w_rec", "head0", "heads_sub", "ln_in", "ln_rec"}
    assert os.path.exists(os.path.join(out, "vocab.json"))
    assert os.path.exists(os.path.join(out, "merges.txt"))
    assert "draft" not in load_checkpoint(d)[1]


def test_spec_engine_on_trained_checkpoint(trained, monkeypatch):
    """A spec engine on the written checkpoint drafts with the trained head
    (``draft_predict`` runs) and its greedy codes equal the sequential
    engine's on the source checkpoint."""
    d, out, rc, _ = trained
    assert rc == 0
    calls = []
    real = tdraft.draft_predict
    monkeypatch.setattr(tdraft, "draft_predict", lambda *a: (calls.append(1), real(*a))[1])
    eng = TTSEngine(out, device="cpu", max_frames=8, chunk_len=4, spec_k=3, spec_iters=2)
    assert eng.is_ready(), eng.get_error()
    assert eng.cfg.draft is not None and "draft" in eng.params
    seq = TTSEngine(d, device="cpu", max_frames=8, chunk_len=4)
    a = seq.synthesize("hello world", temperature=0.0, seed=5)
    b = eng.synthesize("hello world", temperature=0.0, seed=5)
    assert calls
    np.testing.assert_array_equal(np.asarray(b.codes), np.asarray(a.codes))
