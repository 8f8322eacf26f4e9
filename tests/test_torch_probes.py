"""Probes P1 and P2 of the PyTorch port, on the CPU: each arm's plain version
against the JAX probe's kernel in interpret mode at the reduced sizes the
JAX probe's own interpret branch uses (P1: U=4 units, S=2 steps, one call;
P2: U=2 units, P=2 passes), set as module attributes."""

import numpy as np
import pytest
import torch

import tools.a8_probe as ja8
import tools.w8a8_probe as jw8
from leaxer_qwen3_tts_torch.tools import a8_probe as ta8
from leaxer_qwen3_tts_torch.tools import w8a8_probe as tw8

torch.set_num_threads(2)

# The JAX kernels' dots and the plain versions' products sum in other orders
# (~1e-7 relative); a last-bit difference can flip the bf16 rounding of one
# activation (2^-8 relative) or an a8 / w8a8 quantisation step (1/127), which
# the next units carry on.  Over 8 (P1) or 4 (P2) units that stays well below
# 1e-3 of the largest output; a wrong scale, sign, fold or quantisation moves
# the outputs by O(1).
REL_TOL = 1e-3


@pytest.fixture
def small_p1(monkeypatch):
    monkeypatch.setattr(ja8, "INTERPRET", True)
    monkeypatch.setattr(ja8, "U", 4)
    monkeypatch.setattr(ja8, "S", 2)
    monkeypatch.setattr(ja8, "N_CALLS", 1)


def _rows(w: np.ndarray) -> torch.Tensor:
    """JAX [n_u, K, NW] units -> the kernel's [n_u, NW, K] rows."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, 1, 2)))


@pytest.mark.parametrize("arm", ta8.ARMS)
def test_a8_probe_arm_matches_jax(small_p1, arm):
    fn, (w, s), _ = ja8.build(arm)
    rows = ta8.rows(arm)
    x0 = np.full((rows, ta8.H), 0.1, np.float32)
    want = np.asarray(fn(w, s, x0))
    wt = _rows(np.asarray(w.astype(np.float32) if arm == "bf16" else w))
    if arm == "bf16":
        wt = wt.to(torch.bfloat16)  # exact: the values are bf16
    got = ta8.chain(arm, wt, torch.from_numpy(np.asarray(s)[:, 0]), torch.from_numpy(x0), steps=2)
    assert got.shape == want.shape == (rows, ta8.H)
    rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert rel < REL_TOL, (arm, rel)


@pytest.mark.parametrize("arm", ["conv", "w2048"])
def test_a8_probe_weights_are_the_jax_probes(small_p1, arm):
    """make_weights draws the JAX probe's int8 units (same seed and calls)."""
    _, (w, s), _ = ja8.build(arm)
    wt, st = ta8.make_weights(arm, units=4)
    assert torch.equal(wt, _rows(np.asarray(w)))
    assert torch.equal(st, torch.from_numpy(np.asarray(s)[:, 0]))


@pytest.mark.parametrize("arm", tw8.ARMS)
def test_w8a8_probe_arm_matches_jax(monkeypatch, arm):
    monkeypatch.setattr(jw8, "U", 2)
    monkeypatch.setattr(jw8, "P", 2)
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, (2, jw8.H, jw8.N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (2, 1, jw8.N)).astype(np.float32)
    x = rng.standard_normal((1, jw8.H)).astype(np.float32)
    want = np.asarray(jw8.make_fn(arm, interpret=True)(w, s, x))
    got = tw8.chain(arm, _rows(w), torch.from_numpy(s[:, 0]), torch.from_numpy(x), passes=2)
    rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert rel < REL_TOL, (arm, rel)


def test_probe_arms_differ_as_quantisation_does():
    """The int8 x int8 arms track the convert arms only to their activation
    quantisation (the question the probes ask), not bit for bit."""
    w, s = ta8.make_weights("conv", units=4)
    x0 = torch.full((1, ta8.H), 0.1)
    conv, a8 = ta8.chain("conv", w, s, x0, 2), ta8.chain("a8", w, s, x0, 2)
    cos = float((conv * a8).sum() / (conv.norm() * a8.norm()))
    assert 0.98 < cos < 1.0 and not torch.equal(conv, a8)
