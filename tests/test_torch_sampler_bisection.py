"""The early end of the register sampler's bisections (csrc/qtts_stream.cuh,
``qtts_sample_regs``), on the CPU, in float32.

The sampler finds the top-k and top-p thresholds by 40 rounds of bisection,
two rounds per pass (the midpoints of a two-level round tree).  A round's
decision rests on one value u: the top_k-th largest logit (the count of
logits >= mid reaches top_k exactly when u >= mid), or the probability at
which the kept mass falls below top_p (kept exactly when mid < u).  Once a
pass finds a single value left in its interval ([lo, hi] for top-k; (plo,
phi] for top-p, once both ends have moved), the kernel ends the bisection
on lo and hi alone, u deciding each round.  These tests hold that rule to
the full 40-round bisection on rows with ties, masked logits (-1e30), tiny
logits and constant rows: the final interval must be the same floats.

They check the algorithm only: a numpy model of both bisections, whose
midpoints are the kernel's float32 expressions (``qtts_round_tree``: each
node's ``0.5f * (lo + hi)``; the early end's ``0.5f * (lo + hi)``).  They
import nothing of the kernel and pass whatever it does; the kernel itself is
held on the card, where every chain (K2, K3, K5, K7) must equal its
launch-per-op sequence, whose sampler runs the full bisection, bit for bit
(``chip_smoke.py``)."""

from __future__ import annotations

import numpy as np
import pytest

F = np.float32
ROUNDS = 40


def _tree(lo, hi, n=3):
    """The n midpoints of a pass, node c's children at 2c + 1 and 2c + 2
    (``qtts_round_tree``)."""
    nlo, nhi, mid = [F(lo)] + [F(0)] * (n - 1), [F(hi)] + [F(0)] * (n - 1), [F(0)] * n
    for c in range(n):
        mid[c] = F(F(0.5) * F(nlo[c] + nhi[c]))
        if 2 * c + 2 < n:
            nlo[2 * c + 1], nhi[2 * c + 1] = nlo[c], mid[c]
            nlo[2 * c + 2], nhi[2 * c + 2] = mid[c], nhi[c]
    return mid


def _walk(mid, right, rounds, lo, hi):
    node = 0
    for d in range(2):
        if d < rounds:
            if right[node]:
                lo, node = mid[node], 2 * node + 2
            else:
                hi, node = mid[node], 2 * node + 1
    return lo, hi


def _mass(pr, mid):
    """The kept mass at mid (one fixed order: any order, the same each call)."""
    return F(np.where(pr > mid, pr, F(0)).sum(dtype=np.float32))


def top_k_threshold(lg, k, early):
    lo, hi = F(lg.min()), F(lg.max())
    for done in range(0, ROUNDS, 2):
        mid = _tree(lo, hi)
        right = [int((lg >= m).sum()) >= k for m in mid]
        inside = lg[(lg >= lo) & (lg <= hi)]
        if early and inside.min() == inside.max():
            u = inside.min()
            for _ in range(done, ROUNDS):
                m = F(F(0.5) * F(lo + hi))
                lo, hi = (m, hi) if u >= m else (lo, m)
            break
        lo, hi = _walk(mid, right, ROUNDS - done, lo, hi)
    return lo, hi


def top_p_threshold(pr, p, early):
    lo, hi = F(0), F(1)
    for done in range(0, ROUNDS, 2):
        mid = _tree(lo, hi)
        right = [not _mass(pr, m) < p for m in mid]
        inside = pr[(pr > lo) & (pr <= hi)]
        if early and lo != 0 and hi != 1 and inside.size and inside.min() == inside.max():
            u = inside.min()
            for _ in range(done, ROUNDS):
                m = F(F(0.5) * F(lo + hi))
                lo, hi = (m, hi) if m < u else (lo, m)
            break
        lo, hi = _walk(mid, right, ROUNDS - done, lo, hi)
    return lo, hi


def _row(kind, rng, V=512):
    lg = (rng.standard_normal(V) * rng.uniform(0.1, 20)).astype(F)
    if kind == "ties":
        lg = np.round(lg).astype(F)
    elif kind == "masked":
        lg[rng.integers(0, V, V // 7)] = F(-1e30)
    elif kind == "two values":
        lg[:] = F(1.5)
        lg[: V // 100] = F(2.0)
    elif kind == "tiny":
        lg = (lg * F(1e-30)).astype(F)
    elif kind == "constant":
        lg[:] = F(3.0)
    return lg


KINDS = ("normal", "ties", "masked", "two values", "tiny", "constant")


@pytest.mark.parametrize("kind", KINDS)
def test_top_k_early_end_is_exact(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    for _ in range(40):
        lg = _row(kind, rng)
        k = int(rng.choice([1, 2, 50, int(rng.integers(1, lg.size))]))
        assert top_k_threshold(lg, k, True) == top_k_threshold(lg, k, False)


@pytest.mark.parametrize("kind", KINDS)
def test_top_p_early_end_is_exact(kind):
    rng = np.random.default_rng(100 + KINDS.index(kind))
    for _ in range(40):
        lg = _row(kind, rng)
        e = np.exp((lg - lg.max()).astype(F)).astype(F)
        pr = (e / e.sum(dtype=np.float32)).astype(F)
        p = F(rng.choice([rng.uniform(0.5, 0.99), 0.9999999, 1e-9, 0.0]))
        assert top_p_threshold(pr, p, True) == top_p_threshold(pr, p, False)


def test_the_early_end_saves_passes():
    """On a row of spread logits, both bisections end well before 20 passes."""
    rng = np.random.default_rng(7)
    lg = _row("normal", rng, V=2048)
    passes = []
    lo, hi = F(lg.min()), F(lg.max())
    for done in range(0, ROUNDS, 2):
        inside = lg[(lg >= lo) & (lg <= hi)]
        if inside.min() == inside.max():
            break
        mid = _tree(lo, hi)
        lo, hi = _walk(mid, [int((lg >= m).sum()) >= 50 for m in mid], ROUNDS - done, lo, hi)
        passes.append(done)
    assert len(passes) < 12
