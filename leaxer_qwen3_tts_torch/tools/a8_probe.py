"""Probe P1: is a chain of unit matvecs faster with int8 x int8 products
than with the int8 -> bf16 convert that kernel K1 ships?

Port of ``tools/a8_probe.py`` (the JAX package's TPU probe).  A serial chain
of [R, 1024] x [1024, 1024] unit products, ``S`` walks over a stack of
``U`` 1 MB int8 units (72 MB, past the H100's 50 MB L2), each output
normalised into the next unit's input (x * rsqrt(mean(x^2) + 1e-6)), in one
persistent kernel (``csrc/unit_probe.cu``'s ring kernel: each block's rows of
every unit stream through a TMA weight ring, stages in flight across the
per-unit grid barrier).  Arms, all walking the same weight bytes per step:

    conv   int8 units converted to bf16, bf16 activations, float32 sums
    a8     the activation quantised to int8 per vector, int8 x int8 -> int32
    bf16   U/2 bf16 units
    w2048  U/2 int8 units of [1024, 2048], the output folded
    m8     conv with 8 activation rows

Run on the card:

    python -m leaxer_qwen3_tts_torch.tools.a8_probe

It prints each arm's microseconds per unit (kernel, plain version, one
PyTorch call of the unit product) and its error against the plain version,
beside the card's name and power limit.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from .unit_probe import bf16, bound_ms, card_line, launch, library_us, time_ms

H = 1024
U = 72  # units: 72 x 1 MB of int8 (the JAX probe's A8_UNITS)
S = 15  # steps per call: the MTP chain length (A8_STEPS)
ARMS = ("conv", "a8", "bf16", "w2048", "m8")
# Kernel vs plain.  The two sum in other orders (~1e-7 relative), which
# flips the bf16 rounding (2^-8) or the a8 quantisation step (1/127) of an
# activation now and then; every unit is normalised, so a flip is never
# damped and over S x U = 1080 units the chains part as a random walk of
# such flips (an H100 measured 3.6e-2 to 2.2e-1 of the largest output).  So
# the close check is a chain of SHORT_UNITS units, one step, where a flip
# moves the result by ~1e-4; the whole chain must only stay aligned with
# the plain one (cosine similarity), which a wrong index, sign or fold
# breaks (cosine ~0).
SHORT_UNITS, ERR_REL = 2, 1e-3  # max |diff| / max |plain| of the short chain
CHAIN_COS = 0.95


def make_weights(arm: str, units: int = U, device="cpu"):
    """The JAX probe's weights (its build, numpy seed 0) in the kernel's
    layout: rows [n_u, NW, K] and scales [n_u, NW]; n_u is ``units``, or half
    of it for bf16 and w2048."""
    rng = np.random.default_rng(0)
    if arm == "bf16":
        w = torch.from_numpy((rng.standard_normal((units // 2, H, H)) * 0.02).astype(np.float32))
        w, s = w.to(torch.bfloat16), torch.ones((units // 2, H))
    elif arm == "w2048":
        w = torch.from_numpy(rng.integers(-64, 64, (units // 2, H, 2 * H)).astype(np.int8))
        s = torch.full((units // 2, 2 * H), 0.002)
    else:
        w = torch.from_numpy(rng.integers(-64, 64, (units, H, H)).astype(np.int8))
        s = torch.full((units, H), 0.002)
    return w.transpose(1, 2).contiguous().to(device), s.float().to(device)


def rows(arm: str) -> int:
    return 8 if arm == "m8" else 1


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x) + 1e-6)


def chain_reference(arm: str, w: torch.Tensor, s: torch.Tensor, x0: torch.Tensor,
                    steps: int = S) -> torch.Tensor:
    """Plain PyTorch version of one call: [R, K] after ``steps`` walks."""
    x = x0.float()
    K = w.shape[2]
    for _ in range(steps):
        for u in range(w.shape[0]):
            if arm == "a8":
                sx = torch.clamp_min(x.abs().max() / 127.0, 1e-8)
                q = torch.clamp(torch.round(x * (1.0 / sx)), -127, 127)
                acc = (q.double() @ w[u].double().t()).float()  # exact integer sums
                out = acc * (sx * s[u])
            else:
                out = (bf16(x) @ w[u].float().t()) * s[u]
            if out.shape[-1] != K:
                out = out[:, :K] + out[:, K:]
            x = _norm(out)
    return x


def chain(arm: str, w: torch.Tensor, s: torch.Tensor, x0: torch.Tensor,
          steps: int = S) -> torch.Tensor:
    """One call of the chain: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if x0.device.type == "cpu":
        return chain_reference(arm, w, s, x0, steps)
    return launch(chain, arm, 1, w, s, x0, steps, ring=True)


chain.launches = 0  # kernel launches, for chip_smoke.py's path check


def _diff(got: torch.Tensor, want: torch.Tensor):
    """(max |diff|, that / max |want|, cosine similarity)."""
    err = float((got - want).abs().max())
    cos = float((got * want).sum() / (got.norm() * want.norm()))
    return err, err / float(want.abs().max()), cos


def measure(arm: str, calls: int = 20) -> Dict[str, float]:
    """One arm on the card: the kernel against its plain version (a short
    chain closely, the whole chain by its alignment), and microseconds per
    unit of the kernel, the plain version and one PyTorch call of the unit
    product."""
    dev = torch.device("cuda")
    w, s = make_weights(arm, device=dev)
    x0 = torch.full((rows(arm), H), 0.1, device=dev)
    units = S * w.shape[0]
    short = (w[:SHORT_UNITS], s[:SHORT_UNITS], x0, 1)
    err, rel, _ = _diff(chain(arm, *short), chain_reference(arm, *short))
    got = chain(arm, w, s, x0)
    chain_err, chain_rel, cos = _diff(got, chain_reference(arm, w, s, x0))
    ms = time_ms(lambda: chain(arm, w, s, x0), calls)
    plain_ms = time_ms(lambda: chain_reference(arm, w, s, x0), 1, 0)
    b_ms, b_by = bound_ms(arm, w, x0, units)
    return dict(arm=arm, units=units, err=err, rel=rel, checked=f"{SHORT_UNITS}-unit chain",
                tol=ERR_REL, chain_rel=chain_rel, cos=cos,
                ok=bool(rel <= ERR_REL and cos >= CHAIN_COS), ms=ms, plain_ms=plain_ms,
                us_per_unit=ms * 1e3 / units, plain_us_per_unit=plain_ms * 1e3 / units,
                library_us=library_us(arm, w, x0), bound_ms=b_ms, bound_by=b_by,
                finite=bool(torch.isfinite(got).all()))


def report(r: Dict[str, float], card: str, probe: str = "P1") -> str:
    lib = "none" if r["library_us"] is None else f"{r['library_us']:.3f}"
    chained = ("" if "cos" not in r else f"; whole chain rel {r['chain_rel']:.3e} cosine "
               f"{r['cos']:.5f} (need {CHAIN_COS})")
    return (f"{probe} {r['arm']}: {r['us_per_unit']:.3f} us/unit ({r['ms']:.4f} ms per call of "
            f"{r['units']} units), plain {r['plain_us_per_unit']:.3f} us/unit, library unit "
            f"product {lib} us, bound {r['bound_ms'] * 1e3:.2f} us/call ({r['bound_by']}); "
            f"{r['checked']} max_abs_err {r['err']:.3e} rel {r['rel']:.3e} (tol {r['tol']})"
            f"{chained} -> "
            f"{'ok' if r['ok'] and r['finite'] else 'FAIL'} [{card}]")


def run(arms: Sequence[str] = ARMS) -> List[Dict[str, float]]:
    """Every arm measured on the card and its line printed, beside the card's
    name and power limit."""
    card = card_line()
    results = []
    for arm in arms:
        results.append(measure(arm))
        print(report(results[-1], card), flush=True)
    return results


def main(arms: Sequence[str] = ARMS) -> int:
    if not torch.cuda.is_available():
        print("a8_probe: CUDA is not available; the probe runs on the card", file=sys.stderr)
        return 2
    return 0 if all(r["ok"] and r["finite"] for r in run(arms)) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ARMS))
