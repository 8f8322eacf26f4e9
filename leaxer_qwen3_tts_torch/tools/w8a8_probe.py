"""Probe P2: do int8 x int8 -> int32 unit products remove the cost of
converting int8 weights to bf16?

Port of ``tools/w8a8_probe.py`` (the JAX package's TPU probe).  ``P``
passes over ``U`` [1024, 1024] int8 units (16 MB), each unit's input the
previous unit's y * 1e-3 + its input, in one persistent kernel
(``csrc/unit_probe.cu``'s ring kernel, P1's: each block's rows of every unit
stream through a TMA weight ring, stages in flight across the per-unit grid
barrier; the 16 MB stack stays in the 50 MB L2 after the first pass).
Arms:

    bf16   int8 weights converted to bf16, bf16 activations, float32 sums
    w8a8   the activation quantised to int8 (sa = max|x| / 127, no clip),
           int8 x int8 -> int32, then y = acc * (sa * s)

Run on the card:

    python -m leaxer_qwen3_tts_torch.tools.w8a8_probe

It prints each arm's microseconds per unit product (kernel, plain version,
one PyTorch call of the unit product), its error against the plain version
and the two arms' relative difference, beside the card's name and power
limit.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from .a8_probe import report
from .unit_probe import bf16, bound_ms, card_line, launch, library_us, time_ms

U, H, N, P = 16, 1024, 1024, 30  # 16 MB of units, P passes over them
ARMS = ("bf16", "w8a8")
KERNEL_ARM = {"bf16": "conv", "w8a8": "a8"}  # the kernel's arm of each
ERR_REL = 1e-2  # kernel vs plain: max |diff| / max |plain| of the result


def make_inputs(device="cpu"):
    """The JAX probe's weights, scales and input (numpy seed 0) in the
    kernel's layout: rows [U, N, H], scales [U, N], x [1, H]."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.integers(-127, 128, (U, H, N)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (U, 1, N)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, H)).astype(np.float32))
    return (w.transpose(1, 2).contiguous().to(device), s[:, 0].contiguous().to(device),
            x.to(device))


def chain_reference(arm: str, w: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
                    passes: int = P) -> torch.Tensor:
    """Plain PyTorch version of one call: the running input after ``passes``."""
    acc = x.float()
    for _ in range(passes):
        for u in range(w.shape[0]):
            xx = acc
            if arm == "bf16":
                y = (bf16(xx) @ w[u].float().t()) * s[u]
            else:
                sa = xx.abs().max() * (1.0 / 127.0)
                la = torch.round(xx * (1.0 / sa))
                y = (la.double() @ w[u].double().t()).float() * (sa * s[u])
            acc = y * 1e-3 + xx
    return acc


def chain(arm: str, w: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
          passes: int = P) -> torch.Tensor:
    """One call: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return chain_reference(arm, w, s, x, passes)
    return launch(chain, KERNEL_ARM[arm], 2, w, s, x, passes, ring=True)


chain.launches = 0  # kernel launches, for chip_smoke.py's path check


def measure(arm: str, calls: int = 20) -> Dict[str, float]:
    """One arm on the card: error against the plain version, and
    microseconds per unit product of the kernel, the plain version and one
    PyTorch call of the unit product."""
    w, s, x = make_inputs(torch.device("cuda"))
    units = P * w.shape[0]
    got = chain(arm, w, s, x)
    want = chain_reference(arm, w, s, x)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    ms = time_ms(lambda: chain(arm, w, s, x), calls)
    plain_ms = time_ms(lambda: chain_reference(arm, w, s, x), 1, 0)
    b_ms, b_by = bound_ms(arm, w, x, units)
    return dict(arm=arm, units=units, err=err, rel=rel, ok=bool(rel <= ERR_REL), ms=ms,
                checked="whole chain", tol=ERR_REL,
                plain_ms=plain_ms, us_per_unit=ms * 1e3 / units,
                plain_us_per_unit=plain_ms * 1e3 / units, library_us=library_us(arm, w, x),
                bound_ms=b_ms, bound_by=b_by, finite=bool(torch.isfinite(got).all()), out=got)


def run(arms: Sequence[str] = ARMS) -> List[Dict[str, float]]:
    """Every arm measured on the card and its line printed, then the two
    arms' relative difference, beside the card's name and power limit."""
    card = card_line()
    results = {}
    for arm in arms:
        results[arm] = measure(arm)
        print(report(results[arm], card, "P2"), flush=True)
    if len(results) == 2:
        a, b = results["bf16"]["out"], results["w8a8"]["out"]
        print(f"P2 relative L-inf between the arms: "
              f"{float((a - b).abs().max() / a.abs().max()):.4f} [{card}]", flush=True)
    return list(results.values())


def main(arms: Sequence[str] = ARMS) -> int:
    if not torch.cuda.is_available():
        print("w8a8_probe: CUDA is not available; the probe runs on the card", file=sys.stderr)
        return 2
    return 0 if all(r["ok"] and r["finite"] for r in run(arms)) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ARMS))
