"""The unit-matvec chain kernel shared by probes P1 and P2 (``csrc/unit_probe.cu``).

:func:`launch` runs one call of the chain on the card: ``steps`` walks over
the ``n_u`` unit weights ``w`` ([n_u, NW, K] rows, int8 or bf16) from ``x0``
([R, K] float32), each unit a grid-wide phase of one persistent cooperative
kernel.  The probes' modules hold each arm's plain PyTorch version and time
both on the card beside one PyTorch call of the unit product.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

ARM_IDS = {"conv": 0, "a8": 1, "bf16": 2, "w2048": 3, "m8": 4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core rates, ibid.


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def launch(wrapper, arm: str, probe: int, w: torch.Tensor, s: torch.Tensor, x0: torch.Tensor,
           steps: int) -> torch.Tensor:
    """One kernel call on CUDA tensors, counted on ``wrapper``.  Returns the
    chain's result [R, K] (P1: the last output normalised; P2: the last
    running input)."""
    from ..ops._build import check, load_kernels

    for t in (w, s, x0):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: every tensor must be contiguous and on CUDA")
    n_u, NW, K = w.shape
    R = x0.shape[0]
    want = torch.bfloat16 if arm == "bf16" else torch.int8
    if w.dtype != want or s.dtype != torch.float32 or x0.dtype != torch.float32:
        raise ValueError(f"{wrapper.__name__} {arm}: weights {want}, scales and x0 float32")
    y = torch.empty(2 * R * NW, dtype=torch.float32, device=w.device)
    out = torch.empty((R, K), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    wrapper.launches += 1
    err = load_kernels().qtts_unit_probe(
        w.data_ptr(), s.data_ptr(), x0.data_ptr(), y.data_ptr(), out.data_ptr(), ARM_IDS[arm],
        probe, n_u, steps, R, K, NW, stream,
    )
    check(err, wrapper.__name__)
    return out


def time_ms(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_us(arm: str, w: torch.Tensor, x0: torch.Tensor, iters: int = 200) -> Optional[float]:
    """Microseconds of one PyTorch call computing one unit product: a bf16
    ``torch.matmul`` for the convert arms, ``torch._int_mm`` for the int8
    ones where it takes the shape (it refuses M <= 16 rows: None)."""
    u = w[0]
    if arm in ("a8", "w8a8"):
        x8 = torch.ones((x0.shape[0], u.shape[1]), dtype=torch.int8, device=u.device)
        wt = u.t()
        try:
            torch._int_mm(x8, wt)
        except RuntimeError:
            return None
        return time_ms(lambda: torch._int_mm(x8, wt), iters) * 1e3
    xb, wb = x0.to(torch.bfloat16), u.to(torch.bfloat16).t()
    return time_ms(lambda: torch.matmul(xb, wb), iters) * 1e3


def bound_ms(arm: str, w: torch.Tensor, x0: torch.Tensor, units: int) -> tuple:
    """(least ms of one call, "bytes" or "operations"): the weight stack, x0
    and the result moved once; 2 R K NW operations per unit at the bf16 or
    int8 tensor rate."""
    moved = w.numel() * w.element_size() + 2 * x0.numel() * 4
    ops = 2.0 * x0.shape[0] * w.shape[1] * w.shape[2] * units
    peak = PEAK_OPS_PER_S["int8" if arm in ("a8", "w8a8") else "bf16"]
    ms_b, ms_o = moved / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (ms_b, "bytes") if ms_b >= ms_o else (ms_o, "operations")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
