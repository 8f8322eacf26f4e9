"""The unit-matvec chain kernels of probes P1 and P2 (``csrc/unit_probe.cu``).

:func:`launch` runs one call of the chain on the card: ``steps`` walks over
the ``n_u`` unit weights ``w`` ([n_u, NW, K] rows, int8 or bf16) from ``x0``
([R, K] float32), each unit a grid-wide phase of one persistent cooperative
kernel: the probes' kernel on the weight ring (``ring=True``: one block per
SM, each owning a fixed range of every unit's rows, its stages the walk
itself, by the plan of :func:`probe_plan`), or the group kernel it is held
to bit for bit (each unit cut into 16-row groups; the checks' reference).
The probes' modules hold each arm's plain PyTorch version and time both on
the card beside one PyTorch call of the unit product.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import persistent

ARM_IDS = {"conv": 0, "a8": 1, "bf16": 2, "w2048": 3, "m8": 4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core rates, ibid.


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class ProbePlan(NamedTuple):
    """The ring kernel's plan: block b owns rows [bounds[b], bounds[b + 1])
    of every unit; each stage (one unit's rows of a block and their scales)
    fits a slot of slot_bytes and slot_rows scales."""

    grid: int
    bounds: Tuple[int, ...]
    slot_bytes: int
    slot_rows: int
    n_slots: int
    in_bytes: int  # the unit's input, its bf16 rounding and its a8 quantisation
    smem_bytes: int
    issue_stall_ns: int = 0  # checks only: each stage past the first slots issued late


def probe_plan(arm: str, R: int, K: int, NW: int, grid: int) -> ProbePlan:
    """The ring plan on ``grid`` blocks for units of [NW, K] rows (bf16 for
    the bf16 arm, else int8) and R activation rows (P1's arms; P2's conv and
    a8 arms are P1's at R = 1, K = NW = 1024): the rows balanced over
    the grid in multiples of four (``persistent.split_rows``), and as many
    ring slots as fit beside the input area.  The layout mirrors
    ``ring_layout`` in ``csrc/unit_probe.cu``."""
    if NW % persistent.ROW_QUANTUM or NW // persistent.ROW_QUANTUM < grid:
        raise ValueError(f"{grid} blocks over {NW} rows: a block would own none")
    bounds = persistent.split_rows(NW, grid)
    rows = max(b1 - b0 for b0, b1 in zip(bounds, bounds[1:]))
    slot_bytes = rows * K * (2 if arm == "bf16" else 1)
    in_bytes = persistent._align(2 * R * K * 4 + K, 128)
    n_slots = persistent._slots(rows, in_bytes, slot_bytes)
    if n_slots < 1:
        raise ValueError(f"no {slot_bytes}-byte slot fits beside {in_bytes} bytes")
    smem = persistent.smem_layout(n_slots, slot_bytes, rows, in_bytes)["total"]
    return ProbePlan(grid, bounds, slot_bytes, rows, n_slots, in_bytes, smem)


def probe_stages(plan: ProbePlan, block: int, n_u: int, steps: int
                 ) -> Sequence[Tuple[int, int, int, int]]:
    """(walk index i, weight unit, first row, rows) of each of ``block``'s
    stages in the order the ring kernel issues them: stage i carries the
    block's rows of unit i % n_u, into slot i % n_slots."""
    r0, r1 = plan.bounds[block], plan.bounds[block + 1]
    return [(i, i % n_u, r0, r1 - r0) for i in range(steps * n_u)]


_PLANS = {}
_PLANS_LOCK = threading.Lock()


def _device_plan(arm: str, R: int, K: int, NW: int, device):
    """(plan, its bounds on the device), built once per shape and device (the
    bounds staged through pinned memory, no host sync)."""
    key = (arm, R, K, NW, device)
    with _PLANS_LOCK:
        if key not in _PLANS:
            plan = probe_plan(arm, R, K, NW, persistent.grid_size(device))
            host = torch.tensor(plan.bounds, dtype=torch.int32).pin_memory()
            _PLANS[key] = (plan, host, host.to(device, non_blocking=True))
        plan, _, bounds = _PLANS[key]
    return plan, bounds


def launch(wrapper, arm: str, probe: int, w: torch.Tensor, s: torch.Tensor, x0: torch.Tensor,
           steps: int, ring: bool = False) -> torch.Tensor:
    """One kernel call on CUDA tensors, counted on ``wrapper``: the ring
    kernel (``ring``) or the group kernel, for ``probe`` 1 or 2.  Returns the
    chain's result [R, K] (P1: the last output normalised; P2: the last
    running input)."""
    from ..ops._build import check, load_kernels

    if probe not in (1, 2):
        raise ValueError(f"{wrapper.__name__}: the kernels run probe 1's or probe 2's chain, "
                         f"not probe {probe}'s")
    for t in (w, s, x0):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: every tensor must be contiguous and on CUDA")
    n_u, NW, K = w.shape
    R = x0.shape[0]
    want = torch.bfloat16 if arm == "bf16" else torch.int8
    if w.dtype != want or s.dtype != torch.float32 or x0.dtype != torch.float32:
        raise ValueError(f"{wrapper.__name__} {arm}: weights {want}, scales and x0 float32")
    # the bulk copies move 16-byte-aligned runs of rows and scales
    if ring and (w.data_ptr() % 16 or s.data_ptr() % 16):
        raise ValueError(f"{wrapper.__name__}: weights and scales must be 16-byte aligned")
    y = torch.empty(2 * R * NW, dtype=torch.float32, device=w.device)
    out = torch.empty((R, K), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    ptrs = (w.data_ptr(), s.data_ptr(), x0.data_ptr(), y.data_ptr(), out.data_ptr())
    lib = load_kernels()
    if ring:
        plan, bounds = _device_plan(arm, R, K, NW, w.device)
        wrapper.launches += 1
        err = lib.qtts_unit_probe_ring(
            *ptrs, bounds.data_ptr(), ARM_IDS[arm], probe, n_u, steps, R, K, NW, plan.grid,
            plan.n_slots, plan.slot_bytes, plan.slot_rows, plan.in_bytes, plan.smem_bytes,
            plan.issue_stall_ns, stream,
        )
    else:
        wrapper.launches += 1
        err = lib.qtts_unit_probe(*ptrs, ARM_IDS[arm], probe, n_u, steps, R, K, NW, stream)
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
