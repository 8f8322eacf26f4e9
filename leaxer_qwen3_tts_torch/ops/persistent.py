"""The work plan of the persistent kernels K1-K7 (``csrc/qtts_stream.cuh``).

One cooperative launch runs a whole decode step (K1; K4 for B rows), a
whole sub-code chain (K2, and K3 on a float32 cache; K5 for B rows) or a
whole frame (K7: the chain, then the talker step and its lm_head) on a grid
of one block per SM.  Each block owns a fixed,
contiguous range of output rows in every GEMV of the transformer (qkv, o,
gate|up, down) and of the chain's heads, balanced over the grid in multiples
of four rows (the scale copies move 16 bytes at a time).  A block's rows of
one GEMV are cut into stages of at most a slot's weight bytes, and the
stages stream through a ring of ``n_slots`` shared-memory slots by TMA bulk
copies.  This module computes that plan on the host, so that it can be held
on the CPU: which rows each block owns, how many rows a stage takes, how many
slots fit, and the dynamic shared memory of the launch.  The layout mirrors
``qtts_plan_layout``; the C entries check the plan's scalars again and raise
on one they do not take.

Units are int8, bf16 or int4 (``unit_bytes`` 1, 2 or 0.5; the heads of the
pack's type, or ``head_bytes``; an int4 trunk's heads are int8 unless
``head_bytes`` says bf16): a stage's rows are slot_bytes over K x
unit_bytes.  An int4 row carries K / 128 float32 scales (one per 128-column
group) where the other types carry one, so a slot's scale area
(``slot_rows`` floats) holds stage rows x K / 128 of them: 8 per row at K =
1024, 48 at the 1.7B down product (K = 6144); every copy stays a multiple of
16 bytes (rows come in fours).  A bf16 row
of the 1.7B down product (K = 6144) is 12 KB, so a SLOT_BYTES slot holds two
rows, under ROW_QUANTUM: a bf16 plan there, one-row or batched, takes
WIDE_SLOT_BYTES slots (four rows exactly); a batched one then keeps about
six batch rows' inputs per group beside MIN_SLOTS of them.

A frame's plan (``make_plan(..., talker=..., lm_rows=...)``) covers two
weight sets on one grid and one ring: set 0 the MTP trunk with its heads,
set 1 the talker with its lm_head.  Its tables hold set s's kind k at kind
index s * len(KINDS) + k, whose stages follow set 0's in the ring.  Each set
has its own unit type (``unit_bytes`` the trunk's, ``talker_bytes`` the
talker's: an int4 or bf16 talker beside an int8 or int4 trunk), so each
kind's stage rows and scale floats follow its own set; the lm_head rows are
bf16 beside a bf16 talker, else int8 (the chain heads: ``head_bytes``).

A verify pass (K6) is a batched plan of B * S rows, candidate s of stream b
on row b * S + s (``verify_rows``).

The tensor-parallel kernels (K9, K10) run one plan per rank on the rank's
block group (``grid``: the device's SMs over its ranks), over the shard's
widths (:func:`leaxer_qwen3_tts_torch.ops.fused_tp.shard_config`); K10's
head rows are the rank's slice of H (``head_k``), in the heads' own unit type
(``head_bytes``: bf16 heads beside an int8 trunk).

A batched plan (``batch`` rows, K4, K5 and K6) keeps each block's batch rows'
bf16 GEMV inputs in shared memory beside the ring, B x max(H, q_dim, I) x 2
bytes.  Where that leaves fewer than MIN_SLOTS ring slots, the grid is split
into ``groups`` groups of consecutive blocks: group g takes batch rows
[g * B / groups, (g + 1) * B / groups) through every product, and its blocks
split every product's rows among themselves, so each group streams every
weight row once (the other groups' copies of a stage mostly come from L2).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import TransformerConfig

SMEM_PER_BLOCK = 232_448  # shared memory a Hopper block may use (227 KB)
STATIC_SMEM = 2_048  # reserved for the kernels' static shared memory
ATTN_SMEM_BYTES = 21_892  # sizeof(QttsAttnSmem): one attention item
SAMPLE_SMEM_BYTES = 896  # sizeof(QttsSampleSmem)
MAX_STAGE_ROWS = 64  # 8 warps x QTTS_P_RPW rows
THREADS = 256
MAX_K = 6144  # the widest GEMV input a block holds in registers
MAX_KV_HEADS = 64  # the kv heads a plan takes
MAX_BATCH = 32  # the rows a batched launch takes
LAUNCH_ROWS = MAX_BATCH  # the rows one launch of K4, K5 or K6 takes: a call of more is split
MAX_TICKETS = MAX_BATCH * MAX_KV_HEADS  # attention tickets: one per (row, kv head)
ATTN_CHUNK = 64  # cache slots per attention split
MIN_SLOTS = 3  # ring slots a batched plan keeps before it splits the grid into groups
ROW_QUANTUM = 4  # rows per 16 bytes of float32 scales (one a row)
INT4 = 0.5  # unit_bytes of int4 units
INT4_COLS = 128  # columns per int4 scale group
SLOT_BYTES = 32 * 1024  # a batched plan's slot, and a one-row plan's past WIDE_SLOT_BYTES
WIDE_SLOT_BYTES = 48 * 1024  # a one-row plan's slot where a block's layer fits the ring
KINDS = ("qkv", "o", "gu", "down", "head")
MAX_SETS = 2  # QTTS_SETS: weight sets a plan streams


class Plan(NamedTuple):
    grid: int
    shapes: Tuple[Tuple[int, int], ...]  # (N, K) of each kind index; N = 0 for an unused kind
    bounds: Tuple[Tuple[int, ...], ...]  # [kind index][block]: block b's rows are [b], [b + 1])
    stage_rows: Tuple[int, ...]  # rows per stage of each kind index
    slot_bytes: int
    slot_rows: int  # scale floats per slot
    n_slots: int
    union_bytes: int  # GEMV input / attention items / sampler scratch
    smem_bytes: int  # dynamic shared memory of the launch
    batch: int = 1  # rows of the launch (1: K1, K2, K3, K7)
    groups: int = 1  # batch groups: bounds are [kind index][grid + groups]
    n_sets: int = 1  # weight sets (2: K7's MTP trunk, then its talker)
    unit_bytes: float = 1  # bytes per weight: 1 (int8 units), 2 (bf16), 0.5 (int4)
    head_bytes: int = 0  # bytes per head weight where not unit_bytes (K10's bf16 heads)
    talker_bytes: float = 0  # bytes per weight of set 1 (K7's talker) where not unit_bytes


def kind_name(kind: int) -> str:
    """The name of kind index ``kind`` (``talker down`` for set 1's)."""
    name = KINDS[kind % len(KINDS)]
    return name if kind < len(KINDS) else f"talker {name}"


def _align(v: int, a: int) -> int:
    return (v + a - 1) // a * a


def kind_shapes(cfg: TransformerConfig, head_rows: int = 0,
                head_k: int = 0) -> Tuple[Tuple[int, int], ...]:
    """(N, K) of the qkv, o, gate|up and down products and of the heads
    (``head_rows`` rows of K = ``head_k`` or H; none when 0)."""
    H, qd, I = cfg.hidden_size, cfg.q_dim, cfg.intermediate_size
    A = qd + 2 * cfg.kv_dim
    return ((A, H), (H, qd), (2 * I, H), (H, I), (head_rows, head_k or H))


def split_rows(N: int, grid: int) -> Tuple[int, ...]:
    """Row starts of ``grid`` blocks over N rows (N a multiple of
    ROW_QUANTUM), contiguous, balanced to within one quantum, ending at N."""
    q = N // ROW_QUANTUM
    return tuple(ROW_QUANTUM * (b * q // grid) for b in range(grid + 1))


def smem_layout(n_slots: int, slot_bytes: int, slot_rows: int, union_bytes: int) -> dict:
    """Byte offsets of the shared-memory areas (``qtts_plan_layout``)."""
    bars = union_bytes
    scales = bars + _align(8 * n_slots, 16)
    slots = _align(scales + 4 * slot_rows * n_slots, 128)
    return {"bars": bars, "scales": scales, "slots": slots, "total": slots + slot_bytes * n_slots}


def act_bytes(cfg: TransformerConfig, rows: int) -> int:
    """Shared memory of ``rows`` batch rows' bf16 GEMV inputs: the widest
    input (H, q_dim or I), rounded up to 512 columns, per row."""
    return 2 * rows * _align(max(cfg.hidden_size, cfg.q_dim, cfg.intermediate_size), 512)


def _slots(slot_rows: int, union_bytes: int, slot_bytes: int = SLOT_BYTES) -> int:
    """Ring slots of ``slot_bytes`` that fit beside the union region."""
    budget = SMEM_PER_BLOCK - STATIC_SMEM
    n = 0
    while smem_layout(n + 1, slot_bytes, slot_rows, union_bytes)["total"] <= budget:
        n += 1
    return n


def group_blocks(grid: int, groups: int, g: int) -> Tuple[int, int]:
    """The blocks [first, end) of group g."""
    return g * grid // groups, (g + 1) * grid // groups


def group_of(plan: Plan, block: int) -> int:
    """The group of ``block`` (``qtts_group_of``)."""
    return ((block + 1) * plan.groups - 1) // plan.grid


def group_rows(plan: Plan, block: int) -> Tuple[int, int]:
    """The batch rows [first, end) of ``block``'s group (``qtts_group_rows``)."""
    g = group_of(plan, block)
    return g * plan.batch // plan.groups, (g + 1) * plan.batch // plan.groups


def make_plan(cfg: TransformerConfig, grid: int, head_rows: int = 0, batch: int = 1,
              talker: Optional[TransformerConfig] = None, lm_rows: int = 0,
              unit_bytes: int = 1, head_k: int = 0, head_bytes: int = 0,
              talker_bytes: float = 0) -> Plan:
    """The plan of a launch on ``grid`` blocks over the transformer ``cfg``
    (and ``head_rows`` head rows for the chain) for ``batch`` rows (1: K1,
    K2 and K3, whose GEMV input is MAX_K floats), with as many ring slots as
    fit; a batched plan takes the fewest batch groups that leave MIN_SLOTS
    slots.  With ``talker`` (K7, one row): a second weight set, the talker
    and its ``lm_rows`` lm_head rows, after the first.  A plan of one row
    takes WIDE_SLOT_BYTES slots where each block's share of one layer of
    every set fits that ring (fewer, larger stages, each with its fixed
    wait, barrier and refill), else SLOT_BYTES slots (more of them, to keep
    more bytes in flight), unless a SLOT_BYTES slot holds fewer than
    ROW_QUANTUM rows of the widest product (bf16 units at K = 6144).  A
    batched plan takes SLOT_BYTES slots, or WIDE_SLOT_BYTES ones where a
    SLOT_BYTES slot holds fewer than ROW_QUANTUM rows of the widest product
    (the 1.7B bf16 plans: four 12 KB rows a slot, about six batch rows a
    group beside MIN_SLOTS slots).
    ``unit_bytes``: 1 for int8 units, 2 for bf16, 0.5 for int4; ``head_k`` and
    ``head_bytes``: the head rows' width and bytes per weight where they are
    not H and ``unit_bytes`` (K10; set 0's heads beside a bf16 talker in
    K7); ``talker_bytes``: the talker's units where they are not
    ``unit_bytes`` (K7), its lm_head rows bf16 beside bf16 units, else int8.
    Raises ValueError where a block would own no rows of some product, or
    nothing fits."""
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a launch takes 1..{MAX_BATCH} rows, not {batch}")
    if head_rows and batch > grid:
        raise ValueError(f"{batch} rows to sample on {grid} blocks")
    sets = [(cfg, head_rows)]
    if talker is not None:
        if batch != 1 or not lm_rows or head_k:
            raise ValueError("a frame's plan takes one row and the talker's lm_head rows")
        sets.append((talker, lm_rows))
    elif talker_bytes:
        raise ValueError("talker_bytes without a talker")
    shapes = kind_shapes(cfg, head_rows, head_k) + sum(
        (kind_shapes(c, rows) for c, rows in sets[1:]), ())
    for N, K in shapes:
        if N and (N % ROW_QUANTUM or K % 16):
            raise ValueError(f"a [{N}, {K}] product does not split into 16-byte rows of 4")
        if N and N // ROW_QUANTUM < grid:
            raise ValueError(f"{grid} blocks over {N} rows: a block would own none")
    if max(K for N, K in shapes if N) > MAX_K or max(
            c.num_kv_heads for c, _ in sets) > MAX_KV_HEADS:
        raise ValueError(f"GEMV inputs past {MAX_K} wide or past {MAX_KV_HEADS} kv heads")
    if (unit_bytes not in (INT4, 1, 2) or head_bytes not in (0, 1, 2)
            or talker_bytes not in (0, INT4, 1, 2)):
        raise ValueError(f"units of {unit_bytes} bytes: the kernels take int8 (1), bf16 (2) and "
                         f"int4 ({INT4})")
    if any(N and K % (2 * INT4_COLS) and _kind_bytes(i, unit_bytes, head_bytes, talker_bytes)
           == INT4 for i, (N, K) in enumerate(shapes)):
        raise ValueError(f"int4 rows need K a multiple of {2 * INT4_COLS}")
    widest = max(_kind_bytes(i, unit_bytes, head_bytes, talker_bytes) * K
                 for i, (N, K) in enumerate(shapes) if N)
    narrow_fits = SLOT_BYTES // widest >= ROW_QUANTUM
    at = (grid, shapes, batch, len(sets), unit_bytes, head_bytes, talker_bytes)
    if batch == 1:
        wide = _plan_at(WIDE_SLOT_BYTES, cfg, *at)
        if not narrow_fits or wide.n_slots * wide.slot_bytes >= max(
                layer_share(wide, s) for s in range(len(sets))):
            return wide
    elif not narrow_fits:
        return _plan_at(WIDE_SLOT_BYTES, cfg, *at)
    return _plan_at(SLOT_BYTES, cfg, *at)


def _kind_bytes(kind: int, unit_bytes: float, head_bytes: int, talker_bytes: float = 0) -> float:
    """Bytes per weight of kind index ``kind``: set 0's heads take
    ``head_bytes`` where it is set (int8 beside int4 units otherwise); set
    1 (K7's talker) takes ``talker_bytes`` where it is set, its lm_head
    bf16 beside bf16 units and int8 otherwise."""
    head = kind % len(KINDS) == KINDS.index("head")
    if kind >= len(KINDS):
        units = talker_bytes or unit_bytes
        return (2 if units == 2 else 1) if head else units
    if head:
        return head_bytes or (1 if unit_bytes == INT4 else unit_bytes)
    return unit_bytes


def scale_floats(kind: int, K: int, unit_bytes: float, head_bytes: int = 0,
                 talker_bytes: float = 0) -> int:
    """float32 scales per row of kind index ``kind``: K / 128 for int4 rows,
    else one."""
    return K // INT4_COLS if _kind_bytes(kind, unit_bytes, head_bytes,
                                         talker_bytes) == INT4 else 1


def _plan_at(slot_bytes: int, cfg: TransformerConfig, grid: int, shapes, batch: int,
             n_sets: int, unit_bytes: int = 1, head_bytes: int = 0,
             talker_bytes: float = 0) -> Plan:
    """The plan of ``make_plan`` with slots of ``slot_bytes``."""
    stage_rows = []
    slot_rows = 0
    for i, (N, K) in enumerate(shapes):
        row_bytes = int(K * _kind_bytes(i, unit_bytes, head_bytes, talker_bytes))
        rows = min(MAX_STAGE_ROWS, slot_bytes // row_bytes) // ROW_QUANTUM * ROW_QUANTUM
        if N and rows < ROW_QUANTUM:
            raise ValueError(f"a {slot_bytes}-byte slot holds fewer than 4 rows of "
                             f"{row_bytes} bytes")
        stage_rows.append(rows if N else ROW_QUANTUM)
        slot_rows = max(slot_rows, stage_rows[-1] * (
            scale_floats(i, K, unit_bytes, head_bytes, talker_bytes) if N else 1))
    # the GEMV input (MAX_K floats at one row, a group's rows in bf16
    # batched), two attention items, or the sampler's scratch
    for groups in range(1, batch + 1):
        rows_in_group = -(-batch // groups)
        inputs = 4 * MAX_K if batch == 1 else act_bytes(cfg, rows_in_group)
        union_bytes = _align(max(2 * ATTN_SMEM_BYTES, inputs, SAMPLE_SMEM_BYTES), 128)
        n_slots = _slots(slot_rows, union_bytes, slot_bytes)
        if n_slots >= (1 if batch == 1 else MIN_SLOTS):
            break
    else:
        raise ValueError(f"no {slot_bytes}-byte slot fits beside {union_bytes} bytes")
    bounds = []
    for N, _ in shapes:
        row = []
        for g in range(groups):
            first, end = group_blocks(grid, groups, g)
            row += split_rows(N, end - first) if N else (0,) * (end - first + 1)
        bounds.append(tuple(row))
    smem = smem_layout(n_slots, slot_bytes, slot_rows, union_bytes)["total"]
    return Plan(grid, shapes, tuple(bounds), tuple(stage_rows), slot_bytes, slot_rows, n_slots,
                union_bytes, smem, batch, groups, n_sets, unit_bytes, head_bytes, talker_bytes)


def layer_share(plan: Plan, s: int = 0) -> int:
    """The weight bytes of one layer of weight set ``s`` (its qkv, o,
    gate|up and down rows) that the block owning the most of them streams."""
    kinds = range(s * len(KINDS), s * len(KINDS) + 4)
    units = plan.talker_bytes if s == 1 and plan.talker_bytes else plan.unit_bytes
    return int(units * max(
        sum((plan.bounds[k][at + 1] - plan.bounds[k][at]) * plan.shapes[k][1] for k in kinds)
        for at in range(len(plan.bounds[0]) - 1)))


def stages(plan: Plan, kind: int, block: int) -> Sequence[Tuple[int, int]]:
    """(first row, rows) of each stage of ``block``'s rows of kind index ``kind``."""
    at = block + group_of(plan, block)
    r0, r1 = plan.bounds[kind][at], plan.bounds[kind][at + 1]
    step = plan.stage_rows[kind]
    return [(n, min(step, r1 - n)) for n in range(r0, r1, step)]


def row_launches(B: int, S: int = 1) -> Tuple[Tuple[int, int], ...]:
    """(first stream, streams) of each launch of a call of B streams of S
    rows each (K6's candidates; 1 for K4 and K5): ceil(B / s) launches of
    nearly equal size in row order, s the streams whose rows fit in
    LAUNCH_ROWS (read at call time), so that each size has one cached plan
    and the launches take about the same time (B = 40: 20 + 20, not 32 + 8).
    One launch of every row at B <= s."""
    per = LAUNCH_ROWS // S
    if per < 1:
        raise ValueError(f"{S} rows a stream: a launch takes {LAUNCH_ROWS}")
    n = -(-B // per)
    return tuple((i * B // n, (i + 1) * B // n - i * B // n) for i in range(n))


def verify_rows(B: int, S: int, T: int, starts) -> Tuple[Tuple[int, int], ...]:
    """(cache row, position) of each of the B * S rows of a verify pass
    (``qtts_row_pos`` at S candidates per stream): row r = b * S + s on cache
    row b at position start_b + s, start_b clamped into [0, T - S].
    ``starts``: the streams' device starts, or one start for every stream."""
    if isinstance(starts, int):
        starts = [starts] * B
    first = [min(max(int(p), 0), T - S) for p in starts]
    return tuple((r // S, first[r // S] + r % S) for r in range(B * S))


def attention_items(batch: int, num_kv_heads: int, T: int, positions, grid: int):
    """The attention work items of one batched layer (``qtts_bstep_phases``)
    that each of the grid's 2 x ``grid`` halves runs, in order, as (row, kv
    head, split).  The items are the rows' in row order, row b's
    num_kv_heads x (pos_b // ATTN_CHUNK + 1) (kv head fastest, then split),
    and item i goes to half i % (2 grid).  ``positions``: the rows' device
    positions (clamped into [0, T - 1]), or one host position for every row."""
    if isinstance(positions, int):
        pos = [positions] * batch
    else:
        pos = [min(max(int(p), 0), T - 1) for p in positions]
    items = [(b, i % num_kv_heads, i // num_kv_heads) for b in range(batch)
             for i in range(num_kv_heads * (pos[b] // ATTN_CHUNK + 1))]
    return [items[lane::2 * grid] for lane in range(2 * grid)]


# ---------------------------------------------------------------------------
# The plan on the device
# ---------------------------------------------------------------------------


class DevicePlan:
    """A plan's ctypes struct (``QttsPlan``) with the tensors it points to:
    the row bounds and the attention tickets (one per (row, kv head); the
    item that takes the last ticket merges the splits and resets it)."""

    def __init__(self, plan: Plan, device):
        from ._build import Plan as PlanStruct

        self.plan = plan
        # staged through pinned memory and copied without a host sync: a new
        # cache bucket builds its plan inside a decode chunk
        self._host_bounds = torch.tensor(plan.bounds, dtype=torch.int32).pin_memory()
        self.bounds = self._host_bounds.to(device, non_blocking=True)
        self.tickets = torch.zeros(MAX_TICKETS, dtype=torch.int32, device=device)
        unused = (ROW_QUANTUM,) * (MAX_SETS * len(KINDS) - len(plan.stage_rows))
        self.struct = PlanStruct(
            self.bounds.data_ptr(), plan.grid, plan.n_slots, plan.slot_bytes, plan.slot_rows,
            (ctypes.c_int32 * (MAX_SETS * len(KINDS)))(*plan.stage_rows, *unused),
            plan.smem_bytes, plan.union_bytes, self.tickets.data_ptr(), 0, None, plan.batch,
            plan.groups, MAX_TICKETS, plan.n_sets,
        )
        self.trace = None

    def enable_trace(self, barriers: int) -> torch.Tensor:
        """Record each block's start; for each of the first ``barriers`` grid
        barriers the end of the phase's input, the moment its first weight
        stage was in shared memory and the end of its last stage's dot
        products (GEMV phases), the arrival and the departure; and its end
        (``%globaltimer`` ns) in later launches.  Returns the [5 * barriers
        + 3, grid] int64 buffer they overwrite (row 1 the start, rows
        5i + 2..6 barrier i, row 5n + 2 the end).  ``disable_trace`` turns
        it off."""
        rows = 5 * barriers + 3
        self.trace = torch.zeros((rows, self.plan.grid), dtype=torch.int64,
                                 device=self.bounds.device)
        self.struct.trace_rows, self.struct.trace = rows, self.trace.data_ptr()
        return self.trace

    def disable_trace(self) -> None:
        self.struct.trace_rows, self.struct.trace, self.trace = 0, None, None


def grid_size(device) -> int:
    """One block per SM of the device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_plan(cfg: TransformerConfig, device, head_rows: int = 0, batch: int = 1,
                talker: Optional[TransformerConfig] = None, lm_rows: int = 0,
                unit_bytes: int = 1, grid: Optional[int] = None, head_k: int = 0,
                head_bytes: int = 0, talker_bytes: float = 0) -> DevicePlan:
    """The device plan of ``cfg`` (and ``head_rows`` heads, ``batch`` rows;
    the frame's talker and ``lm_rows``; ``unit_bytes`` per weight) on this
    device, on ``grid`` blocks (default: one per SM; a tensor-parallel
    rank's block group, with ``head_k``, ``head_bytes`` and ``talker_bytes``
    as in :func:`make_plan`); each caller keeps its own (the attention
    tickets are per launch stream)."""
    device = torch.device(device)
    return DevicePlan(make_plan(cfg, grid or grid_size(device), head_rows, batch, talker, lm_rows,
                                unit_bytes, head_k, head_bytes, talker_bytes), device)
