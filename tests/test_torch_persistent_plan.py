"""The work plan of the persistent kernels K1-K7 (ops/persistent.py), on the
CPU: for the 0.6B talker, the 0.6B MTP trunk with its heads, and the 1.7B
talker and trunk (K3's plan), at B = 1 (K1, K2, K3) and at B = 2, 5, 8, 24
and 32 rows (K4, K5; K6's B x S rows), and for the 0.6B frame (K7: the MTP
trunk with its 2048-row heads, then the talker with its 3072-row lm_head),
at the SM counts of an H100 SXM (132) and PCIe (114), every (row, batch row)
of every product of every weight set belongs to exactly one block, every
stage fits its ring slot, the launch's shared memory (ring, the batch rows'
inputs, two attention items) fits a Hopper block, and the attention tickets
cover every (row, kv head).  The batched attention's item dealing, against
a model of what it must run, at K4's rows and at K6's B x S rows (its row
map: row r on cache row r // S at the clamped start plus r % S).  And the
probes' ring plan (tools/unit_probe.py) for every arm of P1 and both arms of
P2: every row of every unit in exactly one block's range, the stages in walk
order, the shared memory within a block's; ``launch`` refuses a probe other
than 1 or 2.  Every check of the int8 plans also holds for bf16 units (the
unquantized config, two bytes per weight) at the 0.6B widths at every
batch and at the 1.7B widths at one row, whose 12 KB down rows take the
48 KB slots; a batched 1.7B bf16 plan is refused."""

from __future__ import annotations

import pytest
import torch

from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B, QWEN3_TTS_17B
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.tools import a8_probe, unit_probe, w8a8_probe

_MTP06 = (QWEN3_TTS_06B.code_predictor.transformer,
          QWEN3_TTS_06B.code_predictor.subcode_vocab_size)
_TALKER06 = QWEN3_TTS_06B.talker.transformer
# name -> the weight sets of the plan, (transformer, head rows) each
CASES = {
    "0.6B talker": ((_TALKER06, 0),),
    "0.6B MTP trunk": (_MTP06,),
    "1.7B talker": ((QWEN3_TTS_17B.talker.transformer, 0),),
    "1.7B MTP trunk": ((QWEN3_TTS_17B.code_predictor.transformer,
                        QWEN3_TTS_17B.code_predictor.subcode_vocab_size),),
}
FRAMES = {"0.6B frame": (_MTP06, (_TALKER06, QWEN3_TTS_06B.talker.codec_vocab_size))}
# the same weight sets with bf16 units (a name ending in " bf16")
BF16 = {f"{name} bf16": sets for name, sets in CASES.items()}
GRIDS = (132, 114)
BATCHES = (1, 2, 5, 8, 24, 32)  # 24: a spec pool's 8 streams x 3 candidates
PARAMS = ([(name, grid, B) for name in CASES for grid in GRIDS for B in BATCHES]
          + [(name, grid, 1) for name in FRAMES for grid in GRIDS]
          + [(name, grid, B) for name in BF16 for grid in GRIDS for B in BATCHES])


def _sets(name):
    return {**CASES, **FRAMES, **BF16}[name]


def _unit_bytes(name):
    return 2 if name.endswith(" bf16") else 1


def _plan(name, grid, B):
    (cfg, heads), *rest = _sets(name)
    if rest:
        (talker, lm_rows), = rest
        return persistent.make_plan(cfg, grid, head_rows=heads, talker=talker, lm_rows=lm_rows)
    return persistent.make_plan(cfg, grid, head_rows=heads, batch=B,
                                unit_bytes=_unit_bytes(name))


@pytest.mark.parametrize("name,grid,B", PARAMS)
def test_every_row_once(name, grid, B):
    plan = _plan(name, grid, B)
    assert plan.batch == B and 1 <= plan.groups <= B
    assert all(len(b) == grid + plan.groups for b in plan.bounds)
    # every batch row belongs to exactly one group, and every group has blocks
    rows = [0] * B
    for g in range(plan.groups):
        first, end = persistent.group_blocks(grid, plan.groups, g)
        assert end > first
        b0, b1 = persistent.group_rows(plan, first)
        assert all(persistent.group_rows(plan, blk) == (b0, b1) for blk in range(first, end))
        assert all(persistent.group_of(plan, blk) == g for blk in range(first, end))
        for b in range(b0, b1):
            rows[b] += 1
    assert rows == [1] * B
    for kind, (N, _) in enumerate(plan.shapes):
        if N == 0:
            continue
        owner = [[0] * N for _ in range(B)]  # (batch row, row) -> blocks computing it
        for blk in range(grid):
            b0, b1 = persistent.group_rows(plan, blk)
            for n0, r in persistent.stages(plan, kind, blk):
                assert r > 0 and n0 % persistent.ROW_QUANTUM == 0
                assert r % persistent.ROW_QUANTUM == 0
                for b in range(b0, b1):
                    for n in range(n0, n0 + r):
                        owner[b][n] += 1
        assert owner == [[1] * N for _ in range(B)], persistent.kind_name(kind)
        for g in range(plan.groups):
            first, end = persistent.group_blocks(grid, plan.groups, g)
            at = [blk + g for blk in range(first, end)]
            sizes = [plan.bounds[kind][i + 1] - plan.bounds[kind][i] for i in at]
            assert min(sizes) > 0 and max(sizes) - min(sizes) <= persistent.ROW_QUANTUM


@pytest.mark.parametrize("name,grid,B", PARAMS)
def test_stages_fit_the_ring(name, grid, B):
    plan = _plan(name, grid, B)
    assert plan.n_slots >= (2 if B == 1 else persistent.MIN_SLOTS)
    assert plan.unit_bytes == _unit_bytes(name)
    for kind, (N, K) in enumerate(plan.shapes):
        if N == 0:
            continue
        rows = plan.stage_rows[kind]
        assert rows % persistent.ROW_QUANTUM == 0 and rows <= persistent.MAX_STAGE_ROWS
        assert rows <= plan.slot_rows
        for b in range(grid):
            for _, r in persistent.stages(plan, kind, b):
                assert r * K * plan.unit_bytes <= plan.slot_bytes and r <= plan.slot_rows


@pytest.mark.parametrize("name,grid,B", PARAMS)
def test_shared_memory_fits(name, grid, B):
    plan = _plan(name, grid, B)
    lay = persistent.smem_layout(plan.n_slots, plan.slot_bytes, plan.slot_rows,
                                 plan.union_bytes)
    assert lay["total"] == plan.smem_bytes
    assert plan.smem_bytes + persistent.STATIC_SMEM <= 232_448
    assert lay["scales"] % 16 == 0 and lay["slots"] % 128 == 0 and plan.union_bytes % 128 == 0
    sets = _sets(name)
    cfg = sets[0][0]
    widths = [K for N, K in plan.shapes if N]
    kv_heads = max(c.num_kv_heads for c, _ in sets)
    assert max(widths) <= persistent.MAX_K and kv_heads <= persistent.MAX_KV_HEADS
    # the GEMV input (MAX_K floats at B = 1, else the largest group's rows in
    # bf16 at the widest input), two attention items, or the sampler's scratch
    group_rows = max(persistent.group_rows(plan, blk)[1] - persistent.group_rows(plan, blk)[0]
                     for blk in range(grid))
    widest = max(max(c.hidden_size, c.q_dim, c.intermediate_size) for c, _ in sets)
    inputs = 4 * persistent.MAX_K if B == 1 else 2 * group_rows * (-(-widest // 512) * 512)
    assert inputs == (4 * persistent.MAX_K if B == 1 else persistent.act_bytes(cfg, group_rows))
    assert plan.union_bytes >= max(2 * persistent.ATTN_SMEM_BYTES, inputs,
                                   persistent.SAMPLE_SMEM_BYTES)
    # the attention tickets: one per (row, kv head)
    assert B * kv_heads <= persistent.MAX_TICKETS
    # one more slot would not fit
    more = persistent.smem_layout(plan.n_slots + 1, plan.slot_bytes, plan.slot_rows,
                                  plan.union_bytes)
    assert more["total"] + persistent.STATIC_SMEM > 232_448
    # with one group fewer the ring would keep fewer than MIN_SLOTS slots
    if plan.groups > 1:
        fewer = persistent._slots(plan.slot_rows, persistent.act_bytes(
            cfg, -(-B // (plan.groups - 1))), plan.slot_bytes)
        assert fewer < persistent.MIN_SLOTS


@pytest.mark.parametrize("name,grid,B", [p for p in PARAMS if p[2] == 1])
def test_one_row_slots(name, grid, B):
    """A one-row plan (K1, K2, K3, K7) takes the wide slots exactly where
    each block's share of one layer of every weight set fits their ring;
    the 1.7B plans, whose layer shares are past it, keep the 32 KB slots
    and five of them."""
    plan = _plan(name, grid, B)
    n_sets = len(_sets(name))
    ub = _unit_bytes(name)
    wide = persistent._plan_at(persistent.WIDE_SLOT_BYTES, _sets(name)[0][0], grid, plan.shapes,
                               1, n_sets, ub)
    fits = all(persistent.layer_share(wide, s) <= wide.n_slots * wide.slot_bytes
               for s in range(n_sets))
    # a 32 KB slot must hold four rows of the widest product
    narrow = persistent.SLOT_BYTES // (ub * max(K for N, K in plan.shapes if N)) >= 4
    assert plan.slot_bytes == (persistent.WIDE_SLOT_BYTES if fits or not narrow
                               else persistent.SLOT_BYTES)
    # every block's rows of every kind are counted in its share
    for s in range(n_sets):
        for blk in range(grid):
            own = sum(r * plan.shapes[k][1] * ub for k in range(s * 5, s * 5 + 4)
                      for _, r in persistent.stages(plan, k, blk))
            assert own <= persistent.layer_share(plan, s)
    if name.startswith("1.7B") and ub == 1:
        assert plan.slot_bytes == persistent.SLOT_BYTES and plan.n_slots == 5
    if grid == 132 and name.startswith("0.6B") and ub == 1:
        assert plan.slot_bytes == persistent.WIDE_SLOT_BYTES and plan.n_slots == 3


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", [n for n in BF16 if n.startswith("1.7B")])
def test_bf16_17b_plans(name, grid):
    """bf16 units at the 1.7B widths: a 12 KB down row leaves a 32 KB slot
    two rows, so the one-row plan takes the 48 KB slots, whatever its layer
    share, four down rows a stage, and the union region still leaves the
    ring slots; a batched plan takes the 48 KB slots too (B17), MIN_SLOTS of
    them beside its batch groups' inputs, four down rows a stage."""
    (cfg, heads), = _sets(name)
    plan = _plan(name, grid, 1)
    assert plan.slot_bytes == persistent.WIDE_SLOT_BYTES and plan.n_slots >= 1
    assert plan.stage_rows[persistent.KINDS.index("down")] == 4
    assert persistent.layer_share(plan) > plan.n_slots * plan.slot_bytes  # the share test alone
    for B in (2, 8, 32):
        batched = persistent.make_plan(cfg, grid, head_rows=heads, batch=B, unit_bytes=2)
        assert batched.slot_bytes == persistent.WIDE_SLOT_BYTES
        assert batched.n_slots == persistent.MIN_SLOTS
        assert batched.stage_rows[persistent.KINDS.index("down")] == 4
    # 0.6B bf16 batches keep the 32 KB slots
    for (c, h), in (CASES["0.6B talker"], CASES["0.6B MTP trunk"]):
        assert persistent.make_plan(c, grid, head_rows=h, batch=8,
                                    unit_bytes=2).slot_bytes == persistent.SLOT_BYTES


def test_batched_plans_keep_the_narrow_slots():
    for name in CASES:
        assert _plan(name, 132, 8).slot_bytes == persistent.SLOT_BYTES
    for name in ("0.6B talker bf16", "0.6B MTP trunk bf16"):
        assert _plan(name, 132, 8).slot_bytes == persistent.SLOT_BYTES
    with pytest.raises(ValueError):
        persistent.make_plan(_TALKER06, 132, unit_bytes=4)


@pytest.mark.parametrize("grid", GRIDS)
def test_frame_plan_is_the_chain_then_the_talker(grid):
    """K7's plan: set 0 is the chain's own plan (K2's rows and stages), set 1
    the talker step's (K1's) with the lm_head as its head kind; one ring of
    one slot geometry for both."""
    (mcfg, V), (tcfg, Vc) = FRAMES["0.6B frame"]
    frame = persistent.make_plan(mcfg, grid, head_rows=V, talker=tcfg, lm_rows=Vc)
    chain = persistent.make_plan(mcfg, grid, head_rows=V)
    step = persistent.make_plan(tcfg, grid)
    kinds = len(persistent.KINDS)
    assert frame.n_sets == 2 and chain.n_sets == step.n_sets == 1
    assert len(frame.shapes) == len(frame.bounds) == len(frame.stage_rows) == 2 * kinds
    assert frame.shapes[:kinds] == chain.shapes
    assert frame.shapes[kinds:] == persistent.kind_shapes(tcfg, Vc)
    assert frame.bounds[:kinds] == chain.bounds and frame.bounds[kinds:kinds + 4] == step.bounds[:4]
    same = persistent._plan_at(frame.slot_bytes, mcfg, grid, frame.shapes, 1, 2)
    assert frame == same
    if frame.slot_bytes == chain.slot_bytes == step.slot_bytes:
        assert frame.stage_rows[:kinds] == chain.stage_rows
        assert frame.stage_rows[kinds:kinds + 4] == step.stage_rows[:4]
    assert frame.union_bytes == chain.union_bytes == step.union_bytes
    assert frame.slot_bytes == (chain.slot_bytes if chain.slot_bytes == step.slot_bytes
                                else persistent.SLOT_BYTES)
    assert frame.slot_rows == max(frame.stage_rows)
    assert persistent.kind_name(kinds + 4) == "talker head" and persistent.kind_name(3) == "down"
    with pytest.raises(ValueError):
        persistent.make_plan(mcfg, grid, head_rows=V, batch=2, talker=tcfg, lm_rows=Vc)


def test_plan_refuses_a_grid_past_the_rows():
    cfg = QWEN3_TTS_06B.talker.transformer
    with pytest.raises(ValueError):
        persistent.make_plan(cfg, cfg.hidden_size // persistent.ROW_QUANTUM + 1)
    with pytest.raises(ValueError):
        persistent.make_plan(cfg, 132, batch=persistent.MAX_BATCH + 1)


# K6's streams x candidates: every (B, S) of at most MAX_BATCH rows, S in
# 2..8, at T=512 with starts at the first slot, on both sides of a split
# edge, at T - S and past it, and inside
VERIFY_SHAPES = [(B, S) for S in range(2, 9) for B in range(1, persistent.MAX_BATCH // S + 1)]
VERIFY_STARTS = (0, 61, 200, 600, 509, 5, 130, 62)


def _verify_starts(B):
    return [VERIFY_STARTS[b % len(VERIFY_STARTS)] for b in range(B)]


# (B, T, positions): the first slot, both sides of a 64-slot split edge, the
# last slot, clamped ones past the bucket and below 0; a host position; then
# K6's B x S rows at their own positions
ITEM_CASES = [
    (5, 256, [0, 63, 64, 255, 700]),
    (8, 2560, [0, 63, 64, 2559, 9999, -3, 1800, 130]),
    (32, 512, [(0, 63, 64, 511, 600, 5, 200, 130)[b % 8] for b in range(32)]),
    (4, 2560, 1800),
] + [(B * S, 512, [p for _, p in persistent.verify_rows(B, S, 512, _verify_starts(B))])
     for B, S in VERIFY_SHAPES]


@pytest.mark.parametrize("B,S", VERIFY_SHAPES)
def test_verify_rows(B, S):
    """K6's row map: row r = b * S + s on cache row b at stream b's start,
    clamped into [0, T - S], plus s; at S = 1 it is K4's position clamp."""
    T = 512
    starts = [-4] + _verify_starts(B)[1:]  # stream 0's start below 0
    rows = persistent.verify_rows(B, S, T, starts)
    assert len(rows) == B * S
    for r, (b, p) in enumerate(rows):
        assert b == r // S and p == min(max(starts[b], 0), T - S) + r % S and 0 <= p < T
    assert len(set(rows)) == B * S  # no slot written twice
    assert persistent.verify_rows(B, S, T, 200) == persistent.verify_rows(B, S, T, [200] * B)
    assert [p for _, p in persistent.verify_rows(B * S, 1, T, starts * S)] == [
        min(max(p, 0), T - 1) for p in starts * S]
    assert B * S <= persistent.MAX_BATCH


@pytest.mark.parametrize("B,T,positions", ITEM_CASES)
@pytest.mark.parametrize("grid", GRIDS)
def test_attention_items_run_once(B, T, positions, grid):
    nk = QWEN3_TTS_06B.talker.transformer.num_kv_heads
    assert B * nk <= persistent.MAX_TICKETS  # one ticket per (row, kv head)
    halves = persistent.attention_items(B, nk, T, positions, grid)
    assert len(halves) == 2 * grid
    pos = ([positions] * B if isinstance(positions, int)
           else [min(max(p, 0), T - 1) for p in positions])
    want = {(b, h, s) for b in range(B) for h in range(nk)
            for s in range(pos[b] // persistent.ATTN_CHUNK + 1)}
    ran = [item for items in halves for item in items]
    assert len(ran) == len(set(ran)) and set(ran) == want
    # only items with slots to attend are dealt, evenly over the halves
    counts = [len(items) for items in halves]
    assert max(counts) - min(counts) <= 1
    # the merge: an item of a row with one split merges itself; otherwise
    # the item that takes the (row, kv head)'s last ticket does, the halves
    # taking tickets in turn, one item each
    tickets, merges = {}, {}
    for step in range(max(len(items) for items in halves)):
        for items in halves:
            if step >= len(items):
                continue
            b, h, _ = items[step]
            n_splits = pos[b] // persistent.ATTN_CHUNK + 1
            if n_splits == 1:
                merges[(b, h)] = merges.get((b, h), 0) + 1
                continue
            ticket = tickets.get((b, h), 0)
            tickets[(b, h)] = ticket + 1
            if ticket == n_splits - 1:
                merges[(b, h)] = merges.get((b, h), 0) + 1
    assert merges == {(b, h): 1 for b in range(B) for h in range(nk)}
    assert all(tickets[(b, h)] == pos[b] // persistent.ATTN_CHUNK + 1 for b, h in tickets)


# P1's arms; P2's kernel arms ("p2-" + conv or a8: R = 1, K = NW = 1024) also
# on half an H100's SMs
PROBE_ARMS = ([(arm, grid) for arm in a8_probe.ARMS for grid in GRIDS]
              + [("p2-" + w8a8_probe.KERNEL_ARM[arm], grid) for arm in w8a8_probe.ARMS
                 for grid in GRIDS + (66,)])


def _probe_shape(arm):
    """(kernel arm, R, K, NW, units, walks) of a P1 arm or a "p2-" arm."""
    if arm.startswith("p2-"):
        return arm[3:], 1, w8a8_probe.H, w8a8_probe.N, w8a8_probe.U, w8a8_probe.P
    NW = 2 * a8_probe.H if arm == "w2048" else a8_probe.H
    return arm, a8_probe.rows(arm), a8_probe.H, NW, a8_probe.U, a8_probe.S


def _probe_plan(arm, grid):
    kernel_arm, R, K, NW, _, _ = _probe_shape(arm)
    return unit_probe.probe_plan(kernel_arm, R, K, NW, grid), NW


@pytest.mark.parametrize("arm,grid", PROBE_ARMS)
def test_probe_ring_rows_once(arm, grid):
    """P1's ring: every row of every unit of the walk in exactly one block's
    stage, blocks balanced within one quantum of four rows."""
    plan, NW = _probe_plan(arm, grid)
    n_u, steps = 3, 2
    owner = [[0] * NW for _ in range(steps * n_u)]
    for blk in range(grid):
        stages = unit_probe.probe_stages(plan, blk, n_u, steps)
        for i, u, r0, rows in stages:
            assert u == i % n_u and r0 % persistent.ROW_QUANTUM == 0
            assert 0 < rows and rows % persistent.ROW_QUANTUM == 0
            for n in range(r0, r0 + rows):
                owner[i][n] += 1
    assert owner == [[1] * NW for _ in range(steps * n_u)]
    sizes = [b1 - b0 for b0, b1 in zip(plan.bounds, plan.bounds[1:])]
    assert len(sizes) == grid and max(sizes) - min(sizes) <= persistent.ROW_QUANTUM


@pytest.mark.parametrize("arm,grid", PROBE_ARMS)
def test_probe_ring_stages_walk_in_order(arm, grid):
    """A block's stages are the walk itself: stage i carries unit i % n_u,
    i = 0 .. steps x n_u - 1, and fits one slot (rows and scales)."""
    plan, _ = _probe_plan(arm, grid)
    _, _, K, _, U, S = _probe_shape(arm)
    esize = 2 if arm == "bf16" else 1
    for blk in (0, grid // 2, grid - 1):
        stages = unit_probe.probe_stages(plan, blk, U, S)
        assert [i for i, *_ in stages] == list(range(S * U))
        assert [u for _, u, *_ in stages] == [i % U for i in range(len(stages))]
        for _, _, _, rows in stages:
            assert rows * K * esize <= plan.slot_bytes and rows <= plan.slot_rows
    assert plan.slot_bytes % 16 == 0 and plan.slot_rows % persistent.ROW_QUANTUM == 0


@pytest.mark.parametrize("arm,grid", PROBE_ARMS)
def test_probe_ring_shared_memory_fits(arm, grid):
    """The input area, the ring's barriers, scales and slots fit a Hopper
    block, and one more slot would not."""
    plan, _ = _probe_plan(arm, grid)
    _, R, K, _, _, _ = _probe_shape(arm)
    assert plan.in_bytes % 128 == 0 and plan.in_bytes >= 2 * R * K * 4 + K
    lay = persistent.smem_layout(plan.n_slots, plan.slot_bytes, plan.slot_rows, plan.in_bytes)
    assert lay["total"] == plan.smem_bytes and lay["slots"] % 128 == 0
    assert plan.n_slots >= 2
    assert plan.smem_bytes + persistent.STATIC_SMEM <= persistent.SMEM_PER_BLOCK
    more = persistent.smem_layout(plan.n_slots + 1, plan.slot_bytes, plan.slot_rows,
                                  plan.in_bytes)
    assert more["total"] + persistent.STATIC_SMEM > persistent.SMEM_PER_BLOCK


def test_probe_plan_refuses_a_grid_past_the_rows():
    with pytest.raises(ValueError):
        unit_probe.probe_plan("conv", 1, 1024, 1024, 1024 // persistent.ROW_QUANTUM + 1)


@pytest.mark.parametrize("probe", [0, 3])
def test_probe_launch_refuses_other_probes(probe):
    """The kernels run probe 1's and probe 2's chains only: ``launch``
    refuses any other probe number before it touches the card."""
    w, s = torch.zeros((1, 1024, 1024), dtype=torch.int8), torch.ones((1, 1024))
    x0 = torch.zeros((1, 1024))
    for ring in (True, False):
        with pytest.raises(ValueError, match="probe"):
            unit_probe.launch(w8a8_probe.chain, "conv", probe, w, s, x0, 1, ring=ring)
