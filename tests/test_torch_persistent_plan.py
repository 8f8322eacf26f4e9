"""The work plan of the persistent kernels K1, K2, K4 and K5
(ops/persistent.py), on the CPU: for the 0.6B talker, the 0.6B MTP trunk with
its heads, and the 1.7B talker and trunk, at B = 1 (K1, K2) and at B = 2, 5,
8 and 32 rows (K4, K5), at the SM counts of an H100 SXM (132) and PCIe
(114), every (row, batch row) of every product belongs to exactly one block,
every stage fits its ring slot, the launch's shared memory (ring, the
batch rows' inputs, two attention items) fits a Hopper block, and the
attention tickets cover every (row, kv head).  And the batched attention's
item dealing, against a model of what it must run."""

from __future__ import annotations

import pytest

from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B, QWEN3_TTS_17B
from leaxer_qwen3_tts_torch.ops import persistent

CASES = {
    "0.6B talker": (QWEN3_TTS_06B.talker.transformer, 0),
    "0.6B MTP trunk": (QWEN3_TTS_06B.code_predictor.transformer,
                       QWEN3_TTS_06B.code_predictor.subcode_vocab_size),
    "1.7B talker": (QWEN3_TTS_17B.talker.transformer, 0),
    "1.7B MTP trunk": (QWEN3_TTS_17B.code_predictor.transformer,
                       QWEN3_TTS_17B.code_predictor.subcode_vocab_size),
}
GRIDS = (132, 114)
BATCHES = (1, 2, 5, 8, 32)
PARAMS = [(name, grid, B) for name in CASES for grid in GRIDS for B in BATCHES]


def _plan(name, grid, B):
    cfg, heads = CASES[name]
    return persistent.make_plan(cfg, grid, head_rows=heads, batch=B)


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
        assert owner == [[1] * N for _ in range(B)], persistent.KINDS[kind]
        for g in range(plan.groups):
            first, end = persistent.group_blocks(grid, plan.groups, g)
            at = [blk + g for blk in range(first, end)]
            sizes = [plan.bounds[kind][i + 1] - plan.bounds[kind][i] for i in at]
            assert min(sizes) > 0 and max(sizes) - min(sizes) <= persistent.ROW_QUANTUM


@pytest.mark.parametrize("name,grid,B", PARAMS)
def test_stages_fit_the_ring(name, grid, B):
    plan = _plan(name, grid, B)
    assert plan.n_slots >= (2 if B == 1 else persistent.MIN_SLOTS)
    for kind, (N, K) in enumerate(plan.shapes):
        if N == 0:
            continue
        rows = plan.stage_rows[kind]
        assert rows % persistent.ROW_QUANTUM == 0 and rows <= persistent.MAX_STAGE_ROWS
        assert rows <= plan.slot_rows
        for b in range(grid):
            for _, r in persistent.stages(plan, kind, b):
                assert r * K <= plan.slot_bytes and r <= plan.slot_rows


@pytest.mark.parametrize("name,grid,B", PARAMS)
def test_shared_memory_fits(name, grid, B):
    plan = _plan(name, grid, B)
    lay = persistent.smem_layout(plan.n_slots, plan.slot_bytes, plan.slot_rows,
                                 plan.union_bytes)
    assert lay["total"] == plan.smem_bytes
    assert plan.smem_bytes + persistent.STATIC_SMEM <= 232_448
    assert lay["scales"] % 16 == 0 and lay["slots"] % 128 == 0 and plan.union_bytes % 128 == 0
    cfg, _ = CASES[name]
    widths = [K for N, K in plan.shapes if N]
    assert max(widths) <= persistent.MAX_K and cfg.num_kv_heads <= persistent.MAX_KV_HEADS
    # the GEMV input (MAX_K floats at B = 1, else the largest group's rows in
    # bf16 at the widest input), two attention items, or the sampler's scratch
    group_rows = max(persistent.group_rows(plan, blk)[1] - persistent.group_rows(plan, blk)[0]
                     for blk in range(grid))
    widest = max(cfg.hidden_size, cfg.q_dim, cfg.intermediate_size)
    inputs = 4 * persistent.MAX_K if B == 1 else 2 * group_rows * (-(-widest // 512) * 512)
    assert inputs == (4 * persistent.MAX_K if B == 1 else persistent.act_bytes(cfg, group_rows))
    assert plan.union_bytes >= max(2 * persistent.ATTN_SMEM_BYTES, inputs,
                                   persistent.SAMPLE_SMEM_BYTES)
    # the attention tickets: one per (row, kv head)
    assert B * cfg.num_kv_heads <= persistent.MAX_TICKETS
    # one more slot would not fit
    more = persistent.smem_layout(plan.n_slots + 1, plan.slot_bytes, plan.slot_rows,
                                  plan.union_bytes)
    assert more["total"] + persistent.STATIC_SMEM > 232_448
    # with one group fewer the ring would keep fewer than MIN_SLOTS slots
    if plan.groups > 1:
        fewer = persistent._slots(plan.slot_rows, persistent.act_bytes(
            cfg, -(-B // (plan.groups - 1))))
        assert fewer < persistent.MIN_SLOTS


def test_plan_refuses_a_grid_past_the_rows():
    cfg = QWEN3_TTS_06B.talker.transformer
    with pytest.raises(ValueError):
        persistent.make_plan(cfg, cfg.hidden_size // persistent.ROW_QUANTUM + 1)
    with pytest.raises(ValueError):
        persistent.make_plan(cfg, 132, batch=persistent.MAX_BATCH + 1)


# (B, T, positions): the first slot, both sides of a 64-slot split edge, the
# last slot, clamped ones past the bucket and below 0; a host position
ITEM_CASES = [
    (5, 256, [0, 63, 64, 255, 700]),
    (8, 2560, [0, 63, 64, 2559, 9999, -3, 1800, 130]),
    (32, 512, [(0, 63, 64, 511, 600, 5, 200, 130)[b % 8] for b in range(32)]),
    (4, 2560, 1800),
]


@pytest.mark.parametrize("B,T,positions", ITEM_CASES)
@pytest.mark.parametrize("grid", GRIDS)
def test_attention_items_run_once(B, T, positions, grid):
    nk = QWEN3_TTS_06B.talker.transformer.num_kv_heads
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
