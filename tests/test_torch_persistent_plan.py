"""The work plan of the persistent kernels K1 and K2 (ops/persistent.py), on
the CPU: for the 0.6B talker, the 0.6B MTP trunk with its heads, and the
1.7B talker and trunk, at the SM counts of an H100 SXM (132) and PCIe (114),
every row of every product belongs to exactly one block, every stage fits
its ring slot, and the launch's shared memory fits a Hopper block."""

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
PARAMS = [(name, grid) for name in CASES for grid in GRIDS]


def _plan(name, grid):
    cfg, heads = CASES[name]
    return persistent.make_plan(cfg, grid, head_rows=heads)


@pytest.mark.parametrize("name,grid", PARAMS)
def test_every_row_once(name, grid):
    plan = _plan(name, grid)
    for kind, (N, _) in enumerate(plan.shapes):
        if N == 0:
            continue
        owner = [0] * N
        for b in range(grid):
            for n0, rows in persistent.stages(plan, kind, b):
                assert rows > 0 and n0 % persistent.ROW_QUANTUM == 0
                assert rows % persistent.ROW_QUANTUM == 0
                for n in range(n0, n0 + rows):
                    owner[n] += 1
        assert owner == [1] * N, persistent.KINDS[kind]
        sizes = [plan.bounds[kind][b + 1] - plan.bounds[kind][b] for b in range(grid)]
        assert min(sizes) > 0 and max(sizes) - min(sizes) <= persistent.ROW_QUANTUM


@pytest.mark.parametrize("name,grid", PARAMS)
def test_stages_fit_the_ring(name, grid):
    plan = _plan(name, grid)
    assert plan.n_slots >= 2
    for kind, (N, K) in enumerate(plan.shapes):
        if N == 0:
            continue
        rows = plan.stage_rows[kind]
        assert rows % persistent.ROW_QUANTUM == 0 and rows <= persistent.MAX_STAGE_ROWS
        assert rows <= plan.slot_rows
        for b in range(grid):
            for _, r in persistent.stages(plan, kind, b):
                assert r * K <= plan.slot_bytes and r <= plan.slot_rows


@pytest.mark.parametrize("name,grid", PARAMS)
def test_shared_memory_fits(name, grid):
    plan = _plan(name, grid)
    lay = persistent.smem_layout(plan.n_slots, plan.slot_bytes, plan.slot_rows,
                                 plan.union_bytes)
    assert lay["total"] == plan.smem_bytes
    assert plan.smem_bytes + persistent.STATIC_SMEM <= 232_448
    assert lay["scales"] % 16 == 0 and lay["slots"] % 128 == 0 and plan.union_bytes % 128 == 0
    cfg, _ = CASES[name]
    widths = [K for N, K in plan.shapes if N]
    assert max(widths) <= persistent.MAX_K and cfg.num_kv_heads <= persistent.MAX_KV_HEADS
    # the GEMV input, two attention items, or the sampler's scratch
    assert plan.union_bytes >= max(2 * persistent.ATTN_SMEM_BYTES, 4 * persistent.MAX_K,
                                   persistent.SAMPLE_SMEM_BYTES)
    # one more slot would not fit
    more = persistent.smem_layout(plan.n_slots + 1, plan.slot_bytes, plan.slot_rows,
                                  plan.union_bytes)
    assert more["total"] + persistent.STATIC_SMEM > 232_448


def test_plan_refuses_a_grid_past_the_rows():
    cfg = QWEN3_TTS_06B.talker.transformer
    with pytest.raises(ValueError):
        persistent.make_plan(cfg, cfg.hidden_size // persistent.ROW_QUANTUM + 1)
