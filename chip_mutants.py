"""Mutation check of ``chip_smoke.py``'s K6, K3, K8, K7, P1, P2, persistent K1 / K2 / K4 / K5,
bf16-unit, int8-KV-cache and tensor-parallel (K9, K10) checks on one NVIDIA GPU.

    python3 chip_mutants.py [WORD ...]

With words, only the mutants whose name contains one of them run.

Builds faulty copies of the kernel sources in a temporary directory (the
checkout is never touched), each with one fault, and runs the checks of the
kernel it breaks against it: ``chip_smoke.check_k6_shallow`` on one talker
layer with float32 and bf16 caches and ``chip_smoke.check_k6_equal`` (the
persistent K6 against its launch-per-op pass and the K1 / K4 steps, bit for
bit) on one layer, at full depth (also with every slot write stalled) and
with a one-slot weight ring (K6),
``chip_smoke.check_p1_ring`` (P1's ring kernel against the group kernel,
every arm; P1), ``chip_smoke.check_p2_ring`` (P2's, both arms, also with a
one-slot ring whose stages are issued late; P2),
``chip_smoke.check_k3_equals_k2`` on
the 1.7B MTP trunk (K3, also with a one-slot weight ring),
``chip_smoke.check_k8`` at the 1.7B prefill shape, on the random GQA
shapes and on the key range's edge cases (K8),
``chip_smoke.check_k7_composition`` (against the launch-per-op
frame kernel and the composition K2 -> K1 -> norm+lm_head, also with a
one-slot weight ring) and ``chip_smoke.check_k7_plain`` at the 0.6B widths
(K7),
``chip_smoke.check_k1_equal`` on the 0.6B talker and MTP trunk and
``chip_smoke.check_k2_equal`` on the 0.6B chain (the persistent K1 and K2
against the launch sequences they replaced, bit for bit), each also with a
one-slot weight ring, and ``chip_smoke.check_k4_equal`` /
``chip_smoke.check_k5_equal`` (the persistent K4 and K5 against K1 / K2 rows
and their launch sequences) for the batched attention's faults; the bf16
anchors (``chip_smoke.check_unit_anchor_k1`` / ``_k4`` / ``_chains``: K1,
K4, K3 and K5 on bf16 twins of int8 packs with unit scales, bit for bit)
for the bf16 units' faults, two in the sources and one in
``ops/persistent.py`` (``PY_MUTANTS``, patched in this process after the
source mutants; ``python3 chip_mutants.py int8`` runs the three); the int8
KV cache's five (``python3 chip_mutants.py kvq``) against
``chip_smoke.check_kvq_ties``, ``check_kvq_k1`` on one layer, ``check_kvq_k4``
and ``check_kvq_k6`` (K4 rows against K1, K6 against its steps, also with
every slot write stalled) and K7's int8-cache composition and plain checks;
the tensor-parallel kernels' six (``python3 chip_mutants.py TP``) against
``chip_smoke.check_k9_step``, ``check_k9_stalled``, ``check_k9_narrow_ring``
(a one-slot ring of four rows a stage: the only check a read of K9's o
stage before its wait fails) and ``check_k10`` (also twice in a row with odd ranks'
sends stalled) at 0.6B tp=2 and 1.7B tp=4, two talker layers, and
``check_k9_equals_k1`` and ``check_k10`` at 0.6B on a one-slot weight ring;
the int4 units' three (``python3 chip_mutants.py INT4``: nibble halves
swapped, a scale one group off, one scale per row; ``fused_int4.cu``
rebuilds alone) against ``check_k1_shallow`` on one int4 talker layer
(float32 and bf16 caches), ``check_kvq_k1`` on it and ``check_chain`` on
the 0.6B int4 MTP trunk, greedy and sampled; the batched kernels' three
(``python3 chip_mutants.py INT4-B``: a group scale one off and the nibble
halves swapped in the batched int4 unit, ``fused_int4.cu`` alone; a stage
of a 48 KB batched slot read before its wait) against
``check_k4_shallow`` / ``check_k6_shallow`` on one int4 talker layer,
``check_k5`` on the 0.6B int4 trunk and ``ring_variants`` of K4 on two
1.7B bf16 talker layers (the narrow one-slot ring: one 48 KB slot); the
row split's two (``python3 chip_mutants.py M12B``: K4's launch and K6's
ignoring their first row, so a split call's second launch works on the
first rows' caches) against ``split_rows_checks`` (split calls of 40 and 64
rows against calls of at most 32, bit for bit); K7's int4 frames' one
(``python3 chip_mutants.py K7-MIX``: one 128-column group's partial added
unscaled in the frame's int4 instances alone) against ``frame_mix_checks``
at int4 units and at a bf16 talker beside an int4 trunk.  A mutant rebuilds
only the sources that include the file it changes.  A mutant is caught when at least one case fails.  Exits non-zero if a mutant is not
caught, or without CUDA.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B, QWEN3_TTS_17B
from leaxer_qwen3_tts_torch.ops import _build, persistent
from leaxer_qwen3_tts_torch.ops import fused_mtp as K2
from leaxer_qwen3_tts_torch.ops.fused_mtp import pack_heads
from leaxer_qwen3_tts_torch.ops.quant import quantize_weight

# name -> (source file, original text, faulty text, kernel whose checks must
# catch it); a tuple of texts and one of faulty texts replace pair by pair
MUTANTS = {
    # a call past 32 rows: K4's launch ignores its first row, so the second
    # launch of a split step reads and writes cache rows 0.. (its own rows
    # of x and positions, another stream's cache)
    "M12B K4 launch ignores its first row": (
        "fused_step_batched.cu",
        "  const size_t first = (size_t)row0 * w->nk * T;",
        "  const size_t first = 0;",
        "M12B",
    ),
    # the same in K6: the second launch's streams verify on streams 0..'s
    # cache rows
    "M12B K6 launch ignores its first stream": (
        "fused_verify.cu",
        "  const size_t first = (size_t)row0 * w->nk * T;",
        "  const size_t first = 0;",
        "M12B",
    ),
    # K7 at int4 units (the frame's instances alone, parts 5-8 of
    # fused_int4.cu): the second 128-column group's partial added unscaled,
    # as if its scale were dropped
    "K7-MIX int4 frame drops a group's scale": (
        "fused_int4.cu",
        "      acc[j] = fmaf(part, ss[row * G + g], acc[j]);",
        "#if QTTS_PART >= 5\n"
        "      acc[j] = fmaf(part, g == 1 ? 1.f : ss[row * G + g], acc[j]);\n"
        "#else\n"
        "      acc[j] = fmaf(part, ss[row * G + g], acc[j]);\n"
        "#endif",
        "K7-MIX",
    ),
    # the verify rows leave their own new slot out of the attention
    "own slot dropped": (
        "qtts_stream.cuh",
        "const int end = min(start + QTTS_ATTN_CHUNK, pos + 1);",
        "const int end = min(start + QTTS_ATTN_CHUNK, pos + (OWN ? 1 : 0));",
        "K6",
    ),
    # candidate s also attends slot start + s + 1: the next candidate's new
    # slot (or, for the last, a slot past the pass)
    "K6 candidate s attends slot start+s+1": (
        "qtts_stream.cuh",
        "const int end = min(start + QTTS_ATTN_CHUNK, pos + 1);",
        "const int end = min(start + QTTS_ATTN_CHUNK, pos + (OWN ? 1 : 2));",
        "K6",
    ),
    # the grid barrier between the slot write and the attention dropped: a
    # candidate may read a slot before the item that writes it has
    "K6 write-phase barrier dropped": (
        "qtts_stream.cuh",
        "      qtts_phase_barrier(p);  // the new slots, before any candidate attends them\n",
        "",
        "K6",
    ),
    # the batched consumer reads a launch's second ring stage (the first
    # layer's second qkv stage on the one-slot ring) before it waits on the
    # stage's mbarrier (it waits after its dot products): caught only with a
    # one-slot ring, where that copy is issued just before it is read
    "K6 ring stage read before its copy lands": (
        "qtts_stream.cuh",
        ("    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const WT* ws",
         "    qtts_bstage<ACCUM, WT>(ws, ss, act, K, out, ldo, r0 + c * stage_rows, rows, nb, warp,"
         " lane);\n"
         "    __syncthreads();  // every warp is done with the slot\n"),
        ("    const bool late = stage == 1;\n"
         "    if (!late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const WT* ws",
         "    qtts_bstage<ACCUM, WT>(ws, ss, act, K, out, ldo, r0 + c * stage_rows, rows, nb, warp,"
         " lane);\n"
         "    if (late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    __syncthreads();  // every warp is done with the slot\n"),
        "K6",
    ),
    # P1's ring runs one unit behind the walk: every stage after the first
    # n_slots carries the previous unit's weights (each refill is the copy
    # that was due one unit earlier)
    "P1 stage issued one unit late": (
        "unit_probe.cu",
        "  if (i >= a.steps * a.n_u) return;\n  const int u = i % a.n_u;\n",
        "  if (i >= a.steps * a.n_u) return;\n"
        "  const int u = (i - (i >= ring.n_slots ? 1 : 0)) % a.n_u;\n",
        "P1",
    ),
    # the write kernel rotates every candidate's k at its stream's start
    "k written at the start's angle": (
        "qtts_kernels.cuh",
        "    const float ang = (float)pos * inv_freq[t];\n    qtts_rope_pair(k_s[t], k_s[t + D / 2]",
        "    const float ang = (float)(pos - r % S) * inv_freq[t];\n"
        "    qtts_rope_pair(k_s[t], k_s[t + D / 2]",
        "K6",
    ),
    # the write kernel rounds k to bf16 whatever the cache dtype (a small
    # systematic fault: only a float32 cache can show it)
    "k rounded to bf16": (
        "qtts_kernels.cuh",
        "  kc[at] = qtts_to_cache<CT>(k_s[t]);",
        "  kc[at] = qtts_to_cache<CT>(qtts_bf16_round(k_s[t]));",
        "K6",
    ),
    # the streamed chain (and its launch-per-op reference) writes its KV
    # scratch in bf16 (K2 at the config dtype, not the JAX kernel's float32
    # scratch): caught by the comparison with K2 at a float32 cache
    "K3 scratch in bf16": (
        "fused_mtp_stream.cu",
        "  f32.cache_bf16 = 0;",
        "  f32.cache_bf16 = 1;",
        "K3",
    ),
    # the float32 flash attention skips the last key tile of its range
    "K8 float32 last key tile skipped": (
        "flash_attention.cu",
        "for (int t0 = t_lo; t0 < t_end; t0 += F32_KT) {",
        "for (int t0 = t_lo; t0 + F32_KT < t_end; t0 += F32_KT) {",
        "K8",
    ),
    # the tensor-core flash attention skips the last key tile of its range
    "K8 last planned key tile skipped": (
        "flash_attention.cu",
        "for (int j = lo; j <= hi; ++j) {",
        "for (int j = lo; j < hi; ++j) {",
        "K8",
    ),
    # both kernels give a row that allows no key its online-softmax value
    # (acc / l over the visited tiles) instead of sum_{t<T} v_t / Tp
    "K8 closed form dropped": (
        "flash_attention.cu",
        ("      const float o0 = alive ? acc[dn][2 * h] / denom : tl.vsum[d] / (float)Tp;\n"
         "      const float o1 = alive ? acc[dn][2 * h + 1] / denom : tl.vsum[d + 1] / (float)Tp;\n",
         "      o[d] = alive ? acc[rr][e] / denom : tl.vsum[d] / (float)Tp;\n"),
        ("      const float o0 = acc[dn][2 * h] / denom;\n"
         "      const float o1 = acc[dn][2 * h + 1] / denom;\n",
         "      o[d] = acc[rr][e] / denom;\n"),
        "K8",
    ),
    # the tensor-core kernel's P.V drops P's lo term: P rounded once to bf16
    "K8 P's lo term dropped": (
        "flash_attention.cu",
        ("        fa_mma(acc[2 * dp], pl, bv[0], bv[1]);\n"
         "        fa_mma(acc[2 * dp + 1], pl, bv[2], bv[3]);\n"),
        "",
        "K8",
    ),
    # the probes' ring kernel reads its stage before the mbarrier wait (it
    # waits after its rows, so the barrier's phases stay in step): caught
    # only by the one-slot pass whose stages are issued late
    "P2 ring read before its wait": (
        "unit_probe.cu",
        ("    qtts_mbar_wait(ring.full + slot, (uint32_t)(i / ring.n_slots) & 1u);\n"
         "    const unsigned char* ws",
         "    __syncthreads();  // every warp is done with the slot\n"
         "    if (tid == 0 && a.issue_stall_ns == 0)"),
        ("    const unsigned char* ws",
         "    qtts_mbar_wait(ring.full + slot, (uint32_t)(i / ring.n_slots) & 1u);\n"
         "    __syncthreads();  // every warp is done with the slot\n"
         "    if (tid == 0 && a.issue_stall_ns == 0)"),
        "P2",
    ),
    # the ring kernel normalises probe 2's input as probe 1's
    # (x * rsqrt(mean(x^2) + 1e-6)); the group kernel does not
    "P2 with probe 1's normalisation": (
        "unit_probe.cu",
        "    if (PROBE == 1 && i > 0) {",
        "    if (i > 0) {",
        "P2",
    ),
    # the persistent frame rounds the next talker input to bf16 (the
    # multi-dispatch path's numerics, not the JAX kernel's float32 sum)
    "K7 next input in bf16": (
        "fused_frame.cu",
        "      a.x[k] = __fadd_rn(__fadd_rn(a.c0e[k], c.sub_sum[k]), load_in(a.drip, a.drip_bf16, k));"
        "\n    }\n  }, &talker);",
        "      a.x[k] = qtts_bf16_round(\n"
        "          __fadd_rn(__fadd_rn(a.c0e[k], c.sub_sum[k]), load_in(a.drip, a.drip_bf16, k)));"
        "\n    }\n  }, &talker);",
        "K7",
    ),
    # the grid barrier between the chain's last gather and the talker's first
    # layer dropped from the persistent frame: the talker may read x before
    # the last gather writes it
    "K7 barrier before the talker dropped": (
        "qtts_stream.cuh",
        "    if (j + 1 < n || tail != nullptr) qtts_phase_barrier(p);",
        "    if (j + 1 < n) qtts_phase_barrier(p);",
        "K7",
    ),
    # the persistent frame's talker segment (the plan's second weight set)
    # reads each ring stage before it waits on the stage's mbarrier (it waits
    # after its dot products, so the barrier's phases stay in step): caught
    # by the one-slot ring check (with the default ring the copy has landed)
    "K7 talker ring stage read before its copy lands": (
        "qtts_stream.cuh",
        ("    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const int n0 = r0 + c * stage_rows;\n",
         "      default: break;\n    }\n    __syncthreads();  // every warp is done with the slot\n"),
        ("    const bool late = kind >= QTTS_KINDS;\n"
         "    if (!late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const int n0 = r0 + c * stage_rows;\n",
         "      default: break;\n    }\n"
         "    if (late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    __syncthreads();  // every warp is done with the slot\n"),
        "K7",
    ),
    # the persistent kernels' consumer reads a launch's fourth ring stage
    # (the MTP trunk's layer 0 second gate|up stage on the one-slot ring)
    # before it waits on the stage's mbarrier (it waits after its dot
    # products, so the barrier's phases stay in step): caught by the
    # one-slot ring checks below (with the default ring that copy was issued
    # long before and lands in time)
    "K1/K2 ring stage read before its copy lands": (
        "qtts_stream.cuh",
        ("    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const int n0 = r0 + c * stage_rows;\n",
         "      default: break;\n    }\n    __syncthreads();  // every warp is done with the slot\n"),
        ("    const bool late = stage == 3;\n"
         "    if (!late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const int n0 = r0 + c * stage_rows;\n",
         "      default: break;\n    }\n"
         "    if (late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    __syncthreads();  // every warp is done with the slot\n"),
        "K1K2",
    ),
    # the grid barrier between the o projection (which adds into x) and the
    # gate|up prologue (which reads all of x) dropped
    "K1/K2 grid barrier after the o projection dropped": (
        "qtts_stream.cuh",
        "    g.template residual<WT>(p, ring, q, kinds + QTTS_KIND_O, stage, sh, x, 2 * l);\n"
        "    g.barrier(p);\n",
        "    g.template residual<WT>(p, ring, q, kinds + QTTS_KIND_O, stage, sh, x, 2 * l);\n",
        "K1K2",
    ),
    # the batched attention merges a row's splits by row 0's split count:
    # rows past row 0's splits merge early (or each split alone)
    "K4 merge counts row 0's splits": (
        "qtts_stream.cuh",
        "      const int n_splits = pos / QTTS_ATTN_CHUNK + 1;  // the row's own splits",
        "      const int n_splits = qtts_row_pos(pos_dev, pos_host, 0, T, 1) / QTTS_ATTN_CHUNK + 1;",
        "K4K5",
    ),
    # every row of a kv head takes tickets from one counter: a row's merge
    # fires when the rows together, not its own splits, reach its count
    "K4 one ticket per kv head for all rows": (
        "qtts_stream.cuh",
        "      uint32_t* tk = p.tickets + (size_t)b * nk + h;  // one ticket per (row, kv head)",
        "      uint32_t* tk = p.tickets + h;",
        "K4K5",
    ),
    # the bf16 stages read their rows at the int8 stride (K bytes apart, half
    # a bf16 row), in the one-row and the batched GEMV; int8 is unchanged
    "bf16 stage rows at the int8 stride": (
        "qtts_stream.cuh",
        ("      qtts_unit_load<WT, 16>(ws + (size_t)(warp + j * QTTS_P_WARPS) * K + k0, words);",
         "  const WT* wrow = ws + (size_t)r0 * K + lane * 16;"),
        ("      qtts_unit_load<WT, 16>(ws + (size_t)(warp + j * QTTS_P_WARPS) * K / sizeof(WT) + k0,"
         " words);",
         "  const WT* wrow = ws + (size_t)r0 * K / sizeof(WT) + lane * 16;"),
        "BF16",
    ),
    # the ring copies a bf16 stage as int8 bytes: rows x K bytes from the
    # int8 offset of its first row (half the stage, from the wrong place)
    "bf16 stage copied as int8 bytes": (
        "qtts_stream.cuh",
        ("  const uint32_t wbytes = (uint32_t)rows * r.row_bytes;",
         "                 r.W + ((size_t)q.unit * r.N + n0) * r.row_bytes, wbytes, bar);"),
        ("  const uint32_t wbytes = (uint32_t)rows * r.K;",
         "                 r.W + ((size_t)q.unit * r.N + n0) * r.K, wbytes, bar);"),
        "BF16",
    ),
    # the int8 KV cache: the quantization rounds half away from zero
    # (roundf), where quantize_kv rounds half to even
    "kvq rounding half away from zero": (
        "qtts_kernels.cuh",
        "  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);",
        "  return fminf(fmaxf(roundf(x / scale), -127.f), 127.f);",
        "KVQ",
    ),
    # a cached slot's k scale read from the slot after it
    "kvq k scale read from the wrong slot": (
        "qtts_stream.cuh",
        "      a = ks[(size_t)h * T + j];",
        "      a = ks[(size_t)h * T + j + 1];",
        "KVQ",
    ),
    # the normaliser sums p * v_scale (the weight of the value term) where
    # the reference's softmax sums p alone
    "kvq v scale folded into the normaliser": (
        "qtts_stream.cuh",
        "          l[gi] = l[gi] * alpha + p;\n",
        "          l[gi] = l[gi] * alpha + (qtts_int8_cache<CT> ? p * vsb[u] : p);\n",
        "KVQ",
    ),
    # the step writes the new slot's int8 values but not its scales
    "kvq new slot's scale not written": (
        "qtts_stream.cuh",
        ("          ks[(size_t)h * T + pos] = ks_own;\n",
         "          vs[(size_t)h * T + pos] = vs_own;\n"),
        ("", ""),
        "KVQ",
    ),
    # K6's slot-write phase stores the scales after its grid barrier (a
    # second pass of the write items, each first stalled as the plan says),
    # so a candidate may read another row's new slot with a stale scale
    "kvq K6 scales written after the slot-write barrier": (
        "qtts_stream.cuh",
        ("                               pos_dev, pos_host, S, w.eps, ksl, vsl);\n      }\n"
         "      qtts_phase_barrier(p);  // the new slots, before any candidate attends them\n",),
        ("                               pos_dev, pos_host, S, w.eps, s.part, s.part + 1);\n"
         "      }\n"
         "      qtts_phase_barrier(p);  // the new slots, before any candidate attends them\n"
         "      for (int it = lane0; qtts_int8_cache<CT> && it < B * nk; it += lanes) {\n"
         "        hsync();\n"
         "        const uint64_t t0 = qtts_globaltimer();\n"
         "        while (qtts_globaltimer() - t0 < (uint64_t)p.write_stall_ns) {\n"
         "        }\n"
         "        qtts_kv_write_body<CT>(am[half], hsync, t, it % nk, it / nk, s.qkv, A,\n"
         "                               w.k_norm + (size_t)l * D, w.inv_freq, kl, vl, cache_row, "
         "nq, nk, T,\n"
         "                               pos_dev, pos_host, S, w.eps, ksl, vsl);\n"
         "      }\n",),
        "KVQ",
    ),
    # K10's consumer reads the launch's fourth ring stage (at 0.6B tp=2 on
    # the one-slot ring every block's second gate|up stage of layer 0: 20-24
    # rows that three warps read while the copy flies; the second stage is
    # the o product's, whose copy lands during the attention phase) before
    # it waits on the stage's mbarrier (it waits after its dot products, so
    # the barrier's phases stay in step): caught only with a one-slot ring
    "TP K10 ring stage read before its copy lands": (
        "fused_mtp_tp.cu",
        ("    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    tp_stage_rows<WT>(",
         "                      lane);\n"
         "    __syncthreads();  // every warp is done with the slot\n"),
        ("    const bool late = stage == 3;\n"
         "    if (!late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    tp_stage_rows<WT>(",
         "                      lane);\n"
         "    if (late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    __syncthreads();  // every warp is done with the slot\n"),
        "TP",
    ),
    # K10's stages after a block's first write their rows one quad on: four
    # rows of the next block's left stale, four of its own unwritten
    "TP K10 stage rows one quad off": (
        "fused_mtp_tp.cu",
        "r0 + c * stage_rows, min(stage_rows, nrows - c * stage_rows), K, KC, warp,",
        "r0 + c * stage_rows + (c > 0 ? 4 : 0), min(stage_rows, nrows - c * stage_rows), K, KC,"
        " warp,",
        "TP",
    ),
    # the exchange's sender writes its rows into the slot of the next rank:
    # at tp=2 rank 1 then reads a slot no rank wrote this call
    "TP exchange partner one off": (
        "qtts_tp.cuh",
        "    float* dst = link[peer].recv + (slot + s.me) * s.W + r0;",
        "    float* dst = link[peer].recv + (slot + (s.me + 1) % s.tp) * s.W + r0;",
        "TP",
    ),
    # the hypercube's round adds the value one rank on instead of its
    # partner's: the ranks end with different bits
    "TP hypercube partner off by one": (
        "qtts_tp.cuh",
        "for (int k = 0; k < QTTS_TP_MAX; ++k) u[k] = __fadd_rn(v[k], v[k ^ step]);",
        "for (int k = 0; k < QTTS_TP_MAX; ++k) u[k] = __fadd_rn(v[k], v[(k + step) % QTTS_TP_MAX]);",
        "TP",
    ),
    # K9's o stage read before its wait (the wait after the dot products):
    # on the default and the one-slot rings the copy lands during the
    # attention phase and the read goes unseen; caught only on the narrow
    # one-slot ring (chip_smoke.check_k9_narrow_ring)
    "TP K9 o stage read before its copy lands": (
        "qtts_stream.cuh",
        ("    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const int n0 = r0 + c * stage_rows;\n",
         "      default: break;\n    }\n    __syncthreads();  // every warp is done with the slot\n"),
        ("    const bool late = kind == QTTS_KIND_O;\n"
         "    if (!late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const int n0 = r0 + c * stage_rows;\n",
         "      default: break;\n    }\n"
         "    if (late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    __syncthreads();  // every warp is done with the slot\n"),
        "TP",
    ),
    # int4 units: the nibbles of each byte read in the other order (column
    # 2j + 1 for 2j)
    "INT4 nibble halves swapped": (
        "fused_int4.cu",
        "  const uint32_t biased = ((word ^ 0x88888888u) >> (4 * e)) & 0xFu;",
        "  const uint32_t biased = ((word ^ 0x88888888u) >> (4 * (e ^ 1))) & 0xFu;",
        "INT4",
    ),
    # int4 units: each 128-column group's partial scaled by the next group's
    # scale
    "INT4 scale one group off": (
        "fused_int4.cu",
        "      acc[j] = fmaf(part, ss[row * G + g], acc[j]);",
        "      acc[j] = fmaf(part, ss[row * G + (g + 1) % G], acc[j]);",
        "INT4",
    ),
    # int4 units: one scale per row (the row's first group's) applied once
    # after the whole dot product, as for int8 rows
    "INT4 group scale applied once per row": (
        "fused_int4.cu",
        ("      acc[j] = fmaf(part, ss[row * G + g], acc[j]);",
         "      out[n0 + warp + j * QTTS_P_WARPS] = ACCUM ? __fadd_rn(res[j], acc[j]) : acc[j];"),
        ("      acc[j] += part;",
         "      const float v = __fmul_rn(acc[j], ss[(warp + j * QTTS_P_WARPS) * G]);\n"
         "      out[n0 + warp + j * QTTS_P_WARPS] = ACCUM ? __fadd_rn(res[j], v) : v;"),
        "INT4",
    ),
    # int4 units in the batched GEMV (K4, K5, K6): each (row, batch row)'s
    # group partial scaled by the next group's scale
    "INT4-B batched scale one group off": (
        "fused_int4.cu",
        "      const float sc = srow[r * G + g];",
        "      const float sc = srow[r * G + (g + 1) % G];",
        "INT4-B",
    ),
    # int4 units in the batched GEMV: the nibbles of each byte read in the
    # other order there (the B=1 stage keeps the right order)
    "INT4-B batched nibble halves swapped": (
        "fused_int4.cu",
        "        for (int r = 0; r < R; ++r) wf[r] = qtts_i4_to_float(h ? wv[r].y : wv[r].x, e);",
        "        for (int r = 0; r < R; ++r) wf[r] = qtts_i4_to_float(h ? wv[r].y : wv[r].x, e ^ 1);",
        "INT4-B",
    ),
    # the batched GEMV reads a stage of a 48 KB slot (the 1.7B bf16 batched
    # plans, B17) before it waits on the stage's mbarrier (it waits after its
    # dot products, so the barrier's phases stay in step): caught where a
    # stage's copy is issued right before its read, on the narrow one-slot
    # ring (four 12 KB rows: a 48 KB slot)
    "INT4-B batched 48 KB stage read before its copy lands": (
        "qtts_stream.cuh",
        ("    qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const WT* ws",
         "    qtts_bstage<ACCUM, WT>(ws, ss, act, K, out, ldo, r0 + c * stage_rows, rows, nb, warp, lane);\n"),
        ("    const bool late = ring.slot_bytes == 48 * 1024;\n"
         "    if (!late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"
         "    if (c == 0) qtts_trace_mark(p, 1);\n"
         "    const int rows = min(stage_rows, nrows - c * stage_rows);\n"
         "    const WT* ws",
         "    qtts_bstage<ACCUM, WT>(ws, ss, act, K, out, ldo, r0 + c * stage_rows, rows, nb, warp, lane);\n"
         "    if (late) qtts_mbar_wait(ring.full + slot, (uint32_t)(stage / ring.n_slots) & 1u);\n"),
        "INT4-B",
    ),
    # the exchange's wait satisfied by any raised flag: the previous call's
    # flags pass it, so a rank whose peer's send is late reads the previous
    # call's rows (caught only with the sends stalled, on the second call)
    "TP flag not generation-counted": (
        "qtts_tp.cuh",
        "while (qtts_flag_acquire<SYS>(flag) != gen) {",
        "while (qtts_flag_acquire<SYS>(flag) == 0u) {",
        "TP",
    ),
}


def _plan_as_int8():
    """ops/persistent.py reckons bf16 rows as int8 bytes: a stage takes the
    rows of slot_bytes / K, twice what a bf16 slot holds.  Returns the undo."""
    real = persistent._plan_at

    def faulty(slot_bytes, cfg, grid, shapes, batch, n_sets, unit_bytes=1, head_bytes=0,
               talker_bytes=0):
        return real(slot_bytes, cfg, grid, shapes, batch, n_sets, 1, head_bytes,
                    talker_bytes)._replace(unit_bytes=unit_bytes)

    cs.clear_entries()  # plans cached before the fault would hide it
    persistent._plan_at = faulty

    def undo():
        persistent._plan_at = real
        cs.clear_entries()

    return undo


# name -> (apply: returns its undo, kernel whose checks must catch it):
# faults of the port's Python modules, made in this process
PY_MUTANTS = {"plan reckons bf16 rows as int8 bytes": (_plan_as_int8, "BF16")}
K6_CASES = ((1, 4, [62]), (4, 8, [62, 5, 504, 130]))  # (B, S, starts) at T=512


def checks(gen):
    """kernel -> list of check callables (each raises RuntimeError on a fault)."""
    t1 = dataclasses.replace(QWEN3_TTS_06B.talker.transformer, num_layers=1)
    fw = cs.packed_trunk(t1, gen)
    k6 = [lambda B=B, S=S, starts=starts, dt=dt: cs.check_k6_shallow(t1, fw, B, S, 512, starts,
                                                                    dt, gen)
          for dt in (torch.float32, torch.bfloat16) for B, S, starts in K6_CASES]
    shallow = [(B, S, 512, starts) for B, S, starts in cs.K6_SHALLOW_CASES]
    k6 += [lambda: cs.check_k6_equal("talker-1-layer", t1, fw, shallow, gen),
           lambda: cs.one_slot_ring(lambda: cs.check_k6_equal("talker-1-layer, one ring slot",
                                                              t1, fw, shallow, gen))]
    p1 = [lambda: cs.check_p1_ring(gen, calls=1)]
    p2 = [lambda: cs.check_p2_ring(gen, calls=1)]
    cp = QWEN3_TTS_17B.code_predictor
    H, V, n = cp.transformer.hidden_size, cp.subcode_vocab_size, cp.num_steps
    chain = (cp, cs.packed_trunk(cp.transformer, gen), pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=cs.DEV) * H ** -0.5).to(torch.bfloat16))),
        (torch.randn((n, V, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16),
        torch.ones((H,), dtype=torch.bfloat16, device=cs.DEV))
    k3 = [lambda: cs.check_k3_equals_k2(*chain, gen, 0, inputs=4),
          lambda: cs.one_slot_ring(lambda: cs.check_k3_equals_k2(*chain, gen, 0, inputs=2))]
    t = QWEN3_TTS_17B.talker.transformer
    k8 = [lambda: cs.check_k8("1.7B prefill", 1, 57, 256, t.num_heads, t.num_kv_heads,
                              "prefill", gen)]
    k8 += [lambda shape=shape: cs.check_k8("random GQA", *shape, "random", gen)
           for shape in cs.K8_RANDOM_SHAPES]
    k8 += [lambda case=case: cs.check_k8("key range", *case, gen) for case in cs.K8_SCHEDULE_CASES]
    packs = cs.frame_packs(QWEN3_TTS_06B, gen)
    k7 = [lambda T=T, pos=pos: cs.check_k7_composition(packs, T, pos, torch.bfloat16, gen,
                                                       inputs=4)
          for T, pos in ((256, 64), (2560, 2559))]
    k7 += [lambda knobs=knobs: cs.check_k7_plain(packs, 256, 255, knobs, gen)
           for knobs in cs.K7_KNOBS]
    k7 += [lambda: cs.one_slot_ring(lambda: cs.check_k7_composition(packs, 256, 255,
                                                                   torch.bfloat16, gen, inputs=2))]
    tt, mt = QWEN3_TTS_06B.talker.transformer, QWEN3_TTS_06B.code_predictor.transformer
    cp6 = QWEN3_TTS_06B.code_predictor
    H6, V6, n6 = mt.hidden_size, cp6.subcode_vocab_size, cp6.num_steps
    tfw, mfw = packs[2], packs[6]
    chain6 = (cp6, mfw, pack_heads(quantize_weight(
        (torch.randn((n6, H6, V6), generator=gen, device=cs.DEV) * H6 ** -0.5).to(torch.bfloat16))),
        (torch.randn((n6, V6, H6), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16),
        torch.ones((H6,), dtype=torch.bfloat16, device=cs.DEV))
    k1k2 = [lambda: cs.check_k1_equal("0.6B talker", tt, tfw, ((256, 0), (256, 200), (2560, 1800)),
                                      gen),
            lambda: cs.check_k1_equal("0.6B MTP trunk", mt, mfw, ((17, 0), (17, 16)), gen),
            lambda: cs.check_k2_equal("0.6B MTP trunk", *chain6, gen, inputs=4)]
    # the same checks with every persistent plan at one ring slot: each
    # stage is then issued right after the one before it is consumed, so a
    # consumer that does not wait reads a copy still in flight
    k1k2 += [lambda run=run: cs.one_slot_ring(run) for run in list(k1k2)]
    k4k5 = [lambda dt=dt: cs.check_k4_equal("0.6B talker", tt, tfw, ((5, 256), (8, 2560)), gen,
                                            cache_dtypes=(dt,))
            for dt in (torch.bfloat16, torch.float32)]
    k4k5 += [lambda: cs.check_k5_equal("0.6B MTP trunk", *chain6, gen, batches=(8,),
                                       cache_dtypes=(torch.bfloat16,))]
    k6 += [lambda: cs.check_k6_equal("0.6B talker", tt, tfw, cs.K6_STALL_CASES, gen),
           lambda: cs.check_k6_equal("0.6B talker", tt, tfw, cs.K6_STALL_CASES, gen,
                                     stall_ns=cs.K6_STALL_NS)]
    # bf16 units: the anchors (bf16 twins of int8 packs with unit scales, bit
    # for bit) on the MTP trunk, one talker layer at the 1.7B widths (the 48
    # KB slots' 12 KB rows) and the chains, also on a one-slot ring
    mi8, mb16 = cs.unit_pair(mt, gen)
    h8, h16 = cs.heads_pair(cp6, gen)
    t17 = dataclasses.replace(t, num_layers=1)
    ti8, tb16 = cs.unit_pair(t17, gen)
    anchors = (cp6, mi8, h8, mb16, h16, chain6[3], chain6[4])
    bf16 = [lambda: cs.check_unit_anchor_k1("0.6B MTP trunk", mt, mi8, mb16, ((17, 9),), gen),
            lambda: cs.check_unit_anchor_k1("1.7B talker-1-layer", t17, ti8, tb16, ((256, 63),),
                                            gen),
            lambda: cs.check_unit_anchor_k4("0.6B MTP trunk", mt, mi8, mb16, (8,), 17, gen),
            lambda: cs.check_unit_anchor_chains("0.6B MTP trunk", *anchors, gen)]
    bf16 += [lambda: cs.one_slot_ring(lambda: cs.check_unit_anchor_chains(
        "0.6B MTP trunk, one ring slot", *anchors, gen, knob_sets=cs.UNIT_KNOBS[1:2]))]
    # the int8 KV cache: the exact-tie quantization, K1 on one layer (24
    # inputs, the tight-row count), K4 rows against K1 and K6 against its
    # steps (also with every slot write stalled), and K7 against its
    # composition and its plain version
    kvq = [lambda: cs.check_kvq_ties(t1, gen)]
    kvq += [lambda T=T, pos=pos: cs.check_kvq_k1("talker-1-layer", t1, fw, T, pos, gen,
                                                 cs.K1_TIGHT_INPUTS, 0)
            for T, pos in ((256, 200), (2560, 2559))]
    kvq += [lambda: cs.check_kvq_k4("talker-1-layer", t1, fw, 8, 512, gen, 0)]
    kvq += [lambda ns=ns, case=case: cs.check_kvq_k6("talker-1-layer", t1, fw, *case, gen, 0,
                                                     stall_ns=ns)
            for case in cs.K6_STALL_CASES for ns in (0, cs.K6_STALL_NS)]
    kvq += [lambda: cs.check_k7_composition(packs, 256, 255, torch.int8, gen, inputs=2),
            lambda: cs.check_k7_plain(packs, 256, 255, cs.K7_KNOBS[1], gen, 0, torch.int8)]
    # the tensor-parallel kernels: K9's step against its plain version and,
    # twice in a row with odd ranks' sends stalled, against itself; K10
    # against its plain version (also twice in a row with the sends stalled),
    # at 0.6B tp=2 and 1.7B tp=4, two talker layers; then at 0.6B K9 at tp=1
    # against K1 and K10 against its plain version on a one-slot ring
    tp = []
    for name, cfg, n_tp in cs.TP_MODELS:
        mesh = cs.make_mesh(1, n_tp, devices=cs.card_devices(n_tp))
        tt = dataclasses.replace(cfg.talker.transformer, num_layers=2)
        rows = cs.tp_pack(tt, n_tp, mesh, gen)
        tp += [lambda tt=tt, rows=rows, n_tp=n_tp, mesh=mesh, name=name: cs.check_k9_step(
            f"{name} talker-2-layer", tt, n_tp, rows, mesh, 256, 200, gen),
               lambda tt=tt, rows=rows, n_tp=n_tp, mesh=mesh, name=name: cs.check_k9_stalled(
            f"{name} talker-2-layer", tt, n_tp, rows, mesh, gen),
               lambda tt=tt, rows=rows, n_tp=n_tp, mesh=mesh, name=name:
               cs.check_k9_narrow_ring(f"{name} talker-2-layer", tt, n_tp, rows, mesh, gen)]
        cp, cfw, heads, tables, fnorm = cs.tp_chain_packs(name, cfg, n_tp, mesh, gen)
        args = (cp, n_tp, mesh)
        tp += [lambda a=args, f=cfw, h=heads, tb=tables, fn=fnorm, name=name: cs.check_k10(
            f"K10 {name}", *a, f, h["int8"], tb, fn, cs.K10_KNOBS[0], gen),
               lambda a=args, f=cfw, h=heads, tb=tables, fn=fnorm, name=name: cs.check_k10(
            f"K10 {name} stalled", *a, f, h["bf16"], tb, fn, cs.K10_KNOBS[1], gen, calls=2,
            stall_ns=cs.K10_STALL_NS)]
    t2 = dataclasses.replace(QWEN3_TTS_06B.talker.transformer, num_layers=2)
    mesh2 = cs.make_mesh(1, 2, devices=cs.card_devices(2))
    chain2 = cs.tp_chain_packs("0.6B", QWEN3_TTS_06B, 2, mesh2, gen)
    tp += [lambda: cs.one_slot_ring(lambda: cs.check_k9_equals_k1(
        "0.6B talker-2-layer, one ring slot", t2, gen, cs.K9_EQUAL_CASES[:1])),
           lambda: cs.one_slot_ring(lambda: cs.check_k10(
        "K10 0.6B, one ring slot", chain2[0], 2, mesh2, chain2[1], chain2[2]["int8"],
        *chain2[3:], cs.K10_KNOBS[0], gen))]
    # int4 units: K1 on one talker layer (24 inputs each: the one-layer
    # limits and the tight count) on float32, bf16 and int8 caches, and K2 on
    # the 0.6B int4 MTP trunk with int8 heads against its plain version
    fw4 = cs.int4_trunk(t1, gen)
    int4 = [lambda dt=dt: cs.check_k1_shallow("talker-1-layer int4", t1, fw4, 256, 200, dt, gen,
                                              0)
            for dt in (torch.float32, torch.bfloat16)]
    int4 += [lambda: cs.check_kvq_k1("talker-1-layer int4", t1, fw4, 256, 200, gen,
                                     cs.K1_TIGHT_INPUTS, 0)]
    m4 = cs.int4_trunk(mt, gen)
    int4 += [lambda knobs=knobs: cs.check_chain(
        "K2 int4", K2.fused_mtp_chain, K2.fused_mtp_chain_reference, knobs, cp6, m4, chain6[2],
        chain6[3], chain6[4], gen, 0, flip_rule=True, cache_dtype=torch.bfloat16)
        for knobs in ((0.0,), (0.8, 50, 0.95))]
    # the batched kernels at int4 units (K4 and K6 on one talker layer under
    # the one-layer limits and the tight count, their rows against K1; K5 on
    # the int4 trunk against its plain version and K2's rows) and at bf16
    # units on two 1.7B talker layers on the narrow one-slot ring (one 48 KB
    # slot of four 12 KB rows) and the default ring, bit for bit
    int4_b = [lambda dt=dt: cs.check_k4_shallow(t1, fw4, 8, 512, dt, gen)
              for dt in (torch.float32, torch.bfloat16)]
    int4_b += [lambda: cs.check_k6_shallow(t1, fw4, 4, 4, 512, [0, 61, 200, 600],
                                           torch.float32, gen),
               lambda: cs.check_k5(8, cp6, m4, chain6[2], chain6[3], chain6[4], gen, 1)]
    t17 = dataclasses.replace(QWEN3_TTS_17B.talker.transformer, num_layers=2)
    fw17 = cs.bf16_trunk(t17, gen)
    x17, kc17, vc17, pos17 = cs.k4_inputs(t17, 8, 512, torch.bfloat16, gen)
    pos17 = torch.tensor(pos17, device=cs.DEV)

    def k4_17():
        c = cs.clone_all([kc17, vc17])
        return (cs.K1.fused_decode_step_batched(t17, fw17, x17, pos17, *c)[0], *c)

    int4_b += [lambda: cs.ring_variants("K4 bf16 talker-1.7B-2-layer B=8", k4_17)]
    m12b = [lambda: cs.split_rows_checks(gen)]
    k7_mix = [lambda: cs.frame_mix_checks(gen, mixes=("K7 int4 units",)),
              lambda: cs.frame_mix_checks(gen, mixes=("K7 bf16 talker, int4 trunk",))]
    return {"K6": k6, "K3": k3, "K8": k8, "K7": k7, "K1K2": k1k2, "K4K5": k4k5, "P1": p1,
            "P2": p2, "BF16": bf16, "KVQ": kvq, "TP": tp, "INT4": int4, "INT4-B": int4_b,
            "M12B": m12b, "K7-MIX": k7_mix}


def _includes(csrc, name):
    """The headers of ``csrc`` that ``name`` includes, directly or not."""
    found, todo = set(), [name]
    while todo:
        with open(os.path.join(csrc, todo.pop())) as f:
            for inc in re.findall(r'^#include "([^"]+)"', f.read(), re.M):
                if inc not in found:
                    found.add(inc)
                    todo.append(inc)
    return found


def _compile(csrc, names, out_dir):
    """``out_dir/<object>.o`` of every object of ``csrc/<name>`` for every
    name (``_build.units``), compiled at once."""
    nvcc = _build._nvcc()
    procs = [(name, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *flags, "-c", "-o", os.path.join(out_dir, obj + ".o"),
         os.path.join(csrc, name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, obj, flags in _build.units(names)]
    for name, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {name}:\n{out[-4000:]}")


def build_mutant(csrc, fname, base_objs):
    """Link the mutant's library where ``_build.load_kernels`` looks for it
    (``_build.CSRC_DIR`` and ``BUILD_DIR`` set to the mutant's): the sources
    that are or include ``fname`` compiled from ``csrc``, the others' objects
    from ``base_objs`` (the checkout's)."""
    hit = [s for s in _build.SOURCES if s == fname or fname in _includes(csrc, s)]
    obj_dir = os.path.join(_build.BUILD_DIR, "objects")
    os.makedirs(obj_dir)
    _compile(csrc, hit, obj_dir)
    objs = [os.path.join(obj_dir if s in hit else base_objs, obj + ".o")
            for s, obj, _ in _build.units()]
    link = subprocess.run([_build._nvcc(), "-shared", "-o", _build.library_path(), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"link failed:\n{link.stdout[-4000:]}")


def run_checks(name, checks):
    """Run a mutant's checks: the failed count of the kernel's checks."""
    cs.log(f"=== mutant: {name}")
    failed = 0
    for check in checks:
        try:
            check()
        except RuntimeError:
            failed += 1
    return f"{failed}/{len(checks)}" if failed else "0 (NOT CAUGHT)"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mutants: CUDA is not available", file=sys.stderr)
        return 2
    cs.CARD = cs.card()
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    by_kernel = checks(gen)
    source, build_dir = _build.CSRC_DIR, _build.BUILD_DIR
    caught = {}
    words = sys.argv[1:]
    chosen = [name for name in MUTANTS if not words or any(w in name for w in words)]
    # a mutant recompiles only the sources its fault reaches: the others'
    # objects are compiled from the checkout once
    os.makedirs(build_dir, exist_ok=True)
    base_objs = tempfile.mkdtemp(prefix="mutant-base-", dir=build_dir)
    if chosen:
        _compile(source, _build.SOURCES, base_objs)
    for name in chosen:
        fname, old, new, kernel = MUTANTS[name]
        with tempfile.TemporaryDirectory() as tmp:
            csrc = os.path.join(tmp, "csrc")
            shutil.copytree(source, csrc)
            path = os.path.join(csrc, fname)
            with open(path) as f:
                text = f.read()
            pairs = zip(old, new) if isinstance(old, tuple) else ((old, new),)
            for o, nw in pairs:
                if o not in text:
                    raise RuntimeError(f"mutant {name!r}: the original text is not in {fname}")
                text = text.replace(o, nw)
            with open(path, "w") as f:
                f.write(text)
            _build.CSRC_DIR, _build.BUILD_DIR, _build._lib = csrc, os.path.join(tmp, "build"), None
            try:
                build_mutant(csrc, fname, base_objs)
            except RuntimeError as e:  # the checks' own build then fails them alike
                cs.log(f"mutant {name!r} does not build: {str(e)[:200]}")
            caught[name] = run_checks(name, by_kernel[kernel])
    _build.CSRC_DIR, _build.BUILD_DIR, _build._lib = source, build_dir, None
    shutil.rmtree(base_objs, ignore_errors=True)
    for name, (apply, kernel) in PY_MUTANTS.items():
        if words and not any(w in name for w in words):
            continue
        undo = apply()
        try:
            caught[name] = run_checks(name, by_kernel[kernel])
        finally:
            undo()
    cs.log(f"mutants caught (failed cases of the kernel's checks): {caught} [{cs.CARD}]")
    return 0 if not any("NOT" in v for v in caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
