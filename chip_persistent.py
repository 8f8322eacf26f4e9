"""Quick chip check of the persistent kernels K1-K7 and of P1's ring on one NVIDIA GPU.

    python3 chip_persistent.py

Builds the kernels and prints ptxas's report of the persistent kernels
(registers, stack, spills).  First K6: the persistent verify pass against
the launch-per-op pass it replaced and the K1 / K4 steps, bit for bit
(``chip_smoke.check_k6_equal`` on one talker layer at every
K6_SHALLOW_CASES input and at the 0.6B talker at every K6_DEEP_CASES input,
both caches, again with every slot write stalled, and on one layer with
one ring slot), then timed
against it in turns and traced once at B=1 x S=4 (T=256) and 8 x 3 and
4 x 8 (T=512).  Then P1's ring kernel against the group kernel it replaced,
every arm, bit for bit and in turns (``chip_smoke.check_p1_ring``).  Then
the batched kernels: K4 and K5 against K1
and K2 row by row and against the launch-per-op sequences they replaced, bit
for bit (``chip_smoke.check_k4_equal`` at the 0.6B talker, B = 2, 5, 8 and 32,
T = 256 and 2560, ``chip_smoke.check_k5_equal`` at the 0.6B chain, B = 2, 8
and 32), again with one ring slot, then each timed against its sequence in
turns (B = 8 and 32) and traced once.  Then K1 and K2 against the launch-per-op sequences
they replaced, bit for bit (``chip_smoke.check_k1_equal`` at the 0.6B talker
and MTP trunk, ``chip_smoke.check_k2_equal`` at the 0.6B chain), with the
default weight ring and again with one ring slot
(``chip_smoke.one_slot_ring``).  Then times each against its sequence in
turns and traces one launch per case (``chip_smoke.in_turns``,
``chip_smoke.trace_phases``): K1 at the 0.6B talker, T=256 pos 200 and
T=2560 pos 1800; K2 at the 0.6B MTP trunk with a bf16 cache, greedy and four
sampled knob sets (the engine's defaults, top-k and top-p off, top-k alone,
top-p alone), whose sampler phases give the sampler's cost per knob.  Last
K7 and K3: the persistent frame against the launch-per-op frame kernel and
the composition K2 -> K1 -> norm+lm_head bit for bit
(``chip_smoke.check_k7_composition`` at the 0.6B widths, T = 256 and 2560,
bf16 and float32 caches, and with one ring slot), the persistent K3 against
its launch-per-op chain and K2 with a float32 cache at the 1.7B trunk
(``chip_smoke.check_k3_equals_k2``, and with one ring slot), each timed in
turns with the kernel it replaced and traced once.  A check that fails
raises, and the exit code is then not 0; so it is without CUDA.  It is the short first call after a change to ``csrc/qtts_stream.cuh``;
``chip_smoke.py`` runs the same checks among all the others.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

import chip_smoke as cs
from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B, QWEN3_TTS_17B
from leaxer_qwen3_tts_torch.ops import _build
from leaxer_qwen3_tts_torch.ops import fused_frame as K7
from leaxer_qwen3_tts_torch.ops import fused_mtp as K2
from leaxer_qwen3_tts_torch.ops import fused_step as K1
from leaxer_qwen3_tts_torch.ops import fused_verify as K6
from leaxer_qwen3_tts_torch.ops.quant import quantize_weight
from leaxer_qwen3_tts_torch.runtime.sampling import gumbel_noise

TRACE_KNOBS = ((0.0, 50, 0.9), (0.8, 50, 0.95), (1.0, 0, 1.0), (1.0, 50, 1.0), (1.0, 0, 0.95))


def ptxas_report(path):
    """ptxas's lines for the persistent kernels' entries."""
    with open(path + ".log") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in (
                "step_kernel", "chain_kernel", "frame_kernel", "ring_kernel")):
            cs.log(line.strip()[:160])
            for nxt in lines[i + 1:]:
                if "Compiling entry" in nxt:
                    break
                if "Used" in nxt or "spill" in nxt:
                    cs.log("    " + nxt.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_persistent: CUDA is not available", file=sys.stderr)
        return 2
    cs.CARD = cs.card()
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_kernels()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s [{cs.CARD}]")
    ptxas_report(path)
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    cfg = QWEN3_TTS_06B
    tt, mt, cp = cfg.talker.transformer, cfg.code_predictor.transformer, cfg.code_predictor
    tfw, mfw = cs.packed_trunk(tt, gen), cs.packed_trunk(mt, gen)
    H, V, n = mt.hidden_size, cp.subcode_vocab_size, cp.num_steps
    heads = K2.pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=cs.DEV) * H ** -0.5).to(torch.bfloat16)))
    tables = (torch.randn((n, V, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=cs.DEV)

    t1 = dataclasses.replace(tt, num_layers=1)
    f1 = cs.packed_trunk(t1, gen)
    shallow = [(B, S, 512, starts) for B, S, starts in cs.K6_SHALLOW_CASES]
    cs.check_k6_equal("talker-1-layer", t1, f1, shallow, gen)
    cs.check_k6_equal("0.6B talker", tt, tfw, [c[:4] for c in cs.K6_DEEP_CASES], gen)
    cs.check_k6_equal("0.6B talker", tt, tfw, cs.K6_STALL_CASES, gen, stall_ns=cs.K6_STALL_NS)
    cs.one_slot_ring(lambda: cs.check_k6_equal("talker-1-layer, one ring slot", t1, f1, shallow,
                                               gen))
    for B, S, T, starts, _ in cs.K6_DEEP_CASES:
        if (B, S, T) == (1, 4, 512):
            continue
        x, kc, vc, pos = cs.k6_inputs(tt, B, S, T, starts, torch.bfloat16, gen)
        label = f"K6 0.6B talker {B} x {S} T={T} starts {starts}"
        cs.in_turns(label, lambda: cs.k6_multi(tt, tfw, x, pos, kc, vc),
                    lambda: K6.fused_verify_step(tt, tfw, x, pos, kc, vc), 10)
        cs.trace_phases(label, K6._verify_entry(tt, tfw, B, S, T, torch.bfloat16, x.device).plan,
                        cs.verify_phase_names(tt.num_layers),
                        lambda: K6.fused_verify_step(tt, tfw, x, pos, kc, vc))
        del x, kc, vc
    cs.check_p1_ring(gen)

    cs.check_k4_equal("0.6B talker", tt, tfw, cs.K4_EQUAL_CASES, gen)
    cs.check_k5_equal("0.6B MTP trunk", cp, mfw, heads, tables, fnorm, gen)
    cs.one_slot_ring(lambda: (
        cs.check_k4_equal("0.6B talker, one ring slot", tt, tfw, ((5, 256), (32, 256)), gen,
                          cache_dtypes=(torch.float32,)),
        cs.check_k5_equal("0.6B MTP trunk, one ring slot", cp, mfw, heads, tables, fnorm, gen,
                          batches=(8, 32), cache_dtypes=(torch.bfloat16,))))
    for B in (8, 32):
        x, kc, vc, pos = cs.k4_inputs(tt, B, 512, torch.bfloat16, gen)
        pos_dev = torch.tensor(pos, device=cs.DEV)
        cs.in_turns(f"K4 0.6B talker B={B} T=512", lambda: cs.k4_multi(tt, tfw, x, pos_dev, kc, vc),
                    lambda: K1.fused_decode_step_batched(tt, tfw, x, pos_dev, kc, vc), 10)
        cs.trace_phases(f"K4 0.6B talker B={B} T=512",
                        K1._batch_entry(tt, tfw, B, 512, x.device).plan,
                        cs.step_phase_names(tt.num_layers, batched=True),
                        lambda: K1.fused_decode_step_batched(tt, tfw, x, pos_dev, kc, vc))
        del x, kc, vc
        knobs = [cs.K5_KNOBS[b % len(cs.K5_KNOBS)] for b in range(B)]
        lhb = (torch.randn((B, H), generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
        c0b = (torch.randn((B, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
        args = (mt, mfw, fnorm, heads, tables, lhb, c0b, gumbel_noise((n, B, V), gen, cs.DEV),
                *zip(*knobs))
        cs.in_turns(f"K5 0.6B B={B} mixed knobs bf16 cache",
                    lambda: cs.k5_multi(*args, cache_dtype=torch.bfloat16),
                    lambda: K2.fused_mtp_chain_batched(*args, cache_dtype=torch.bfloat16), 5)
        cs.trace_phases(f"K5 0.6B B={B} mixed knobs",
                        K2._batch_chain_entry("qtts_mtp_chain_batched", mt, mfw, heads, tables, B,
                                              torch.bfloat16, lhb.device).plan,
                        cs.chain_phase_names(mt.num_layers, n, batched=True),
                        lambda: K2.fused_mtp_chain_batched(*args, cache_dtype=torch.bfloat16))

    def equal_checks():
        cs.check_k1_equal("0.6B talker", tt, tfw, ((256, 0), (256, 200), (2560, 1800)), gen)
        cs.check_k1_equal("0.6B MTP trunk", mt, mfw, ((17, 0), (17, 9), (17, 16)), gen)
        cs.check_k2_equal("0.6B MTP trunk", cp, mfw, heads, tables, fnorm, gen, inputs=4)

    equal_checks()
    cs.one_slot_ring(equal_checks)

    for T, pos in ((256, 200), (2560, 1800)):
        x, kc, vc = cs.k1_inputs(tt, T, pos, torch.bfloat16, gen)
        cs.in_turns(f"K1 0.6B talker T={T} pos {pos}", lambda: cs.k1_multi(tt, tfw, x, pos, kc, vc),
                    lambda: K1.fused_decode_step(tt, tfw, x, pos, kc, vc), 20)
        cs.trace_phases(f"K1 0.6B talker T={T} pos {pos}", K1._step_entry(tt, tfw, T, x.device).plan,
                        cs.step_phase_names(tt.num_layers),
                        lambda: K1.fused_decode_step(tt, tfw, x, pos, kc, vc))
    lh = (torch.randn((1, H), generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
    c0 = (torch.randn((1, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
    noise = gumbel_noise((n, 1, V), gen, cs.DEV)
    plan = K2._chain_entry("qtts_mtp_chain", mt, mfw, heads, tables, torch.bfloat16,
                           lh.device).plan
    for knobs in TRACE_KNOBS:
        args = (mt, mfw, fnorm, heads, tables, lh, c0, noise, *knobs)
        cs.in_turns(f"K2 0.6B {knobs} bf16 cache",
                    lambda: cs.k2_multi(*args, cache_dtype=torch.bfloat16),
                    lambda: K2.fused_mtp_chain(*args, cache_dtype=torch.bfloat16), 10)
        cs.trace_phases(f"K2 0.6B {knobs}", plan, cs.chain_phase_names(mt.num_layers, n),
                        lambda: K2.fused_mtp_chain(*args, cache_dtype=torch.bfloat16))

    packs = cs.frame_packs(cfg, gen)
    for T, pos in ((256, 64), (2560, 2559)):
        for dt in (torch.bfloat16, torch.float32):
            cs.check_k7_composition(packs, T, pos, dt, gen, inputs=2)
    cs.one_slot_ring(lambda: cs.check_k7_composition(packs, 256, 255, torch.bfloat16, gen,
                                                     inputs=2))
    inp = cs.k7_inputs(packs, 255, 1, gen)
    kc, vc = cs.k7_caches(tt, 256, 255, torch.bfloat16, gen)
    knobs = cs.K7_KNOBS[1]
    cs.in_turns(f"K7 0.6B frame T=256 pos 255 {knobs}",
                lambda: cs.k7_call(cs.k7_multi, packs, inp, knobs, kc, vc),
                lambda: cs.k7_call(K7.fused_frame_step, packs, inp, knobs, kc, vc), 10)
    cs.trace_phases(f"K7 0.6B frame T=256 pos 255 {knobs}",
                    K7.frame_plan(*packs, 256, torch.bfloat16),
                    cs.frame_phase_names(tt.num_layers, mt.num_layers, n),
                    lambda: cs.k7_call(K7.fused_frame_step, packs, inp, knobs, kc, vc))
    del packs, kc, vc, tfw
    cp17 = QWEN3_TTS_17B.code_predictor
    H, V = cp17.transformer.hidden_size, cp17.subcode_vocab_size
    chain17 = (cp17, cs.packed_trunk(cp17.transformer, gen), K2.pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=cs.DEV) * H ** -0.5).to(torch.bfloat16))),
        (torch.randn((n, V, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16),
        torch.ones((H,), dtype=torch.bfloat16, device=cs.DEV))
    cs.check_k3_equals_k2(*chain17, gen, 10, inputs=8)
    cs.one_slot_ring(lambda: cs.check_k3_equals_k2(*chain17, gen, 0, inputs=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
