"""A/B of the B=1 fixed 300-frame run between two checkouts, on one GPU.

    python3 chip_ab.py OLD NEW [--spec] [--batched] [--frame] [--voice] [--chains] [--kernels]
                               [--mesh]

OLD and NEW are checkout roots (unpack a commit with ``git archive`` into a
directory that ``.gitignore`` lists).  Each run is its own process, in the
order OLD, NEW, NEW, OLD, since each checkout builds and loads its own
kernels; a run makes the 0.6B preset's engine (random weights, seed 0,
int8), warms it up and times ``chip_smoke.check_fixed_run`` three times.
With ``--spec`` a run also times the speculative B=1 fixed run at k=4
(``chip_smoke.spec_fixed_run``, sampled, 300 frames, as the smoke's spec
phase does) at full acceptance and with the repeat draft, twice each, in ms
per committed frame, and the spec pool (8 slots x 3 candidates, the smoke's
12 pool requests with their seeds, after one warm-up round) twice, in
aggregate RTF.  With ``--batched`` a run also times the batched fixed
300-frame runs at B=8 and B=32 (ms per batched frame and aggregate RTF, as
the smoke's batched phase) and, by CUDA events on seeded inputs, the kernels
of the batched frame (K4 at T=512 with the smoke's per-row positions, K5 with
its mixed knobs, B=8 and 32) and of the B=1 frame (K1 at T=256 pos 200, K2
sampled).  With ``--frame`` a run also times the 0.6B ``frame_fused`` fixed
300-frame run twice and K7 on a seeded frame (T=256, pos 255, sampled);
with ``--voice`` the 1.7B preset's fixed 300-frame instruct run twice
(random weights, the smoke's voice configuration), K3 on a seeded chain
(sampled), and the prefill ms and TTFA of four instruct requests (the
smoke's voice text, 48 frames at most, after a warm-up): the prefill's 28
K8 launches are what its attention costs end to end.  With ``--kernels`` a
run first times the kernels alone (and makes no engine unless another flag
asks for one), by CUDA events on
seeded inputs, three timings each (bf16 caches):
K1 (T=256, pos 200), K2 (sampled), K3 (K2's inputs: the 0.6B int8 trunk on
its float32 cache), K4 (B=8, 32 at T=512), K5 (B=4, 8, 32,
mixed knobs), K6 (B=1 x S=4 at T=256 start 200, 8 x 3 and 4 x 8 at
T=512, the smoke's starts), K7 (T=256, pos 255, sampled), P1 (the
conv arm's whole chain), K8 at the 1.7B prefill shape (bf16, B=1, S=57,
T=256, 16 / 8 heads; also its device time per call from the profiler) and
P2 (both arms' whole chain).  With ``--chains`` a run makes no engine: it
times the chains alone on seeded inputs, three times each, and traces each once
(``chip_smoke.trace_phases``): K5 at B=8 and 32 with K5_KNOBS cycled over
the rows and with the engine's knobs, and the persistent B=1 chain on the
1.7B trunk with a float32 cache (``fused_mtp_chain``: the kernel that K3
runs, and at an older checkout the persistent chain K3 did not yet run).
With ``--mesh`` a run makes no single-device engine: on a mesh that lists
the card tp times (0.6B tp=2, 1.7B tp=4) it times the K9 step (the talker,
T=256, pos 200) and K10 (sampled, bf16 heads) by CUDA events on seeded
inputs, three timings each, then runs ``chip_smoke.tp_engine_runs`` (its
ms/frame lines).  Prints one ``AB`` line per run with the card's name and
power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

TEXT = "hello world, this is a fixed length run"


def spec_ms(cs, eng):
    """ms per committed frame of the B=1 spec fixed run: {label: [ms, ms]}."""
    from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams
    from leaxer_qwen3_tts_torch.runtime.speculative import repeat_draft

    sampled = SamplingParams.create(0.8, 50, 0.95, forbid_eos=True)
    out = {}
    for label, force in (("full", True), ("zero", False)):
        for _ in range(2):
            _, _, decode_s, decoded = cs.spec_fixed_run(eng, 300, sampled, [cs.SPEC_TEXT],
                                                        repeat_draft, force)
            out.setdefault(label, []).append(decode_s * 1e3 / decoded)
    return out


def spec_pool_rtf(cs, params, tok, eng):
    """Aggregate RTF of the smoke's 12 pool requests through an 8-slot spec
    pool at k=3: one warm-up round, then two timed rounds."""
    import time

    from leaxer_qwen3_tts_torch.api.engine import TTSEngine
    from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B
    from leaxer_qwen3_tts_torch.serve import ContinuousBatcher

    spec_eng = TTSEngine(config=QWEN3_TTS_06B, params=params, tokenizer=tok, quantize="int8",
                         spec_k=cs.SPEC_K, spec_iters=cs.SPEC_ITERS, spec_accept_floor=0.0)
    pool = ContinuousBatcher(spec_eng, pool_size=8, kv_bucket=eng.kv_ladder[0],
                             spec_k=cs.POOL_SPEC_K, spec_iters=cs.POOL_SPEC_ITERS)
    rtf = []
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            futs = [pool.submit(text, language=lang, temperature=k[0], top_k=k[1], top_p=k[2],
                                max_tokens=mt, seed=cs.SEED + i)
                    for i, (text, lang, k, mt) in enumerate(cs.POOL_REQUESTS)]
            audio = sum(f.result(timeout=600).metrics.audio_seconds for f in futs)
            rtf.append(audio / (time.perf_counter() - t0))
    finally:
        pool.shutdown()
    return rtf[1:]


def device_ms(fn, iters):
    """Device ms per call of ``fn`` from ``torch.profiler`` (self device time
    of every device op over ``iters`` calls, after one warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / iters


def kernels_ms(cs):
    """The kernels alone by CUDA events on seeded inputs: {label: [ms] x 3}."""
    import torch

    from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B
    from leaxer_qwen3_tts_torch.ops import fused_frame as K7
    from leaxer_qwen3_tts_torch.ops import fused_mtp as K2
    from leaxer_qwen3_tts_torch.ops import fused_mtp_stream as K3
    from leaxer_qwen3_tts_torch.ops import fused_step as K1
    from leaxer_qwen3_tts_torch.ops import flash_attention as K8
    from leaxer_qwen3_tts_torch.ops import fused_verify as K6
    from leaxer_qwen3_tts_torch.ops.quant import quantize_weight
    from leaxer_qwen3_tts_torch.runtime.sampling import gumbel_noise
    from leaxer_qwen3_tts_torch.tools import a8_probe as P1
    from leaxer_qwen3_tts_torch.tools import w8a8_probe as P2

    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    tt, cp = QWEN3_TTS_06B.talker.transformer, QWEN3_TTS_06B.code_predictor
    mt = cp.transformer
    tfw, mfw = cs.packed_trunk(tt, gen), cs.packed_trunk(mt, gen)
    H, V, n = mt.hidden_size, cp.subcode_vocab_size, cp.num_steps
    heads = K2.pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=cs.DEV) * H ** -0.5).to(torch.bfloat16)))
    tables = (torch.randn((n, V, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=cs.DEV)
    out = {}

    def timed(label, fn, iters):
        out[label] = [round(cs.time_ms(fn, iters), 4) for _ in range(3)]

    x, kc, vc = cs.k1_inputs(tt, 256, 200, torch.bfloat16, gen)
    timed("K1 T=256 pos 200", lambda: K1.fused_decode_step(tt, tfw, x, 200, kc, vc), 20)
    for B in (1, 4, 8, 32):
        lh = (torch.randn((B, H), generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
        c0 = (torch.randn((B, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
        noise = gumbel_noise((n, B, V), gen, cs.DEV)
        if B == 1:
            args = (mt, mfw, fnorm, heads, tables, lh, c0, noise, *cs.K5_KNOBS[1])
            timed("K2 sampled", lambda: K2.fused_mtp_chain(*args, cache_dtype=torch.bfloat16), 10)
            timed("K3 0.6B trunk sampled", lambda: K3.fused_mtp_chain_streamed(*args), 10)
            continue
        if B > 4:
            x, kc, vc, pos = cs.k4_inputs(tt, B, 512, torch.bfloat16, gen)
            pos_dev = torch.tensor(pos, device=cs.DEV)
            timed(f"K4 B={B} T=512",
                  lambda: K1.fused_decode_step_batched(tt, tfw, x, pos_dev, kc, vc), 10)
        knobs = [cs.K5_KNOBS[b % len(cs.K5_KNOBS)] for b in range(B)]
        args = (mt, mfw, fnorm, heads, tables, lh, c0, noise, *zip(*knobs))
        timed(f"K5 B={B} mixed knobs",
              lambda: K2.fused_mtp_chain_batched(*args, cache_dtype=torch.bfloat16), 5)
    for B, S, T, starts, _ in cs.K6_DEEP_CASES:
        if (B, S, T) == (1, 4, 512):
            continue
        x, kc, vc, pos = cs.k6_inputs(tt, B, S, T, starts, torch.bfloat16, gen)
        timed(f"K6 {B}x{S} T={T}", lambda: K6.fused_verify_step(tt, tfw, x, pos, kc, vc), 10)
    del x, kc, vc, tfw, mfw
    packs = cs.frame_packs(QWEN3_TTS_06B, gen)
    inp = cs.k7_inputs(packs, 255, 1, gen)
    caches = cs.k7_caches(packs[0], 256, 255, torch.bfloat16, gen)
    timed("K7 T=256 pos 255 sampled",
          lambda: cs.k7_call(K7.fused_frame_step, packs, inp, (0.8, 50, 0.95), *caches), 10)
    del packs, caches
    w, s = P1.make_weights("conv", device=cs.DEV)
    x0 = torch.full((1, P1.H), 0.1, device=cs.DEV)
    timed(f"P1 conv chain of {P1.S * P1.U} units", lambda: P1.chain("conv", w, s, x0), 10)
    del w, s
    q, k, v, mask = cs.k8_case(1, 57, 256, 16, 8, "prefill", torch.bfloat16, gen)
    timed("K8 1.7B prefill S=57 T=256", lambda: K8.flash_attend(q, k, v, mask), 200)
    out["K8 1.7B prefill device ms (profiler)"] = [
        round(device_ms(lambda: K8.flash_attend(q, k, v, mask), 200), 5) for _ in range(3)]
    w, s, x0 = P2.make_inputs(cs.DEV)
    for arm in P2.ARMS:
        timed(f"P2 {arm} chain of {P2.P * P2.U} units", lambda: P2.chain(arm, w, s, x0), 10)
    return out


def batched_ms(cs, eng):
    """The batched fixed runs and the kernels' ms, B=1 and batched:
    {label: ms}."""
    import torch

    from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B
    from leaxer_qwen3_tts_torch.ops import fused_mtp as K2
    from leaxer_qwen3_tts_torch.ops import fused_step as K1
    from leaxer_qwen3_tts_torch.ops.quant import quantize_weight
    from leaxer_qwen3_tts_torch.runtime.sampling import gumbel_noise

    out = {}
    for B in (8, 32):
        texts = [cs.BATCH_TEXTS[b % len(cs.BATCH_TEXTS)] for b in range(B)]
        out[f"fixed B={B} ms per batched frame"] = cs.check_fixed_run(eng, 300, texts, cs.CARD)
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    tt, cp = QWEN3_TTS_06B.talker.transformer, QWEN3_TTS_06B.code_predictor
    mt = cp.transformer
    tfw, mfw = cs.packed_trunk(tt, gen), cs.packed_trunk(mt, gen)
    H, V, n = mt.hidden_size, cp.subcode_vocab_size, cp.num_steps
    heads = K2.pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=cs.DEV) * H ** -0.5).to(torch.bfloat16)))
    tables = (torch.randn((n, V, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=cs.DEV)
    x, kc, vc = cs.k1_inputs(tt, 256, 200, torch.bfloat16, gen)
    out["K1 T=256 pos 200"] = cs.time_ms(lambda: K1.fused_decode_step(tt, tfw, x, 200, kc, vc), 20)
    for B in (1, 8, 32):
        lh = (torch.randn((B, H), generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
        c0 = (torch.randn((B, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
        noise = gumbel_noise((n, B, V), gen, cs.DEV)
        if B == 1:
            args = (mt, mfw, fnorm, heads, tables, lh, c0, noise, *cs.K5_KNOBS[1])
            out["K2 sampled"] = cs.time_ms(
                lambda: K2.fused_mtp_chain(*args, cache_dtype=torch.bfloat16), 10)
            continue
        x, kc, vc, pos = cs.k4_inputs(tt, B, 512, torch.bfloat16, gen)
        pos_dev = torch.tensor(pos, device=cs.DEV)
        out[f"K4 B={B} T=512"] = cs.time_ms(
            lambda: K1.fused_decode_step_batched(tt, tfw, x, pos_dev, kc, vc), 10)
        knobs = [cs.K5_KNOBS[b % len(cs.K5_KNOBS)] for b in range(B)]
        args = (mt, mfw, fnorm, heads, tables, lh, c0, noise, *zip(*knobs))
        out[f"K5 B={B} mixed knobs"] = cs.time_ms(
            lambda: K2.fused_mtp_chain_batched(*args, cache_dtype=torch.bfloat16), 5)
    return out


def frame_ms(cs, params, tok):
    """The frame_fused fixed runs and K7's ms on a seeded frame: {label: ms}."""
    import torch

    from leaxer_qwen3_tts_torch.api.engine import TTSEngine
    from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B
    from leaxer_qwen3_tts_torch.ops import fused_frame as K7

    eng = TTSEngine(config=QWEN3_TTS_06B, params=params, tokenizer=tok, quantize="int8",
                    frame_fused=True)
    eng.synthesize("warm up", language="en", max_tokens=16)
    out = {f"frame_fused fixed run {i}": cs.check_fixed_run(eng, 300, [TEXT], cs.CARD)
           for i in range(2)}
    del eng
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    packs = cs.frame_packs(QWEN3_TTS_06B, gen)
    inp = cs.k7_inputs(packs, 255, 1, gen)
    kc, vc = cs.k7_caches(packs[0], 256, 255, torch.bfloat16, gen)
    out["K7 T=256 pos 255 sampled"] = cs.time_ms(
        lambda: cs.k7_call(K7.fused_frame_step, packs, inp, (0.8, 50, 0.95), kc, vc), 10)
    return out


def voice_ms(cs, tok):
    """The 1.7B fixed instruct runs, K3's ms on a seeded chain, and the
    prefill ms and TTFA of four instruct requests: {label: ms or [ms]}."""
    import torch

    from leaxer_qwen3_tts_torch.api.engine import TTSEngine
    from leaxer_qwen3_tts_torch.ops import fused_mtp_stream as K3
    from leaxer_qwen3_tts_torch.runtime.sampling import gumbel_noise
    from leaxer_qwen3_tts_torch.runtime.weights import init_params

    cfg = cs.voice_config()
    params = init_params(cfg, seed=cs.SEED, device="cuda")
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8")
    del params
    eng.synthesize("warm up", language="en", max_tokens=16, instruct=cs.VOICE_INSTRUCT)
    out = {f"1.7B fixed instruct run {i}": cs.check_fixed_run(
        eng, 300, [cs.VOICE_TEXT], cs.CARD, instruct=cs.VOICE_INSTRUCT) for i in range(2)}
    requests = [eng.synthesize(cs.VOICE_TEXT, language="en", temperature=0.8, top_k=50,
                               top_p=0.95, max_tokens=48, seed=cs.SEED + i,
                               instruct=cs.VOICE_INSTRUCT).metrics for i in range(4)]
    out["1.7B instruct prefill ms"] = [round(m.stage_seconds["prefill"] * 1e3, 3)
                                       for m in requests]
    out["1.7B instruct TTFA ms"] = [round(m.ttfa_seconds * 1e3, 3) for m in requests]
    cp, cpp = cfg.code_predictor, eng.params["code_predictor"]
    H, V, n = cp.transformer.hidden_size, cp.subcode_vocab_size, cp.num_steps
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    lh = (torch.randn((1, H), generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
    c0 = (torch.randn((1, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
    args = (cp.transformer, cpp["fused_step"], cpp["transformer"]["final_norm"],
            cpp["fused_heads"], eng.params["embeddings"]["pred_embed"], lh, c0,
            gumbel_noise((n, 1, V), gen, cs.DEV), 0.8, 50, 0.95)
    out["K3 1.7B sampled"] = cs.time_ms(lambda: K3.fused_mtp_chain_streamed(*args), 10)
    return out


def chains_ms(cs):
    """K5 (B=8, 32; mixed and engine knobs) and the 1.7B float32-cache chain,
    timed three times and traced once each: {label: [ms, ms, ms]}."""
    import torch

    from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B, QWEN3_TTS_17B
    from leaxer_qwen3_tts_torch.ops import fused_mtp as K2
    from leaxer_qwen3_tts_torch.ops.quant import quantize_weight
    from leaxer_qwen3_tts_torch.runtime.sampling import gumbel_noise

    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    out = {}
    for cfg in (QWEN3_TTS_06B, QWEN3_TTS_17B):
        cp = cfg.code_predictor
        mt = cp.transformer
        H, V, n = mt.hidden_size, cp.subcode_vocab_size, cp.num_steps
        mfw = cs.packed_trunk(mt, gen)
        heads = K2.pack_heads(quantize_weight(
            (torch.randn((n, H, V), generator=gen, device=cs.DEV) * H ** -0.5).to(torch.bfloat16)))
        tables = (torch.randn((n, V, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
        fnorm = torch.ones((H,), dtype=torch.bfloat16, device=cs.DEV)
        runs = []
        if cfg is QWEN3_TTS_06B:
            for B in (8, 32):
                for label, knobs in (("mixed", [cs.K5_KNOBS[b % len(cs.K5_KNOBS)]
                                                for b in range(B)]),
                                     ("engine knobs", [(0.8, 50, 0.95)] * B)):
                    runs.append((f"K5 B={B} {label}", B, knobs, True))
        else:
            runs.append(("1.7B chain, float32 cache", 1, [(0.8, 50, 0.95)], False))
        for label, B, knobs, batched in runs:
            lh = (torch.randn((B, H), generator=gen, device=cs.DEV) * 0.5).to(torch.bfloat16)
            c0 = (torch.randn((B, H), generator=gen, device=cs.DEV) * 0.02).to(torch.bfloat16)
            noise = gumbel_noise((n, B, V), gen, cs.DEV)
            if batched:
                args = (mt, mfw, fnorm, heads, tables, lh, c0, noise, *zip(*knobs))
                fn = lambda: K2.fused_mtp_chain_batched(*args, cache_dtype=torch.bfloat16)
                plan = K2._batch_chain_entry("qtts_mtp_chain_batched", mt, mfw, heads, tables, B,
                                             torch.bfloat16, lh.device).plan
            else:
                args = (mt, mfw, fnorm, heads, tables, lh, c0, noise, *knobs[0])
                fn = lambda: K2.fused_mtp_chain(*args, cache_dtype=torch.float32)
                plan = K2._chain_entry("qtts_mtp_chain", mt, mfw, heads, tables, torch.float32,
                                       lh.device).plan
            out[label] = [cs.time_ms(fn, 5) for _ in range(3)]
            cs.trace_phases(f"{label}", plan, cs.chain_phase_names(mt.num_layers, n, batched),
                            fn)
        del mfw, heads, tables
        torch.cuda.empty_cache()
    return out


def mesh_ms(cs, tok):
    """The tensor-parallel path: {label: [ms] x 3} of the K9 step and K10 at
    0.6B tp=2 and 1.7B tp=4, then the mesh engines (they log their lines)."""
    import torch

    from leaxer_qwen3_tts_torch.ops import fused_mtp_tp as K10
    from leaxer_qwen3_tts_torch.ops import fused_tp as K9

    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    out = {}
    for name, cfg, tp in cs.TP_MODELS:
        mesh = cs.make_mesh(1, tp, devices=cs.card_devices(tp))
        t = cfg.talker.transformer
        fw = cs.tp_pack(t, tp, mesh, gen)
        x = torch.randn((1, t.hidden_size), generator=gen, device=cs.DEV) * 0.3
        kc, vc = cs.tp_caches(t, tp, 256, 200, torch.bfloat16, gen, mesh.model_devices())
        out[f"{name} K9 step"] = [
            cs.time_ms(lambda: K9.fused_decode_step_tp(t, fw, x, 200, kc, vc, mesh), 20)
            for _ in range(3)]
        del fw, kc, vc
        cp, cfw, heads, tables, fnorm = cs.tp_chain_packs(name, cfg, tp, mesh, gen)
        sp, lh, c0, noise = cs.tp_chain_inputs(cp, gen, (0.8, 50, 0.95))
        args = (fnorm, heads["bf16"], tables, lh, c0, noise, sp.temperature, sp.top_k, sp.top_p)
        out[f"{name} K10"] = [
            cs.time_ms(lambda: K10.fused_mtp_chain_tp(cp.transformer, tp, mesh, cfw, *args), 20)
            for _ in range(3)]
        del cfw, heads, tables
        torch.cuda.empty_cache()
    cs.tp_engine_runs(tok, cs.CARD)
    return out


def run_one(root: str, spec: bool, batched: bool, frame: bool = False,
            voice: bool = False, chains: bool = False, kernels: bool = False,
            mesh: bool = False) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from leaxer_qwen3_tts_torch.api.engine import TTSEngine
    from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B
    from leaxer_qwen3_tts_torch.runtime.weights import init_params

    if not os.path.abspath(cs.__file__).startswith(root):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {root}")
    cs.CARD = cs.card()
    torch.backends.cuda.matmul.allow_tf32 = False
    if chains:
        print(f"AB {root}: chains {chains_ms(cs)} [{cs.CARD}]", flush=True)
        return
    if mesh:
        with tempfile.TemporaryDirectory() as workdir:
            tok = cs.byte_level_tokenizer(workdir)
        print(f"AB {root}: mesh {mesh_ms(cs, tok)} [{cs.CARD}]", flush=True)
        return
    if kernels:
        print(f"AB {root}: kernels {kernels_ms(cs)} [{cs.CARD}]", flush=True)
        if not (spec or batched or frame or voice):
            return
    params = init_params(QWEN3_TTS_06B, seed=cs.SEED, device="cuda")
    with tempfile.TemporaryDirectory() as workdir:
        tok = cs.byte_level_tokenizer(workdir)
    eng = TTSEngine(config=QWEN3_TTS_06B, params=params, tokenizer=tok, quantize="int8")
    eng.synthesize("warm up", language="en", max_tokens=16)
    ms = [cs.check_fixed_run(eng, 300, [TEXT], cs.CARD) for _ in range(3)]
    print(f"AB {root}: ms/frame {ms} [{cs.CARD}]", flush=True)
    if spec:
        print(f"AB {root}: spec k=4 ms per committed frame {spec_ms(cs, eng)} [{cs.CARD}]",
              flush=True)
        print(f"AB {root}: spec pool 8 x {cs.POOL_SPEC_K} aggregate RTF "
              f"{spec_pool_rtf(cs, params, tok, eng)} [{cs.CARD}]", flush=True)
    if batched:
        print(f"AB {root}: batched {batched_ms(cs, eng)} [{cs.CARD}]", flush=True)
    if frame:
        print(f"AB {root}: frame_fused {frame_ms(cs, params, tok)} [{cs.CARD}]", flush=True)
    if voice:
        del eng, params
        torch.cuda.empty_cache()
        print(f"AB {root}: 1.7B {voice_ms(cs, tok)} [{cs.CARD}]", flush=True)


def main() -> int:
    args = sys.argv[1:]
    names = ("--spec", "--batched", "--frame", "--voice", "--chains", "--kernels", "--mesh")
    flags = [a for a in args if a in names]
    args = [a for a in args if a not in flags]
    if args[:1] == ["--one"]:
        run_one(os.path.abspath(args[1]), *(f in flags for f in names))
        return 0
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = args
    for root in (old, new, new, old):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root] + flags,
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith(("AB ", "fixed run", "trace ")) or " mesh tp=" in ln]
        print("\n".join(lines) if lines else out.stdout[-2000:] + out.stderr[-2000:], flush=True)
        if out.returncode != 0:
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
