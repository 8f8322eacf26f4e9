"""Smoke test of the PyTorch port on one NVIDIA GPU (H100): build, check, drive.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and never
prints the final line:

1. Device: requires CUDA (there is no CPU path); prints the card's name and
   power limit; turns TF32 off for matmuls and cuDNN.
2. Build: compiles the CUDA kernels from ``leaxer_qwen3_tts_torch/csrc``.
3. K1 (``fused_decode_step``) against its plain PyTorch version at the 0.6B
   talker shapes (28 layers, H=1024, int8, bf16 cache) at T=256 and T=2560,
   at the MTP trunk shapes (6 layers, T=17), and on 1 talker layer, where
   rounding cannot cascade, with a float32 and a bf16 cache at every bucket
   and at the attention's split edges: 24 seeded inputs per case, each within
   flip-tolerant limits and at least 8 of them agreeing to 1e-5.
4. K2 (``fused_mtp_chain``) against its plain version at the 0.6B MTP shapes,
   greedy and sampled, on the same noise.
5. Slice: ``TTSEngine.synthesize`` (0.6B preset, random weights from a seed,
   int8) on three requests, then a fixed 300-frame run through the generate
   callables and the engine's cache growth (256 -> 512 slots), with any host
   sync inside a decode chunk raising.  Launch counters, reset just before,
   must show one K1 step and one K2 chain per decoded frame.
6. The kernel report and the device line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.config import (
    LANG_ENGLISH,
    QWEN3_TTS_06B,
    SAMPLES_PER_FRAME,
)
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.frontend._bpe_py import byte_to_proxy
from leaxer_qwen3_tts_torch.models.codec12hz import vocoder_forward
from leaxer_qwen3_tts_torch.models.layers import init_transformer_params
from leaxer_qwen3_tts_torch.ops import _build
from leaxer_qwen3_tts_torch.ops import fused_mtp as K2
from leaxer_qwen3_tts_torch.ops import fused_step as K1
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params, quantize_weight
from leaxer_qwen3_tts_torch.runtime.prompt import prompt_length
from leaxer_qwen3_tts_torch.runtime.sampling import (
    SamplingParams,
    gumbel_noise,
    scale_by_temperature,
)
from leaxer_qwen3_tts_torch.runtime.weights import init_params

DEV = torch.device("cuda")
SEED = 0
# Kernel vs plain tolerances.  Both sides round the same operands to bf16
# and accumulate in float32 in different orders; a ~1e-7 difference flips
# the bf16 rounding of a few activations and bf16 cache entries (one ulp:
# 0.0078 at magnitude 1), and over 28 random-weight layers the flips compound:
# the plain version moves by ~1e-2 relative (x) under a 2^-20 relative
# change of its own input (measured on an H100; printed beside each check
# as `plain_sensitivity`), so the deep bf16 checks are held to 5e-2.  On one
# layer nothing cascades: most inputs agree to ~1e-7, and when a GEMV input
# lands on a bf16 rounding edge the flip moves x by up to 1.8e-3 relative and
# the written slot by up to 2.2e-3 relative (288 seeded inputs, H100).  A wrong
# index, sign or scale moves them by O(1).  Those flip-tolerant limits cannot
# see a small systematic fault (one attention slot dropped or counted twice, a
# bf16-rounded residual: 2e-3 to 5e-3 relative), so each shallow case also
# runs K1_TIGHT_INPUTS seeded inputs and needs K1_TIGHT_MIN of them to agree
# to K1_TIGHT_REL in x and in the written slot.  A flip hits some inputs: on
# an H100 16 to 23 of 24 agreed, for both cache dtypes at every position.  A
# systematic fault hits every input: each of those three faults, built into
# a copy of fused_step.cu, left 0 of 24 tight wherever it applies.
K1_DEEP_X_REL, K1_DEEP_SLOT_ABS = 5e-2, 1.25e-1  # max|dx|/max|x|; slot abs
K1_SHALLOW_X_REL, K1_SHALLOW_SLOT_ABS = 1e-2, 2.5e-2
K1_SHALLOW_LAYERS = 1
# every ladder bucket, the attention's 64-slot split edges and the first slot
K1_SHALLOW_CASES = ((2560, 1800), (256, 0), (256, 63), (512, 64), (1024, 1023), (2560, 2559))
K1_TIGHT_REL = 1e-5
K1_TIGHT_INPUTS, K1_TIGHT_MIN = 24, 8
K2_MARGIN_REL = 1e-5  # a sub-code mismatch passes only below this score margin
K2_SUM_ABS = 1e-5  # sub_sum when every sub-code matches (same table rows)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def packed_trunk(t, gen):
    layers = quantize_params(fuse_params({"m": {"transformer": init_transformer_params(
        t, gen, DEV)}}, modules=("m",)), modules=("m",))["m"]["transformer"]["layers"]
    return K1.pack_fused_weights(t, layers)


@dataclasses.dataclass
class K1Run:
    """One seeded input through K1 and its plain version."""

    x: torch.Tensor
    kc: torch.Tensor  # caches before the step
    vc: torch.Tensor
    xp: torch.Tensor  # the plain version's x
    err: float  # max |x_kernel - x_plain|
    rel: float  # err / max |x_plain|
    slot_err: float  # max abs error of the k and v written at pos
    slot_rel: float  # slot_err / max |written slot, plain|
    untouched: bool  # the kernel left every other slot as it was


def k1_run(t, fw, T, pos, cache_dtype, gen) -> K1Run:
    L, nk, d = t.num_layers, t.num_kv_heads, t.head_dim
    x = torch.randn((1, t.hidden_size), generator=gen, device=DEV) * 0.3
    kc = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    vc = (torch.randn((L, 1, nk, T, d), generator=gen, device=DEV) * 0.5).to(cache_dtype)
    kc[:, :, :, pos:] = 0
    vc[:, :, :, pos:] = 0
    kk, vk = kc.clone(), vc.clone()
    kp, vp = kc.clone(), vc.clone()
    xk, _, _ = K1.fused_decode_step(t, fw, x, pos, kk, vk)
    xp, _, _ = K1.fused_decode_step_reference(t, fw, x, pos, kp, vp)
    torch.cuda.synchronize()
    err = float((xk - xp).abs().max())
    slot_k = torch.stack((kk[:, :, :, pos], vk[:, :, :, pos])).float()
    slot_p = torch.stack((kp[:, :, :, pos], vp[:, :, :, pos])).float()
    slot_err = float((slot_k - slot_p).abs().max())
    others = torch.ones(T, dtype=torch.bool, device=DEV)
    others[pos] = False
    untouched = bool(torch.equal(kk[:, :, :, others], kc[:, :, :, others])) and bool(
        torch.equal(vk[:, :, :, others], vc[:, :, :, others]))
    return K1Run(x, kc, vc, xp, err, err / float(xp.abs().max()), slot_err,
                 slot_err / float(slot_p.abs().max()), untouched)


def time_k1(t, fw, r: K1Run, pos, iters):
    """Kernel and plain ms per step on the run's input and caches."""
    kk, vk, kp, vp = r.kc.clone(), r.vc.clone(), r.kc.clone(), r.vc.clone()
    ms = time_ms(lambda: K1.fused_decode_step(t, fw, r.x, pos, kk, vk), iters)
    plain_ms = time_ms(lambda: K1.fused_decode_step_reference(t, fw, r.x, pos, kp, vp), 3, 1)
    return ms, plain_ms


def check_k1_deep(name, t, fw, T, pos, gen, iters):
    """One input at full depth with a bf16 cache, held to the deep limits."""
    r = k1_run(t, fw, T, pos, torch.bfloat16, gen)
    # elementwise (a uniform scale would vanish in the first RMSNorm)
    wiggle = 1 + 2 ** -20 * torch.randn(r.x.shape, generator=gen, device=DEV)
    xs, _, _ = K1.fused_decode_step_reference(t, fw, r.x * wiggle, pos, r.kc.clone(),
                                              r.vc.clone())
    sensitivity = float((xs - r.xp).abs().max()) / float(r.xp.abs().max())
    ms, plain_ms = time_k1(t, fw, r, pos, iters)
    ok = r.rel < K1_DEEP_X_REL and r.slot_err < K1_DEEP_SLOT_ABS and r.untouched
    log(f"K1 {name}: L={t.num_layers} T={T} pos={pos} cache=bfloat16 x max_abs_err="
        f"{r.err:.3e} rel={r.rel:.3e} (tol {K1_DEEP_X_REL}; plain_sensitivity "
        f"{sensitivity:.3e}) slot max_abs_err={r.slot_err:.3e} (tol {K1_DEEP_SLOT_ABS}) "
        f"untouched_slots_equal={r.untouched} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K1 {name} disagrees with its plain version")
    return r.err, ms, plain_ms


def check_k1_shallow(name, t, fw, T, pos, cache_dtype, gen, iters):
    """K1_TIGHT_INPUTS seeded inputs on a shallow trunk: every one within the
    flip-tolerant limits, and at least K1_TIGHT_MIN of them tight."""
    runs = [k1_run(t, fw, T, pos, cache_dtype, gen) for _ in range(K1_TIGHT_INPUTS)]
    rel = max(r.rel for r in runs)
    slot_err = max(r.slot_err for r in runs)
    untouched = all(r.untouched for r in runs)
    tight = sum(r.rel <= K1_TIGHT_REL and r.slot_rel <= K1_TIGHT_REL for r in runs)
    ms = plain_ms = float("nan")
    if iters:
        ms, plain_ms = time_k1(t, fw, runs[0], pos, iters)
    ok = (rel < K1_SHALLOW_X_REL and slot_err < K1_SHALLOW_SLOT_ABS and untouched
          and tight >= K1_TIGHT_MIN)
    log(f"K1 {name}: L={t.num_layers} T={T} pos={pos} cache={str(cache_dtype)[6:]} "
        f"{len(runs)} inputs: x max rel {rel:.3e} (tol {K1_SHALLOW_X_REL}) slot "
        f"max_abs_err={slot_err:.3e} (tol {K1_SHALLOW_SLOT_ABS}) tight (x and slot rel <= "
        f"{K1_TIGHT_REL}) {tight}/{len(runs)} (need {K1_TIGHT_MIN}) "
        f"untouched_slots_equal={untouched} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K1 {name} T={T} pos={pos} disagrees with its plain version")
    return max(r.err for r in runs), ms, plain_ms


def check_k2(knobs, cp, fw, heads, tables, fnorm, gen, iters):
    n, V = cp.num_steps, cp.subcode_vocab_size
    H = cp.transformer.hidden_size
    t = cp.transformer
    sp = SamplingParams.create(*knobs)
    mode = "greedy" if sp.greedy else f"sampled T={sp.temperature} k={sp.top_k} p={sp.top_p}"
    lh = (torch.randn((1, H), generator=gen, device=DEV) * 0.5).to(torch.bfloat16)
    c0 = (torch.randn((1, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    noise = None if sp.greedy else gumbel_noise((n, 1, V), gen, DEV)

    def run(fn):
        return fn(t, fw, fnorm, heads, tables, lh, c0, noise, sp.temperature, sp.top_k,
                  sp.top_p, cache_dtype=torch.bfloat16)

    sk, sum_k = run(K2.fused_mtp_chain)
    # the plain run records each step's sampler inputs for the margin check
    seen = []
    real = K2.gumbel_topk_topp_sample

    def record(logits, g, *a):
        seen.append((logits.clone(), None if g is None else g.clone()))
        return real(logits, g, *a)

    K2.gumbel_topk_topp_sample = record
    try:
        sp_, sum_p = run(K2.fused_mtp_chain_reference)
    finally:
        K2.gumbel_topk_topp_sample = real
    torch.cuda.synchronize()
    kern, plain = sk[0].tolist(), sp_[0].tolist()
    diff = [j for j in range(n) if kern[j] != plain[j]]
    if diff:
        j = diff[0]
        logits, g = seen[j]
        score = logits[0] if sp.greedy else scale_by_temperature(logits[0], sp.temperature) + g[0]
        margin = float((score[kern[j]] - score[plain[j]]).abs() / score.abs().max())
        ok = margin < K2_MARGIN_REL
        log(f"K2 {mode}: first sub-code mismatch at step {j}: kernel {kern[j]} plain "
            f"{plain[j]} relative score margin {margin:.3e} (tol {K2_MARGIN_REL})")
        err = float("nan")
    else:
        err = float((sum_k - sum_p).abs().max())
        ok = err < K2_SUM_ABS
    ms = plain_ms = float("nan")
    if iters:
        ms = time_ms(lambda: run(K2.fused_mtp_chain), iters)
        plain_ms = time_ms(lambda: run(K2.fused_mtp_chain_reference), 2, 1)
    log(f"K2 {mode}: subcodes kernel {kern} plain {plain} equal={not diff} sub_sum "
        f"max_abs_err={err:.3e} (tol {K2_SUM_ABS}) kernel {ms:.4f} ms/chain plain "
        f"{plain_ms:.4f} ms/chain -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K2 {mode} disagrees with its plain version")
    return 0.0 if diff else err, ms, plain_ms


def byte_level_tokenizer(workdir: str) -> Tokenizer:
    """All 256 byte proxies plus a few merges (the tests' tiny vocab)."""
    proxy = byte_to_proxy()
    tokens = [proxy[b] for b in range(256)]
    merges = []
    for a, b in [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), ("Ġ", "w"),
                 ("o", "r"), ("Ġw", "or"), ("l", "d"), ("Ġwor", "ld")]:
        merges.append((a, b))
        if a + b not in tokens:
            tokens.append(a + b)
    vocab_path = os.path.join(workdir, "vocab.json")
    merges_path = os.path.join(workdir, "merges.txt")
    with open(vocab_path, "w") as f:
        json.dump({tok: i for i, tok in enumerate(tokens)}, f, ensure_ascii=True)
    with open(merges_path, "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return Tokenizer(vocab_path, merges_path)


def fixed_length_run(eng, frames_total: int):
    """``frames_total`` frames with EOS forbidden, through the generate
    callables and the engine's cache growth, as the engine loop drives them."""
    sp = SamplingParams.create(0.8, 50, 0.95, forbid_eos=True)
    ids = eng._tokenize("hello world, this is a fixed length run")
    lang_id = LANG_ENGLISH
    P = prompt_length(lang_id)
    ladder = eng.kv_ladder
    bidx = next(i for i, b in enumerate(ladder) if b >= P + eng.chunk_len + 1)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    ids_t = torch.tensor([ids], device=DEV)
    lens = torch.tensor([len(ids)], device=DEV)
    t0 = time.perf_counter()
    state, bundle = eng._get_fns(lang_id, ladder[bidx], eng.first_chunk_len).prefill(
        eng.params, ids_t, lens, gen)
    if state.pos != P:
        raise RuntimeError(f"prompt length {state.pos} != {P}")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    frames, valid, buckets = [], [], []
    steps, decode_s = 0, 0.0
    while steps < frames_total:
        cur = min(eng.first_chunk_len if steps == 0 else eng.chunk_len, frames_total - steps)
        while P + steps + cur + 1 > ladder[bidx] and bidx + 1 < len(ladder):
            bidx += 1
            state = eng._grow_state(state, ladder[bidx])
        buckets.append(state.cache.max_len)
        fns = eng._get_fns(lang_id, ladder[bidx], cur)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the chunk raises
        try:
            state, fr, vd = fns.decode(eng.params, state, bundle.trailing,
                                       bundle.trailing_len, bundle.tts_pad_embed, sp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        frames.append(fr.cpu())
        decode_s += time.perf_counter() - t0
        valid.append(vd.cpu())
        steps += cur
    codes = torch.cat(frames, dim=1)
    audio = vocoder_forward(eng.cfg.vocoder, eng.params["vocoder"], codes.to(DEV)).cpu()
    return codes, torch.cat(valid, dim=1), audio, buckets, prefill_s, decode_s


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    card_line = card()
    log(f"card: {card_line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.basename(path)}")
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    cfg = QWEN3_TTS_06B
    talker_t = cfg.talker.transformer
    mtp_t = cfg.code_predictor.transformer
    talker_fw = packed_trunk(talker_t, gen)
    mtp_fw = packed_trunk(mtp_t, gen)
    k1 = [
        check_k1_deep("talker", talker_t, talker_fw, 256, 200, gen, 20),
        check_k1_deep("talker", talker_t, talker_fw, 2560, 1800, gen, 20),
        check_k1_deep("mtp-trunk", mtp_t, mtp_fw, 17, 9, gen, 50),
    ]
    del talker_fw
    ts = dataclasses.replace(talker_t, num_layers=K1_SHALLOW_LAYERS)
    fws = packed_trunk(ts, gen)
    for cache_dtype in (torch.float32, torch.bfloat16):
        for T, pos in K1_SHALLOW_CASES:
            timed = cache_dtype == torch.float32 and pos == 1800
            k1.append(check_k1_shallow(f"talker-{K1_SHALLOW_LAYERS}-layer", ts, fws, T, pos,
                                       cache_dtype, gen, 20 if timed else 0))

    cp = cfg.code_predictor
    H, V, n = mtp_t.hidden_size, cp.subcode_vocab_size, cp.num_steps
    heads = K2.pack_heads(quantize_weight(
        (torch.randn((n, H, V), generator=gen, device=DEV) * H ** -0.5).to(torch.bfloat16)))
    tables = (torch.randn((n, V, H), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    fnorm = torch.ones((H,), dtype=torch.bfloat16, device=DEV)
    # greedy and the engine's default knobs (timed), then top-k / top-p off
    # and top_k = 1
    k2 = [check_k2(knobs, cp, mtp_fw, heads, tables, fnorm, gen, iters) for knobs, iters in (
        ((0.0,), 10), ((0.8, 50, 0.95), 10), ((1.0, 0, 1.0), 0), ((0.7, 1, 0.9), 0))]
    del mtp_fw, heads, tables
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=DEV)
    with tempfile.TemporaryDirectory() as workdir:
        tok = byte_level_tokenizer(workdir)
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, quantize="int8")
    del params
    torch.cuda.synchronize()
    log(f"engine: 0.6B preset, random weights (seed {SEED}), int8, built in "
        f"{time.perf_counter() - t0:.1f} s; KV ladder {eng.kv_ladder}")

    K1.fused_decode_step.launches = 0
    K2.fused_mtp_chain.launches = 0
    requests = [
        dict(text="hello world", language="en", temperature=0.0),
        dict(text="hello world, hello world", language="en", temperature=0.8, top_k=50,
             top_p=0.95),
        dict(text="你好，世界", language="zh", temperature=0.8, top_k=50, top_p=0.95),
    ]
    decoded = 0
    for req in requests:
        r = eng.synthesize(max_tokens=48, seed=SEED, **req)
        m = r.metrics
        decoded += m.decoded_frames
        if r.audio.shape != (r.codes.shape[0] * SAMPLES_PER_FRAME,) or not np.isfinite(
                r.audio).all() or r.codes.shape[1:] != (16,):
            raise RuntimeError(f"bad synthesis output for {req}")
        decode_ms = m.stage_seconds.get("decode", 0.0) * 1e3 / max(m.decoded_frames, 1)
        log(f"synthesize {req['language']} T={req['temperature']}: {m.frames} frames "
            f"({m.decoded_frames} decoded), {decode_ms:.3f} ms/frame decode, RTF "
            f"{m.rtf:.2f}x, TTFA {m.ttfa_seconds * 1e3:.1f} ms, total "
            f"{m.total_seconds * 1e3:.1f} ms [{card_line}]")

    n_fixed = 300
    codes, valid, audio, buckets, prefill_s, decode_s = fixed_length_run(eng, n_fixed)
    decoded += n_fixed
    launches = (K1.fused_decode_step.launches, K2.fused_mtp_chain.launches)
    if codes.shape != (1, n_fixed, 16) or not bool(valid.all()):
        raise RuntimeError("fixed-length run: wrong frame count or an invalid frame")
    if audio.shape != (1, n_fixed * SAMPLES_PER_FRAME) or not bool(torch.isfinite(audio).all()):
        raise RuntimeError("fixed-length run: bad audio")
    if buckets[0] != 256 or 512 not in buckets:
        raise RuntimeError(f"fixed-length run did not grow the cache 256 -> 512: {buckets}")
    ms_frame = decode_s * 1e3 / n_fixed
    log(f"fixed run: {n_fixed} frames, buckets {sorted(set(buckets))}, prefill "
        f"{prefill_s * 1e3:.1f} ms, {ms_frame:.3f} ms/frame, RTF "
        f"{(n_fixed / 12) / (prefill_s + decode_s):.2f}x [{card_line}]")
    if launches != (decoded, decoded):
        raise RuntimeError(f"launch counts {launches}, expected one K1 and one K2 per "
                           f"decoded frame ({decoded})")
    log(f"launches on the main path: K1 {launches[0]}, K2 {launches[1]} "
        f"= one each per decoded frame ({decoded})")

    report = {"kernels": [
        {"name": "fused_decode_step", "route": "cuda",
         "source": "leaxer_qwen3_tts_torch/csrc/fused_step.cu",
         "replaces": "leaxer_qwen3_tts_tpu/ops/fused_step.py:1290",
         "launches": launches[0], "max_abs_err": max(e for e, _, _ in k1),
         "ms": k1[0][1], "plain_ms": k1[0][2]},
        {"name": "fused_mtp_chain", "route": "cuda",
         "source": "leaxer_qwen3_tts_torch/csrc/fused_mtp.cu",
         "replaces": "leaxer_qwen3_tts_tpu/ops/fused_mtp.py:835",
         "launches": launches[1], "max_abs_err": max(e for e, _, _ in k2),
         "ms": k2[1][1], "plain_ms": k2[1][2]},
    ]}
    print(json.dumps(report))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
