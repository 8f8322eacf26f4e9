"""int8-vs-bf16 fidelity report for the quantized decode configuration.

Port of the JAX package's ``tools/quality_report.py``: the same comparison,
flags and JSON, plus ``--device {cuda,cpu}``.  The fast configuration is
int8 (or int4) weight units; the quality-exact one is bf16.  This tool
quantifies what quantization changes, with the per-stage oracles of the
parity gate (``parity_check.compute_stages``) on the SAME weights:

  * prefill / per-step decode logit correlation and L-inf
  * greedy code agreement (exact-match fraction + first divergence step)
  * waveform L-inf / RMS over the agreeing prefix (after the first code
    divergence the audio legitimately differs, so global waveform distance
    is not meaningful)

Caveat: on random-init weights (``--random-preset``) the logits are
near-uniform, so greedy top-1 agreement is a PESSIMISTIC bound and the
figures are numerics, not perceived quality; rerun on converted real
weights for the fidelity numbers that matter.

Usage:
  python -m leaxer_qwen3_tts_torch.tools.quality_report --model <ckpt> [--text ...]
      [--max-frames N] [--quantize int8|int4] [--kv-quant] [--device {cuda,cpu}]
  python -m leaxer_qwen3_tts_torch.tools.quality_report --random-preset \\
      qwen3-tts-12hz-0.6b-base
Prints one JSON line; exit 0 (reporting, not a gate; 1 if an engine is not ready).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

FILL_CHUNK = 1 << 24  # elements of a leaf filled at a time


def compare(bf16_stages: dict, int8_stages: dict) -> dict:
    out: dict = {}
    a, b = bf16_stages, int8_stages

    def corr(x, y):
        x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
        if x.size == 0 or x.std() == 0 or y.std() == 0:
            return 1.0
        return float(np.corrcoef(x, y)[0, 1])

    out["prefill_logit_corr"] = corr(a["prefill_logits"], b["prefill_logits"])
    out["prefill_logit_linf"] = float(
        np.max(np.abs(a["prefill_logits"] - b["prefill_logits"]))
    )

    ca, cb = a["codes"], b["codes"]
    n = min(len(ca), len(cb))
    if n:
        eq = (ca[:n] == cb[:n]).all(axis=1)
        first_div = int(np.argmin(eq)) if not eq.all() else n
        out["frames_compared"] = n
        out["code_agreement"] = float((ca[:n] == cb[:n]).mean())
        out["first_divergence_frame"] = first_div
        # per-step logit fidelity over the AGREEING prefix (identical history)
        la, lb = a["decode_logits"], b["decode_logits"]
        m = min(len(la), len(lb), max(first_div, 1))
        out["decode_logit_corr_agreeing"] = corr(la[:m], lb[:m])
        out["decode_logit_linf_agreeing"] = float(
            np.max(np.abs(la[:m] - lb[:m]))
        ) if m else 0.0
        # waveform distance over the agreeing prefix
        spf = 2000
        wa = a["waveform"][: first_div * spf]
        wb = b["waveform"][: first_div * spf]
        k = min(len(wa), len(wb))
        if k:
            out["waveform_linf_agreeing"] = float(np.max(np.abs(wa[:k] - wb[:k])))
            out["waveform_rms_agreeing"] = float(
                np.sqrt(np.mean((wa[:k] - wb[:k]) ** 2))
            )
    return out


def _leaf_order(key: str):
    """The JAX pytree's flatten order of a '/'-joined member name: dict keys
    sorted, list items by index."""
    return tuple((0, int(s), "") if s.isdigit() else (1, 0, s) for s in key.split("/"))


def _fill(i: int, shape, dtype, device):
    """Leaf ``i`` of the JAX tool's fill, bit for bit:
    ``(iota * 16807 + i * 131) % 199``, then ``(v / 199 - 0.5) * 0.04`` in
    float32, cast to ``dtype``.  ``iota`` is each element's index rounded to
    float32 (XLA's float32 iota).  XLA's CPU compiler computes both
    expressions as fused multiply-adds, the division as a product with the
    float32 reciprocal of 199: here each product and sum is exact in float64
    and rounded to float32 once, as an FMA rounds.  The remainder is exact."""
    import torch

    n = int(np.prod(shape))
    recip = float(np.float32(1.0) / np.float32(199.0))
    out = torch.empty((n,), dtype=dtype, device=device)
    for s in range(0, n, FILL_CHUNK):
        e = min(n, s + FILL_CHUNK)
        iota = torch.arange(s, e, dtype=torch.int64, device=device).to(torch.float32)
        v = torch.fmod((iota.double() * 16807.0 + float(i * 131)).float(), 199.0)
        out[s:e] = ((v.double() * recip - 0.5).float() * 0.04).to(dtype)
    return out.reshape(shape)


def _random_engine_inputs(preset: str, device="cuda"):
    """Random params for a preset, filled on ``device`` (no host-to-device
    weight transfer): the JAX tool's values bit for bit, leaf ``i`` in its
    flatten order, on the port's params (the checkpoints' member names) for
    ``with_speaker_encoder=False``.  The values are irrelevant to the
    fidelity comparison, which runs both configurations on the SAME params."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..config import PRESETS
    from ..runtime.weights import _leaves, init_params, unflatten_params

    cfg = PRESETS[preset]
    with FakeTensorMode():  # shapes and dtypes only: nothing is allocated
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in _leaves(
            init_params(cfg, device="cpu", with_speaker_encoder=False))}
    device = torch.device(device)
    flat = {k: _fill(i, *shapes[k], device) for i, k in enumerate(sorted(shapes, key=_leaf_order))}
    return cfg, unflatten_params(flat)


def _tiny_tokenizer():
    """Byte-level fallback tokenizer (256-proxy vocab) for --random-preset:
    the fidelity comparison only needs SOME deterministic ids."""
    import tempfile

    from ..frontend import Tokenizer
    from ..frontend._bpe_py import byte_to_proxy

    proxy = byte_to_proxy()
    vocab = {proxy[b]: b for b in range(256)}
    d = tempfile.mkdtemp()
    with open(f"{d}/vocab.json", "w") as f:
        json.dump(vocab, f, ensure_ascii=True)
    with open(f"{d}/merges.txt", "w") as f:
        f.write("#version: 0.2\n")
    return Tokenizer(f"{d}/vocab.json", f"{d}/merges.txt")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="leaxer_qwen3_tts_torch.tools.quality_report",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", help="framework checkpoint dir")
    p.add_argument("--random-preset", help="preset name: random-init params "
                   "filled on the device (no checkpoint needed)")
    p.add_argument("--text", default="hello world")
    p.add_argument("--language", default="auto")
    p.add_argument("--max-frames", type=int, default=48)
    p.add_argument("--quantize", default="int8", choices=["int8", "int4"],
                   help="quantized configuration to compare against bf16")
    p.add_argument("--kv-quant", action="store_true",
                   help="compare the int8 KV CACHE against the bf16 cache "
                        "with UNquantized weights (isolates cache fidelity "
                        "from weight quantization)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engines run: the card (default) or the CPU; no "
                        "fallback between them")
    args = p.parse_args(argv)
    if not args.model and not args.random_preset:
        p.error("need --model or --random-preset")

    from ..api.engine import TTSEngine
    from ..cli.main import engine_device
    from .parity_check import compute_stages, device_ready

    device = engine_device(args.device)
    if args.random_preset:
        if not device_ready(device):
            return 1
        cfg, params = _random_engine_inputs(args.random_preset, device or "cuda")
        tok = _tiny_tokenizer()
        print("random weights: the figures are numerics, not perceived quality",
              file=sys.stderr)

    if args.kv_quant:
        # isolate the CACHE: both engines keep full-precision weights
        variants = (("cache_bf16", dict()), ("cache_int8", dict(kv_quant=True)))
        base, other = "cache_bf16", "cache_int8"
    else:
        variants = (("bf16", dict()), (args.quantize, dict(quantize=args.quantize)))
        base, other = "bf16", args.quantize
    results = {}
    for name, kw in variants:
        if args.random_preset:
            eng = TTSEngine(config=cfg, params=params, tokenizer=tok, device=device, **kw)
        else:
            eng = TTSEngine(args.model, device=device, **kw)
        if not eng.is_ready():
            print(f"engine ({name}) not ready: {eng.get_error()}", file=sys.stderr)
            return 1
        results[name] = compute_stages(eng, args.text, args.language, args.max_frames)
        del eng

    report = compare(results[base], results[other])
    report["text"] = args.text
    report["max_frames"] = args.max_frames
    report["quantize"] = "kv_int8" if args.kv_quant else args.quantize
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
