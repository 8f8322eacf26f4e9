"""Speculative-decoding acceptance report for a checkpoint.

Port of the JAX package's ``tools/spec_report.py``: the same texts, flags
and JSON, plus ``--device {cuda,cpu}``.  Spec decode's speed depends on
acceptance (one verify iteration costs about one sequential frame and
commits 1 + accepted frames), so deploying it well needs the acceptance rate
ON YOUR WEIGHTS AND TEXTS.  This tool runs the engine's spec path over probe
texts and reports:

  * draft acceptance rate (accepted drafted slots / offered)
  * commits per verify iteration (1 = worst case, k = best)
  * greedy parity against the sequential engine (must match exactly)
  * which draft ran (the trained draft head if the checkpoint ships one,
    else the zero-cost repeat draft)

Usage:
  python -m leaxer_qwen3_tts_torch.tools.spec_report --model <ckpt> [--k 4]
      [--texts f.txt] [--temp 0] [--device {cuda,cpu}]
  python -m leaxer_qwen3_tts_torch.tools.spec_report --random-preset qwen3-tts-12hz-0.6b-base
Prints one JSON line; exit 0 (reporting, not a gate; 1 if an engine is not ready).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

DEFAULT_TEXTS = [
    "hello world",
    "The quick brown fox jumps over the lazy dog.",
    "Speech synthesis on tensor processing units.",
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="leaxer_qwen3_tts_torch.tools.spec_report",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", help="framework checkpoint dir")
    p.add_argument("--random-preset", help="preset name with random params filled on "
                   "the device (machinery check, pessimistic acceptance)")
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--temp", type=float, default=0.0)
    p.add_argument("--max-frames", type=int, default=96)
    p.add_argument("--texts", help="file with one probe text per line")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int4"])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engines run: the card (default) or the CPU; no "
                        "fallback between them")
    args = p.parse_args(argv)
    if not args.model and not args.random_preset:
        p.error("need --model or --random-preset")

    from ..api.engine import TTSEngine
    from ..cli.main import engine_device
    from .parity_check import device_ready

    texts = DEFAULT_TEXTS
    if args.texts:
        with open(args.texts) as f:
            texts = [ln.strip() for ln in f if ln.strip()]

    device = engine_device(args.device)
    kw = dict(max_frames=args.max_frames, quantize=args.quantize, device=device)
    if args.random_preset:
        from .quality_report import _random_engine_inputs, _tiny_tokenizer

        if not device_ready(device):
            return 1
        cfg, params = _random_engine_inputs(args.random_preset, device or "cuda")
        kw.update(config=cfg, params=params, tokenizer=_tiny_tokenizer())
        seq_eng = TTSEngine(**kw)
        spec_eng = TTSEngine(**kw, spec_k=args.k)
    else:
        seq_eng = TTSEngine(args.model, **kw)
        spec_eng = TTSEngine(args.model, **kw, spec_k=args.k)
    for name, eng in (("sequential", seq_eng), ("speculative", spec_eng)):
        if not eng.is_ready():
            print(f"engine ({name}) not ready: {eng.get_error()}", file=sys.stderr)
            return 1

    total_iters = total_accepted = total_frames = 0
    greedy_match = True
    per_text = []
    for text in texts:
        r = spec_eng.synthesize(text, temperature=args.temp, seed=0)
        m = r.metrics
        offered = m.spec_iterations * (args.k - 1)
        per_text.append({
            "text": text[:40],
            "frames": m.frames,
            "iterations": m.spec_iterations,
            "acceptance": round(m.spec_accepted / offered, 3) if offered else 0.0,
        })
        total_iters += m.spec_iterations
        total_accepted += m.spec_accepted
        total_frames += m.frames
        if args.temp == 0.0:
            r_seq = seq_eng.synthesize(text, temperature=0.0, seed=0)
            a, b = np.asarray(r_seq.codes), np.asarray(r.codes)
            n = min(len(a), len(b))
            greedy_match = greedy_match and bool((a[:n] == b[:n]).all())

    offered = total_iters * (args.k - 1)
    report = {
        "k": args.k,
        "temperature": args.temp,
        "draft": (
            "model" if spec_eng.cfg.draft is not None
            and "draft" in spec_eng.params else "repeat"
        ),
        "texts": len(texts),
        "frames": total_frames,
        "iterations": total_iters,
        "acceptance": round(total_accepted / offered, 3) if offered else 0.0,
        "commits_per_iteration": (
            round(1 + total_accepted / total_iters, 2) if total_iters else 0.0
        ),
        "greedy_parity_vs_sequential": greedy_match if args.temp == 0.0 else None,
        "per_text": per_text,
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
