"""Generate a per-stage parity fixture (.npz) from a framework checkpoint.

Port of the JAX package's ``tools/make_parity_fixtures.py``, plus ``--device
{cuda,cpu}``.  Produces every stage oracle ``parity_check`` understands:
token_ids, prompt_embeds, prefill_logits, decode_logits, codes, waveform —
under greedy decoding, so the fixture is deterministic and comparable frame
for frame.  The schema is the JAX tool's, so either package's gate reads
either package's fixture.

Usage:
  python -m leaxer_qwen3_tts_torch.tools.make_parity_fixtures --model <ckpt> \\
      --text "..." --out fx.npz [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="leaxer_qwen3_tts_torch.tools.make_parity_fixtures",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="framework checkpoint dir")
    p.add_argument("--text", default="hello world")
    p.add_argument("--language", default="auto")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs: the card (default) or the CPU; no "
                        "fallback between them")
    args = p.parse_args(argv)

    from ..api.engine import TTSEngine
    from ..cli.main import engine_device
    from .parity_check import compute_stages

    engine = TTSEngine(args.model, device=engine_device(args.device))
    if not engine.is_ready():
        print(f"engine not ready: {engine.get_error()}", file=sys.stderr)
        return 1
    stages = compute_stages(engine, args.text, args.language, args.max_frames)
    np.savez_compressed(args.out, **stages)
    for k, v in stages.items():
        shape = getattr(v, "shape", None)
        print(f"  {k}: {shape if shape is not None else v!r}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
