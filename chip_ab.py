"""A/B of the B=1 fixed 300-frame run between two checkouts, on one GPU.

    python3 chip_ab.py OLD NEW

OLD and NEW are checkout roots (unpack a commit with ``git archive`` into a
directory that ``.gitignore`` lists).  Each run is its own process, in the
order OLD, NEW, NEW, OLD, since each checkout builds and loads its own
kernels; a run makes the 0.6B preset's engine (random weights, seed 0,
int8), warms it up and times ``chip_smoke.check_fixed_run`` three times.
Prints one ``AB`` line per run with the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

TEXT = "hello world, this is a fixed length run"


def run_one(root: str) -> None:
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
    params = init_params(QWEN3_TTS_06B, seed=cs.SEED, device="cuda")
    with tempfile.TemporaryDirectory() as workdir:
        tok = cs.byte_level_tokenizer(workdir)
    eng = TTSEngine(config=QWEN3_TTS_06B, params=params, tokenizer=tok, quantize="int8")
    eng.synthesize("warm up", language="en", max_tokens=16)
    ms = [cs.check_fixed_run(eng, 300, [TEXT], cs.CARD) for _ in range(3)]
    print(f"AB {root}: ms/frame {ms} [{cs.CARD}]", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        run_one(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = sys.argv[1:]
    for root in (old, new, new, old):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        print("\n".join(lines) if lines else out.stdout[-2000:] + out.stderr[-2000:], flush=True)
        if out.returncode != 0:
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
