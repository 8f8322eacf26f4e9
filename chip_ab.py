"""A/B of the B=1 fixed 300-frame run between two checkouts, on one GPU.

    python3 chip_ab.py OLD NEW [--spec]

OLD and NEW are checkout roots (unpack a commit with ``git archive`` into a
directory that ``.gitignore`` lists).  Each run is its own process, in the
order OLD, NEW, NEW, OLD, since each checkout builds and loads its own
kernels; a run makes the 0.6B preset's engine (random weights, seed 0,
int8), warms it up and times ``chip_smoke.check_fixed_run`` three times.
With ``--spec`` a run also times the speculative B=1 fixed run at k=4
(``chip_smoke.spec_fixed_run``, sampled, 300 frames, as the smoke's spec
phase does) at full acceptance and with the repeat draft, twice each, in ms
per committed frame.  Prints one ``AB`` line per run with the card's name
and power limit.
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


def run_one(root: str, spec: bool) -> None:
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
    if spec:
        print(f"AB {root}: spec k=4 ms per committed frame {spec_ms(cs, eng)} [{cs.CARD}]",
              flush=True)


def main() -> int:
    args = sys.argv[1:]
    spec = "--spec" in args
    args = [a for a in args if a != "--spec"]
    if args[:1] == ["--one"]:
        run_one(os.path.abspath(args[1]), spec)
        return 0
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = args
    for root in (old, new, new, old):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]
                             + (["--spec"] if spec else []), capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        print("\n".join(lines) if lines else out.stdout[-2000:] + out.stderr[-2000:], flush=True)
        if out.returncode != 0:
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
