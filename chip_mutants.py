"""Mutation check of ``chip_smoke.py``'s K6 checks on one NVIDIA GPU.

    python3 chip_mutants.py

Builds faulty copies of the kernel sources in a temporary directory (the
checkout is never touched), each with one fault in the verify path, and runs
``chip_smoke.check_k6_shallow`` against each on one talker layer, float32 and
bf16 caches.  A mutant is caught when at least one case fails.  Exits
non-zero if a mutant that should be caught is not, or without CUDA.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile

import torch

import chip_smoke as cs
from leaxer_qwen3_tts_torch.config import QWEN3_TTS_06B
from leaxer_qwen3_tts_torch.ops import _build

# name -> (source file, original text, faulty text)
MUTANTS = {
    # the verify rows leave their own new slot out of the attention
    "own slot dropped": (
        "qtts_kernels.cuh",
        "const int end = min(start + QTTS_ATTN_CHUNK, pos + 1);",
        "const int end = min(start + QTTS_ATTN_CHUNK, pos + (TAIL_IN_CACHE ? 0 : 1));",
    ),
    # the write kernel rotates every candidate's k at its stream's start
    "k written at the start's angle": (
        "qtts_kernels.cuh",
        "    const float ang = (float)pos * inv_freq[t];\n    qtts_rope_pair(k_s[t], k_s[t + D / 2]",
        "    const float ang = (float)(pos - r % S) * inv_freq[t];\n"
        "    qtts_rope_pair(k_s[t], k_s[t + D / 2]",
    ),
    # the write kernel rounds k to bf16 whatever the cache dtype (a small
    # systematic fault: only a float32 cache can show it)
    "k rounded to bf16": (
        "qtts_kernels.cuh",
        "  kc[at] = qtts_to_cache<CT>(k_s[t]);",
        "  kc[at] = qtts_to_cache<CT>(qtts_bf16_round(k_s[t]));",
    ),
}
CASES = ((1, 4, [62]), (4, 8, [62, 5, 504, 130]))  # (B, S, starts) at T=512


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mutants: CUDA is not available", file=sys.stderr)
        return 2
    cs.CARD = cs.card()
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(cs.SEED)
    t1 = dataclasses.replace(QWEN3_TTS_06B.talker.transformer, num_layers=1)
    fw = cs.packed_trunk(t1, gen)
    source = _build.CSRC_DIR
    caught = {}
    for name, (fname, old, new) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            csrc = os.path.join(tmp, "csrc")
            shutil.copytree(source, csrc)
            path = os.path.join(csrc, fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"mutant {name!r}: the original text is not in {fname}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
            _build.CSRC_DIR, _build.BUILD_DIR, _build._lib = csrc, os.path.join(tmp, "build"), None
            cs.log(f"=== mutant: {name}")
            failed = 0
            for cache_dtype in (torch.float32, torch.bfloat16):
                for B, S, starts in CASES:
                    try:
                        cs.check_k6_shallow(t1, fw, B, S, 512, starts, cache_dtype, gen)
                    except RuntimeError:
                        failed += 1
            caught[name] = failed
    _build.CSRC_DIR, _build._lib = source, None
    cs.log(f"mutants caught (failed cases of {2 * len(CASES)}): {caught} [{cs.CARD}]")
    return 0 if all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
