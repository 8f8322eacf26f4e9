"""K8 alone on one NVIDIA GPU: its checks, its reach, and an A/B against another checkout.

    python3 chip_k8.py [OLD]

Builds ``csrc/flash_attention.cu`` by itself (seconds, not the whole kernel
library's minutes) and runs ``chip_smoke.check_k8`` through it: the 1.7B
prefill shape, the random GQA shapes, the key range's edge cases and the
reach cases (head_dim 17-256, 1-32 q heads per kv head), each against the
plain version and timed beside SDPA, with the profiler's device time per
call.  With OLD (a checkout root: unpack a commit with ``git archive`` into
a directory that ``.gitignore`` lists) it also builds OLD's
``flash_attention.cu`` and times both at the 1.7B prefill shape (bf16, B=1,
S=57, T=256, 16 / 8 heads, head_dim 128) in turns (OLD, NEW, NEW, OLD, OLD,
NEW, NEW, OLD), by CUDA events and device time, after checking that both
give the same outputs bit for bit.  Every timing line carries the card's
name and power limit.  Exits non-zero if a check fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from leaxer_qwen3_tts_torch.ops import _build  # noqa: E402
from leaxer_qwen3_tts_torch.ops import flash_attention as K8  # noqa: E402
from leaxer_qwen3_tts_torch.ops.persistent import grid_size  # noqa: E402

PREFILL = (1, 57, 256, 16, 8)  # B, S, T, nq, nk: the 1.7B talker's prefill


def build_alone(root: str, out_dir: str) -> tuple:
    """``root``'s flash_attention.cu as a library of its own.  Returns (the
    library, whether its entry takes head_dim)."""
    src = os.path.join(root, "leaxer_qwen3_tts_torch", "csrc", "flash_attention.cu")
    so = os.path.join(out_dir, "lib.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    lib.qtts_flash_attend.restype = ctypes.c_int
    with open(src) as f:
        takes_d = "int qt, int D," in f.read()
    return lib, takes_d


class _Lib:
    """The kernel library as the wrappers see it, holding K8 alone."""

    def __init__(self, lib):
        self._so = lib
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.qtts_flash_attend.argtypes = [vp, vp, vp, vp, vp, *([i32] * 9), vp]

    def __getattr__(self, name):
        return getattr(self._so, name)

    def qtts_error_string(self, err):
        return f"CUDA error {err}".encode()


def checks(gen) -> list:
    cases = [("1.7B prefill", *PREFILL, 128, "prefill")]
    cases += [("reach", *c) for c in cs.K8_REACH_CASES]
    cases += [("random", *sh, 128, "random") for sh in cs.K8_RANDOM_SHAPES]
    cases += [("sched", *c[:5], 128, c[5]) for c in cs.K8_SCHEDULE_CASES]
    fails = []
    for name, B, S, T, nq, nk, d, kind in cases:
        try:
            cs.check_k8(name, B, S, T, nq, nk, kind, gen, iters=20, d=d)
        except Exception:
            cs.log(traceback.format_exc())
            fails.append((name, B, S, T, nq, nk, d, kind))
    return fails


def ab(libs: dict, gen) -> bool:
    """OLD against NEW at the prefill shape.  Returns whether the outputs
    are equal bit for bit."""
    B, S, T, nq, nk = PREFILL
    q, k, v, mask = cs.k8_case(B, S, T, nq, nk, "prefill", torch.bfloat16, gen)
    m8 = mask.contiguous()
    out = torch.empty_like(q)
    qt = K8.query_tile(nq // nk, B, nk, S, grid_size(q.device))
    stream = torch.cuda.current_stream().cuda_stream

    def call(name):
        lib, takes_d = libs[name]
        ints = [B, S, nq, nk, T, K8.padded_keys(T), qt] + ([128] if takes_d else []) + [1]
        err = lib.qtts_flash_attend(*[ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, m8, out)],
                                    *[ctypes.c_int(i) for i in ints], ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"{name}: qtts_flash_attend returned {err}")

    outs = {}
    for name in libs:
        call(name)
        torch.cuda.synchronize()
        outs[name] = out.clone()
    equal = torch.equal(outs["OLD"], outs["NEW"])
    cs.log(f"K8 A/B at the 1.7B prefill shape: outputs equal bit for bit: {equal}")
    for name in ("OLD", "NEW", "NEW", "OLD", "OLD", "NEW", "NEW", "OLD"):
        ms = cs.time_ms(lambda: call(name), 200)
        dev = cs.device_ms(lambda: call(name), 200)
        cs.log(f"K8 A/B {name}: {ms * 1e3:.2f} us per call (CUDA events), device "
               f"{dev * 1e3:.2f} us per call (profiler) [{cs.CARD}]")
    return equal


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_k8: CUDA is not available", file=sys.stderr)
        return 2
    cs.CARD = cs.card()
    cs.log(f"card: {cs.CARD}")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = {}
        for name, root in (("NEW", REPO), ("OLD", sys.argv[1] if len(sys.argv) > 1 else None)):
            if root is None:
                continue
            os.makedirs(os.path.join(tmp, name))
            libs[name] = build_alone(os.path.abspath(root), os.path.join(tmp, name))
            cs.log(f"built {name} flash_attention.cu alone")
        _build._lib = _Lib(libs["NEW"][0])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED)
        fails = checks(gen)
        equal = ab(libs, gen) if "OLD" in libs else True
    cs.log(f"chip_k8: failed checks {fails}; A/B outputs equal {equal}")
    return 0 if not fails and equal else 1


if __name__ == "__main__":
    sys.exit(main())
