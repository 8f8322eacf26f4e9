"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source
(or per part of a source in PARTS) started together, and linked into one shared library with a plain C
interface, at first use, into ``build/torch_kernels/`` at the repository
root; the file name carries a hash of the sources and flags, so a changed
source rebuilds.  The library is loaded with ``ctypes``.  A missing ``nvcc``
or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
SOURCES = (
    "fused_step.cu", "fused_step_batched.cu", "fused_mtp.cu", "fused_mtp_batched.cu",
    "fused_verify.cu", "fused_mtp_stream.cu", "flash_attention.cu", "fused_frame.cu",
    "unit_probe.cu", "fused_tp.cu", "fused_mtp_tp.cu", "fused_int4.cu",
)
HEADERS = ("qtts_kernels.cuh", "qtts_stream.cuh", "qtts_tp.cuh", "qtts_frame.cuh")
# sources compiled as several objects, part i instantiating its share of the
# kernels (-DQTTS_PART=i), so that no one compile holds back the parallel
# build (fused_int4.cu's seventeen int4 kernels took 625 s as one): the int4
# step, chains, batched step, verify pass and batched chain, then K7 at its
# four mixes with int4 units; K7's frames beside the bf16-talker frame; the
# batched step, verify pass and chain beside their bf16 instances (the last
# three objects to finish when whole)
PARTS = {"fused_int4.cu": 9, "fused_frame.cu": 2, "fused_step_batched.cu": 2,
         "fused_verify.cu": 2, "fused_mtp_batched.cu": 2}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class StepWeights(ctypes.Structure):
    """Mirror of ``QttsStepWeights`` (csrc/qtts_kernels.cuh)."""

    _fields_ = [
        ("wqkv", ctypes.c_void_p), ("sqkv", ctypes.c_void_p),
        ("wo", ctypes.c_void_p), ("so", ctypes.c_void_p),
        ("wgu", ctypes.c_void_p), ("sgu", ctypes.c_void_p),
        ("wd", ctypes.c_void_p), ("sd", ctypes.c_void_p),
        ("attn_norm", ctypes.c_void_p), ("mlp_norm", ctypes.c_void_p),
        ("q_norm", ctypes.c_void_p), ("k_norm", ctypes.c_void_p),
        ("inv_freq", ctypes.c_void_p),
        ("L", ctypes.c_int32), ("H", ctypes.c_int32), ("nq", ctypes.c_int32),
        ("nk", ctypes.c_int32), ("D", ctypes.c_int32), ("I", ctypes.c_int32),
        ("eps", ctypes.c_float), ("attn_scale", ctypes.c_float), ("unit_type", ctypes.c_int32),
    ]


class StepScratch(ctypes.Structure):
    """Mirror of ``QttsStepScratch``."""

    _fields_ = [
        ("qkv", ctypes.c_void_p), ("attn", ctypes.c_void_p),
        ("gu", ctypes.c_void_p), ("part", ctypes.c_void_p),
        ("max_splits", ctypes.c_int32),
    ]


class ChainArgs(ctypes.Structure):
    """Mirror of ``QttsChainArgs``."""

    _fields_ = [
        ("final_norm", ctypes.c_void_p), ("heads", ctypes.c_void_p),
        ("head_scales", ctypes.c_void_p), ("tables", ctypes.c_void_p),
        ("gumbel", ctypes.c_void_p), ("last_hidden", ctypes.c_void_p),
        ("code0_embed", ctypes.c_void_p), ("subcodes", ctypes.c_void_p),
        ("sub_sum", ctypes.c_void_p), ("x", ctypes.c_void_p),
        ("x_in", ctypes.c_void_p), ("logits", ctypes.c_void_p),
        ("counter", ctypes.c_void_p), ("k_cache", ctypes.c_void_p),
        ("v_cache", ctypes.c_void_p),
        ("cache_bf16", ctypes.c_int32), ("n", ctypes.c_int32), ("V", ctypes.c_int32),
        ("Vt", ctypes.c_int32),
        ("temperature", ctypes.c_float), ("top_k", ctypes.c_int32),
        ("top_p", ctypes.c_float), ("greedy", ctypes.c_int32), ("heads_bf16", ctypes.c_int32),
    ]


class Plan(ctypes.Structure):
    """Mirror of ``QttsPlan`` (csrc/qtts_stream.cuh); built by ``ops/persistent.py``."""

    _fields_ = [
        ("bounds", ctypes.c_void_p),
        ("grid", ctypes.c_int32), ("n_slots", ctypes.c_int32),
        ("slot_bytes", ctypes.c_int32), ("slot_rows", ctypes.c_int32),
        ("stage_rows", ctypes.c_int32 * 10), ("smem_bytes", ctypes.c_int32),
        ("union_bytes", ctypes.c_int32), ("tickets", ctypes.c_void_p),
        ("trace_rows", ctypes.c_int32), ("trace", ctypes.c_void_p),
        ("batch", ctypes.c_int32), ("groups", ctypes.c_int32), ("n_tickets", ctypes.c_int32),
        ("n_sets", ctypes.c_int32), ("write_stall_ns", ctypes.c_int32),
    ]


MAX_BATCH = 32  # QTTS_MAX_BATCH: the rows one launch of kernel K4, K5 or K6 takes


class BatchScratch(ctypes.Structure):
    """Mirror of ``QttsBatchScratch``."""

    _fields_ = [
        ("qkv", ctypes.c_void_p), ("gu", ctypes.c_void_p), ("part", ctypes.c_void_p),
        ("hb", ctypes.c_void_p), ("max_splits", ctypes.c_int32), ("attn", ctypes.c_void_p),
    ]


class ChainBatchArgs(ctypes.Structure):
    """Mirror of ``QttsChainBatchArgs``."""

    _fields_ = [
        ("final_norm", ctypes.c_void_p), ("heads", ctypes.c_void_p),
        ("head_scales", ctypes.c_void_p), ("tables", ctypes.c_void_p),
        ("noise", ctypes.c_void_p), ("noise_step_stride", ctypes.c_int64),
        ("noise_row_stride", ctypes.c_int64),
        ("last_hidden", ctypes.c_void_p), ("code0_embed", ctypes.c_void_p),
        ("subcodes", ctypes.c_void_p), ("sub_sum", ctypes.c_void_p),
        ("x", ctypes.c_void_p), ("x_in", ctypes.c_void_p), ("logits", ctypes.c_void_p),
        ("k_cache", ctypes.c_void_p), ("v_cache", ctypes.c_void_p),
        ("cache_bf16", ctypes.c_int32), ("B", ctypes.c_int32), ("n", ctypes.c_int32),
        ("V", ctypes.c_int32), ("Vt", ctypes.c_int32),
        ("temperature", ctypes.c_float * MAX_BATCH), ("top_k", ctypes.c_int32 * MAX_BATCH),
        ("top_p", ctypes.c_float * MAX_BATCH), ("greedy", ctypes.c_int32 * MAX_BATCH),
        ("heads_bf16", ctypes.c_int32),
    ]


class FrameArgs(ctypes.Structure):
    """Mirror of ``QttsFrameArgs``."""

    _fields_ = [
        ("tw", StepWeights), ("ts", StepScratch), ("mw", StepWeights), ("ms", StepScratch),
        ("mc", ChainArgs),
        *[(name, ctypes.c_void_p) for name in (
            "talker_norm", "lm", "lm_scale", "codec", "last_logits", "suppress", "g0",
            "last_hidden", "drip", "k_cache", "v_cache", "x", "c0e", "lh", "codes", "logits",
            "hidden", "k_scale", "v_scale")],
        *[(name, ctypes.c_int32) for name in (
            "cache_bf16", "lh_bf16", "drip_bf16", "T", "pos", "Vc", "eos", "forbid_eos")],
    ]


TP_MAX = 8  # QTTS_TP_MAX: the ranks a K9 or K10 launch takes


class TpLink(ctypes.Structure):
    """Mirror of ``QttsTpLink`` (csrc/qtts_tp.cuh): what the ranks reach of one rank."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("recv", "flags", "bar", "status")]


class TpStepRank(ctypes.Structure):
    """Mirror of ``QttsTpStepRank`` (csrc/fused_tp.cu): one rank of K9."""

    _fields_ = [("w", StepWeights), ("s", StepScratch), ("p", Plan)] + [
        (name, ctypes.c_void_p) for name in ("x_in", "x", "part", "k_cache", "v_cache")]


class TpStepArgs(ctypes.Structure):
    """Mirror of ``QttsTpStepArgs``."""

    _fields_ = [
        ("rank", TpStepRank * TP_MAX), ("link", TpLink * TP_MAX),
        *[(name, ctypes.c_int32) for name in (
            "tp", "rank0", "n_local", "bpr", "T", "pos", "cache_bf16", "cross_device",
            "stall_ns")],
        ("gen", ctypes.c_uint32), ("timeout_ns", ctypes.c_int64),
    ]


class TpRank(ctypes.Structure):
    """Mirror of ``QttsTpRank`` (csrc/fused_mtp_tp.cu): one rank of K10."""

    _fields_ = [("w", StepWeights), ("p", Plan)] + [(name, ctypes.c_void_p) for name in (
        "heads", "head_scales", "tables", "gumbel", "final_norm", "last_hidden",
        "code0_embed", "rope", "x", "x_in", "qkv", "attn", "gu", "part", "logits", "k_cache",
        "v_cache", "codes", "sub_sum")]


class TpChainArgs(ctypes.Structure):
    """Mirror of ``QttsTpChainArgs``."""

    _fields_ = [
        ("rank", TpRank * TP_MAX), ("link", TpLink * TP_MAX),
        *[(name, ctypes.c_int32) for name in (
            "tp", "rank0", "n_local", "bpr", "n", "V", "Vt", "W", "KCo", "KCd")],
        ("gen", ctypes.c_uint32), ("temperature", ctypes.c_float), ("top_k", ctypes.c_int32),
        ("top_p", ctypes.c_float),
        *[(name, ctypes.c_int32) for name in ("greedy", "heads_bf16", "cross_device", "stall_ns")],
        ("timeout_ns", ctypes.c_int64),
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def units(names=SOURCES):
    """(source, object name, extra nvcc flags) of every object built from
    ``names``: one per source, or one per part of a source in PARTS."""
    out = []
    for s in names:
        n = PARTS.get(s, 0)
        out += ([(s, f"{s}.{i}", (f"-DQTTS_PART={i}",)) for i in range(n)] if n
                else [(s, s, ())])
    return out


def _digest() -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(PARTS.items()))).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libqtts_kernels_{_digest()}.so")


def build() -> str:
    """Compile the kernels if the library for the current sources is missing.
    Returns its path; the compiler's resource report is in ``<path>.log``,
    with each object's seconds to finish and its compilers' CPU seconds
    (:func:`object_times` reads them)."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmp, obj + ".o") for _, obj, _ in units()]
        cmds = [[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", o, os.path.join(CSRC_DIR, s)]
                for (s, _, flags), o in zip(units(), objs)]
        t0 = time.monotonic()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [None] * len(procs)

        def wait(i: int) -> None:  # each object's output, its seconds to build and of CPU
            out = procs[i].stdout.read()
            # the rusage of nvcc's whole tree (cicc, ptxas and the host
            # compiler are waited for by nvcc, so counted in its own)
            _, status, ru = os.wait4(procs[i].pid, 0)
            procs[i].returncode = os.waitstatus_to_exitcode(status)
            outs[i] = (f"{out}built in {time.monotonic() - t0:.1f} s, "
                       f"{ru.ru_utime + ru.ru_stime:.1f} s of CPU\n")

        waits = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        runs = [(c, out, p.returncode) for c, out, p in zip(cmds, outs, procs)]
        if all(rc == 0 for _, _, rc in runs):
            link = [nvcc, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            runs.append((link, proc.stdout, proc.returncode))
        with open(path + ".log", "w") as f:
            f.write("\n".join(" ".join(c) + "\n" + out for c, out, _ in runs))
        for c, out, rc in runs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {c[-1]}:\n{out[-4000:]}")
        os.replace(os.path.join(tmp, "lib.so"), path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def object_times(log_path: str) -> list:
    """(object, seconds to finish, CPU seconds) of each compiled object, from
    a build log that :func:`build` wrote, in the log's order."""
    with open(log_path) as f:
        text = f.read()
    return [(os.path.basename(m.group(1)), float(m.group(2)), float(m.group(3)))
            for m in re.finditer(r" -o (\S+\.o) \S+\n[\s\S]*?built in ([0-9.]+) s, "
                                 r"([0-9.]+) s of CPU\n", text)]


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.qtts_attn_chunk.restype = i32
            lib.qtts_attn_chunk.argtypes = []
            lib.qtts_error_string.restype = ctypes.c_char_p
            lib.qtts_error_string.argtypes = [i32]
            W, S, P = (ctypes.POINTER(t) for t in (StepWeights, StepScratch, Plan))
            lib.qtts_decode_step.restype = i32
            lib.qtts_decode_step.argtypes = [W, S, P, vp, vp, vp, vp, vp, vp, i32, i32, i32, vp]
            lib.qtts_decode_step_multi.restype = i32
            lib.qtts_decode_step_multi.argtypes = [W, S, vp, vp, vp, vp, i32, i32, i32, vp]
            lib.qtts_mtp_chain.restype = i32
            lib.qtts_mtp_chain.argtypes = [W, S, P, ctypes.POINTER(ChainArgs), vp]
            lib.qtts_mtp_chain_multi.restype = i32
            lib.qtts_mtp_chain_multi.argtypes = [W, S, ctypes.POINTER(ChainArgs), vp]
            lib.qtts_persistent_sizes.restype = None
            lib.qtts_persistent_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
            _check_persistent_sizes(lib)
            BS, CB = ctypes.POINTER(BatchScratch), ctypes.POINTER(ChainBatchArgs)
            lib.qtts_decode_step_batched.restype = i32
            lib.qtts_decode_step_batched.argtypes = [
                W, BS, P, vp, vp, vp, vp, vp, vp, i32, i32, i32, vp, i32, i32, i32, vp,
            ]
            lib.qtts_decode_step_batched_multi.restype = i32
            lib.qtts_decode_step_batched_multi.argtypes = [
                W, BS, vp, vp, vp, vp, i32, i32, i32, vp, i32, vp,
            ]
            lib.qtts_mtp_chain_batched.restype = i32
            lib.qtts_mtp_chain_batched.argtypes = [W, BS, P, CB, vp]
            lib.qtts_mtp_chain_batched_multi.restype = i32
            lib.qtts_mtp_chain_batched_multi.argtypes = [W, BS, CB, vp]
            lib.qtts_mtp_chain_streamed.restype = i32
            lib.qtts_mtp_chain_streamed.argtypes = lib.qtts_mtp_chain.argtypes
            lib.qtts_mtp_chain_streamed_multi.restype = i32
            lib.qtts_mtp_chain_streamed_multi.argtypes = lib.qtts_mtp_chain_multi.argtypes
            lib.qtts_flash_attend.restype = i32
            lib.qtts_flash_attend.argtypes = [vp, vp, vp, vp, vp, *([i32] * 9), vp]
            lib.qtts_norm_head.restype = i32
            lib.qtts_norm_head.argtypes = [vp, vp, ctypes.c_float, vp, vp, vp, vp, i32, i32, i32,
                                           vp]
            lib.qtts_frame_step.restype = i32
            lib.qtts_frame_step.argtypes = [ctypes.POINTER(FrameArgs), P, vp]
            lib.qtts_frame_step_multi.restype = i32
            lib.qtts_frame_step_multi.argtypes = [ctypes.POINTER(FrameArgs), vp]
            lib.qtts_frame_args_size.restype = i32
            lib.qtts_frame_args_size.argtypes = []
            if lib.qtts_frame_args_size() != ctypes.sizeof(FrameArgs):
                raise RuntimeError("FrameArgs does not mirror QttsFrameArgs")
            lib.qtts_unit_probe.restype = i32
            lib.qtts_unit_probe.argtypes = [vp, vp, vp, vp, vp, *([i32] * 7), vp]
            lib.qtts_unit_probe_ring.restype = i32
            lib.qtts_unit_probe_ring.argtypes = [vp, vp, vp, vp, vp, vp, *([i32] * 14), vp]
            lib.qtts_verify_step.restype = i32
            lib.qtts_verify_step.argtypes = [
                W, BS, P, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp, i32, i32, i32, vp,
            ]
            lib.qtts_tp_decode_step.restype = i32
            lib.qtts_tp_decode_step.argtypes = [ctypes.POINTER(TpStepArgs), vp]
            lib.qtts_tp_step_args_size.restype = i32
            lib.qtts_tp_step_args_size.argtypes = []
            if lib.qtts_tp_step_args_size() != ctypes.sizeof(TpStepArgs):
                raise RuntimeError("TpStepArgs does not mirror QttsTpStepArgs")
            lib.qtts_tp_mtp_chain.restype = i32
            lib.qtts_tp_mtp_chain.argtypes = [ctypes.POINTER(TpChainArgs), vp]
            lib.qtts_tp_enable_peers.restype = i32
            lib.qtts_tp_enable_peers.argtypes = [ctypes.POINTER(ctypes.c_int), i32]
            lib.qtts_tp_chain_args_size.restype = i32
            lib.qtts_tp_chain_args_size.argtypes = []
            if lib.qtts_tp_chain_args_size() != ctypes.sizeof(TpChainArgs):
                raise RuntimeError("TpChainArgs does not mirror QttsTpChainArgs")
            lib.qtts_verify_step_multi.restype = i32
            lib.qtts_verify_step_multi.argtypes = [
                W, BS, vp, vp, vp, vp, i32, i32, i32, i32, vp, i32, vp,
            ]
            _lib = lib
        return _lib


def _check_persistent_sizes(lib) -> None:
    """ops/persistent.py plans with the library's struct sizes and limits."""
    from . import persistent

    got = (ctypes.c_int * 11)()
    lib.qtts_persistent_sizes(got)
    got[10] = lib.qtts_attn_chunk()
    want = (persistent.ATTN_SMEM_BYTES, persistent.SAMPLE_SMEM_BYTES, persistent.MAX_STAGE_ROWS,
            persistent.THREADS, persistent.MAX_K, persistent.MAX_KV_HEADS,
            persistent.MAX_TICKETS, persistent.MAX_BATCH, persistent.MAX_SETS,
            ctypes.sizeof(Plan), persistent.ATTN_CHUNK)
    if tuple(got) != want:
        raise RuntimeError(f"ops/persistent.py plans with {want}, the kernels have {tuple(got)}")


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if err != 0:
        msg = load_kernels().qtts_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
