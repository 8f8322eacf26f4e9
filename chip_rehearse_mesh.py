"""Rehearse ``chip_smoke.py``'s mesh runs on the CPU at a small width.

Runs ``mesh_plain_runs`` (the plain mesh routes and their make_mesh(1, 1)
witnesses), ``mesh_route_runs`` (the K9 / K10 and plain mixes of the tp
phase; the K9 / K10 wrappers are wrapped to bump their ``.launches`` as the
card's do) and ``mesh_train_step`` on stand-in configs: a 2-layer trunk of
width 512 for the 0.6B preset, and a 3-layer trunk, which the patched K10
gate refuses, for the 1.7B preset (as the 1.7B trunk fails K10's gate at
tp=2).  Every engine is built with ``device="cpu"``, and the CUDA timers and
memory calls are stubbed.  A failed check raises, as on the card.

    python3 chip_rehearse_mesh.py        # ~30-60 s
"""

import dataclasses
import functools
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from conftest_util import build_tiny_cfg  # noqa: E402
from leaxer_qwen3_tts_torch import config as tcfg  # noqa: E402
from leaxer_qwen3_tts_torch.api import engine as tengine  # noqa: E402
from leaxer_qwen3_tts_torch.api.engine import TTSEngine  # noqa: E402
from leaxer_qwen3_tts_torch.models import code_predictor as tcp  # noqa: E402
from leaxer_qwen3_tts_torch.models import talker as ttalker  # noqa: E402


def counted(mod, name):
    """Wrap ``mod.name`` so each call bumps the wrapped function's
    ``.launches``, which ``chip_smoke.launches`` reads."""
    orig = getattr(mod, name)

    def wrapper(*a, **k):
        orig.launches += 1
        return orig(*a, **k)

    setattr(mod, name, wrapper)


def stand_ins():
    """(the 0.6B stand-in, the 1.7B stand-in, the tiny config)."""
    tiny = tcfg.TTSModelConfig.from_json(build_tiny_cfg().to_json())
    t = tcfg.TransformerConfig(hidden_size=512, num_layers=2, num_heads=8, num_kv_heads=4,
                               head_dim=128, intermediate_size=1024, dtype="float32")
    wide = dataclasses.replace(
        tiny, talker=dataclasses.replace(tiny.talker, transformer=t, decode_impl="fused"),
        code_predictor=dataclasses.replace(tiny.code_predictor, transformer=t, impl="fused",
                                           subcode_vocab_size=256, resident=True),
        speaker_encoder=None)
    big = dataclasses.replace(wide, code_predictor=dataclasses.replace(
        wide.code_predictor, transformer=dataclasses.replace(t, num_layers=3)))
    return wide, big, tiny


def main() -> int:
    torch.set_num_threads(4)
    cs.DEV = torch.device("cpu")
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.empty_cache = lambda: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    cs.TTSEngine = functools.partial(TTSEngine, device="cpu")
    counted(ttalker, "fused_decode_step_tp")
    counted(tcp, "fused_mtp_chain_tp")
    wide, big, tiny = stand_ins()
    real_gate = tengine.supports_tp_resident
    tengine.supports_tp_resident = lambda c, *a: c.num_layers != 3 and real_gate(c, *a)
    cs.QWEN3_TTS_06B, cs.QWEN3_TTS_17B = wide, big
    cs.SAMPLES_PER_FRAME = tiny.vocoder.samples_per_frame
    cs.CARD = "CPU rehearsal"
    with tempfile.TemporaryDirectory() as d:
        tok = cs.byte_level_tokenizer(d)

    t0 = time.perf_counter()
    params = cs.init_params(wide, seed=0, device=cs.DEV, with_speaker_encoder=False)
    cs.mesh_plain_runs(wide, params, tok, cs.CARD)
    print(f"mesh_plain_runs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.mesh_route_runs(tok, cs.CARD)
    print(f"mesh_route_runs: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    batch = {"text_ids": torch.randint(0, 1000, (4, 8), generator=gen),
             "text_len": torch.tensor([8, 5, 6, 7]),
             "codes": torch.randint(0, 2048, (4, 6, 16), generator=gen),
             "num_frames": torch.tensor([5, 2, 4, 3])}
    bf16 = lambda part: dataclasses.replace(part, transformer=dataclasses.replace(
        part.transformer, dtype="bfloat16"))
    tiny16 = dataclasses.replace(tiny, talker=bf16(tiny.talker),
                                 code_predictor=bf16(tiny.code_predictor))
    cs.mesh_train_step(tiny16, cs.init_params(tiny16, seed=0, device=cs.DEV,
                                              with_speaker_encoder=False), batch, cs.CARD)
    print(f"mesh_train_step: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
