"""CLI: flag for flag the JAX package's (``leaxer_qwen3_tts_tpu/cli/main.py``),
itself the reference's (main_onnx.cpp:60-192) plus --seed, --speaker,
--stream and --verbose, and one flag of its own: ``--device {cuda,cpu}``
(default cuda), where the JAX package takes its platform from
``JAX_PLATFORMS``.  ``--device cpu`` runs the kernels' plain versions on the
CPU; with ``--device cuda`` and no card the engine is not ready and the CLI
exits 1: there is no fallback.

Behavioral parity points: default output `output.wav`; unknown --lang falls
back to auto (parse_language, main_onnx.cpp:79-86); output parent dirs are
created; the summary prints "Generated X.XX seconds of audio"; exit code 1 on
missing/invalid inputs, a flag whose path is not ported (the engine's error)
or failed synthesis; output WAV is 16-bit PCM mono 24 kHz without peak
normalization (main_onnx.cpp:15-58).  On the card an unset --quantize (the
default) runs bf16 weight units, --quantize int8 int8 units and --quantize
int4 int4 units (int8 heads), at both presets, each with --kv-quant (the
int8 KV cache), any --mtp-quantize (an MTP trunk of another precision;
"auto" adds the int4 trunk the chain takes where the primary one fails the
residency gate), --spec-k and --frame-fused on (the whole-frame kernel K7
at every unit mix; an unquantized MTP trunk decodes K1 + K3 per frame, as
JAX's frame gate refuses bf16 trunks), and --mtp-resident off (the per-step
chain: one K1 step per chain position).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="leaxer-qwen3-tts-torch",
        description="Qwen3-TTS inference on PyTorch (CUDA kernels on the GPU)",
    )
    p.add_argument("-m", "--model", help="model checkpoint directory (required)")
    p.add_argument("-p", "--prompt", help="text to synthesize (required)")
    p.add_argument("-o", "--output", default="output.wav", help="output WAV file")
    p.add_argument("--lang", default="auto", help="language: auto, en, zh, ja, ko")
    p.add_argument("--ref", help="reference audio for voice clone (3s WAV)")
    p.add_argument("--temp", type=float, default=0.8, help="temperature (0 = greedy)")
    p.add_argument("--top-k", type=int, default=50, help="top-k sampling")
    p.add_argument("--top-p", type=float, default=0.95, help="top-p sampling")
    p.add_argument("--max-tokens", type=int, default=2048, help="max frames to generate")
    p.add_argument("--seed", type=int, default=0, help="sampling PRNG seed (deterministic)")
    p.add_argument("--speaker", help="preset speaker name (CustomVoice models)")
    p.add_argument(
        "--instruct",
        help="EXPERIMENTAL: voice-design instruction text (VoiceDesign models); the "
             "prompt layout is the JAX package's",
    )
    p.add_argument(
        "--quantize", choices=["int8", "int4"],
        help="weight-only quantization (unset: bf16 weight units; int8; int4: group-128 "
             "int4 transformer weights, int8 heads)",
    )
    p.add_argument(
        "--mtp-quantize", choices=["int8", "int4", "auto"],
        help="override the MTP trunk's pack precision (auto: --quantize's, plus an int4 "
             "trunk where it fails the residency gate); defaults to --quantize",
    )
    p.add_argument(
        "--mtp-resident", choices=["on", "off"],
        help="pin the resident MTP chain kernel (all 15 sub-code steps in one "
             "launch; off: one step kernel launch per sub-code); default: on; "
             "QTTS_MTP_RESIDENT env overrides",
    )
    p.add_argument(
        "--frame-fused", choices=["on", "off"],
        help="pin the whole-frame kernel (code0 sample + MTP chain + talker step + "
             "lm_head in ONE launch per frame, sequential B=1 only); default: "
             "QTTS_FRAME_FUSED env; an unquantized MTP trunk (a bf16 one) decodes the "
             "multi-dispatch path, as the JAX frame gate routes it",
    )
    p.add_argument(
        "--kv-quant", action="store_true",
        help="int8 KV cache with per-(slot, head) scales (the talker's; halves its "
             "K/V bytes)",
    )
    p.add_argument(
        "--spec-k", type=int, choices=range(2, 9), metavar="K",
        help="speculative frame decoding: verify K drafted frames per talker "
             "pass (greedy output identical to sequential decode)",
    )
    p.add_argument(
        "--stream", action="store_true",
        help="write audio to the output WAV incrementally as it decodes "
             "(header patched at the end; a tailing player hears audio "
             "before synthesis finishes)",
    )
    p.add_argument("--verbose", action="store_true", help="print per-stage metrics")
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the engine runs: the card (default) or the CPU (the kernels' "
             "plain versions); no fallback between them",
    )
    return p


def parse_language(lang: str) -> str:
    """Unknown values fall back to auto (reference parse_language semantics)."""
    s = (lang or "auto").lower()
    if s in ("en", "english", "zh", "chinese", "ja", "japanese", "ko", "korean"):
        return s
    return "auto"


def engine_device(flag: str):
    """The engine's device for --device: None for cuda (the card, and an error
    where there is none), "cpu" for the CPU."""
    return None if flag == "cuda" else flag


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not args.model or not args.prompt:
        print("Error: --model and --prompt are required", file=sys.stderr)
        build_parser().print_help(sys.stderr)
        return 1
    if not os.path.isdir(args.model):
        print(f"Error: model directory not found: {args.model}", file=sys.stderr)
        return 1

    lang = parse_language(args.lang)
    print(f"Model: {args.model}")
    print(f"Text: {args.prompt}")
    if args.ref:
        print(f"Reference: {args.ref}")
    print(f"Language: {lang}")
    print(f"Output: {args.output}\n")

    parent = os.path.dirname(args.output)
    if parent:
        os.makedirs(parent, exist_ok=True)

    # import late so --help stays fast (no torch import)
    from ..api.engine import TTSEngine
    from ..config import SAMPLE_RATE
    from ..frontend import write_wav

    engine = TTSEngine(args.model, device=engine_device(args.device), max_frames=args.max_tokens,
                       quantize=args.quantize, spec_k=args.spec_k, kv_quant=args.kv_quant,
                       mtp_quantize=args.mtp_quantize,
                       mtp_resident=(None if args.mtp_resident is None
                                     else args.mtp_resident == "on"),
                       frame_fused=(None if args.frame_fused is None
                                    else args.frame_fused == "on"))
    if not engine.is_ready():
        print(f"Error: {engine.get_error()}", file=sys.stderr)
        return 1

    sampling = dict(
        language=lang,
        temperature=args.temp,
        top_k=args.top_k,
        top_p=args.top_p,
        max_tokens=args.max_tokens,
        seed=args.seed,
    )
    if args.instruct:
        sampling["instruct"] = args.instruct

    print("Synthesizing...")
    try:
        if args.stream and not args.ref and not args.speaker:
            # incremental write: audio chunks land in the file as they decode
            from ..frontend import StreamingWavWriter

            result = None
            with StreamingWavWriter(args.output, SAMPLE_RATE) as w:
                for item in engine.synthesize_stream(args.prompt, **sampling):
                    if hasattr(item, "metrics"):
                        result = item
                    else:
                        w.write(item)
        else:
            if args.stream:
                print("(--stream with --ref/--speaker: falling back to "
                      "one-shot write)", file=sys.stderr)
            if args.ref:
                if not engine.has_speaker_encoder():
                    print(
                        "Error: speaker encoder not available for voice clone",
                        file=sys.stderr,
                    )
                    return 1
                result = engine.synthesize_clone(args.prompt, args.ref, **sampling)
            elif args.speaker:
                result = engine.synthesize_speaker(args.prompt, args.speaker, **sampling)
            else:
                result = engine.synthesize(args.prompt, **sampling)
    except Exception as e:
        print(f"Error: synthesis failed: {e}", file=sys.stderr)
        return 1

    if result is None or result.audio.size == 0:
        print("Error: synthesis failed", file=sys.stderr)
        return 1

    print(f"Generated {result.audio.size / SAMPLE_RATE:.2f} seconds of audio")
    if args.verbose:
        print(result.metrics.summary())

    if not (args.stream and not args.ref and not args.speaker):
        try:
            write_wav(args.output, result.audio, SAMPLE_RATE)
        except Exception as e:
            print(f"Error: failed to write WAV: {e}", file=sys.stderr)
            return 1
    print(f"Saved to: {args.output}")
    return 0
