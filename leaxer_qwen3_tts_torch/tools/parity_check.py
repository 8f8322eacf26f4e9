"""Stage-level parity gate against reference fixtures (<=1e-2 L-inf).

Port of the JAX package's ``tools/parity_check.py``: the same stages, keys,
bounds and exit codes, plus ``--device {cuda,cpu}``.  A fixture .npz holds
any of these keys (unknown keys are ignored):

  text                : str       — the prompt
  token_ids           : int32 [T] — expected BPE ids (tokenizer stage)
  mel_input_wav       : str path  — reference WAV fed to the mel stage
  mel                 : f32 [frames, 128] — expected log-mel
  prompt_embeds       : f32 [P, H] — assembled prompt embedding sequence
  prefill_logits      : f32 [V]   — talker logits after the prompt
  decode_logits       : f32 [F, V] — per-frame talker logits under greedy
                        decode (logits after frame t select frame t+1's code0)
  codes               : int32 [F, 16] — greedy codec frames
  waveform            : f32 [N]   — final audio (<=1e-2 L-inf gate)

``main`` is the JAX tool's gate (absolute bounds, codes equal).  Fixtures
come from ``make_parity_fixtures`` (this package's or the JAX package's: the
same schema).  ``gate_fixture`` holds an engine at full width against a
fixture the JAX tools wrote from the same weights (random weights, where a
greedy pick may part at a near tie): bounds relative to each stage's
magnitude beside the absolute ones, logits' correlation, and the decode
stages over the frames before the codes first part, which must be explained
by a tie.

  python -m leaxer_qwen3_tts_torch.tools.parity_check --model <ckpt_dir> \\
      --fixture fx.npz [--device {cuda,cpu}]

Exit code 0 = all present stages pass; 1 = any stage fails.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import numpy as np

WAVEFORM_LINF = 1e-2  # BASELINE.md gate
EMBEDS_LINF = 1e-2
LOGITS_LINF = 5e-2  # logit magnitudes ~10; bf16 checkpoints need the slack

# gate_fixture's bounds on L-inf / max|reference| of each stage, by the
# fixture's ``quantize``: twice the error of the CPU run (the kernels' plain
# versions; tests/test_torch_tools.py) on the committed 0.6B fixtures,
# rounded down.  That run's prompt embeds are exact; the card's float32
# text projection may round an embed one bf16 ulp apart, so their bound is
# one bf16 ulp of the largest value (2^-8)
REL_BOUNDS = {
    "int8": {"prompt_embeds": 2.0 ** -8, "prefill_logits": 9.1e-3,  # CPU 4.593e-3
             "decode_logits": 2.5e-2, "waveform": 1.7e-2},  # CPU 1.273e-2, 8.583e-3
    "none": {"prompt_embeds": 2.0 ** -8, "prefill_logits": 1.38e-2,  # CPU 6.938e-3
             "decode_logits": 1.86e-2, "waveform": 1.7e-2},  # CPU 9.320e-3, 8.583e-3
}
MIN_LOGIT_CORR = 0.999  # Pearson correlation of the logits with the reference's
TIE_FACTOR = 2.0  # a code0 part needs the picks' margin <= TIE_FACTOR x the logits' L-inf


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def device_ready(device) -> bool:
    """False, with the engine's message, where ``device`` is None (the card)
    and there is no CUDA device: the tools fill their random params on the
    device before any engine can say so."""
    import torch

    if device is None and not torch.cuda.is_available():
        print("no CUDA device: the tools run on the card; pass --device cpu to run the "
              "kernels' plain versions on the CPU", file=sys.stderr)
        return False
    return True


def compute_stages(engine, text: str, language: str = "auto", max_frames=None) -> dict:
    """Greedy per-stage oracles for ``text`` on ``engine``'s model.

    Returns {text, token_ids, prompt_embeds, prefill_logits, decode_logits,
    codes, waveform}; decode runs one frame per dispatch on the engine's own
    packed params (on the card each frame is the engine's route: K1 and K2
    at int8 units, K1 and K3 at bf16 units), so every frame's logits are
    observable."""
    import torch

    from ..config import language_to_codec_id
    from ..models.codec12hz import vocoder_forward
    from ..runtime.generate import make_generate_fns
    from ..runtime.sampling import SamplingParams

    cfg, dev = engine.cfg, engine.device
    ids = engine.tokenizer.encode(text)
    lang_id = language_to_codec_id(language if language != "auto" else None)
    max_frames = engine.max_frames if max_frames is None else int(max_frames)

    t_bucket = ((len(ids) + 15) // 16) * 16
    ids_arr = np.zeros((1, t_bucket), np.int64)
    ids_arr[0, : len(ids)] = ids
    fns = make_generate_fns(cfg, batch=1, max_len=engine.kv_ladder[-1], chunk_len=1,
                            lang_id=lang_id)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state, bundle = fns.prefill(engine.params, torch.from_numpy(ids_arr).to(dev),
                                torch.tensor([len(ids)], device=dev), gen)
    P = int(bundle.prompt_len)
    out = {
        "text": text,
        "token_ids": np.asarray(ids, np.int32),
        "prompt_embeds": _numpy(bundle.prompt_embeds)[0, :P],
        "prefill_logits": _numpy(state.last_logits)[0],
    }
    sp = SamplingParams.create(temperature=0.0)
    frames, valids, logits_seq = [], [], []
    for _ in range(max_frames):
        state, frame, valid = fns.decode(engine.params, state, bundle.trailing,
                                         bundle.trailing_len, bundle.tts_pad_embed, sp)
        frames.append(_numpy(frame)[0, 0])
        valids.append(bool(valid[0, 0]))
        logits_seq.append(_numpy(state.last_logits)[0])
        if bool(state.done.all()):
            break
    n_valid = sum(valids)
    codes = np.asarray(frames[:n_valid], np.int32).reshape(n_valid, -1)
    out["codes"] = codes
    out["decode_logits"] = np.asarray(logits_seq[:n_valid], np.float32)
    if n_valid:
        wav = vocoder_forward(cfg.vocoder, engine.params["vocoder"],
                              torch.from_numpy(codes[None]).to(dev))
        out["waveform"] = _numpy(wav)[0]
    else:
        out["waveform"] = np.zeros((0,), np.float32)
    return out


def _linf_stage(name, got, want, bound, failures):
    if got.shape != want.shape:
        print(f"{name}: FAIL (shape {got.shape} vs {want.shape})")
        failures.append(name)
        return
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    ok = err <= bound
    print(f"{name}: {'PASS' if ok else 'FAIL'} (L-inf {err:.2e} <= {bound})")
    if not ok:
        failures.append(name)


def load_fixture(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    if a.size == 0 or a.std() == 0 or b.std() == 0:
        return 1.0
    return float(np.corrcoef(a, b)[0, 1])


def _pick(codes: np.ndarray, t: int) -> int:
    """Code0 of frame ``t``, or EOS where the run latched it before frame t."""
    from ..config import CODEC_EOS

    return int(codes[t, 0]) if t < len(codes) else CODEC_EOS


def gate_fixture(engine, fixture, language: str = "auto",
                 log: Callable[[str], None] = print) -> dict:
    """Hold ``engine``'s stages against ``fixture`` (a path or a dict of
    arrays written by the JAX tools from the same weights).

    1. ``token_ids`` equal.
    2. ``prompt_embeds`` and ``prefill_logits``: the JAX tool's absolute
       bound and ``REL_BOUNDS`` of the fixture's ``quantize`` (else int8's)
       on L-inf / max|reference|; the logits' correlation at least
       ``MIN_LOGIT_CORR``.
    3. ``decode_logits`` and ``waveform`` the same, over the agreeing prefix:
       the frames before the first frame whose 16 codes differ
       (``samples_per_frame`` samples a frame).
    4. The codes are data: agreement, the first differing frame and position.
    5. A first part at code0 (an EOS on one side only included) fails unless
       the reference's margin between its pick and the engine's, on the
       logits that picked them (``prefill_logits`` for frame 0,
       ``decode_logits[t - 1]`` for frame t), is at most ``TIE_FACTOR`` x the
       L-inf on those logits: the most that rounding can move two logits
       apart.  That margin is at least the reference's top-two margin, and
       past it the engine's pick is not the greedy pick of its own logits.
       A first part at a sub-code is reported (the fixture holds no chain
       logits).

    The frames run are the fixture's ``frames`` (else its decode_logits'
    length).  Each stage's error is logged beside its bound.  Returns
    {ok, failures, stages: {name: (linf, rel)}, corr, codes: {...},
    frames_run (the decode dispatches: one talker step and one chain each)}."""
    fx = load_fixture(fixture) if isinstance(fixture, str) else dict(fixture)
    max_frames = int(fx["frames"]) if "frames" in fx else len(fx["decode_logits"])
    rel_bounds = REL_BOUNDS[str(fx.get("quantize", "int8"))]
    st = compute_stages(engine, str(fx["text"]), language, max_frames)
    failures, stages, corr = [], {}, {}

    got_ids, want_ids = st["token_ids"], fx["token_ids"].astype(np.int32).ravel()
    ok = got_ids.shape == want_ids.shape and bool((got_ids == want_ids).all())
    log(f"token_ids: {'PASS' if ok else 'FAIL'} ({len(got_ids)} ids)")
    if not ok:
        failures.append("token_ids")
        return {"ok": False, "failures": failures, "stages": stages, "corr": corr,
                "codes": {}, "frames_run": 0}

    def held(name, got, want, abs_bound, logits=False):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        if got.shape != want.shape:
            log(f"{name}: FAIL (shape {got.shape} vs {want.shape})")
            failures.append(name)
            return
        if not want.size:
            log(f"{name}: nothing to compare")
            return
        linf = float(np.max(np.abs(got - want)))
        rel = linf / max(float(np.max(np.abs(want))), 1e-30)
        stages[name] = (linf, rel)
        ok = linf <= abs_bound and rel <= rel_bounds[name]
        msg = f"L-inf {linf:.3e} <= {abs_bound}, rel {rel:.3e} <= {rel_bounds[name]:.3e}"
        if logits:
            corr[name] = c = _corr(got, want)
            ok = ok and c >= MIN_LOGIT_CORR
            msg += f", corr {c:.6f} >= {MIN_LOGIT_CORR}"
        log(f"{name}: {'PASS' if ok else 'FAIL'} ({msg})")
        if not ok:
            failures.append(name)

    held("prompt_embeds", st["prompt_embeds"], fx["prompt_embeds"], EMBEDS_LINF)
    held("prefill_logits", st["prefill_logits"], fx["prefill_logits"].ravel(), LOGITS_LINF,
         logits=True)

    got, want = st["codes"], fx["codes"].astype(np.int32)
    n = min(len(got), len(want))
    rows_eq = (got[:n] == want[:n]).all(axis=1)
    m = int(np.argmin(rows_eq)) if not rows_eq.all() else n  # the agreeing prefix
    part = None
    if m < n:
        part = (m, int(np.argmax(got[m] != want[m])))
    elif len(got) != len(want):
        part = (n, 0)  # one side latched EOS at frame n
    agreement = float((got[:n] == want[:n]).mean()) if n else 1.0
    codes = {"frames": (len(got), len(want)), "agreement": agreement, "agreeing_frames": m,
             "first_part": part}
    where = (f"first part at frame {part[0]}, position {part[1]}" if part
             else "no part")
    log(f"codes (data): {len(got)} frames vs {len(want)}, agreement {agreement:.4f} over {n}, "
        f"{m} agreeing frames, {where}")
    if part is not None and part[1] == 0:
        t = part[0]
        ref = fx["prefill_logits"].ravel() if t == 0 else fx["decode_logits"][t - 1]
        mine = st["prefill_logits"] if t == 0 else st["decode_logits"][t - 1]
        ref = np.asarray(ref, np.float64)
        margin = float(ref[_pick(want, t)] - ref[_pick(got, t)])
        linf = float(np.max(np.abs(np.asarray(mine, np.float64) - ref)))
        ok = margin <= TIE_FACTOR * linf
        codes.update(margin=margin, margin_linf=linf)
        log(f"code0 part at frame {t}: {'PASS' if ok else 'FAIL'} (the reference's margin "
            f"between the two picks {margin:.3e} <= {TIE_FACTOR} x L-inf {linf:.3e}: a near "
            "tie)")
        if not ok:
            failures.append("codes")
    elif part is not None:
        log(f"sub-code part at frame {part[0]}, position {part[1]}: reported, not checked "
            "(the fixture holds no chain logits)")
    if m:
        held("decode_logits", st["decode_logits"][:m], fx["decode_logits"][:m], LOGITS_LINF,
             logits=True)
        spf = engine.cfg.vocoder.samples_per_frame
        held("waveform", st["waveform"][: m * spf], fx["waveform"].ravel()[: m * spf],
             WAVEFORM_LINF)
    else:
        log("decode_logits, waveform: no agreeing frame to compare")
    return {"ok": not failures, "failures": failures, "stages": stages, "corr": corr,
            "codes": codes, "frames_run": min(len(got) + 1, max_frames)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="leaxer_qwen3_tts_torch.tools.parity_check",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="framework checkpoint dir")
    p.add_argument("--fixture", required=True, help=".npz with reference outputs")
    p.add_argument("--language", default="auto")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs: the card (default) or the CPU; no "
                        "fallback between them")
    args = p.parse_args(argv)

    from ..api.engine import TTSEngine
    from ..cli.main import engine_device
    from ..config import MelConfig
    from ..frontend import log_mel, read_wav, resample

    fx = load_fixture(args.fixture)
    engine = TTSEngine(args.model, device=engine_device(args.device))
    if not engine.is_ready():
        print(f"engine not ready: {engine.get_error()}", file=sys.stderr)
        return 1

    failures = []
    text = str(fx["text"]) if "text" in fx else None

    if "token_ids" in fx and text is not None:
        got = np.asarray(engine.tokenizer.encode(text), np.int32)
        want = fx["token_ids"].astype(np.int32).ravel()
        ok = got.shape == want.shape and (got == want).all()
        print(f"tokenizer: {'PASS' if ok else 'FAIL'} ({len(got)} ids)")
        if not ok:
            failures.append("tokenizer")

    if "mel" in fx and "mel_input_wav" in fx:
        audio, sr = read_wav(str(fx["mel_input_wav"]))
        if sr != 24000:
            audio = resample(audio, sr, 24000)
        got = log_mel(audio, MelConfig(), "cpu").numpy()
        want = fx["mel"]
        err = float(np.max(np.abs(got - want))) if got.shape == want.shape else np.inf
        ok = got.shape == want.shape and err < 1e-2
        print(f"mel: {'PASS' if ok else 'FAIL'} (L-inf {err:.2e})")
        if not ok:
            failures.append("mel")

    needs_stages = any(k in fx for k in ("prompt_embeds", "prefill_logits", "decode_logits"))
    if needs_stages and text is not None:
        st = compute_stages(
            engine, text, args.language,
            max_frames=len(fx["decode_logits"]) if "decode_logits" in fx else None,
        )
        if "prompt_embeds" in fx:
            _linf_stage("prompt_embeds", st["prompt_embeds"],
                        fx["prompt_embeds"].astype(np.float32), EMBEDS_LINF, failures)
        if "prefill_logits" in fx:
            _linf_stage("prefill_logits", st["prefill_logits"],
                        fx["prefill_logits"].astype(np.float32).ravel(), LOGITS_LINF, failures)
        if "decode_logits" in fx:
            want = fx["decode_logits"].astype(np.float32)
            n = min(len(st["decode_logits"]), len(want))
            _linf_stage("decode_logits", st["decode_logits"][:n], want[:n], LOGITS_LINF,
                        failures)

    needs_generation = any(k in fx for k in ("codes", "waveform"))
    if needs_generation and text is not None:
        # bound generation by the fixture's length (greedy is deterministic,
        # so equal-length runs are comparable frame for frame)
        if "codes" in fx:
            max_tok = int(len(fx["codes"]))
        else:
            max_tok = max(1, int(np.ceil(len(fx["waveform"].ravel()) / 2000)))
        result = engine.synthesize(text, language=args.language, temperature=0.0,
                                   max_tokens=max_tok)
        if "codes" in fx:
            got, want = result.codes, fx["codes"]
            n = min(len(got), len(want))
            match = float((got[:n] == want[:n]).mean()) if n else 0.0
            ok = got.shape == want.shape and match == 1.0
            print(f"codes: {'PASS' if ok else 'FAIL'} (match {match:.3f}, "
                  f"{got.shape} vs {want.shape})")
            if not ok:
                failures.append("codes")
        if "waveform" in fx:
            got, want = result.audio, fx["waveform"].ravel()
            n = min(len(got), len(want))
            err = float(np.max(np.abs(got[:n] - want[:n]))) if n else np.inf
            ok = len(got) == len(want) and err <= WAVEFORM_LINF
            print(f"waveform: {'PASS' if ok else 'FAIL'} "
                  f"(L-inf {err:.2e} <= {WAVEFORM_LINF})")
            if not ok:
                failures.append("waveform")

    if failures:
        print(f"FAILED stages: {failures}", file=sys.stderr)
        return 1
    print("all present stages PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
