"""Train the speculative-decoding draft head on a checkpoint's own rollouts.

Port of the JAX package's ``tools/train_draft.py``, flag for flag, plus
``--device {cuda,cpu}``.  The spec decoder's speed scales with draft
acceptance; this tool trains the EAGLE-style head (``models/draft.py``) to
predict the model's own next-frame codes, with no external data:

  1. roll out the main model over probe texts through ``TTSEngine`` (on the
     card: the fused decode kernels the engine picks);
  2. teacher-force the draft on (talker hidden, frame embed) -> next codes
     (``training/draft_loss.py``; main weights frozen, reloaded raw from the
     checkpoint);
  3. write the trained draft (params and DraftConfig) back into the
     checkpoint: the engine then uses it whenever spec_k is set.

Usage:
  python -m leaxer_qwen3_tts_torch.tools.train_draft --model <ckpt> [--texts f.txt]
      [--steps 500] [--frames 128] [--d-model 512] [--lr 3e-3] [--out <ckpt2>]
      [--device {cuda,cpu}]
Writes to --out (default: --model, in place).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

import numpy as np

DEFAULT_TEXTS = [
    "hello world",
    "The quick brown fox jumps over the lazy dog.",
    "Speech synthesis on tensor processing units.",
    "A longer sentence exercises the text drip schedule across many frames.",
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="leaxer_qwen3_tts_torch.tools.train_draft",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="framework checkpoint dir")
    p.add_argument("--out", help="output checkpoint dir (default: in place)")
    p.add_argument("--texts", help="file with one rollout text per line")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--frames", type=int, default=128,
                   help="rollout frames per text")
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--temperature", type=float, default=None,
                   help="single rollout temperature (overrides --temperatures)")
    p.add_argument("--temperatures", default="0.0,0.7,1.0",
                   help="comma-separated rollout temperatures: diverse "
                        "sampling covers the code distribution the draft "
                        "will see at serving temperatures, not just the "
                        "greedy mode")
    p.add_argument("--sustained", type=int, default=2,
                   help="synthetic sustained-frame sequences per text "
                        "(repeat-a-frame stretches: silence / held phonemes "
                        "are where the repeat draft wins and the trained "
                        "draft must at least match it)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the rollouts and the training run: the card "
                        "(default) or the CPU; no fallback between them")
    args = p.parse_args(argv)

    import torch

    from ..api.engine import TTSEngine, _to_device
    from ..cli.main import engine_device
    from ..config import DraftConfig
    from ..models.draft import init_draft_params
    from ..runtime.prompt import wrap_text_ids
    from ..runtime.weights import load_checkpoint, save_checkpoint
    from ..training.draft_loss import draft_loss, make_draft_train_step
    from ..training.train_step import adam

    texts = DEFAULT_TEXTS
    if args.texts:
        with open(args.texts) as f:
            texts = [ln.strip() for ln in f if ln.strip()]

    eng = TTSEngine(args.model, device=engine_device(args.device), max_frames=args.frames)
    if not eng.is_ready():
        print(f"engine not ready: {eng.get_error()}", file=sys.stderr)
        return 1
    cfg, dev = eng.cfg, eng.device

    # --- 1. self-rollouts (the training targets) --------------------------
    # every text rolls out at every temperature (serving samples), plus
    # synthetic sustained stretches (a frame held for many steps: where the
    # repeat draft accepts and a trained draft must not regress)
    if args.temperature is not None:
        temps = [args.temperature]
    else:
        temps = [float(x) for x in args.temperatures.split(",") if x.strip()]
    rollouts = []  # (text_ids, codes)
    rng = np.random.default_rng(args.seed)
    for i, text in enumerate(texts):
        ids = None
        for j, temp in enumerate(temps):
            r = eng.synthesize(text, temperature=temp, seed=args.seed + i * 131 + j,
                               max_tokens=args.frames)
            if len(r.codes) < 4:
                continue
            if ids is None:
                ids = np.asarray(wrap_text_ids(eng.tokenizer.encode(text)), np.int32)
            rollouts.append((ids, np.asarray(r.codes)))
            for _ in range(args.sustained if j == 0 else 0):
                # hold one frame of this rollout for a sustained stretch
                f = r.codes[rng.integers(0, len(r.codes))]
                hold = int(rng.integers(6, max(len(r.codes), 8)))
                rollouts.append((ids, np.tile(np.asarray(f)[None, :], (hold, 1))))
    if not rollouts:
        print("no usable rollouts (all too short)", file=sys.stderr)
        return 1

    # one right-padded batch (lengths vary; the loss masks by num_frames)
    B = len(rollouts)
    T = max(len(ids) for ids, _ in rollouts)
    F = max(len(c) for _, c in rollouts)
    text_ids = np.zeros((B, T), np.int64)
    text_len = np.zeros((B,), np.int64)
    codes = np.zeros((B, F, 16), np.int64)
    num_frames = np.zeros((B,), np.int64)
    for b, (ids, c) in enumerate(rollouts):
        text_ids[b, : len(ids)] = ids
        text_len[b] = len(ids)
        codes[b, : len(c)] = c
        num_frames[b] = len(c)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("text_ids", text_ids), ("text_len", text_len), ("codes", codes),
        ("num_frames", num_frames))}

    # --- 2. train the draft head (main model frozen) ----------------------
    t = cfg.talker.transformer
    dcfg = cfg.draft or DraftConfig(
        hidden_size=t.hidden_size,
        d_model=args.d_model,
        codec_vocab_size=cfg.talker.codec_vocab_size,
        subcode_vocab_size=cfg.code_predictor.subcode_vocab_size,
        dtype=t.dtype,
    )
    # train on the unmodified checkpoint weights (the engine fused and packed
    # its copy): reload them raw
    _, raw_params = load_checkpoint(args.model)
    raw_params = _to_device(raw_params, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    dp = raw_params.get("draft") or init_draft_params(dcfg, gen, dev)
    with torch.no_grad():
        m0 = draft_loss(cfg, dcfg, raw_params, dp, batch["text_ids"], batch["text_len"],
                        batch["codes"], batch["num_frames"])
    tx = adam(args.lr)
    opt = tx.init(dp)
    step = make_draft_train_step(cfg, dcfg, tx)
    m = m0
    for _ in range(args.steps):
        dp, opt, m = step(dp, opt, raw_params, batch)

    # --- 3. write back ----------------------------------------------------
    out = args.out or args.model
    raw_params["draft"] = {k: v.detach() for k, v in dp.items()}
    save_checkpoint(out, dataclasses.replace(cfg, draft=dcfg), raw_params)
    if out != args.model:  # carry the tokenizer files along
        for name in ("vocab.json", "merges.txt"):
            src = os.path.join(args.model, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out, name))

    report = {
        "rollouts": B,
        "frames": int(num_frames.sum()),
        "steps": args.steps,
        "loss_before": round(float(m0.loss), 4),
        "loss_after": round(float(m.loss), 4),
        "step1_code0_acc": round(float(m.step1_code0_acc), 4),
        "out": out,
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
