"""python -m leaxer_qwen3_tts_torch.serve -m <model_dir> [--port 8080] ...

Port of ``leaxer_qwen3_tts_tpu/serve/__main__.py``, flag for flag, plus
``--device {cuda,cpu}`` as in the CLI: build the engine from the checkpoint
directory, pick the continuous pool or the static batcher, warm both up
(unless ``--no-warmup``), then serve HTTP until Ctrl-C (exit 0).  On the card
every weight precision serves at both presets: an unset ``--quantize`` (the
default) as bf16 weight units, ``--quantize int8`` and ``int4`` as int8 and
int4 units, each with or without ``--kv-quant`` (the int8 KV cache) and
``--spec-k``, at any ``--pool-size`` (past 32 rows the batched kernels run
as launches of at most 32 rows), and with ``--mtp-resident off`` (the
per-step chain: one step kernel launch per chain position).
"""

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="leaxer-qwen3-tts-torch-serve")
    p.add_argument("-m", "--model", required=True, help="model checkpoint dir")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    p.add_argument(
        "--batcher", choices=["continuous", "static"], default="continuous",
        help="continuous: persistent decode pool, per-request admit/retire "
        "(default); static: batch forms, runs to completion",
    )
    p.add_argument("--pool-size", type=int, default=8,
                   help="decode slots (continuous batcher)")
    p.add_argument("--kv-bucket", type=int, default=512,
                   help="pool KV bucket = max frames + prompt (continuous)")
    p.add_argument("--max-batch", type=int, default=8, help="static batcher")
    p.add_argument("--max-wait-ms", type=float, default=30.0, help="static batcher")
    p.add_argument("--max-tokens", type=int, default=2048)
    p.add_argument("--quantize", choices=["int8", "int4"])
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache with per-(slot, head) scales (the talker's)")
    p.add_argument("--mtp-resident", choices=["on", "off"],
                   help="pin the resident MTP chain kernel "
                        "(default: on; QTTS_MTP_RESIDENT env overrides)")
    p.add_argument("--spec-accept-floor", type=float, default=0.3,
                   help="adaptive spec: revert to sequential decode when "
                        "trailing acceptance stays below this (0 disables)")
    p.add_argument(
        "--spec-k", type=int, choices=range(2, 9), metavar="K",
        help="speculative decoding: the continuous pool verifies K drafted "
             "frames per slot per talker pass (streaming requests included); "
             "the static batcher uses the engine's spec paths",
    )
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warmup pass (first requests then pay the kernels' "
                        "build and the plan caches)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs: the card (default) or the CPU")
    args = p.parse_args(argv)

    from ..api.engine import EngineError, TTSEngine
    from ..cli.main import engine_device
    from .pool import ContinuousBatcher
    from .server import BatchingServer, make_http_server

    engine = TTSEngine(
        args.model, device=engine_device(args.device), max_frames=args.max_tokens,
        quantize=args.quantize, spec_k=args.spec_k, kv_quant=args.kv_quant,
        spec_accept_floor=args.spec_accept_floor,
        mtp_resident=(None if args.mtp_resident is None
                      else args.mtp_resident == "on"),
    )
    if not engine.is_ready():
        print(f"Error: {engine.get_error()}", file=sys.stderr)
        return 1
    warm_engine = not args.no_warmup and engine.tokenizer is not None
    try:
        if args.batcher == "continuous":
            server = ContinuousBatcher(
                engine, pool_size=args.pool_size, kv_bucket=args.kv_bucket,
                spec_k=args.spec_k,
            )
        else:
            server = BatchingServer(
                engine, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms
            )
    except EngineError as e:  # batched decoding the card does not take
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if warm_engine:
        print("warming up (building the kernels, filling the plan caches)...", flush=True)
        dt = engine.warmup()  # /synthesize_stream + static-batcher paths
        if args.batcher == "continuous":
            dt += server.warmup()  # the pool's own decode and splice
        print(f"warmup done in {dt:.1f}s", flush=True)
    httpd = make_http_server(server, args.host, args.port)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} (POST /synthesize; "
          f"{args.batcher} batching)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
