"""Multi-stream serving: dynamic batching over the batched engine.

Port of ``leaxer_qwen3_tts_tpu/serve/server.py`` (pure Python over the
engine; nothing here touches a tensor):

  * ``BatchingServer`` — a background batcher thread that groups queued
    requests (same language) into one batch, pads the batch up to a size
    bucket with duplicates, runs ``TTSEngine.synthesize_batch`` (kernels K4
    and K5 on the card; under a mesh the batch split over its data groups,
    on the plain step and the cached chain), and resolves per-request
    futures.  Per-request
    temperature/top-k/top-p ride as per-row knobs.
  * ``make_http_server`` — a zero-dependency HTTP facade (POST /synthesize ->
    WAV bytes; POST /synthesize_stream through the continuous pool; GET
    /healthz) over either server.
"""

from __future__ import annotations

import io
import json
import queue
import struct
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..api.engine import SynthesisResult, TTSEngine
from ..config import SAMPLE_RATE
from ..utils.logging import get_logger

log = get_logger(__name__)

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)


@dataclass
class _Request:
    text: str
    language: str
    temperature: float
    top_k: int
    top_p: float
    max_tokens: Optional[int]
    seed: Optional[int] = None  # per-request reproducibility (per-row chains)
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)


class BatchingServer:
    """Groups concurrent synthesis requests into batches.

    max_wait_ms bounds added latency: a request waits at most that long for
    companions before its batch launches (possibly alone).
    """

    def __init__(
        self,
        engine: TTSEngine,
        max_batch: int = 8,
        max_wait_ms: float = 30.0,
    ):
        if max_batch not in BATCH_BUCKETS:
            raise ValueError(f"max_batch must be one of {BATCH_BUCKETS}")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._batches_run = 0
        self._requests_done = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> "Future[SynthesisResult]":
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        req = _Request(text, language, temperature, top_k, top_p, max_tokens,
                       seed)
        self._queue.put(req)
        return req.future

    def synthesize(self, text: str, **kw) -> SynthesisResult:
        return self.submit(text, **kw).result()

    @property
    def stats(self) -> dict:
        return {
            "batches": self._batches_run,
            "requests": self._requests_done,
            "queued": self._queue.qsize(),
        }

    def shutdown(self, wait: bool = True) -> None:
        self._stop.set()
        if wait:
            self._thread.join(timeout=30)

    # ------------------------------------------------------------------
    def _collect_batch(self) -> List[_Request]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt.language != first.language:
                # a different prompt (language): push back for the next batch
                self._queue.put(nxt)
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect_batch()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # pragma: no cover
                log.exception("batch failed")
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
        # drain on shutdown
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            r.future.set_exception(RuntimeError("server shut down"))

    def _run_batch(self, batch: List[_Request]) -> None:
        n = len(batch)
        bucket = next(b for b in BATCH_BUCKETS if b >= n)
        padded = batch + [batch[0]] * (bucket - n)  # duplicates decode identically

        texts = [r.text for r in padded]
        temps = [r.temperature for r in padded]
        top_ks = [r.top_k for r in padded]
        top_ps = [r.top_p for r in padded]
        # the engine bound applies batch-wide: use the LARGEST request bound
        # (EOS latching ends shorter streams; min would truncate longer ones)
        bounds = [r.max_tokens for r in padded]
        max_tok = None if any(b is None for b in bounds) else max(bounds)
        # per-request seeds ride as per-stream noise generators; an
        # all-unseeded batch shares one generator
        seeds = [r.seed for r in padded]
        seed_arg = (
            [s if s is not None else 0 for s in seeds]
            if any(s is not None for s in seeds)
            else 0
        )
        results = self.engine.synthesize_batch(
            texts,
            language=batch[0].language,
            temperature=temps if len(set(temps)) > 1 else temps[0],
            top_k=top_ks if len(set(top_ks)) > 1 else top_ks[0],
            top_p=top_ps if len(set(top_ps)) > 1 else top_ps[0],
            max_tokens=max_tok,
            seed=seed_arg,
        )
        self._batches_run += 1
        for r, res in zip(batch, results[:n]):
            self._requests_done += 1
            r.future.set_result(self._trim(r, res))

    def _trim(self, r: _Request, res: SynthesisResult) -> SynthesisResult:
        """Enforce the request's own max_tokens: the batch ran with the max
        over all requests, so shorter bounds must be applied per-result."""
        if r.max_tokens is None or len(res.codes) <= r.max_tokens:
            return res
        spf = self.engine.cfg.vocoder.samples_per_frame
        m = res.metrics
        m.frames = int(r.max_tokens)
        m.audio_seconds = r.max_tokens * spf / float(SAMPLE_RATE)
        return SynthesisResult(
            audio=res.audio[: r.max_tokens * spf],
            codes=res.codes[: r.max_tokens],
            metrics=m,
        )


# ---------------------------------------------------------------------------
# WAV bytes helper + HTTP facade (stdlib only)
# ---------------------------------------------------------------------------


def wav_bytes(audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    pcm = (np.clip(np.asarray(audio, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    out = io.BytesIO()
    out.write(b"RIFF")
    out.write(struct.pack("<I", 36 + pcm.nbytes))
    out.write(b"WAVE")
    out.write(b"fmt ")
    out.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
    out.write(b"data")
    out.write(struct.pack("<I", pcm.nbytes))
    out.write(pcm.tobytes())
    return out.getvalue()


def make_http_server(
    server: BatchingServer,
    host: str = "127.0.0.1",
    port: int = 8080,
):
    """ThreadingHTTPServer facade; caller runs .serve_forever().

    ``/synthesize_stream`` requires a server with ``submit_stream`` (the
    ContinuousBatcher): the request decodes in the SHARED pool batch and its
    audio streams incrementally per chunk; the static BatchingServer answers
    501."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            log.info("%s " + fmt, self.address_string(), *args)

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"ok": True, **server.stats}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path == "/synthesize_stream":
                self._do_stream()
                return
            if self.path != "/synthesize":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                text = req["text"]
            except Exception:
                self.send_error(400, "expected JSON body with a 'text' field")
                return
            try:
                seed = req.get("seed")
                result = server.synthesize(
                    text,
                    language=req.get("language", "auto"),
                    temperature=float(req.get("temperature", 0.8)),
                    top_k=int(req.get("top_k", 50)),
                    top_p=float(req.get("top_p", 0.95)),
                    max_tokens=req.get("max_tokens"),
                    seed=int(seed) if seed is not None else None,
                )
            except Exception as e:
                self.send_error(500, str(e))
                return
            body = wav_bytes(result.audio)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-RTF", f"{result.metrics.rtf:.2f}")
            self.end_headers()
            self.wfile.write(body)

        def _do_stream(self):
            """Chunked-transfer streaming THROUGH the continuous pool: raw
            16-bit PCM as the request's frames decode in the shared batch.
            Content-Type audio/L16 (mono, 24 kHz, little-endian)."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                text = req["text"]
            except Exception:
                self.send_error(400, "expected JSON body with a 'text' field")
                return
            if not hasattr(server, "submit_stream"):
                self.send_error(
                    501,
                    "streaming requires the continuous batcher",
                )
                return
            try:
                seed = req.get("seed")
                gen = server.submit_stream(
                    text,
                    language=req.get("language", "auto"),
                    temperature=float(req.get("temperature", 0.8)),
                    top_k=int(req.get("top_k", 50)),
                    top_p=float(req.get("top_p", 0.95)),
                    max_tokens=req.get("max_tokens"),
                    seed=int(seed) if seed is not None else None,
                )
                self.send_response(200)
                self.send_header("Content-Type", "audio/L16;rate=24000;channels=1")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for item in gen:
                    if hasattr(item, "metrics"):  # final SynthesisResult
                        break
                    pcm = (np.clip(item, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
                    self.wfile.write(f"{len(pcm):x}\r\n".encode())
                    self.wfile.write(pcm)
                    self.wfile.write(b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except BrokenPipeError:
                pass
            except Exception:
                log.exception("stream failed")
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    pass

    return ThreadingHTTPServer((host, port), Handler)
