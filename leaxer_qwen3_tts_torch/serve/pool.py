"""Continuous batching: a persistent decode pool with per-slot admit/retire.

Port of ``leaxer_qwen3_tts_tpu/serve/pool.py``.  Over an engine on a mesh
the slots are split over the mesh's "data" axis as JAX's pool shards them:
``pool_size`` must divide over the data groups (else ``EngineError``, as
JAX's), and group g holds slots ``[g P/d, (g+1) P/d)`` on its lead device
(cache rows, per-slot position, step, EOS latch, text drip and noise
generator).  Admission prefills a request on its slot's group and splices it
there; each pool chunk decodes group by group, on the plain step and the
cached chain (no pool state takes the mesh's K9 or K10, as in JAX):

  * B decode SLOTS run one shared chunked decode forever; requests are
    ADMITTED into free slots at chunk boundaries and RETIRED independently on
    EOS or their own max_tokens.  A short request admitted mid-flight
    finishes without waiting for a long batch-mate.
  * language conditioning lives entirely in the per-request B=1 PREFILL, so
    mixed languages share one decode.
  * per-request sampling knobs ride as per-row host knobs, updated on
    admission.

Mechanics: an admission worker thread runs a B=1 prefill sized to the
pool's KV bucket (and, for a streaming request, a one-frame bootstrap decode
so its first audio leaves at the splice), then the decode thread SPLICES the
single-stream state into slot b of the pool state, in place: the cache row
(``models.layers.splice_kv_cache``), the per-slot position, step, EOS latch,
text-drip buffer and noise generator.  Pool chunks decode with
``uniform_fill=False``: each slot at its own position, read by kernel K4 on
the device (a pool of one slot too: K4 at one row is K1's arithmetic), so a
chunk needs no host sync; an unpacked talker, and an int8 cache on a bucket
the kernels' gate refuses, decode on the plain layers, as the JAX pool does.  Retirement vocodes the stream's
codes off the decode loop and resolves its future.

``warmup`` runs tiny greedy requests through the live pool before it
serves (every declared text bucket and language, and the streamed path).

Speculative mode (``spec_k``): each pool decode runs ``spec_iters`` verify
iterations over ``pool_size`` x ``spec_k`` candidate rows (kernels K6 and K5
on the card) with per-slot acceptance, fill levels and EOS latches, all on
the device.  The admission prefill also samples frame 0 (the spec state's
pending frame), so every request's first frame is committed at the splice.
When the pool-wide trailing acceptance stays below the engine's
``spec_accept_floor``, the whole pool converts to sequential decode
(``spec_to_seq``) and stays there; ``stats["spec_fallback"]`` reports it.

Determinism: each slot has its own ``torch.Generator``, seeded at admission
from (pool seed, request seed) -- never from the slot or the admission order
-- so a seeded request's codes are a function of (text, language, knobs,
seed), whichever slot it lands in and whatever else is in flight (in spec
mode, as long as the pool does not fall back mid-request: the fallback is
pool-wide).  Requests without a seed fold in an admission counter for a
fresh stream each time.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..api.engine import EngineError, SynthesisResult, TTSEngine, _round_up
from ..config import SAMPLE_RATE, language_to_codec_id
from ..models.codec12hz import vocode_chunk, vocoder_forward
from ..models.layers import splice_kv_cache
from ..models.talker import talker_init_cache
from ..parallel import row_groups
from ..runtime.generate import GenerateState, make_generate_fns
from ..runtime.prompt import prompt_length, tts_embeds
from ..runtime.sampling import SamplingParams
from ..runtime.speculative import (
    SpecState,
    decode_frames_spec,
    default_draft,
    make_spec_generate_fns,
    spec_to_seq,
)
from ..utils.logging import get_logger
from ..utils.metrics import SynthesisMetrics

log = get_logger(__name__)

_STREAM_DONE = object()  # chunk-queue sentinel: no more audio chunks


@dataclass
class _PoolRequest:
    text: str
    language: str
    temperature: float
    top_k: int
    top_p: float
    max_tokens: Optional[int]
    forbid_eos: bool = False  # benchmarking / length-forcing knob
    seed: Optional[int] = None  # per-request determinism (occupancy-invariant)
    # streaming requests receive incremental audio chunks on chunk_q while
    # still decoding in the shared pool batch
    stream: bool = False
    chunk_q: Optional["queue.Queue"] = None
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)


@dataclass
class _Active:
    req: _PoolRequest
    budget: int
    frames: List[np.ndarray] = field(default_factory=list)  # [16] rows
    admitted_at: float = field(default_factory=time.perf_counter)
    # --- streaming emitter state (stream=True requests only) ---
    # committed frames vocode incrementally with a rolling causal left
    # context (the engine's B=1 scheme); the retired result's audio IS the
    # concatenation of the emitted chunks
    emit_lock: threading.Lock = field(default_factory=threading.Lock)
    emit_busy: bool = False  # one drain runner per request at a time
    finish_pending: bool = False  # retired: the drain runner finalizes
    voc_fed: int = 0  # frames handed to the incremental vocoder so far
    voc_tail: Optional[np.ndarray] = None  # [ctx, 16] rolling left context
    audio_parts: List[np.ndarray] = field(default_factory=list)
    first_audio_at: Optional[float] = None


@dataclass
class _SlotGroup:
    """One data group's slots ``[g P/d, (g+1) P/d)`` on its lead device:
    the plain path's params there, the draft of a spec pool, the slots'
    decode state and text drips (``trailing`` rows, their lengths) and the
    TTS_PAD embedding."""

    slots: slice
    device: torch.device
    params: dict
    tts_pad: torch.Tensor
    trailing: torch.Tensor
    trailing_len: torch.Tensor
    draft_fn: Optional[Callable] = None
    state: object = None


class PoolStream:
    """Handle for a streaming pool request: iterate to receive np.float32
    audio chunks (24 kHz) as the request decodes inside the shared pool
    batch; the final item is the SynthesisResult (the contract of
    TTSEngine.synthesize_stream).  ``future`` resolves with the result."""

    def __init__(self, req: _PoolRequest):
        self._req = req
        self.future: Future = req.future

    def __iter__(self):
        while True:
            item = self._req.chunk_q.get()
            if item is _STREAM_DONE:
                break
            yield item
        yield self.future.result()  # raises if the request failed


class ContinuousBatcher:
    """Drop-in alternative to BatchingServer with continuous admission.

    Same surface: ``submit`` -> Future[SynthesisResult], ``synthesize``,
    ``submit_stream``, ``stats``, ``shutdown``; composes with
    ``make_http_server``.  ``sync_check=True`` (CUDA only) runs every pool
    decode chunk under ``torch.cuda.set_sync_debug_mode("error")``, so a
    host sync inside a chunk raises; the other threads' device work then
    waits for the chunk (the mode is process-wide), which serializes
    admission and retirement behind decoding.
    """

    def __init__(
        self,
        engine: TTSEngine,
        pool_size: int = 8,
        chunk_len: int = 16,
        kv_bucket: int = 512,
        text_bucket_max: Optional[int] = None,
        seed: int = 0,
        spec_k: Optional[int] = None,
        spec_iters: int = 2,
        sync_check: bool = False,
    ):
        if spec_k is not None and not 2 <= int(spec_k) <= 8:
            raise ValueError("spec_k must be in [2, 8]")
        if not engine.is_ready():
            raise EngineError(f"engine not ready: {engine.get_error()}")
        if engine.mesh is not None:
            data = engine.mesh.shape.get("data", 1)
            if int(pool_size) % max(data, 1) != 0:
                raise EngineError(f"pool_size ({pool_size}) must divide over the mesh data axis "
                                  f"({data})")
        self.spec_k = int(spec_k) if spec_k else None
        self.spec_iters = max(1, int(spec_iters))
        self.device = engine.device
        if sync_check and self.device.type != "cuda":
            raise ValueError("sync_check needs a CUDA engine")
        self.engine = engine
        self.cfg = engine.cfg
        self.pool_size = int(pool_size)
        self.chunk_len = int(chunk_len)
        self.kv_bucket = int(kv_bucket)
        if text_bucket_max is None:
            # text drips one token per generated frame, so prompts beyond
            # ~kv_bucket tokens could never finish dripping anyway
            text_bucket_max = _round_up(min(self.kv_bucket, 512), 16)
        self.text_bucket_max = int(text_bucket_max)
        self.sync_check = bool(sync_check)
        self._seed = int(seed)
        self._prefill_cache = {}

        cfg = self.cfg
        B = self.pool_size
        H = cfg.talker.hidden_size
        dt = cfg.talker.transformer.torch_dtype
        # the slots' data groups; one group without a mesh
        parts = row_groups(engine.mesh, B, self.device)
        self._per = B // len(parts)
        self._groups: List[_SlotGroup] = []
        for slots, dev in parts:
            params = engine.params_on(dev)
            self._groups.append(_SlotGroup(
                slots, dev, params, tts_embeds(params["embeddings"], dev)[2],
                torch.zeros((self._per, self.text_bucket_max, H), dtype=dt, device=dev),
                torch.zeros((self._per,), dtype=torch.long, device=dev),
                default_draft(cfg, params) if self.spec_k else None,
                self._make_idle_state(dev)))
        if self.spec_k:
            self._decode = self._spec_decode
        else:
            self._use_sequential_decode()

        # host-side per-slot sampling knobs; idle slots decode greedily (no noise)
        self._temps = [0.0] * B
        self._top_ks = [50] * B
        self._top_ps = [0.95] * B
        self._forbid = [False] * B

        self._slots: List[Optional[_Active]] = [None] * B
        self._queue: "queue.Queue[_PoolRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._requests_done = 0
        self._chunks_run = 0
        self._admits = 0  # unseeded requests' noise derivation counter
        # adaptive spec, pool-wide: trailing committed slots and iterations of
        # live streams since the last window
        self._acc_slots = 0
        self._acc_iters = 0
        self._spec_fallback = False
        self._warming = False  # warmup's requests leave the acceptance window alone
        # device work of other threads waits for a sync-checked chunk
        self._device_lock = threading.Lock()
        # admission prefills run on worker threads; the decode loop only
        # splices finished prefills at chunk boundaries
        self._reserved = [False] * B  # slots held by in-flight prefills
        self._ready: "queue.Queue[tuple]" = queue.Queue()
        self._admit_exec = ThreadPoolExecutor(max_workers=2, thread_name_prefix="pool-admit")
        # retirement vocoding runs off the decode loop
        self._finisher = ThreadPoolExecutor(
            max_workers=max(2, self.pool_size // 4), thread_name_prefix="pool-retire"
        )
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _text_for_bucket(self, bucket: int) -> str:
        """A text whose BPE length rounds up to exactly ``bucket``."""
        words, text = ["a"], "a"
        while _round_up(len(self.engine._tokenize(text)), 16) < bucket:
            words.append("a")
            text = " ".join(words)
        return text

    def warmup(self, languages=("auto",), text_buckets=None, streaming: bool = True) -> float:
        """Run tiny greedy requests through the live pool, so that the first
        real requests skip the one-time costs (on the card: the kernels'
        build and the wrappers' struct and plan caches at the pool's shapes).

        Covers every declared (text bucket, language) signature (the
        admission prefill), the pooled decode chunk, the splice, retirement
        vocoding and (``streaming``) the streamed request's bootstrap and
        per-chunk vocoding.  Needs a tokenizer.  The pool's counters are put
        back afterwards, so unseeded requests draw as they would have without
        it, and a spec pool does not count the warmup's acceptance: its
        adaptive fallback sees real requests only.  Returns the seconds
        spent."""
        t0 = time.perf_counter()
        if text_buckets is None:
            text_buckets = (16,)
        counters = (self._admits, self._requests_done, self._chunks_run)
        texts = {b: self._text_for_bucket(b) for b in text_buckets}
        self._warming = True
        try:
            futs = [self.submit(texts[b], language=lang, temperature=0.0,
                                max_tokens=self.chunk_len)
                    for lang in languages for b in text_buckets]
            stream = (self.submit_stream(texts[min(text_buckets)], temperature=0.0,
                                         max_tokens=2 * self.chunk_len) if streaming else ())
            for f in futs:
                f.result()
            list(stream)
        finally:
            self._warming = False
        self._admits, self._requests_done, self._chunks_run = counters
        dt = time.perf_counter() - t0
        log.info("pool warmup done in %.1fs", dt)
        return dt

    # ------------------------------------------------------------------
    def submit(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        forbid_eos: bool = False,
        seed: Optional[int] = None,
    ) -> "Future[SynthesisResult]":
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        req = _PoolRequest(text, language, temperature, top_k, top_p, max_tokens, forbid_eos,
                           seed)
        self._queue.put(req)
        return req.future

    def synthesize(self, text: str, **kw) -> SynthesisResult:
        return self.submit(text, **kw).result()

    def submit_stream(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> PoolStream:
        """Streaming synthesis THROUGH the continuous pool: the request
        decodes in the shared batch while its committed frames vocode
        incrementally per chunk -- first audio after the admission
        bootstrap, not at retirement.  Iterate the returned PoolStream for
        audio chunks; the final item is the SynthesisResult."""
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        req = _PoolRequest(text, language, temperature, top_k, top_p, max_tokens, seed=seed,
                           stream=True, chunk_q=queue.Queue())
        self._queue.put(req)
        return PoolStream(req)

    @property
    def stats(self) -> dict:
        return {
            "chunks": self._chunks_run,
            "requests": self._requests_done,
            "queued": self._queue.qsize(),
            "active": sum(s is not None for s in self._slots),
            "spec_fallback": self._spec_fallback,
        }

    def shutdown(self, wait: bool = True) -> None:
        self._stop.set()
        if wait:
            self._thread.join(timeout=60)
        self._admit_exec.shutdown(wait=wait)
        self._finisher.shutdown(wait=wait)

    # ------------------------------------------------------------------
    # device helpers
    # ------------------------------------------------------------------

    def _device_work(self):
        """Context for device work off the decode loop: waits for a
        sync-checked chunk to finish (no-op without sync_check)."""
        return self._device_lock if self.sync_check else contextlib.nullcontext()

    @contextlib.contextmanager
    def _chunk_section(self):
        """Context of one pool decode chunk: with sync_check, a host sync
        inside it raises."""
        if not self.sync_check:
            yield
            return
        with self._device_lock:
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")

    @staticmethod
    def _generator(seed: int, device) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gen

    def _group_of(self, slot: int):
        """(data group index, the slot's row in the group's state)."""
        return divmod(slot, self._per)

    def _use_sequential_decode(self) -> None:
        # uniform_fill=False: pool slots run at DIFFERENT fill levels
        fns = make_generate_fns(self.cfg, batch=self._per, max_len=self.kv_bucket,
                                chunk_len=self.chunk_len, uniform_fill=False)
        self._decode = lambda grp, sp: fns.decode(grp.params, grp.state, grp.trailing,
                                                  grp.trailing_len, grp.tts_pad, sp)

    def _spec_decode(self, grp: _SlotGroup, sp):
        return decode_frames_spec(self.cfg, grp.params, grp.state, grp.trailing,
                                  grp.trailing_len, grp.tts_pad, sp, self.spec_k,
                                  self.spec_iters, grp.draft_fn)

    def _make_idle_state(self, dev):
        """Fresh all-slots-idle state of one data group's slots on its lead
        ``dev``: at construction and to recover after a failed chunk
        (in-flight requests were failed by the caller)."""
        cfg = self.cfg
        B, T = self._per, self.kv_bucket
        H, V = cfg.talker.hidden_size, cfg.talker.codec_vocab_size
        dt = cfg.talker.transformer.torch_dtype
        cache = talker_init_cache(cfg.talker, B, T, dev)
        zeros = torch.zeros((B,), dtype=torch.long, device=dev)
        if self.spec_k:
            return SpecState(
                cache=cache._replace(length=zeros),
                valid_mask=torch.zeros((B, T), dtype=torch.bool, device=dev),
                pending=torch.zeros((B, 16), dtype=torch.int32, device=dev),
                pending_nodrip=torch.zeros((B, H), dtype=dt, device=dev),
                pending_hidden=torch.zeros((B, H), dtype=dt, device=dev),
                rope_pos=zeros,
                step=torch.ones((B,), dtype=torch.long, device=dev),
                done=torch.ones((B,), dtype=torch.bool, device=dev),  # empty slots idle as done
                generators=tuple(self._generator(self._seed, dev) for _ in range(B)),
            )
        return GenerateState(
            cache=cache._replace(length=zeros.clone()),
            valid_mask=torch.zeros((B, T), dtype=torch.bool, device=dev),
            last_logits=torch.zeros((B, V), dtype=torch.float32, device=dev),
            last_hidden=torch.zeros((B, H), dtype=dt, device=dev),
            pos=zeros.clone(),
            step=zeros.clone(),
            done=torch.ones((B,), dtype=torch.bool, device=dev),  # empty slots idle as done
            # placeholders: the admission splice puts the request's generator in
            generators=tuple(self._generator(self._seed, dev) for _ in range(B)),
        )

    def _get_prefill(self, lang_id, spec: bool):
        """B=1 callables of the pool's bucket for one language: the spec
        prefill (which samples frame 0), or the generate callables whose
        one-frame decode bootstraps a streaming request's frame 0."""
        key = (lang_id, spec)
        if key not in self._prefill_cache:
            if spec:
                self._prefill_cache[key] = make_spec_generate_fns(
                    self.cfg, max_len=self.kv_bucket, k=self.spec_k, num_iters=self.spec_iters,
                    lang_id=lang_id,
                )
            else:
                self._prefill_cache[key] = make_generate_fns(
                    self.cfg, batch=1, max_len=self.kv_bucket, chunk_len=1, lang_id=lang_id,
                )
        return self._prefill_cache[key]

    def _vocode(self, codes: np.ndarray) -> np.ndarray:
        """Whole-utterance vocode at retirement."""
        if len(codes) == 0:
            return np.zeros((0,), np.float32)
        with self._device_work():
            c = torch.from_numpy(np.ascontiguousarray(codes, np.int64))[None].to(self.device)
            audio = vocoder_forward(self.cfg.vocoder, self.engine.params["vocoder"], c)
            return audio[0].cpu().numpy().astype(np.float32)

    # ------------------------------------------------------------------
    # streaming emitter (per-slot incremental vocode)
    # ------------------------------------------------------------------

    def _stream_vocode(self, active: _Active, frames_new: np.ndarray) -> np.ndarray:
        """Vocode ``frames_new`` [n, 16] with the request's rolling left
        context; returns the n*spf new audio samples (equal to the
        whole-utterance vocode: every vocoder op is causal)."""
        voc_cfg = self.cfg.vocoder
        tail = active.voc_tail
        ctx = 0 if tail is None else len(tail)
        window = frames_new if tail is None else np.concatenate([tail, frames_new])
        with self._device_work():
            w = torch.from_numpy(np.ascontiguousarray(window, np.int64))[None].to(self.device)
            audio = vocode_chunk(voc_cfg, self.engine.params["vocoder"], w, ctx)
            audio = audio[0].cpu().numpy().astype(np.float32)
        keep = min(voc_cfg.left_context_frames, len(window))
        active.voc_tail = window[len(window) - keep :]
        return audio

    def _drain_stream(self, active: _Active) -> None:
        """Emit audio for every committed-but-unvocoded frame of a streaming
        request.  Runs on a finisher thread (never the decode loop); the
        emit_busy flag keeps exactly ONE runner per request so chunks vocode
        and emit in order.  After retirement (finish_pending) the runner
        also finalizes the request."""
        while True:
            with active.emit_lock:
                total = min(len(active.frames), active.budget)
                n_new = total - active.voc_fed
                if n_new <= 0:
                    if active.finish_pending:
                        active.finish_pending = False  # sole finalizer
                    else:
                        active.emit_busy = False
                        return
                    finalize = True
                else:
                    frames_new = np.stack(active.frames[active.voc_fed : total])
                    active.voc_fed = total
                    finalize = False
            if finalize:
                try:
                    self._finalize_stream(active)
                finally:
                    with active.emit_lock:
                        active.emit_busy = False
                return
            audio = self._stream_vocode(active, frames_new)
            active.audio_parts.append(audio)
            if active.first_audio_at is None:
                active.first_audio_at = time.perf_counter()
            active.req.chunk_q.put(audio)

    def _drain_stream_safe(self, active: _Active) -> None:
        try:
            self._drain_stream(active)
        except Exception as e:  # pragma: no cover
            log.exception("stream vocode failed")
            with active.emit_lock:
                active.emit_busy = False
            self._fail_request(active.req, e)

    def _kick_stream(self, active: _Active) -> None:
        """Schedule a drain runner if none is active (from the decode loop
        after new frames commit)."""
        with active.emit_lock:
            if active.emit_busy:
                return  # the live runner will pick the new frames up
            active.emit_busy = True
        self._finisher.submit(self._drain_stream_safe, active)

    @staticmethod
    def _fail_request(req: _PoolRequest, exc: Exception) -> None:
        if not req.future.done():
            req.future.set_exception(exc)
        if req.chunk_q is not None:
            req.chunk_q.put(_STREAM_DONE)  # unblock the iterator

    # ------------------------------------------------------------------
    # pool loop
    # ------------------------------------------------------------------

    def _admit_seed(self, req: _PoolRequest) -> int:
        """The request's noise seed: from (pool seed, request seed) ONLY for
        a seeded request, so the same (text, seed) resamples identically at
        any occupancy; unseeded requests fold in the admission counter.  The
        domain word (1 vs 0) keeps user seeds and counter values apart.
        Called on the decode thread."""
        if req.seed is not None:
            words = [self._seed, 1, int(req.seed)]
        else:
            words = [self._seed, 0, self._admits]
        self._admits += 1
        entropy = [w & 0xFFFF_FFFF_FFFF_FFFF for w in words]
        return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])

    def _prefill_request(self, slot: int, req: _PoolRequest, seed: int) -> None:
        """ADMISSION WORKER (off the decode loop): tokenize, run the B=1
        prefill (and a streaming request's one-frame bootstrap), then hand
        the result to the decode thread via _ready."""
        try:
            eng = self.engine
            ids = eng._tokenize(req.text)
            vocab = self.cfg.talker.text_vocab_size
            bad = [i for i in ids if not 0 <= int(i) < vocab]
            if bad:
                raise EngineError(f"token id(s) out of range [0, {vocab}): {bad[:8]}")
            t_bucket = _round_up(len(ids), 16)
            if t_bucket > self.text_bucket_max:
                raise EngineError(
                    f"text too long for the pool ({len(ids)} tokens > "
                    f"{self.text_bucket_max} bucket)"
                )
            lang_id = language_to_codec_id(req.language if req.language != "auto" else None)
            spec = self.spec_k is not None  # snapshot: the pool may fall back meanwhile
            per_dispatch = self.spec_k * self.spec_iters if spec else self.chunk_len
            budget = self.kv_bucket - prompt_length(lang_id) - per_dispatch
            if budget < 1:
                raise EngineError("pool kv_bucket too small for the prompt")
            if req.max_tokens is not None:
                budget = min(budget, int(req.max_tokens))
            ids_arr = np.zeros((1, t_bucket), np.int64)
            ids_arr[0, : len(ids)] = ids
            fns = self._get_prefill(lang_id, spec)
            frame0, valid0 = None, False
            sp1 = SamplingParams.create(req.temperature, req.top_k, req.top_p,
                                        forbid_eos=req.forbid_eos)
            # the request runs on its slot's data group
            grp = self._groups[self._group_of(slot)[0]]
            dev, params = grp.device, grp.params
            with self._device_work():
                # host-to-device copies: never inside a sync-checked chunk
                ids_t = torch.from_numpy(ids_arr).to(dev)
                lens_t = torch.tensor([len(ids)], device=dev)
                if spec:
                    # the spec prefill samples frame 0: it is committed at the splice
                    s1, bundle, f0, v0 = fns.prefill(params, ids_t, lens_t,
                                                     self._generator(seed, dev), sp1)
                    frame0, valid0 = f0[0].cpu().numpy(), bool(v0[0].cpu())
                else:
                    s1, bundle = fns.prefill(params, ids_t, lens_t, self._generator(seed, dev))
                if req.stream and not spec:
                    # bootstrap frame 0 here: first audio leaves at the
                    # splice, not after the next pooled chunk.  The state
                    # then carries step=1 (drip index) and the EOS latch.
                    s1, f0, v0 = fns.decode(params, s1, bundle.trailing,
                                            bundle.trailing_len, bundle.tts_pad_embed, sp1)
                    frame0 = f0[0, 0].cpu().numpy()
                    valid0 = bool(v0[0, 0].cpu())
            self._ready.put((slot, req, seed, (spec, t_bucket, budget, s1, bundle, frame0, valid0)))
        except Exception as e:
            log.exception("admission prefill failed")
            self._ready.put((slot, req, seed, e))

    def _splice_ready(self) -> None:
        """Decode thread: splice every finished admission prefill into the
        pool state."""
        while True:
            try:
                slot, req, seed, payload = self._ready.get_nowait()
            except queue.Empty:
                return
            if not isinstance(payload, Exception) and payload[0] != (self.spec_k is not None):
                # the pool fell back to sequential decode while this prefill
                # was in flight: redo it in the current mode
                self._admit_exec.submit(self._prefill_request, slot, req, seed)
                continue
            self._reserved[slot] = False
            if isinstance(payload, Exception):
                self._fail_request(req, payload)
                continue
            try:
                self._splice_one(slot, req, *payload[1:])
            except Exception as e:
                # the pool state may be half written: rebuild it and fail
                # every in-flight request; the loop itself survives
                log.exception("admission splice failed; rebuilding pool state")
                self._fail_request(req, e)
                self._reset(e)

    def _splice_one(self, slot, req, t_bucket, budget, s1, bundle, frame0, valid0) -> None:
        g, row = self._group_of(slot)
        grp = self._groups[g]
        st = grp.state
        splice_kv_cache(st.cache, s1.cache, row)
        st.valid_mask[row].copy_(s1.valid_mask[0])
        if self.spec_k:
            # the spec state after frame 0: pending frame, its embed sum and
            # hidden, RoPE position (= fill level), step 1, the EOS latch
            for name in ("pending", "pending_nodrip", "pending_hidden", "rope_pos", "step",
                         "done"):
                getattr(st, name)[row].copy_(getattr(s1, name)[0])
        else:
            st.last_logits[row].copy_(s1.last_logits[0])
            st.last_hidden[row].copy_(s1.last_hidden[0])
            # pos/step/done from the admission state: after a bootstrap, frame
            # 0 is decoded (step=1; done latched if it hit EOS)
            st.pos[row].copy_(s1.pos[0])
            st.step[row].copy_(s1.step[0])
            st.done[row].copy_(s1.done[0])
        gens = list(st.generators)
        gens[row] = s1.generators[0]  # the request's own noise stream
        grp.state = st._replace(generators=tuple(gens))
        grp.trailing[row].zero_()
        grp.trailing[row, :t_bucket].copy_(bundle.trailing[0])
        grp.trailing_len[row].copy_(bundle.trailing_len[0])
        active = _Active(req=req, budget=budget)
        if valid0 and budget >= 1:
            active.frames.append(frame0)  # the bootstrap committed frame 0
        self._temps[slot] = float(req.temperature)
        self._top_ks[slot] = int(req.top_k)
        self._top_ps[slot] = float(req.top_p)
        self._forbid[slot] = bool(req.forbid_eos)
        self._slots[slot] = active
        if req.stream and active.frames:
            self._kick_stream(active)

    def _retire(self, slot: int) -> None:
        """Free the slot at once; vocode + future resolution run on the
        finisher pool so a long utterance's vocode never stalls decoding."""
        active = self._slots[slot]
        self._slots[slot] = None
        g, row = self._group_of(slot)
        self._groups[g].state.done[row] = True
        self._temps[slot] = 0.0  # idle: greedy, draws no noise
        self._forbid[slot] = False
        self._requests_done += 1
        if active.req.stream:
            # the drain runner finalizes once it has vocoded every frame
            with active.emit_lock:
                active.finish_pending = True
                if active.emit_busy:
                    return  # the live runner picks finish_pending up
                active.emit_busy = True
            self._finisher.submit(self._drain_stream_safe, active)
        else:
            self._finisher.submit(self._finish, active)

    def _finish(self, active: _Active) -> None:
        try:
            codes = (np.stack(active.frames).astype(np.int32) if active.frames
                     else np.zeros((0, 16), np.int32))[: active.budget]
            self._resolve(active, codes, self._vocode(codes))
        except Exception as e:  # pragma: no cover
            self._fail_request(active.req, e)

    def _finalize_stream(self, active: _Active) -> None:
        """Resolve a retired streaming request: every frame was vocoded
        incrementally, so the final audio IS the streamed concatenation."""
        try:
            codes = (np.stack(active.frames).astype(np.int32) if active.frames
                     else np.zeros((0, 16), np.int32))[: active.budget]
            audio = (np.concatenate(active.audio_parts) if active.audio_parts
                     else np.zeros((0,), np.float32))
            self._resolve(active, codes, audio)
        except Exception as e:  # pragma: no cover
            self._fail_request(active.req, e)

    def _resolve(self, active: _Active, codes, audio) -> None:
        now = time.perf_counter()
        spf = self.cfg.vocoder.samples_per_frame
        m = SynthesisMetrics(
            audio_seconds=len(codes) * spf / float(SAMPLE_RATE),
            frames=len(codes),
            total_seconds=now - active.req.enqueued_at,
        )
        if active.first_audio_at is not None:
            m.ttfa_seconds = active.first_audio_at - active.req.enqueued_at
        m.stage_seconds["queued"] = active.admitted_at - active.req.enqueued_at
        active.req.future.set_result(SynthesisResult(audio=audio, codes=codes, metrics=m))
        if active.req.chunk_q is not None:
            active.req.chunk_q.put(_STREAM_DONE)

    def _try_admissions(self) -> None:
        """Decode thread: hand queued requests to admission workers (one per
        free, unreserved slot)."""
        for slot in range(self.pool_size):
            if self._slots[slot] is not None or self._reserved[slot]:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._reserved[slot] = True
            self._admit_exec.submit(self._prefill_request, slot, req, self._admit_seed(req))

    def _reset(self, exc: Exception) -> None:
        """Fail every in-flight request and rebuild an idle pool state."""
        for slot, active in enumerate(self._slots):
            if active is not None:
                self._fail_request(active.req, exc)
            self._slots[slot] = None
            self._temps[slot] = 0.0
            self._forbid[slot] = False
        for grp in self._groups:
            grp.state = self._make_idle_state(grp.device)

    def _check_acceptance(self, valid_np, done_np) -> None:
        """Pool-wide adaptive spec: one decode covers every slot, so the pool
        tracks the trailing acceptance of its live streams and, once a window
        of them stays below the engine's spec_accept_floor, converts the
        whole state to sequential decode."""
        live = [i for i in range(self.pool_size)
                if self._slots[i] is not None and not bool(done_np[i])]
        if live:
            self._acc_iters += self.spec_iters * len(live)
            self._acc_slots += int(valid_np[live].sum())
        if self._acc_iters < max(self.engine.spec_adapt_window, 2 * self.spec_iters):
            return
        accept = max(0, self._acc_slots - self._acc_iters) / max(
            self._acc_iters * (self.spec_k - 1), 1)
        self._acc_slots = self._acc_iters = 0  # a rolling window
        if accept < self.engine.spec_accept_floor:
            log.info("pool spec acceptance %.2f < floor %.2f; switching the pool to "
                     "sequential decode", accept, self.engine.spec_accept_floor)
            self._switch_to_sequential()

    def _switch_to_sequential(self) -> None:
        """The fallback: every slot's pending input is consumed by one talker
        step (``spec_to_seq``; idle slots convert harmlessly, their rows are
        overwritten at the next splice) and the sequential decode takes over."""
        with self._chunk_section():
            for grp in self._groups:
                grp.state = spec_to_seq(self.cfg, grp.params, grp.state, grp.trailing,
                                        grp.trailing_len, grp.tts_pad, uniform_fill=False)
        self.spec_k = None
        self._use_sequential_decode()
        self._spec_fallback = True

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._splice_ready()
            self._try_admissions()
            if not any(s is not None for s in self._slots):
                time.sleep(0.002 if any(self._reserved) else 0.005)
                continue
            sp = SamplingParams.create(tuple(self._temps), tuple(self._top_ks),
                                       tuple(self._top_ps), forbid_eos=tuple(self._forbid))
            try:
                outs = []
                with self._chunk_section():
                    # one chunk per data group, its slots' knobs, one after another
                    for grp in self._groups:
                        grp.state, frames, valid = self._decode(grp, sp.select(grp.slots))
                        outs.append((frames, valid))
                # the one sync of the chunk
                frames_np = np.concatenate([fr.cpu().numpy() for fr, _ in outs])
                valid_np = np.concatenate([va.cpu().numpy() for _, va in outs])
                done_np = np.concatenate([grp.state.done.cpu().numpy() for grp in self._groups])
            except Exception as e:
                log.exception("pool decode failed; failing active requests")
                self._reset(e)
                continue
            self._chunks_run += 1
            if self.spec_k and self.engine.spec_accept_floor > 0 and not self._warming:
                self._check_acceptance(valid_np, done_np)
            for slot, active in enumerate(self._slots):
                if active is None:
                    continue
                n_before = len(active.frames)
                for frame, ok in zip(frames_np[slot], valid_np[slot]):
                    if ok and len(active.frames) < active.budget:
                        active.frames.append(frame)
                if bool(done_np[slot]) or len(active.frames) >= active.budget:
                    self._retire(slot)  # streaming: retire chains the drain
                elif active.req.stream and len(active.frames) > n_before:
                    self._kick_stream(active)  # incremental audio per chunk
        # drain on shutdown
        for active in self._slots:
            if active is not None:
                self._fail_request(active.req, RuntimeError("server shut down"))
        for q in (self._queue, self._ready):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                self._fail_request(item if q is self._queue else item[1],
                                   RuntimeError("server shut down"))

