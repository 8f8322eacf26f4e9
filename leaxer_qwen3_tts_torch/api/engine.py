"""TTSEngine: the top-level synthesis API of the PyTorch port.

Port of ``leaxer_qwen3_tts_tpu/api/engine.py``, built from a checkpoint
directory or from (config, params): ``synthesize`` and
``synthesize_stream`` (with an optional voice-design ``instruct`` segment
and an optional reference WAV), ``synthesize_clone`` and
``extract_speaker_embedding`` (voice cloning: log-mel, then the speaker
encoder, into the prompt's speaker segment), ``synthesize_speaker`` (a
CustomVoice preset speaker spliced from the checkpoint's ``speaker_table``),
``warmup``, ``synthesize_tokens`` and
``synthesize_batch`` (B streams in one decode, EOS latched per stream,
per-stream seeds), the KV
bucket ladder with cache growth between chunks, the small first chunk for
time-to-first-audio, and the streamed vocoder with causal left context.

With ``spec_k`` the engine decodes speculatively
(``runtime/speculative.py``): ``synthesize`` and ``synthesize_stream`` at B=1
and ``synthesize_batch`` at B>1 verify ``spec_k`` candidate frames per talker
pass, with the trained draft head when the parameters carry one and the
repeat draft otherwise, and fall back to sequential decode when a request's
trailing acceptance stays below ``spec_accept_floor``.

The engine runs on the CUDA device unless the caller passes
``device="cpu"``.  As in the JAX engine, construction records an error
instead of raising (no device and no CUDA device, a configuration the kernels
do not take, ...): ``is_ready()`` and ``get_error()`` report it, and every
synthesis call then raises ``EngineError("engine not ready: ...")``; only a
``spec_k`` outside [2, 8] raises at once.  On the card
every route the JAX engine takes on one device runs, chosen by its own
predicates (at build time, before any tensor moves): a fused talker and
MTP trunk are packed as the JAX engine packs them on its accelerator, and
an unpacked one (``decode_impl="xla"``, ``impl="cached"`` or ``"dense"``,
an architecture JAX's unit gate refuses) decodes on the plain layers;
packs are made with
``quantize="int8"`` as int8 units, ``quantize=None`` (the default) as bf16
units with scales of one (bits=16, no quantization), ``quantize="int4"`` as
int4 units (group-128 scales, the heads int8), for kernels K1 and K2 or K3
(B=1; K3 for an MTP trunk past the residency gate: the 1.7B trunks and
every bf16 trunk), K4 and K5 (B >= 2), K6 (the verify pass, B x spec_k
rows) and K7 (``frame_fused``), at every unit type and both presets; past 32
rows K4, K5 and K6 run as launches of at most 32 rows (K6 by whole streams),
each row as in a call of at most 32.  ``mtp_quantize`` packs
the MTP trunk at another precision from the raw weights (its heads stay
those of ``quantize``: raw heads run as bf16 rows beside an int8 or int4
trunk), and ``"auto"`` adds an int4 ``fused_step_alt`` that the chain takes
where the primary pack fails the residency gate at its batch (JAX's
``resident_pack``; the 0.6B int8 trunk past 16 rows).  Where the B=1 chain
is K3, the batched chain K5 runs on K3's float32 cache, so that its rows
equal K3's.  With ``frame_fused`` each B=1 frame whose packs pass JAX's
frame gate is one K7 launch: a talker of int8, int4 or bf16 units beside an
int8 or int4 trunk (a bf16 trunk fails the gate and decodes K1 + K3, as in
JAX), the lm_head and heads bf16 rows beside a bf16 talker.  With the
resident chain off (``mtp_resident=False``, ``QTTS_MTP_RESIDENT=0``), with
shared heads (``head_mode="shared"``) or with ``QTTS_MTP_STREAM=0`` past
K2's gate, the chain is the per-step one: one K1 (B=1) or K4 launch per
chain position (``models/code_predictor.py::chain_route``).  What still
refuses, each naming its ROADMAP item: float32 embedding tables in the
kernels (K2v), and an architecture JAX's fused step (or, under a mesh, its
tensor-parallel step or chain) takes and the step kernels do not (K1a).  A
talker with
``attn_impl="pallas"`` runs its prefill attention as
kernel K8.  ``kv_quant=True`` keeps the
talker's KV cache in int8 with per-(slot, head) scales (K1, K4, K6 and K7
take it; the top bucket is rounded up to 128 slots).  A configuration the
kernels do not take leaves the engine not ready; a batch they do not take
raises ``EngineError``.

With ``mesh`` (``parallel.make_mesh(data, tp, devices=...)``; a device
listed ``data x tp`` times holds ``tp`` logical shards per data group) the
engine takes every mesh the JAX engine takes, on the routes JAX's
predicates give: ``quantize`` must be None and ``frame_fused`` off (JAX
refuses both), nothing is fused, and the talker's and the MTP trunk's
per-rank int8 packs (``pack_fused_tp``) are attached where JAX attaches
them (:meth:`TTSEngine.mesh_routes`: tp > 1, ``supports_tp`` and no int8
cache for the talker, ``supports_tp_resident`` for the trunk).  A B=1
request steps on kernel K9 and draws its chain on kernel K10 where those
packs are, on the first data row's model ranks; everywhere else (B > 1, a
pool, the verify pass and the candidates' chains of ``spec_k``, an int8
cache, tp=1, a trunk past K10's budget) the step is the plain layers' and
the chain the cached one, as in the JAX engine.  A batch is split over the
data groups where it divides (``parallel.split_rows``, JAX's ``P("data")``)
and stays on group 0 where it does not (JAX's ``P()``); each group prefills
and decodes its rows on its lead device, the groups issued one after
another from the caller's thread.  The prefill, lm_head, code0 draw,
embeddings and vocoder run on the leads with the full params, one copy per
distinct lead device (the JAX engine lets GSPMD shard them: a standing
difference, ROADMAP Queue 3).  With one seed for a batch split over data
groups, group 0 draws from the seed's generator and group g from a
generator seeded from (seed, g); per-stream seeds give each stream the
draws of its one-device run.  On
the CPU the same code runs the kernels' plain versions.  A decode chunk (a
dispatch of verify iterations) enqueues its frames on the device and the
engine syncs once per chunk, when it copies the chunk's codes to the host.
With ``QTTS_PROFILE`` set, every synthesis writes a trace
(``utils/profiling.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import (
    IM_END,
    IM_START,
    MAX_NEW_TOKENS,
    PRESET_SPEAKERS,
    SAMPLE_RATE,
    TTS_BOS,
    TTS_EOS,
    TTSModelConfig,
    language_to_codec_id,
)
from ..frontend.mel import log_mel
from ..frontend.tokenizer import Tokenizer, find_tokenizer_files
from ..frontend.wav import read_wav, resample
from ..models.code_predictor import attach_heads, prepare_fused_step
from ..models.codec12hz import vocode_chunk, vocoder_forward
from ..models.speaker_encoder import speaker_encoder_forward
from ..models.talker import attach_lm_head, prepare_fused_talker, talker_shard_cache
from ..ops.fused_mtp_tp import shard_heads, supports_tp_resident
from ..ops.fused_step import supports, unit_gate
from ..ops.fused_tp import check_timeouts, pack_fused_tp, pack_rows, supports_shard, supports_tp
from ..ops.quant import fuse_params, quantize_params
from ..parallel import Mesh, row_groups
from ..runtime.generate import (
    GenerateFns,
    GenerateState,
    frame_fused_eligible,
    make_generate_fns,
)
from ..runtime.prompt import prompt_length
from ..runtime.sampling import SamplingParams
from ..runtime.speculative import (
    SpecGenerateFns,
    default_draft,
    make_spec_generate_fns,
    spec_to_seq,
)
from ..runtime.weights import load_checkpoint
from ..utils.logging import get_logger
from ..utils.metrics import StageTimer, SynthesisMetrics
from ..utils.profiling import maybe_trace

log = get_logger(__name__)


class EngineError(RuntimeError):
    """Typed engine failure."""


class SynthesisResult(NamedTuple):
    audio: np.ndarray  # [T] float32 mono 24 kHz (a list per stream inside a batched run)
    codes: np.ndarray  # [frames, 16] int32
    metrics: SynthesisMetrics


def _round_up(n: int, multiple: int) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


def _to_device(node, device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    return node


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Group(NamedTuple):
    """One data group's share of a batch: its rows, lead device, the plain
    path's params there, noise generators and inputs on that device."""

    rows: slice
    device: torch.device
    params: dict
    gens: list
    ids: torch.Tensor
    lens: torch.Tensor
    segments: dict

    @property
    def batch(self) -> int:
        return int(self.ids.shape[0])


class TTSEngine:
    """Qwen3-TTS synthesis engine on PyTorch.

    Construct from a checkpoint directory (``config.json`` and the weights,
    see ``runtime/weights.py``; the tokenizer files are looked up beside
    them) or from ``config`` and ``params``.  Construction records errors
    instead of raising: check ``is_ready()`` / ``get_error()``."""

    mesh = None  # the mesh (parallel.make_mesh), if any
    params: Optional[dict] = None
    _bits = 8  # the packs' unit bits (16: bf16 units, quantize=None; 4: int4)
    _mtp_bits: Optional[int] = None  # the MTP trunk's, where mtp_quantize sets it
    _mtp_alt = False  # mtp_quantize="auto": an int4 alt trunk beside the primary

    def __init__(
        self,
        model_dir: Optional[str] = None,
        *,
        config: Optional[TTSModelConfig] = None,
        params: Optional[dict] = None,
        tokenizer: Optional[Tokenizer] = None,
        device=None,
        max_frames: int = MAX_NEW_TOKENS,
        chunk_len: int = 32,
        first_chunk_len: int = 8,
        text_bucket: int = 16,
        quantize: Optional[str] = None,
        kv_buckets: Tuple[int, ...] = (256, 512, 1024),
        mesh=None,
        spec_k: Optional[int] = None,
        spec_iters: int = 8,
        spec_accept_floor: float = 0.3,
        spec_adapt_window: int = 24,
        kv_quant: bool = False,
        mtp_quantize: Optional[str] = None,
        mtp_resident: Optional[bool] = None,
        frame_fused: Optional[bool] = None,
    ):
        self._ready = False
        self._error = ""
        self.mesh = mesh
        self.cfg = config
        self.params: Optional[dict] = None
        self._lead_params = {}  # under a mesh: the plain path's params per lead device
        self.tokenizer = tokenizer
        self.device = torch.device("cpu")
        # speculative decoding: spec_k candidate frames per talker pass,
        # spec_iters verify iterations per dispatch.  Adaptive fallback: once
        # spec_adapt_window iterations have run with trailing acceptance below
        # spec_accept_floor, the request goes on sequentially (0 disables it)
        if spec_k is not None and not 2 <= int(spec_k) <= 8:
            raise ValueError("spec_k must be in [2, 8]")
        self.spec_k = int(spec_k) if spec_k is not None else None
        self.spec_iters = max(1, int(spec_iters))
        self.spec_accept_floor = float(spec_accept_floor)
        self.spec_adapt_window = max(1, int(spec_adapt_window))
        self.max_frames = int(max_frames)
        self.chunk_len = max(1, min(int(chunk_len), self.max_frames))
        self.first_chunk_len = max(1, min(int(first_chunk_len), self.chunk_len))
        self.text_bucket = int(text_bucket)
        full = self.max_frames + 32
        if full > 1024:
            full = _round_up(full, 512)
        elif kv_quant:
            # the int8-KV kernels take 128-aligned buckets (the JAX kernels'
            # scale windows): a top bucket off that grid would raise on the card
            full = _round_up(full, 128)
        # KV-cache bucket ladder: attention reads scale with the current
        # bucket; the cache is zero-padded up a rung as the position nears it
        self.kv_ladder = tuple(sorted({b for b in kv_buckets if b < full} | {full}))
        # as in the JAX engine, construction records its error instead of
        # raising: check is_ready() / get_error(); synthesis raises then
        try:
            self._build(model_dir, config, params, device, quantize, mesh, kv_quant,
                        mtp_quantize, mtp_resident, frame_fused)
            self._ready = True
        except Exception as e:  # record, don't raise (the JAX engine's contract)
            self._error = str(e)
            log.error("engine init failed: %s", e)

    def _check_arguments(self, quantize, mesh, mtp_quantize, frame_fused=None) -> None:
        """The arguments' own errors, before anything is loaded."""
        if quantize not in (None, "int8", "int4"):
            raise EngineError(f"unknown quantize mode {quantize!r}")
        if quantize is not None and mesh is not None:
            raise EngineError(f"quantize={quantize} with a mesh is unsupported")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise EngineError(f"mesh {mesh!r}: a leaxer_qwen3_tts_torch.parallel.Mesh "
                                  "(make_mesh) is expected")
            if frame_fused:
                raise EngineError("frame_fused with a mesh is unsupported: the JAX package's "
                                  "frame gate refuses a mesh (ROADMAP M15)")
        if mtp_quantize not in (None, "int8", "int4", "auto"):
            raise EngineError(f"unknown mtp_quantize mode {mtp_quantize!r}")

    def _build(self, model_dir, config, params, device, quantize, mesh, kv_quant,
               mtp_quantize, mtp_resident, frame_fused) -> None:
        self._check_arguments(quantize, mesh, mtp_quantize, frame_fused)
        if mesh is not None:
            # the plain path runs on the mesh's first device
            if device is not None and torch.device(device) != mesh.lead:
                raise EngineError(f"device {device} is not the mesh's first device {mesh.lead}")
            device = mesh.lead
        if device is None:
            if not torch.cuda.is_available():
                raise EngineError(
                    "no CUDA device: the engine runs on the card; pass device='cpu' to run "
                    "the kernels' plain versions on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        # the JAX engine's pack precisions: quantize=None packs bf16 units;
        # mtp_quantize overrides the MTP trunk's ("auto" keeps the engine's
        # and adds an int4 alt trunk, fused_step_alt)
        self._bits = {None: 16, "int8": 8, "int4": 4}[quantize]
        self._mtp_bits = (self._bits if mtp_quantize in (None, "auto")
                          else {"int8": 8, "int4": 4}[mtp_quantize])
        self._mtp_alt = mtp_quantize == "auto" and self._mtp_bits != 4
        if model_dir is not None:
            config, params = load_checkpoint(model_dir)
            if self.tokenizer is None:
                found = find_tokenizer_files(model_dir)
                if found is not None:
                    self.tokenizer = Tokenizer(found[0], found[1])
                else:
                    log.warning(
                        "no vocab.json found for %s; text synthesis disabled "
                        "(token-level API still available)", model_dir,
                    )
        elif config is None or params is None:
            raise EngineError("need model_dir or (config, params)")
        if mtp_resident is not None:
            # pin the resident MTP chain on or off (None keeps the config's
            # resident, else QTTS_MTP_RESIDENT)
            config = dataclasses.replace(config, code_predictor=dataclasses.replace(
                config.code_predictor, resident=bool(mtp_resident)))
        if frame_fused is not None:
            # pin the whole-frame kernel K7 on or off (None keeps the config's
            # frame_fused); B=1 sequential decode only: the argument refuses
            # spec_k, as in the JAX engine (a config with frame_fused set
            # decodes spec iterations and runs K7 on sequential frames only)
            if frame_fused and self.spec_k is not None:
                raise EngineError("frame_fused is sequential-only: unset spec_k")
            config = dataclasses.replace(config, frame_fused=bool(frame_fused))
        if kv_quant:
            # the int8 KV cache with per-(slot, head) scales, on the talker
            # only (the MTP cache stays in the model dtype, as in the JAX
            # engine); orthogonal to the weights' quantize
            config = dataclasses.replace(config, talker=dataclasses.replace(
                config.talker, transformer=dataclasses.replace(
                    config.talker.transformer, kv_cache_quant=True)))
        self.cfg = cfg = config
        talker_fused = cfg.talker.decode_impl == "fused"
        mtp_fused = cfg.code_predictor.impl == "fused"
        if self.device.type == "cuda":
            # every route the JAX package takes on one device runs here, chosen
            # by its own predicates; what stays refused is where JAX's route is
            # a kernel that the port's kernel does not take
            problems = []
            for name, t, fused in (("talker", cfg.talker.transformer, talker_fused),
                                   ("MTP trunk", cfg.code_predictor.transformer, mtp_fused)):
                if mesh is None and fused and unit_gate(t) and not supports(t):
                    problems.append(
                        f"the JAX package decodes this {name} on its fused step, which the step "
                        "kernels here take at head_dim 128, at most 8 q heads per kv head and "
                        "QK-norm only (ROADMAP item K1a)")
            if mesh is not None:
                problems += self._mesh_problems(cfg, mesh)
            if problems:
                raise EngineError("CUDA kernel path unavailable: " + "; ".join(problems))

        if mesh is not None:
            self.params = self._mesh_params(cfg, _to_device(params, self.device), mesh)
            # the plain path's params once per distinct lead device (one card
            # listed d x tp times holds one copy)
            self._lead_params = {self.device: self.params}
            for lead in mesh.data_leads():
                if lead not in self._lead_params:
                    self._lead_params[lead] = _to_device(self.params, lead)
            return
        # one qkv and one gate/up product per layer (the JAX engine's fuse=True,
        # its default; the port takes no other layout)
        params = fuse_params(_to_device(params, self.device))
        cp = cfg.code_predictor
        # JAX's order (its api/engine.py): the MTP trunk of another precision
        # and the "auto" int4 alt trunk are packed from the raw weights, then
        # int8 quantizes (the int8 packs reuse the QuantizedLinear values),
        # then the primary packs, then int4 quantizes what the plain path
        # reads (the int4 packs are cut from the raw weights on the same grid)
        if mtp_fused and self._mtp_bits != self._bits:
            params["code_predictor"] = prepare_fused_step(cp, params["code_predictor"],
                                                          bits=self._mtp_bits)
        if mtp_fused and self._mtp_alt:
            params["code_predictor"] = prepare_fused_step(cp, params["code_predictor"], bits=4,
                                                          alt=True)
        if self._bits == 8:
            params = quantize_params(params)
        if mtp_fused and "fused_step" not in params["code_predictor"]:
            params["code_predictor"] = prepare_fused_step(cp, params["code_predictor"],
                                                          bits=self._bits)
        if talker_fused:
            params["talker"] = prepare_fused_talker(cfg.talker, params["talker"], bits=self._bits)
        if self._bits == 4:
            params = quantize_params(params, bits=4)
            if "fused_step" in params["talker"]:
                # K7's lm_head: the int8 one the plain path now reads
                params["talker"] = attach_lm_head(params["talker"])
        if "fused_step" in params["code_predictor"]:
            # the chains read the heads the plain path reads (int8 once
            # quantized, raw ones as bf16 rows), whenever the trunk was packed
            params["code_predictor"] = attach_heads(cp, params["code_predictor"])
        self.params = params

    @staticmethod
    def mesh_routes(cfg: TTSModelConfig, tp: int) -> Tuple[bool, bool]:
        """(K9, K10): whether the JAX engine's mesh build (its
        ``api/engine.py`` under ``mesh is not None``) attaches the talker's
        and the MTP trunk's ``fused_tp`` packs at this tp, so that a B=1 step
        is kernel K9 (with no int8 cache) and a B=1 sampled chain kernel K10.
        Where it does not, the step is the plain layers' and the chain the
        cached one."""
        tr, cp = cfg.talker.transformer, cfg.code_predictor
        k9 = (tp > 1 and cfg.talker.decode_impl == "fused" and supports_tp(tr, tp)
              and not tr.kv_cache_quant)
        k10 = (tp > 1 and cp.impl == "fused" and cp.head_mode == "per_step"
               and supports_tp_resident(cp.transformer, tp, cp.num_steps, cp.subcode_vocab_size))
        return k9, k10

    @classmethod
    def _mesh_problems(cls, cfg: TTSModelConfig, mesh) -> List[str]:
        """Why the card cannot decode ``cfg`` on ``mesh``: a pack the JAX
        engine attaches whose rank shard the card's kernels K9 / K10 do not
        take (``supports_shard``: K1's architecture reach and a power-of-two
        tp).  Every other mesh runs its plain step and cached chain."""
        tp = mesh.shape.get("model", 1)
        problems = []
        for name, on, t in zip(("talker's step on K9", "MTP trunk's chain on K10"),
                               cls.mesh_routes(cfg, tp),
                               (cfg.talker.transformer, cfg.code_predictor.transformer)):
            if on and not supports_shard(t, tp):
                problems.append(
                    f"the JAX package decodes the {name} at tp={tp}, whose rank shard the card's "
                    "kernels take at head_dim 128, at most 8 q heads per kv head, K1's row and "
                    "width grid and a power-of-two tp only (ROADMAP item K1a)")
        return problems

    @classmethod
    def _mesh_params(cls, cfg: TTSModelConfig, params: dict, mesh) -> dict:
        """The JAX engine's mesh build: nothing fused or quantized; per-rank
        int8 packs of the raw layers for K9 (``talker["fused_tp"]``) and K10
        (``code_predictor["fused_tp"]`` with the heads' shards,
        ``fused_tp_heads``) where :meth:`mesh_routes` says JAX attaches them,
        on the first data row's model ranks.  Each pack is JAX's
        (``pack_fused_tp``) turned into the ranks' rows (``pack_rows``): the
        engine keeps the rows only, the same int8 values and scales."""
        tp = mesh.shape.get("model", 1)
        tr, cp = cfg.talker.transformer, cfg.code_predictor
        k9, k10 = cls.mesh_routes(cfg, tp)
        params = dict(params)
        if k9:
            params["talker"] = dict(params["talker"], fused_tp=pack_rows(tr, tp, pack_fused_tp(
                tr, params["talker"]["transformer"]["layers"], tp, mesh=mesh)))
        if k10:
            sub = params["code_predictor"]
            params["code_predictor"] = dict(
                sub, fused_tp=pack_rows(cp.transformer, tp, pack_fused_tp(
                    cp.transformer, sub["transformer"]["layers"], tp, mesh=mesh)),
                fused_tp_heads=shard_heads(sub["heads"], mesh.model_devices()))
        return params

    # ------------------------------------------------------------------
    # Status (the JAX engine's is_ready / get_error / has_speaker_encoder)
    # ------------------------------------------------------------------

    def is_ready(self) -> bool:
        return self._ready

    def get_error(self) -> str:
        return self._error

    def has_speaker_encoder(self) -> bool:
        return bool(self._ready and "speaker_encoder" in (self.params or {}))

    def _require_ready(self) -> None:
        if not self._ready:
            raise EngineError(f"engine not ready: {self._error}")

    def params_on(self, device) -> dict:
        """The params of the plain path on ``device``: the engine's, or under
        a mesh the copy on that data group's lead device."""
        return self._lead_params.get(torch.device(device), self.params)

    # ------------------------------------------------------------------
    # Public synthesis API
    # ------------------------------------------------------------------

    def synthesize(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: int = 0,
        instruct: Optional[str] = None,
    ) -> SynthesisResult:
        """Text -> 24 kHz waveform.  ``instruct``: an optional voice-design
        instruction (VoiceDesign models), a prompt segment of its own."""
        return self._last(self.synthesize_stream(
            text, language, temperature, top_k, top_p, max_tokens, seed, instruct=instruct
        ))

    def synthesize_stream(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: int = 0,
        speaker_wav: Optional[str] = None,
        instruct: Optional[str] = None,
    ) -> Iterator:
        """Yields audio chunks (np float32 @ 24 kHz) as they decode; the final
        item is the SynthesisResult.  ``speaker_wav``: a reference WAV whose
        speaker embedding conditions the voice (as :meth:`synthesize_clone`)."""
        speaker = None
        if speaker_wav is not None:
            speaker = torch.from_numpy(self.extract_speaker_embedding(speaker_wav))[None]
        return self._text_stream(text, language, temperature, top_k, top_p, max_tokens, seed,
                                 speaker=speaker, instruct=instruct)

    def synthesize_clone(
        self,
        text: str,
        ref_wav_path: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: int = 0,
        instruct: Optional[str] = None,
    ) -> SynthesisResult:
        """Voice clone from a ~3 s reference WAV: its speaker embedding
        (:meth:`extract_speaker_embedding`) goes into the prompt's
        speaker segment."""
        spk = torch.from_numpy(self.extract_speaker_embedding(ref_wav_path))[None]
        return self._last(self._text_stream(text, language, temperature, top_k, top_p,
                                            max_tokens, seed, speaker=spk, instruct=instruct))

    def extract_speaker_embedding(self, wav_path: str) -> np.ndarray:
        """Reference WAV -> float32 speaker embedding [output_dim]: read,
        resample to 24 kHz, log-mel, speaker encoder (on the engine's
        device)."""
        self._require_ready()
        if not self.has_speaker_encoder():
            raise EngineError("model has no speaker encoder")
        audio, sr = read_wav(wav_path)
        if sr != SAMPLE_RATE:
            audio = resample(audio, sr, SAMPLE_RATE)
        mel = log_mel(audio, self.cfg.mel, device=self.device)  # [T, num_mels]
        emb = speaker_encoder_forward(self.cfg.speaker_encoder, self.params["speaker_encoder"],
                                      mel[None])
        return emb[0].float().cpu().numpy()

    def warmup(self, language: str = "auto", languages=None, text_buckets=None) -> float:
        """Run the requests a serving deployment will send once, so that the
        first real request does not pay the one-time costs: on the card the
        first call builds the CUDA kernels (``ops/_build.py``) and fills the
        wrappers' struct, scratch and plan caches.

        One full-length greedy request per declared (text bucket, language)
        signature, ``min(max_frames, top KV bucket)`` frames long (every KV
        ladder rung the budget reaches, the small first chunk and the
        steady-state chunks, the streamed vocoder's windows), plus one
        ``first_chunk_len`` request (the early-EOS partial window), from the
        token ids ``[5] * (bucket - 2)``.  Defaults to the first text bucket
        and one language.  Returns the wall-clock seconds spent."""
        self._require_ready()
        t0 = time.perf_counter()
        if languages is None:
            languages = (language,)
        if text_buckets is None:
            text_buckets = (self.text_bucket,)
        long_frames = min(self.max_frames, self.kv_ladder[-1])
        for lang in languages:
            for tb in text_buckets:
                ids = [[5] * max(1, int(tb) - 2)]  # rounds up to bucket tb
                for mt in (long_frames, self.first_chunk_len):
                    timer = StageTimer(SynthesisMetrics())
                    # untraced: QTTS_PROFILE traces the requests, not the warmup
                    for _ in self._ids_stream_impl(ids, lang, 0.0, 50, 0.95, mt, 0, timer):
                        pass
        dt = time.perf_counter() - t0
        log.info("engine warmup done in %.1fs", dt)
        return dt

    def synthesize_speaker(
        self,
        text: str,
        speaker: str,
        language: str = "auto",
        **kw,
    ) -> SynthesisResult:
        """Preset-speaker synthesis (CustomVoice models): the speaker's row of
        the checkpoint's ``speaker_table`` ([num_speakers, hidden]) is spliced
        into the prompt.  ``kw``: ``synthesize``'s sampling knobs, ``seed``,
        ``max_tokens`` and ``instruct``.  Without a table it warns and falls
        back to ``synthesize``; an unknown name raises ``EngineError``."""
        self._require_ready()
        name = speaker.lower()
        table = self.params.get("speaker_table")
        if table is None:
            log.warning(
                "model has no speaker_table (CustomVoice weights); "
                "falling back to the default voice"
            )
            return self.synthesize(text, language, **kw)
        if name not in PRESET_SPEAKERS:
            raise EngineError(
                f"unknown speaker {speaker!r}; expected one of {sorted(PRESET_SPEAKERS)}"
            )
        spk = table[PRESET_SPEAKERS[name]].float()[None]
        return self._last(self._text_stream(text, language, speaker=spk, **kw))

    def synthesize_batch(
        self,
        texts: Sequence[str],
        language: str = "auto",
        temperature=0.8,
        top_k=50,
        top_p=0.95,
        max_tokens: Optional[int] = None,
        seed=0,
    ) -> List[SynthesisResult]:
        """Batched multi-stream synthesis: all texts decode in one batch of B
        streams; each stream's EOS latches on its own.  The knobs may be
        scalars or per-stream sequences.  ``seed`` is an int (one noise
        generator for the batch) or a length-B sequence (one generator per
        stream: each stream's samples then depend on its own seed only).
        Past 32 streams kernels K4 and K5 run as launches of at most 32
        rows each, every stream as in a batch of at most 32."""
        self._require_ready()
        timer = StageTimer(SynthesisMetrics())
        with timer.stage("tokenize"):
            id_lists = [self._tokenize(t) for t in texts]
        result = self._last(self._ids_stream(
            id_lists, language, temperature, top_k, top_p, max_tokens, seed, timer
        ))
        if len(texts) == 1:
            return [result]
        return [
            SynthesisResult(audio=result.audio[b], codes=result.codes[b], metrics=result.metrics[b])
            for b in range(len(texts))
        ]

    def synthesize_tokens(
        self,
        token_ids: Sequence[int],
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: int = 0,
    ) -> SynthesisResult:
        """Synthesis from a chat-wrapped sequence
        [IM_START, ASSISTANT, TTS_BOS, *text, TTS_EOS, IM_END] (or bare text ids)."""
        self._require_ready()
        ids = [int(i) for i in token_ids]
        if len(ids) >= 6 and ids[0] == IM_START and ids[-1] == IM_END:
            text_ids = ids[3:-2]
        else:
            text_ids = [i for i in ids if i not in (IM_START, IM_END, TTS_BOS, TTS_EOS)]
        if not text_ids:
            raise EngineError("no text tokens in sequence")
        timer = StageTimer(SynthesisMetrics())
        return self._last(self._ids_stream(
            [text_ids], language, temperature, top_k, top_p, max_tokens, seed, timer
        ))

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    @staticmethod
    def _last(stream) -> SynthesisResult:
        result = None
        for item in stream:
            result = item
        return result

    def _text_stream(self, text, language="auto", temperature=0.8, top_k=50, top_p=0.95,
                     max_tokens=None, seed=0, speaker=None, instruct=None):
        self._require_ready()
        timer = StageTimer(SynthesisMetrics())
        with timer.stage("tokenize"):
            ids = self._tokenize(text)
            instruct_ids = self._tokenize(instruct) if instruct else None
        yield from self._ids_stream(
            [ids], language, temperature, top_k, top_p, max_tokens, seed, timer,
            speaker=speaker, instruct_ids=instruct_ids,
        )

    def _tokenize(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise EngineError("tokenizer not loaded (missing vocab.json/merges.txt)")
        ids = self.tokenizer.encode(text)
        if not ids:
            raise EngineError("empty text")
        return ids

    def _get_fns(self, lang_id, kv_bucket: int, chunk_len: int, batch: int = 1,
                 route_batch: Optional[int] = None) -> GenerateFns:
        """The generate callables of ``batch`` rows.  ``route_batch``: the
        whole batch's rows, which choose the mesh's routes (JAX's K9 and K10
        gates take B=1 only); a data group's share of a larger batch decodes
        on the plain step and the cached chain."""
        routed = (batch if route_batch is None else route_batch) == 1
        return make_generate_fns(
            self.cfg, batch=batch, max_len=kv_bucket, chunk_len=chunk_len, lang_id=lang_id,
            mesh=self.mesh if routed else None,
        )

    def _groups(self, ids_t, lens_t, seeds, segments) -> List["_Group"]:
        """The batch's rows over the mesh's data groups (``row_groups``: the
        whole batch on the engine's device without a mesh or where the batch
        does not divide), each with its inputs on its lead device and its
        noise generators: per-stream seeds sliced; one seed kept by group 0
        and folded with g for group g."""
        B = int(ids_t.shape[0])
        out = []
        for g, (rows, dev) in enumerate(row_groups(self.mesh, B, self.device)):
            if len(seeds) > 1:
                picked = seeds[rows]
            elif g == 0:
                picked = seeds
            else:
                words = [int(seeds[0]) & 0xFFFF_FFFF_FFFF_FFFF, g]
                picked = [int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])]
            gens = []
            for sd in picked:
                gens.append(torch.Generator(device=dev))
                gens[-1].manual_seed(int(sd))
            whole = rows == slice(0, B)
            seg = {k: v if whole else v[rows].to(dev) for k, v in segments.items()}
            out.append(_Group(rows, dev, self.params_on(dev), gens,
                              ids_t if whole else ids_t[rows].to(dev),
                              lens_t if whole else lens_t[rows].to(dev), seg))
        return out

    @staticmethod
    def _grow_state(state: GenerateState, new_len: int) -> GenerateState:
        """Zero-pad the KV cache (:meth:`KVCache.grow`, or every rank's head
        shard of a mesh's :class:`TPKVCache`) and the validity mask up to the
        next bucket; padded slots are invalid until written."""
        vm = state.valid_mask
        pad = new_len - state.cache.max_len
        valid = torch.cat([vm, torch.zeros((vm.shape[0], pad), dtype=vm.dtype, device=vm.device)], 1)
        return state._replace(cache=state.cache.grow(new_len), valid_mask=valid)

    def _ids_stream(self, *args, **kw):
        with maybe_trace("synthesize"):
            yield from self._ids_stream_impl(*args, **kw)

    def _ids_stream_impl(
        self, id_lists, language, temperature, top_k, top_p, max_tokens, seed, timer,
        speaker: Optional[torch.Tensor] = None,  # [B, H] preset or cloned speaker embedding
        instruct_ids: Optional[List[int]] = None,  # the instruction's token ids
    ):
        self._require_ready()
        cfg = self.cfg
        B = len(id_lists)
        if B < 1:
            raise EngineError("no texts")
        vocab = cfg.talker.text_vocab_size
        for ids in list(id_lists) + ([instruct_ids] if instruct_ids else []):
            bad = [i for i in ids if not 0 <= int(i) < vocab]
            if bad:
                raise EngineError(f"token id(s) out of range [0, {vocab}): {bad[:8]}")
        lang_id = language_to_codec_id(language if language != "auto" else None)
        max_tokens = self.max_frames if max_tokens is None else min(max_tokens, self.max_frames)

        t_bucket = _round_up(max(len(ids) for ids in id_lists), self.text_bucket)
        ids_padded = np.zeros((B, t_bucket), np.int64)
        for b, ids in enumerate(id_lists):
            ids_padded[b, : len(ids)] = ids
        lens = np.array([len(ids) for ids in id_lists], np.int64)
        dev = self.device
        # the optional prompt segments, as the prefill functions take them
        segments = {}
        if speaker is not None:
            segments["speaker_embed"] = speaker.to(dev)
        i_bucket = 0
        if instruct_ids:
            i_bucket = _round_up(len(instruct_ids), self.text_bucket)
            instr = np.zeros((B, i_bucket), np.int64)
            instr[:, : len(instruct_ids)] = instruct_ids
            segments["instruct_ids"] = torch.from_numpy(instr).to(dev)
            segments["instruct_len"] = torch.full((B,), len(instruct_ids), dtype=torch.long,
                                                  device=dev)
        P = prompt_length(lang_id, speaker is not None, i_bucket)
        # the last chunk may overshoot max_tokens by up to chunk_len - 1
        # frames, so the budget keeps a full chunk below the top bucket
        top = self.kv_ladder[-1]
        budget = top - P - self.chunk_len
        if budget < 1:
            raise EngineError(
                f"prompt ({P} positions) too long for the KV cache "
                f"(top bucket {top}, chunk {self.chunk_len})"
            )
        max_tokens = min(max_tokens, budget)
        bidx = next(
            (i for i, b in enumerate(self.kv_ladder) if b >= P + self.chunk_len + 1),
            len(self.kv_ladder) - 1,
        )
        try:
            sp = SamplingParams.create(temperature, top_k, top_p)
            if sp.per_row:
                sp.rows(B)
        except ValueError as e:
            raise EngineError(str(e)) from None
        if isinstance(seed, (list, tuple, np.ndarray)):
            seeds = list(seed)
            if len(seeds) != B:
                raise EngineError(f"seed sequence length {len(seeds)} != batch {B}")
        else:
            seeds = [seed]
        ids_t = torch.from_numpy(ids_padded).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        groups = self._groups(ids_t, lens_t, seeds, segments)
        if self.spec_k is not None:
            spec = self._spec_stream if B == 1 else self._spec_stream_batched
            yield from spec(timer, groups, lang_id, P, max_tokens, sp)
            return

        # per data group: [state, bundle] of its rows on its lead device
        runs = []
        with timer.stage("prefill"):
            for grp in groups:
                fns = self._get_fns(lang_id, self.kv_ladder[bidx], self.first_chunk_len,
                                    grp.batch, B)
                runs.append(list(fns.prefill(grp.params, grp.ids, grp.lens, grp.gens,
                                             **grp.segments)))
            for d in {grp.device for grp in groups}:
                _sync(d)

        voc_cfg = cfg.vocoder
        spf = voc_cfg.samples_per_frame
        frames_chunks, valid_chunks, audio_chunks = [], [], []
        tail: Optional[torch.Tensor] = None  # rolling [B, ctx, 16] vocoder context
        steps = fused_frames = 0
        first = True
        while steps < max_tokens:
            cur_chunk = self.first_chunk_len if first else self.chunk_len
            while (
                P + steps + cur_chunk + 1 > self.kv_ladder[bidx]
                and bidx + 1 < len(self.kv_ladder)
            ):
                bidx += 1
                for run in runs:
                    run[0] = self._grow_state(run[0], self.kv_ladder[bidx])
            if frame_fused_eligible(cfg, self.params, runs[0][0], sp, mesh=self.mesh):
                fused_frames += cur_chunk
            with timer.stage("decode"):
                outs = []
                for grp, run in zip(groups, runs):
                    fns = self._get_fns(lang_id, self.kv_ladder[bidx], cur_chunk, grp.batch, B)
                    bundle = run[1]
                    run[0], fr, va = fns.decode(
                        grp.params, run[0], bundle.trailing, bundle.trailing_len,
                        bundle.tts_pad_embed, sp.select(grp.rows),
                    )
                    outs.append((fr.to(dev), va.to(dev)))
                frames = torch.cat([o[0] for o in outs]) if len(outs) > 1 else outs[0][0]
                valid = torch.cat([o[1] for o in outs]) if len(outs) > 1 else outs[0][1]
                frames_np = frames.cpu().numpy()  # the one sync of the chunk
                if self.mesh is not None and B == 1:
                    check_timeouts()  # K9's and K10's status words of the chunk's launches
            valid_np = valid.cpu().numpy()
            done = all(bool(run[0].done.all().cpu()) for run in runs)
            frames_chunks.append(frames_np)
            valid_chunks.append(valid_np)
            steps += cur_chunk

            with timer.stage("vocode"):
                n_ctx = 0 if tail is None else int(tail.shape[1])
                window = frames if tail is None else torch.cat([tail, frames], dim=1)
                audio = vocode_chunk(voc_cfg, self.params["vocoder"], window, n_ctx)
                audio = audio.cpu().numpy().astype(np.float32)
                ctx = min(voc_cfg.left_context_frames, int(window.shape[1]))
                tail = window[:, window.shape[1] - ctx :]
            audio = audio * np.repeat(valid_np, spf, axis=1)  # post-EOS samples -> 0
            audio_chunks.append(audio)
            timer.mark_first_audio()
            first = False
            keep = min(cur_chunk, max_tokens - (steps - cur_chunk)) * spf
            yield audio[0, :keep] if B == 1 else audio[:, :keep]
            if done:
                break

        all_frames = np.concatenate(frames_chunks, axis=1)[:, :max_tokens]
        all_valid = np.concatenate(valid_chunks, axis=1)[:, :max_tokens]
        n_valid = all_valid.sum(axis=1)  # frames before EOS, per stream
        full_audio = np.concatenate(audio_chunks, axis=1)
        metrics = timer.finish()
        metrics.decoded_frames = steps
        metrics.frame_fused_frames = fused_frames
        if B == 1:
            metrics.frames = int(n_valid[0])
            metrics.audio_seconds = metrics.frames * spf / SAMPLE_RATE
            yield SynthesisResult(
                audio=full_audio[0, : metrics.frames * spf],
                codes=all_frames[0][all_valid[0]],
                metrics=metrics,
            )
            return
        # per-stream counts; the stage times are the batch's (one decode for
        # every stream), so a stream's RTF is its audio over the batch's wall
        per_stream = [
            SynthesisMetrics(
                stage_seconds=dict(metrics.stage_seconds),
                audio_seconds=float(n_valid[b]) * spf / SAMPLE_RATE,
                frames=int(n_valid[b]),
                decoded_frames=steps,
                ttfa_seconds=metrics.ttfa_seconds,
                total_seconds=metrics.total_seconds,
            )
            for b in range(B)
        ]
        yield SynthesisResult(
            audio=[full_audio[b, : int(n_valid[b]) * spf] for b in range(B)],
            codes=[all_frames[b][all_valid[b]] for b in range(B)],
            metrics=per_stream,
        )

    # ------------------------------------------------------------------
    # Speculative decoding
    # ------------------------------------------------------------------

    def _get_spec_fns(self, lang_id, max_len: int, num_iters: int, batch: int = 1,
                      params: Optional[dict] = None) -> SpecGenerateFns:
        """Spec callables (JAX's take no mesh: the verify pass is the plain
        layers' and the candidates' chain the cached one under a mesh);
        ``params``: the group's, whose draft head drafts."""
        return make_spec_generate_fns(self.cfg, max_len=max_len, k=self.spec_k,
                                      num_iters=num_iters, batch=batch, lang_id=lang_id,
                                      draft_fn=default_draft(self.cfg, params or self.params))

    def _spec_prologue(self, P: int, max_tokens: int):
        """Iterations per dispatch shrunk to fit short requests and small
        caches (a dispatch may consume spec_k * iters slots), max_tokens
        clamped to the cache, and the first ladder rung.  Returns (iters,
        spec_chunk, max_tokens, bidx)."""
        top = self.kv_ladder[-1]
        iters = min(self.spec_iters, max(1, -(-max_tokens // self.spec_k)))
        while self.spec_k * iters > top - P - 1 and iters > 1:
            iters -= 1
        spec_chunk = self.spec_k * iters
        budget = top - P - spec_chunk
        if budget < 1:
            raise EngineError(
                f"prompt ({P} positions) too long for the KV cache "
                f"(top bucket {top}, spec chunk {spec_chunk})"
            )
        bidx = next(
            (i for i, b in enumerate(self.kv_ladder) if b >= P + spec_chunk + 1),
            len(self.kv_ladder) - 1,
        )
        return iters, spec_chunk, min(max_tokens, budget), bidx

    def _spec_stream(self, timer, groups, lang_id, P, max_tokens, sp):
        """Speculative decode of one stream (on group 0).  Commits per
        dispatch are data-dependent (between iters and iters * spec_k
        frames), so committed frames are compacted on the host and vocoded
        in the sequential path's windows (a small first one for time to
        first audio)."""
        (grp,) = groups
        iters, spec_chunk, max_tokens, bidx = self._spec_prologue(P, max_tokens)
        # the first dispatch runs one iteration, so first audio follows it
        cur_iters = 1
        with timer.stage("prefill"):
            fns = self._get_spec_fns(lang_id, self.kv_ladder[bidx], cur_iters)
            state, bundle, frame0, valid0 = fns.prefill(self.params, grp.ids, grp.lens, grp.gens,
                                                        sp, **grp.segments)
            frame0, valid0 = frame0.cpu().numpy(), valid0.cpu().numpy()
        out = _FrameEmitter(self, timer, max_tokens)
        if valid0[0]:
            out.committed.append(frame0[0])
        done = not bool(valid0[0])
        slots = 1  # inputs consumed so far: the host copy of state.step
        n_iterations = 0
        while True:
            yield from out.drain()
            if done or len(out.committed) >= max_tokens:
                break
            while (P + slots - 1 + spec_chunk + 1 > self.kv_ladder[bidx]
                   and bidx + 1 < len(self.kv_ladder)):
                bidx += 1
                state = self._grow_state(state, self.kv_ladder[bidx])
            if P + slots - 1 + spec_chunk + 1 > self.kv_ladder[bidx]:
                break  # the cache is full (the max_tokens clamp makes this rare)
            fns = self._get_spec_fns(lang_id, self.kv_ladder[bidx], cur_iters)
            with timer.stage("decode"):
                state, frames, valid = fns.decode(self.params, state, bundle.trailing,
                                                  bundle.trailing_len, bundle.tts_pad_embed, sp)
                frames_np = frames[0].cpu().numpy()  # the one sync of the dispatch
            out.committed.extend(frames_np[valid[0].cpu().numpy()])
            done = bool(state.done.all().cpu())
            slots = int(state.step[0].cpu())
            n_iterations += cur_iters
            cur_iters = iters
            if (not done and self.spec_accept_floor > 0
                    and n_iterations >= self.spec_adapt_window):
                accept = (slots - 1 - n_iterations) / max(n_iterations * (self.spec_k - 1), 1)
                if accept < self.spec_accept_floor:
                    yield from self._spec_seq_continue(
                        state, bundle, out, sp, lang_id, P, bidx, n_iterations, slots,
                    )
                    return
        yield from out.drain(final=True)
        yield self._spec_result(out, n_iterations, slots, 1 + n_iterations * self.spec_k)

    def _spec_result(self, out: "_FrameEmitter", n_iterations, slots, decoded,
                     fallback=False) -> SynthesisResult:
        metrics = out.timer.finish()
        metrics.frames = out.emitted
        metrics.audio_seconds = out.emitted * self.cfg.vocoder.samples_per_frame / SAMPLE_RATE
        metrics.decoded_frames = decoded
        metrics.spec_iterations = n_iterations
        # each iteration commits 1 + its accepted drafts; slots counts frame 0
        metrics.spec_accepted = max(0, slots - 1 - n_iterations)
        metrics.spec_fallback = fallback
        return SynthesisResult(
            audio=np.concatenate(out.audio) if out.audio else np.zeros((0,), np.float32),
            codes=np.stack(out.committed[: out.emitted]).astype(np.int32) if out.emitted
            else np.zeros((0, 16), np.int32),
            metrics=metrics,
        )

    def _spec_seq_continue(self, spec_state, bundle, out: "_FrameEmitter", sp, lang_id, P, bidx,
                           n_iterations, slots):
        """The adaptive fallback: one talker step consumes the pending input
        (``spec_to_seq``), then the sequential chunked loop runs to the end."""
        pos = P + slots - 1  # the pending input's position: the host fill level
        spec_state = spec_state._replace(cache=spec_state.cache._replace(length=pos))
        with out.timer.stage("decode"):
            state = spec_to_seq(self.cfg, self.params, spec_state, bundle.trailing,
                                bundle.trailing_len, bundle.tts_pad_embed)
        # on a mesh the sequential steps are K9's where its pack is (the
        # conversion step itself is the plain one, as JAX's spec_to_seq)
        state = state._replace(cache=talker_shard_cache(self.cfg.talker, self.params["talker"],
                                                        state.cache, self.mesh))
        pos += 1
        decoded = 1 + n_iterations * self.spec_k
        while len(out.committed) < out.max_tokens:
            cur = self.chunk_len
            while pos + cur + 1 > self.kv_ladder[bidx] and bidx + 1 < len(self.kv_ladder):
                bidx += 1
                state = self._grow_state(state, self.kv_ladder[bidx])
            if pos + cur + 1 > self.kv_ladder[bidx]:
                break
            fns = self._get_fns(lang_id, self.kv_ladder[bidx], cur)
            with out.timer.stage("decode"):
                state, frames, valid = fns.decode(self.params, state, bundle.trailing,
                                                  bundle.trailing_len, bundle.tts_pad_embed, sp)
                frames_np = frames[0].cpu().numpy()
                if self.mesh is not None:
                    check_timeouts()
            out.committed.extend(frames_np[valid[0].cpu().numpy()])
            pos += cur
            decoded += cur
            yield from out.drain()
            if bool(state.done.all().cpu()):
                break
        yield from out.drain(final=True)
        yield self._spec_result(out, n_iterations, slots, decoded, fallback=True)

    def _spec_stream_batched(self, timer, groups, lang_id, P, max_tokens, sp):
        """Speculative decode of B > 1 streams (``synthesize_batch``): one
        verify pass covers B x spec_k candidate rows with per-stream
        acceptance, per data group; frames compact per stream on the host
        and the vocoder runs once at the end on the padded batch."""
        B = sum(grp.batch for grp in groups)
        spf = self.cfg.vocoder.samples_per_frame
        iters, spec_chunk, max_tokens, bidx = self._spec_prologue(P, max_tokens)
        runs = []  # per data group: [state, bundle]
        with timer.stage("prefill"):
            f0, v0 = [], []
            for grp in groups:
                fns = self._get_spec_fns(lang_id, self.kv_ladder[bidx], iters, grp.batch,
                                         grp.params)
                state, bundle, frame0, valid0 = fns.prefill(grp.params, grp.ids, grp.lens,
                                                            grp.gens, sp.select(grp.rows),
                                                            **grp.segments)
                runs.append([state, bundle])
                f0.append(frame0.cpu().numpy())
                v0.append(valid0.cpu().numpy())
            f0, v0 = np.concatenate(f0), np.concatenate(v0)
        buffers = [[f0[b]] if v0[b] else [] for b in range(B)]
        done = ~v0
        steps = np.ones((B,), np.int64)
        n_iterations = 0
        while not done.all() and not all(len(buf) >= max_tokens for buf in buffers):
            slots = int(steps.max())
            while (P + slots - 1 + spec_chunk + 1 > self.kv_ladder[bidx]
                   and bidx + 1 < len(self.kv_ladder)):
                bidx += 1
                for run in runs:
                    run[0] = self._grow_state(run[0], self.kv_ladder[bidx])
            if P + slots - 1 + spec_chunk + 1 > self.kv_ladder[bidx]:
                break
            with timer.stage("decode"):
                outs = []
                for grp, run in zip(groups, runs):
                    fns = self._get_spec_fns(lang_id, self.kv_ladder[bidx], iters, grp.batch,
                                             grp.params)
                    bundle = run[1]
                    run[0], frames, valid = fns.decode(grp.params, run[0], bundle.trailing,
                                                       bundle.trailing_len, bundle.tts_pad_embed,
                                                       sp.select(grp.rows))
                    outs.append((frames, valid))
                # the one sync of the dispatch
                frames_np = np.concatenate([fr.cpu().numpy() for fr, _ in outs])
            valid_np = np.concatenate([va.cpu().numpy() for _, va in outs])
            for b in range(B):
                buffers[b].extend(frames_np[b][valid_np[b]])
            done = np.concatenate([run[0].done.cpu().numpy() for run in runs])
            steps = np.concatenate([run[0].step.cpu().numpy() for run in runs])
            n_iterations += iters
        n_valid = [min(len(buf), max_tokens) for buf in buffers]
        F_pad = _round_up(max(max(n_valid), 1), self.chunk_len)  # few vocoder shapes
        codes = np.zeros((B, F_pad, 16), np.int32)
        for b in range(B):
            if n_valid[b]:
                codes[b, : n_valid[b]] = np.stack(buffers[b][: n_valid[b]])
        with timer.stage("vocode"):
            c = torch.from_numpy(codes.astype(np.int64)).to(self.device)
            audio = vocoder_forward(self.cfg.vocoder, self.params["vocoder"], c)
            audio = audio.cpu().numpy().astype(np.float32)
        timer.mark_first_audio()
        metrics = timer.finish()
        per_stream = [
            SynthesisMetrics(
                stage_seconds=dict(metrics.stage_seconds),
                audio_seconds=n_valid[b] * spf / SAMPLE_RATE,
                frames=n_valid[b],
                decoded_frames=1 + n_iterations * self.spec_k,
                ttfa_seconds=metrics.ttfa_seconds,
                total_seconds=metrics.total_seconds,
                spec_iterations=n_iterations,
                spec_accepted=max(0, int(steps[b]) - 1 - n_iterations),
            )
            for b in range(B)
        ]
        yield SynthesisResult(
            audio=[audio[b, : n_valid[b] * spf] for b in range(B)],
            codes=[codes[b, : n_valid[b]] for b in range(B)],
            metrics=per_stream,
        )


class _FrameEmitter:
    """The committed frames of one speculative stream, vocoded in windows
    (``first_chunk_len`` frames first, then ``chunk_len``) with a rolling
    causal left context, as the sequential stream vocodes its chunks."""

    def __init__(self, engine: TTSEngine, timer: StageTimer, max_tokens: int):
        self.engine = engine
        self.timer = timer
        self.max_tokens = max_tokens
        self.committed: List[np.ndarray] = []  # [16] rows, in order
        self.emitted = 0  # frames vocoded and yielded
        self.audio: List[np.ndarray] = []
        self.want = engine.first_chunk_len
        self.tail: Optional[torch.Tensor] = None  # [1, ctx, 16] on the device

    def _vocode(self, frames_np: np.ndarray) -> np.ndarray:
        eng = self.engine
        voc_cfg = eng.cfg.vocoder
        frames = torch.from_numpy(np.ascontiguousarray(frames_np, np.int64))[None].to(eng.device)
        n_ctx = 0 if self.tail is None else int(self.tail.shape[1])
        window = frames if self.tail is None else torch.cat([self.tail, frames], dim=1)
        audio = vocode_chunk(voc_cfg, eng.params["vocoder"], window, n_ctx)
        ctx = min(voc_cfg.left_context_frames, int(window.shape[1]))
        self.tail = window[:, window.shape[1] - ctx :]
        return audio[0].cpu().numpy().astype(np.float32)

    def drain(self, final: bool = False):
        """Yield the audio of every full window of committed frames up to
        ``max_tokens`` (and, when ``final``, of the frames left over)."""
        limit = min(len(self.committed), self.max_tokens)
        while limit - self.emitted >= self.want or (final and limit > self.emitted):
            n = min(self.want, limit - self.emitted)
            with self.timer.stage("vocode"):
                audio = self._vocode(np.stack(self.committed[self.emitted : self.emitted + n]))
            self.audio.append(audio)
            self.emitted += n
            self.timer.mark_first_audio()
            self.want = self.engine.chunk_len
            yield audio
