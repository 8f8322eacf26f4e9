"""The port's engine on a tensor-parallel mesh against the JAX engine on its
mesh, on the CPU: ``make_mesh(1, 2, devices=[cpu, cpu])`` (one device listed
twice: two logical ranks) against JAX's ``make_mesh(1, 2)`` over two
virtual CPU devices.

The routing (which packs the engine attaches, which path each step takes)
equals JAX's; greedy codes equal JAX's on the conftest tiny model (no pack:
the plain path on the mesh's first device) and on a model at the TP tile
widths (the talker step is K9's plain version, the chain K10's, against
JAX's Pallas kernels in interpret mode), through a KV-bucket growth of every
rank's head shards; the plain path keeps the full unfused params on the
first device (a standing difference from JAX, which shards them); what JAX
refuses under a mesh (quantize, frame_fused) leaves the engine not ready,
and everything else a mesh takes runs (``test_torch_mesh_serving.py``
holds the data axis, spec, kv_quant, pools and the server against JAX)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest_util import build_tiny_cfg
from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.parallel import make_mesh as jmake_mesh
from leaxer_qwen3_tts_tpu.runtime.weights import init_params as jinit
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.models import talker as ttalker
from leaxer_qwen3_tts_torch.ops import fused_tp as ttp
from leaxer_qwen3_tts_torch.ops.fused_mtp_tp import TPHeads
from leaxer_qwen3_tts_torch.parallel import make_mesh
from leaxer_qwen3_tts_torch.serve import BatchingServer, ContinuousBatcher
from test_torch_speculative import _port

torch.set_num_threads(2)

CPU = torch.device("cpu")
IDS = [5, 6, 7, 8]  # prompt length 8: a 12-slot first bucket grows after the first chunk
ENGINE = dict(max_frames=4, chunk_len=2, first_chunk_len=2, kv_buckets=(12,))


def _tp_cfg():
    """Talker and MTP trunk at the TP tile widths (H=512, 8 / 4 heads, I=1024:
    NU = KCo = KCd = 512 at tp=2), the fused talker step and the resident
    chain on, 3 sub-code steps and a 4-codebook tiny vocoder."""
    t = jcfg.TransformerConfig(hidden_size=512, num_layers=2, num_heads=8, num_kv_heads=4,
                               head_dim=128, intermediate_size=1024, dtype="float32")
    tiny = build_tiny_cfg()
    return jcfg.TTSModelConfig(
        name="tp-mesh-test",
        talker=jcfg.TalkerConfig(transformer=t, text_embed_dim=64, decode_impl="fused"),
        code_predictor=jcfg.CodePredictorConfig(transformer=t, num_steps=3,
                                                subcode_vocab_size=256, max_seq_len=5,
                                                impl="fused", resident=True),
        vocoder=dataclasses.replace(tiny.vocoder, num_codebooks=4),
        speaker_encoder=None,
    )


@pytest.fixture(scope="module")
def tp_model():
    cfg = _tp_cfg()
    params = jinit(cfg, jax.random.PRNGKey(0), with_speaker_encoder=False)
    return cfg, params


@pytest.fixture(scope="module")
def jax_tp_run(tp_model):
    """The JAX mesh engine's greedy run (computed once: its K9 and K10 run
    interpreted)."""
    cfg, params = tp_model
    jm = jmake_mesh(1, 2, devices=jax.devices()[:2])
    with jax.set_mesh(jm):
        je = JEngine(config=cfg, params=params, mesh=jm, **ENGINE)
        assert je.is_ready(), je.get_error()
        r = je.synthesize_tokens(IDS, temperature=0.0, max_tokens=4)
    return je, r


def _mesh(tp=2):
    return make_mesh(1, tp, devices=[CPU] * tp)


def test_tp_engine_routes_and_decodes_like_jax(tp_model, jax_tp_run, monkeypatch):
    """Both engines attach the talker's and the MTP's ``fused_tp`` packs (the
    port's: the ranks' row packs); the port's greedy codes equal JAX's over
    4 frames (2 chunks, the bucket growing 12 -> 36 between them), each
    frame one call of K9's step entry (on the CPU its plain version: L x tp
    plain halves of each kind) and one K10 chain."""
    cfg, params = tp_model
    je, jr = jax_tp_run
    tc, tparams = _port(cfg, params)
    eng = TTSEngine(config=tc, params=tparams, mesh=_mesh(), **ENGINE)
    assert eng.is_ready(), eng.get_error()
    assert eng.device == CPU and eng.kv_ladder == je.kv_ladder == (12, 36)
    for sub in ("talker", "code_predictor"):
        assert ("fused_tp" in eng.params[sub]) == ("fused_tp" in je.params[sub]) == True
    assert isinstance(eng.params["code_predictor"]["fused_tp_heads"], TPHeads)
    for sub in ("talker", "code_predictor"):
        assert isinstance(eng.params[sub]["fused_tp"], ttp.FusedTPRows)
    assert "fused_step" not in eng.params["talker"]  # no single-device pack under a mesh
    calls = {"step": 0, "attn": 0, "mlp": 0, "chain": 0, "grow": []}
    real_step, real_chain = ttalker.fused_decode_step_tp, tcp.fused_mtp_chain_tp
    real_attn, real_mlp = ttp.attn_half_reference, ttp.mlp_half_reference
    real_grow = TTSEngine._grow_state

    def step(*a, **k):
        calls["step"] += 1
        return real_step(*a, **k)

    def attn(*a, **k):
        calls["attn"] += 1
        return real_attn(*a, **k)

    def mlp(*a, **k):
        calls["mlp"] += 1
        return real_mlp(*a, **k)

    def chain(*a, **k):
        calls["chain"] += 1
        return real_chain(*a, **k)

    def grow(state, new_len):
        out = real_grow(state, new_len)
        calls["grow"].append(tuple(s.shape for s in out.cache.k))
        return out

    monkeypatch.setattr(ttalker, "fused_decode_step_tp", step)
    monkeypatch.setattr(ttp, "attn_half_reference", attn)
    monkeypatch.setattr(ttp, "mlp_half_reference", mlp)
    monkeypatch.setattr(tcp, "fused_mtp_chain_tp", chain)
    monkeypatch.setattr(TTSEngine, "_grow_state", staticmethod(grow))
    r = eng.synthesize_tokens(IDS, temperature=0.0, max_tokens=4)
    frames, L = r.metrics.decoded_frames, cfg.talker.transformer.num_layers
    assert frames == 4 and calls["step"] == calls["chain"] == frames
    assert calls["attn"] == calls["mlp"] == frames * L * 2
    assert ttp.fused_decode_step_tp.launches == 0  # the plain version on the CPU
    # every rank's head shard grew: [L, 1, nk / 2, 36, d] each
    assert calls["grow"] == [((L, 1, 2, 36, 128), (L, 1, 2, 36, 128))]
    np.testing.assert_array_equal(r.codes, jr.codes)
    assert np.isfinite(r.audio).all() and r.audio.shape == jr.audio.shape


def test_tiny_engine_on_a_mesh_matches_jax(tiny_model, tiny_vocab_files):
    """The conftest tiny model takes no pack at tp=2 (its tiles are under
    256), in both engines: greedy codes equal JAX's mesh engine; the plain
    path runs on the mesh's first device on the full, unfused params."""
    cfg, params = tiny_model
    tc, tparams = _port(cfg, params)
    vocab_path, merges_path, _ = tiny_vocab_files
    kw = dict(max_frames=6, chunk_len=2, first_chunk_len=2)
    jm = jmake_mesh(1, 2, devices=jax.devices()[:2])
    with jax.set_mesh(jm):
        je = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path),
                     mesh=jm, **kw)
        jr = je.synthesize("hello world", temperature=0.0)
    eng = TTSEngine(config=tc, params=tparams, tokenizer=Tokenizer(vocab_path, merges_path),
                    mesh=_mesh(), **kw)
    assert eng.is_ready(), eng.get_error()
    for sub in ("talker", "code_predictor"):
        assert "fused_tp" not in eng.params[sub] and "fused_tp" not in je.params[sub]
    r = eng.synthesize("hello world", temperature=0.0)
    np.testing.assert_array_equal(r.codes, jr.codes)
    np.testing.assert_allclose(r.audio, np.asarray(jr.audio), atol=2e-4)
    # the standing difference: the plain path's weights are whole and unfused
    # on the first device (JAX shards wq over the model axis)
    layers = eng.params["talker"]["transformer"]["layers"]
    assert "wqkv" not in layers and layers["wq"].shape == tuple(params["talker"]["transformer"][
        "layers"]["wq"].shape) and layers["wq"].device == CPU
    assert len(je.params["talker"]["transformer"]["layers"]["wq"].sharding.device_set) == 2


def test_mesh_refusals(tp_model, tiny_vocab_files):
    """quantize with a mesh leaves the engine not ready as JAX's does, and
    frame_fused too (JAX's frame gate refuses a mesh), each naming its
    reason; a device other than the mesh's first and an object that is no
    mesh are refused.  Everything else a mesh takes is taken: spec_k, a data
    axis, synthesize_batch, the pool and the server."""
    cfg, params = tp_model
    tc, tparams = _port(cfg, params)
    jm = jmake_mesh(1, 2, devices=jax.devices()[:2])
    je = JEngine(config=cfg, params=params, mesh=jm, quantize="int8")
    for quantize in ("int8", "int4"):
        te = TTSEngine(config=tc, params=tparams, mesh=_mesh(), quantize=quantize)
        assert not te.is_ready() and not je.is_ready()
        assert "unsupported" in te.get_error() and "unsupported" in je.get_error()
    te = TTSEngine(config=tc, params=tparams, mesh=_mesh(), frame_fused=True)
    assert not te.is_ready() and "frame_fused" in te.get_error()
    assert "frame gate refuses a mesh" in te.get_error()
    te = TTSEngine(config=tc, params=tparams, mesh=_mesh(), device="cuda")
    assert not te.is_ready() and "first device" in te.get_error()
    te = TTSEngine(config=tc, params=tparams, mesh=object(), device="cpu")
    assert not te.is_ready() and "make_mesh" in te.get_error()
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    spec = TTSEngine(config=tc, params=tparams, mesh=_mesh(), spec_k=4, tokenizer=tok,
                     max_frames=4)
    assert spec.is_ready(), spec.get_error()
    assert len(spec.synthesize("hello", temperature=0.0, max_tokens=2).codes) <= 2
    data = TTSEngine(config=tc, params=tparams, mesh=make_mesh(2, 2, devices=[CPU] * 4),
                     tokenizer=tok, max_frames=4)
    assert data.is_ready(), data.get_error()
    eng = TTSEngine(config=tc, params=tparams, mesh=_mesh(), tokenizer=tok, max_frames=4)
    assert eng.is_ready(), eng.get_error()
    width = tc.code_predictor.num_steps + 1  # the frame's codes
    for e in (eng, data):
        out = e.synthesize_batch(["hello", "hello world"], temperature=0.0, max_tokens=2)
        assert len(out) == 2 and all(np.isfinite(r.audio).all() for r in out)
        pool = ContinuousBatcher(e, pool_size=2, chunk_len=2, kv_bucket=e.kv_ladder[0])
        try:
            assert pool.synthesize("hello", temperature=0.0, max_tokens=2).codes.shape[1] == width
        finally:
            pool.shutdown()
        server = BatchingServer(e, max_batch=2)
        try:
            assert server.synthesize("hello", temperature=0.0,
                                     max_tokens=2).codes.shape[1] == width
        finally:
            server.shutdown()
    assert len(eng.synthesize_batch(["hello"], temperature=0.0, max_tokens=2)) == 1


# (preset, tp) -> (K9 takes the talker, K10 takes the MTP trunk), the JAX gates' values
ROUTES = {
    ("QWEN3_TTS_06B", 2): (True, True), ("QWEN3_TTS_06B", 4): (True, True),
    ("QWEN3_TTS_06B", 8): (False, False), ("QWEN3_TTS_17B", 2): (True, False),
    ("QWEN3_TTS_17B", 4): (True, True), ("QWEN3_TTS_17B", 8): (True, True),
}


@pytest.mark.parametrize("preset,tp", list(ROUTES))
def test_card_routing_by_preset(preset, tp):
    """The route a mesh engine takes at each (preset, tp), shapes only: the
    talker's B=1 step on K9 or the plain layers, the chain on K10 or the
    cached one (1.7B at tp=2: K9 beside the cached chain, the trunk past
    K10's budget), and under kv_quant the plain step beside the same chain;
    the card takes every one (no problem)."""
    cfg = getattr(tcfg, preset)
    mesh = make_mesh(1, tp, devices=[CPU] * tp)
    k9, k10 = ROUTES[preset, tp]
    assert TTSEngine.mesh_routes(cfg, tp) == (k9, k10)
    assert TTSEngine._mesh_problems(cfg, mesh) == []
    kvq = dataclasses.replace(cfg, talker=dataclasses.replace(cfg.talker, transformer=(
        dataclasses.replace(cfg.talker.transformer, kv_cache_quant=True))))
    assert TTSEngine.mesh_routes(kvq, tp) == (False, k10)
    assert TTSEngine._mesh_problems(kvq, mesh) == []
    assert TTSEngine.mesh_routes(cfg, 1) == (False, False)


def test_talker_step_routes_by_the_jax_predicate(tp_model):
    """K9 takes a B=1 step with a mesh and a pack: the prefill's cache is
    split once into the ranks' kv heads (a TPKVCache) and the step runs on
    the shards; an int8 cache, no mesh or B > 1 keep the full cache and the
    other routes."""
    cfg, params = tp_model
    tc, tparams = _port(cfg, params)
    eng = TTSEngine(config=tc, params=tparams, mesh=_mesh(), **ENGINE)
    tp_ = eng.params["talker"]
    from leaxer_qwen3_tts_torch.models.layers import KVCache, TPKVCache, init_kv_cache

    t = tc.talker.transformer
    cache = init_kv_cache(t, 1, 16, CPU)._replace(length=3)
    shard = ttalker.talker_shard_cache(tc.talker, tp_, cache, eng.mesh)
    assert isinstance(shard, TPKVCache) and len(shard.k) == 2 and shard.length == 3
    assert shard.k[0].shape == (t.num_layers, 1, t.num_kv_heads // 2, 16, t.head_dim)
    valid = torch.zeros((1, 16), dtype=torch.bool)
    emb = torch.randn((1, t.hidden_size), generator=torch.Generator().manual_seed(0))
    logits, hidden, c2, v2 = ttalker.talker_decode_step(tc.talker, tp_, emb, torch.tensor([3]),
                                                        shard, valid, mesh=eng.mesh)
    assert isinstance(c2, TPKVCache) and c2.length == 4 and bool(v2[0, 3])
    assert c2.grow(36).k[1].shape == (t.num_layers, 1, t.num_kv_heads // 2, 36, t.head_dim)
    # no mesh, B > 1 or an int8 cache: the full cache stays
    kvq = dataclasses.replace(t, kv_cache_quant=True)
    for c, mesh in ((cache, None), (init_kv_cache(t, 2, 16, CPU), eng.mesh),
                    (init_kv_cache(kvq, 1, 16, CPU), eng.mesh)):
        assert ttalker.talker_shard_cache(tc.talker, tp_, c, mesh) is c
    # without the mesh the plain layers run on the full cache
    _, _, c3, _ = ttalker.talker_decode_step(tc.talker, tp_, emb, torch.tensor([3]), cache, valid)
    assert isinstance(c3, KVCache) and isinstance(c3.k, torch.Tensor)
