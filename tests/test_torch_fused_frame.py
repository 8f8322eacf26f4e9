"""Kernel K7 (the whole-frame step) of the PyTorch port, on the CPU: its plain
version against the JAX kernel in interpret mode (a sampled frame with EOS
forbidden, a greedy frame with EOS allowed), the port's frame-fused generate
loop against the JAX one, the gates that route a frame to K7, and the engine's
``frame_fused`` knob."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.models.code_predictor import init_code_predictor_params
from leaxer_qwen3_tts_tpu.models.code_predictor import prepare_fused_step as j_prep_cp
from leaxer_qwen3_tts_tpu.models.talker import init_talker_params
from leaxer_qwen3_tts_tpu.models.talker import prepare_fused_talker as j_prep_talker
from leaxer_qwen3_tts_tpu.ops import fused_frame as j_ff
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.models.talker import prepare_fused_talker
from leaxer_qwen3_tts_torch.ops import fused_frame as tff
from leaxer_qwen3_tts_torch.ops.fused_mtp import pack_heads
from leaxer_qwen3_tts_torch.ops.fused_step import meta_pack, pack_fused_weights
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params
from leaxer_qwen3_tts_torch.runtime import generate as tgen
from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams, make_codec_suppress_mask
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from test_torch_fused_mtp_stream import _jax_pack
from test_torch_voice import _kernel_width

torch.set_num_threads(2)

VC, N_STEPS, V, H = 3072, 4, 256, 1024
# the JAX test's own tolerances (tests/test_fused_frame.py)
HIDDEN_TOL, LOGITS_TOL, CACHE_TOL = 1e-5, 1e-4, 5e-5


@pytest.fixture(scope="module")
def frame_models():
    """tests/test_fused_frame.py's setup (2 talker and 2 MTP layers at
    H=1024, float32, 4 chain steps over 256 sub-codes) with the full 3072
    codec vocabulary, so that CODEC_EOS (2150) is a real lane: both packages'
    packs from the same raw weights."""
    tt = jcfg.TransformerConfig(hidden_size=H, num_layers=2, num_heads=8, num_kv_heads=4,
                                head_dim=128, intermediate_size=1024, dtype="float32")
    jt = jcfg.TalkerConfig(transformer=tt, codec_vocab_size=VC, text_vocab_size=152000,
                           decode_impl="fused")
    jm = jcfg.CodePredictorConfig(transformer=tt, num_steps=N_STEPS, subcode_vocab_size=V,
                                  max_seq_len=N_STEPS + 2, impl="fused")
    t_raw = init_talker_params(jt, jax.random.PRNGKey(0))
    m_raw = init_code_predictor_params(jm, jax.random.PRNGKey(1))
    jtq = j_prep_talker(jt, j_quant(j_fuse({"talker": t_raw}))["talker"])
    jmq = j_prep_cp(jm, j_quant(j_fuse({"code_predictor": m_raw}))["code_predictor"])
    tc = tcfg.TransformerConfig(**dataclasses.asdict(tt))
    raw = params_from_jax(flatten_params(jax.device_get({"talker": t_raw,
                                                         "code_predictor": m_raw})))
    q = quantize_params(fuse_params(raw))
    tq, mq = q["talker"], q["code_predictor"]
    rng = np.random.default_rng(0)
    codec = (rng.standard_normal((VC, H)) * 0.02).astype(np.float32)
    tables = (rng.standard_normal((N_STEPS, V, H)) * 0.02).astype(np.float32)
    port = dict(
        tcfg=tc, mcfg=tc,
        tfw=pack_fused_weights(tc, tq["transformer"]["layers"]),
        talker_fnorm=tq["transformer"]["final_norm"], lm_head=pack_heads(tq["lm_head"]),
        codec_table=torch.from_numpy(codec),
        mfw=pack_fused_weights(tc, mq["transformer"]["layers"]),
        mtp_fnorm=mq["transformer"]["final_norm"], heads=pack_heads(mq["heads"]),
        tables=torch.from_numpy(tables),
    )
    jax_packs = (tt, tt, jtq["fused_step"], jtq["transformer"]["final_norm"], jtq["lm_head"],
                 jnp.asarray(codec), jmq["fused_step"], jmq["transformer"]["final_norm"],
                 jmq["heads"], jnp.asarray(tables))
    return port, jax_packs


def _frame_inputs(seed, T, L=2, nk=4, d=128):
    """Seeded inputs of one frame: last logits with CODEC_EOS on top, the
    real control-token mask plus noise, hidden, drip, caches with slots
    before the write position filled, and Gumbel noise."""
    rng = np.random.default_rng(seed)
    ll = (rng.standard_normal((1, VC)) * 2.0).astype(np.float32)
    ll[0, tcfg.CODEC_EOS] = 30.0
    sup = (make_codec_suppress_mask(VC).numpy()
           + rng.standard_normal(VC).astype(np.float32) * 0.1).astype(np.float32)
    lh = (rng.standard_normal((1, H)) * 0.5).astype(np.float32)
    drip = (rng.standard_normal((1, H)) * 0.02).astype(np.float32)
    kc = (rng.standard_normal((L, 1, nk, T, d)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((L, 1, nk, T, d)) * 0.5).astype(np.float32)
    g0 = rng.gumbel(size=(1, VC)).astype(np.float32)
    gm = rng.gumbel(size=(N_STEPS, 1, V)).astype(np.float32)
    return ll, sup, lh, drip, kc, vc, g0, gm


@pytest.mark.parametrize("knobs,forbid_eos,pos", [
    ((0.8, 50, 0.9), True, 7),  # sampled, EOS forbidden: code0 is another token
    ((0.0, 50, 0.9), False, 40),  # greedy, EOS allowed: code0 is CODEC_EOS
])
def test_frame_reference_matches_jax(frame_models, knobs, forbid_eos, pos):
    """The plain version against JAX ``fused_frame_step`` (interpret) on the
    same inputs and noise: code0 and sub-codes exact; hidden within 1e-5,
    logits within 1e-4, the caches within 5e-5."""
    port, jax_packs = frame_models
    T = 64
    ll, sup, lh, drip, kc, vc, g0, gm = _frame_inputs(pos, T)
    kc[:, :, :, pos:] = 0
    vc[:, :, :, pos:] = 0
    temp, top_k, top_p = knobs
    jo = j_ff.fused_frame_step(
        *jax_packs, jnp.asarray(ll), jnp.asarray(lh), jnp.asarray(sup), jnp.asarray(drip),
        jnp.int32(pos), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(g0), jnp.asarray(gm),
        jnp.float32(temp), jnp.int32(top_k), jnp.float32(top_p), jnp.bool_(forbid_eos),
        interpret=True,
    )
    k_cache, v_cache = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to = tff.fused_frame_step(
        **port, last_logits=torch.from_numpy(ll), last_hidden=torch.from_numpy(lh),
        suppress=torch.from_numpy(sup), drip=torch.from_numpy(drip), pos=pos, k_cache=k_cache,
        v_cache=v_cache, g0=torch.from_numpy(g0), gumbel=torch.from_numpy(gm),
        temperature=temp, top_k=top_k, top_p=top_p, forbid_eos=forbid_eos,
    )
    code0, subs, logits, hidden = to[:4]
    assert code0.dtype == subs.dtype == torch.int32
    assert code0.tolist() == np.asarray(jo[0]).tolist()
    assert (code0.item() == tcfg.CODEC_EOS) == (not forbid_eos)
    assert subs.tolist() == np.asarray(jo[1]).tolist()
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jo[3]), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jo[2]), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    for got, want in zip((k_cache, v_cache), jo[4:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CACHE_TOL, rtol=1e-5)


def test_frame_reference_is_the_composition(frame_models):
    """The plain version is the composition the card holds the kernel to: the
    plain sampler's code0, the plain chain on its codec row, the float32 next
    input (no cast) through the plain talker step, then the final norm and
    the bf16-lhs lm_head."""
    from leaxer_qwen3_tts_torch.ops import fused_mtp as tfm
    from leaxer_qwen3_tts_torch.ops import fused_step as tfs

    port, _ = frame_models
    T, pos = 64, 63
    ll, sup, lh, drip, kc, vc, g0, gm = _frame_inputs(5, T)
    args = dict(last_logits=torch.from_numpy(ll), last_hidden=torch.from_numpy(lh).bfloat16(),
                suppress=torch.from_numpy(sup), drip=torch.from_numpy(drip).bfloat16(), pos=pos,
                g0=torch.from_numpy(g0), gumbel=torch.from_numpy(gm), temperature=0.7,
                top_k=40, top_p=0.95, forbid_eos=True)
    k1, v1 = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    code0, subs, logits, hidden, _, _ = tff.fused_frame_step(**port, k_cache=k1, v_cache=v1,
                                                             **args)
    logits0 = args["last_logits"] + args["suppress"]
    logits0[0, tcfg.CODEC_EOS] += tfm.NEG_INF
    c0 = tfm.gumbel_topk_topp_sample(logits0, args["g0"], 0.7, 40, 0.95)
    assert code0.tolist() == c0.tolist() and c0.item() != tcfg.CODEC_EOS
    c0e = port["codec_table"][c0].float()
    s2, ssum = tfm.fused_mtp_chain_reference(
        port["mcfg"], port["mfw"], port["mtp_fnorm"], port["heads"], port["tables"],
        args["last_hidden"], c0e, args["gumbel"], 0.7, 40, 0.95)
    assert torch.equal(s2, subs)
    k2, v2 = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    x = c0e + ssum + args["drip"].float()
    x, _, _ = tfs.fused_decode_step_reference(port["tcfg"], port["tfw"], x, pos, k2, v2)
    h = tfs._rms(x, port["talker_fnorm"].float(), port["tcfg"].rms_norm_eps)
    assert torch.equal(h, hidden) and torch.equal(k1, k2) and torch.equal(v1, v2)
    assert torch.equal(tfs._gemv(h, port["lm_head"].q, port["lm_head"].scale), logits)
    # the multi-dispatch cast of the next input moves the talker's x
    k3, v3 = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    xc, _, _ = tfs.fused_decode_step_reference(
        port["tcfg"], port["tfw"], (c0e + ssum + args["drip"].float()).bfloat16().float(),
        pos, k3, v3)
    assert not torch.equal(xc, x)


def _loop_models():
    """tests/test_fused_frame.py's generate-loop configuration (talker and
    MTP at one layer, H=1024, float32; 4 chain steps) in both packages."""
    cfg0 = jcfg.TTSModelConfig()
    tt = dataclasses.replace(cfg0.talker.transformer, num_layers=1, hidden_size=1024,
                             intermediate_size=1024, dtype="float32")
    mt = dataclasses.replace(cfg0.code_predictor.transformer, num_layers=1, hidden_size=1024,
                             intermediate_size=1024, dtype="float32")
    cfg = dataclasses.replace(
        cfg0,
        talker=dataclasses.replace(cfg0.talker, transformer=tt, decode_impl="fused"),
        code_predictor=dataclasses.replace(cfg0.code_predictor, transformer=mt, num_steps=4,
                                           max_seq_len=6, impl="fused", resident=True),
        frame_fused=True,
    )
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init

    raw = j_init(cfg, jax.random.PRNGKey(0))
    jp = j_quant(j_fuse(raw))
    jp["talker"] = j_prep_talker(cfg.talker, jp["talker"])
    jp["code_predictor"] = j_prep_cp(cfg.code_predictor, jp["code_predictor"])
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = quantize_params(fuse_params(params_from_jax(flatten_params(jax.device_get(raw)))))
    tp["talker"] = prepare_fused_talker(tc.talker, tp["talker"])
    tp["code_predictor"] = tcp.prepare_fused_step(tc.code_predictor, tp["code_predictor"])
    return cfg, jp, tc, tp


@pytest.fixture(scope="module")
def loop_models():
    return _loop_models()


IDS = np.array([[5, 6, 7, 8]], np.int32)
LENS = np.array([4], np.int32)


def _port_frames(tc, tp, sp, seed, calls=None, chunk_len=2, chunks=1):
    fns = tgen.make_generate_fns(tc, batch=1, max_len=96, chunk_len=chunk_len)
    gen = torch.Generator().manual_seed(seed)
    state, bd = fns.prefill(tp, torch.from_numpy(IDS).long(), torch.from_numpy(LENS), gen)
    out = []
    for _ in range(chunks):
        state, fr, vd = fns.decode(tp, state, bd.trailing, bd.trailing_len, bd.tts_pad_embed, sp)
        assert vd.all()
        out.append(fr.numpy())
    return np.concatenate(out, axis=1)


def test_frame_fused_loop_greedy_matches_jax(loop_models, monkeypatch):
    """Greedy frames of the port's frame-fused loop (K7's plain version, one
    call per frame) equal the JAX loop's with its interpret-mode kernel."""
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns as j_make
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP

    cfg, jp, tc, tp = loop_models
    jfns = j_make(cfg, batch=1, max_len=96, chunk_len=2, donate=False)
    st, bd = jfns.prefill(jp, jnp.asarray(IDS), jnp.asarray(LENS), jax.random.PRNGKey(1))
    _, jfr, _ = jfns.decode(jp, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed,
                            JSP.create(temperature=0.0, forbid_eos=True))
    calls = []
    real = tgen.fused_frame_step
    monkeypatch.setattr(tgen, "fused_frame_step", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    got = _port_frames(tc, tp, SamplingParams.create(0.0, forbid_eos=True), 0)
    assert len(calls) == 2
    np.testing.assert_array_equal(got, np.asarray(jfr))


def test_frame_fused_loop_sampled_per_seed(loop_models):
    """Sampled frames: the same seed gives the same frames, another seed
    other frames (the noise: code0's [Vc] then the chain's [n, V], drawn
    from the stream's generator)."""
    _, _, tc, tp = loop_models
    sp = SamplingParams.create(0.8, 50, 0.95, forbid_eos=True)
    a = _port_frames(tc, tp, sp, 1, chunk_len=2, chunks=2)
    b = _port_frames(tc, tp, sp, 1, chunk_len=2, chunks=2)
    c = _port_frames(tc, tp, sp, 2, chunk_len=2, chunks=2)
    assert a.shape == (1, 4, 1 + 4)  # code0 and the 4 sub-codes of this config
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("T,want", [(512, True), (1024, True), (1000, False), (64, True)])
def test_supports_frame_matches_jax(frame_models, T, want):
    """The port's gate against the JAX gate on the JAX test's buckets
    (tests/test_fused_frame.py::test_supports_frame_gates, int8 KV aside),
    and a non-int8 trunk refused."""
    port, jax_packs = frame_models
    tt, jmfw = jax_packs[0], jax_packs[6]
    assert tff.supports_frame(port["mfw"], T, port["tcfg"]) is want
    assert j_ff.supports_frame(jmfw, T, tt) is want
    bf = port["mfw"]._replace(wqkv=port["mfw"].wqkv.bfloat16())
    assert not tff.supports_frame(bf, T, port["tcfg"])


@pytest.mark.parametrize("preset,fits", [("QWEN3_TTS_06B", True), ("QWEN3_TTS_17B", False)])
def test_supports_frame_presets_match_jax(preset, fits):
    """On meta-device packs of the presets' MTP trunks: the 0.6B trunk (78
    MB) passes the gate, the 1.7B trunk (302 MB) does not, as in JAX."""
    cp = getattr(tcfg, preset).code_predictor
    jp = getattr(jcfg, preset)
    talker = getattr(tcfg, preset).talker.transformer
    assert tff.supports_frame(meta_pack(cp.transformer), 512, talker) is fits
    assert j_ff.supports_frame(_jax_pack(jp.code_predictor.transformer), 512,
                               jp.talker.transformer) is fits


def test_engine_frame_fused_path(tiny_vocab_files, monkeypatch):
    """The engine with frame_fused=True on the kernel-width model: synthesize,
    synthesize_stream and synthesize_tokens decode every frame through K7
    (one call per frame, counted in the metrics), seeded output repeats, and
    the streamed chunks equal the final audio."""
    tc, params, tok = _kernel_width(tiny_vocab_files)
    eng = TTSEngine(config=tc, params=params, tokenizer=tok, quantize="int8", device="cpu",
                    max_frames=8, chunk_len=4, first_chunk_len=2, frame_fused=True)
    assert eng.cfg.frame_fused
    calls = []
    real = tgen.fused_frame_step
    monkeypatch.setattr(tgen, "fused_frame_step", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    r = eng.synthesize("hello world", temperature=0.8, seed=3, max_tokens=6)
    m = r.metrics
    assert len(calls) == m.decoded_frames == m.frame_fused_frames > 0
    assert r.codes.shape[1] == 1 + tc.code_predictor.num_steps and np.isfinite(r.audio).all()
    assert r.audio.shape == (r.codes.shape[0] * tc.vocoder.samples_per_frame,)
    again = eng.synthesize("hello world", temperature=0.8, seed=3, max_tokens=6)
    np.testing.assert_array_equal(again.codes, r.codes)
    chunks = list(eng.synthesize_stream("hello world", temperature=0.8, seed=3, max_tokens=6))
    np.testing.assert_array_equal(chunks[-1].codes, r.codes)
    np.testing.assert_array_equal(np.concatenate(chunks[:-1])[: r.audio.shape[0]], r.audio)
    g = eng.synthesize_tokens([5, 6, 7], temperature=0.0, max_tokens=4, language="en")
    assert g.metrics.frame_fused_frames == g.metrics.decoded_frames > 0


def test_engine_frame_fused_routes_like_jax(tiny_vocab_files, monkeypatch):
    """Off the gate the frame-fused engine runs the multi-dispatch path: a
    batch (B=2), and a trunk that fails supports_frame (the 1.7B trunk; here
    forced), which decodes through K3 as the JAX gate routes it."""
    tc, params, tok = _kernel_width(tiny_vocab_files)
    eng = TTSEngine(config=tc, params=params, tokenizer=tok, quantize="int8", device="cpu",
                    max_frames=4, chunk_len=2, frame_fused=True)
    calls = []
    real = tgen.fused_frame_step
    monkeypatch.setattr(tgen, "fused_frame_step", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    batch = eng.synthesize_batch(["hello", "world"], temperature=0.0, max_tokens=4)
    assert not calls and all(r.metrics.frame_fused_frames == 0 for r in batch)
    k3 = []
    real_k3 = tcp.fused_mtp_chain_streamed
    monkeypatch.setattr(tgen, "supports_frame", lambda *a, **k: False)
    monkeypatch.setattr(tcp, "supports_resident", lambda *a, **k: False)
    monkeypatch.setattr(tcp, "fused_mtp_chain_streamed",
                        lambda *a, **k: (k3.append(1), real_k3(*a, **k))[1])
    r = eng.synthesize("hello", temperature=0.0, max_tokens=4)
    assert not calls and r.metrics.frame_fused_frames == 0
    assert len(k3) == r.metrics.decoded_frames > 0


def test_engine_frame_fused_refusals(tiny_vocab_files):
    """The argument frame_fused=True is sequential-only: with spec_k the
    engine is not ready (the JAX engine's message); a config with
    frame_fused set and spec_k builds a ready engine, as in the JAX engine;
    with no device and no card the engine is not ready as ever."""
    tc, params, tok = _kernel_width(tiny_vocab_files)
    eng = TTSEngine(config=tc, params=params, quantize="int8", device="cpu", frame_fused=True,
                    spec_k=4)
    assert not eng.is_ready() and "sequential-only" in eng.get_error()
    with pytest.raises(EngineError, match="engine not ready: frame_fused is sequential-only"):
        eng.synthesize("hello", temperature=0.0)
    eng = TTSEngine(config=dataclasses.replace(tc, frame_fused=True), params=params,
                    quantize="int8", device="cpu", spec_k=4)
    assert eng.is_ready(), eng.get_error()
    if not torch.cuda.is_available():
        eng = TTSEngine(config=tc, params=params, quantize="int8", frame_fused=True)
        assert not eng.is_ready() and "device='cpu'" in eng.get_error()
