"""The routes the JAX package takes outside its step and chain kernels, in
the PyTorch port: the MTP chain's and the talker step's route tables
against the JAX package's own dispatch (its functions replaced by recorders
that name the route taken), ``QTTS_ASSERT_FUSED`` against the JAX case, the
engine's card gate (past it for every knob; the step kernels' narrower
architecture reach refused by name), a kernel-width int8 engine at the JAX
package's default implementations (``decode_impl="xla"``, ``impl="cached"``)
against the JAX engine, the dense chain against JAX's
``predict_subcodes_dense``, and ``talker_prefill_all_logits`` (M4).
Tolerances as stated at each comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import leaxer_qwen3_tts_tpu.ops.fused_mtp as jfm
import leaxer_qwen3_tts_tpu.ops.fused_step as jfs
from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.models import code_predictor as jcp
from leaxer_qwen3_tts_tpu.models import layers as jlayers
from leaxer_qwen3_tts_tpu.models import talker as jtalker
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
from leaxer_qwen3_tts_tpu.runtime import sampling as jsamp
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.models import layers as tlayers
from leaxer_qwen3_tts_torch.models import talker as ttalker
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params
from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from test_torch_slice import _kernel_width_cfg

torch.set_num_threads(2)

ATOL = 2e-4  # the regression fixture's audio tolerance (test_regression.py)


class _Route(Exception):
    pass


def _recorder(name):
    def record(*a, **k):
        raise _Route(name)
    return record


# the JAX chain functions -> the port's route names
JAX_CHAINS = {
    "predict_subcodes_dense": "dense", "predict_subcodes_tp_resident": "tp",
    "predict_subcodes_resident": "resident", "predict_subcodes_resident_batched": "resident",
    "predict_subcodes_streamed": "streamed", "predict_subcodes_fused": "per_step",
    "predict_subcodes_fused_batched": "per_step",
}


@pytest.fixture(scope="module")
def kw():
    """The kernel-width model: JAX raw params, its int8 MTP pack, and the port's."""
    cfg = _kernel_width_cfg()
    raw = j_init(cfg, jax.random.PRNGKey(0))
    jp = j_quant(j_fuse(raw))
    jcpp = jcp.prepare_fused_step(cfg.code_predictor, jp["code_predictor"])
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = quantize_params(fuse_params(params_from_jax(flatten_params(jax.device_get(raw)))))
    tcpp = tcp.prepare_fused_step(tc.code_predictor, tp["code_predictor"])
    return cfg, raw, jp, jcpp, tc, tp, tcpp


def _jax_chain_route(monkeypatch, cp, params, B):
    for name, _ in JAX_CHAINS.items():
        monkeypatch.setattr(jcp, name, _recorder(name))
    # the cached loop's first call of its own
    monkeypatch.setattr(jcp, "_head_fn", _recorder("cached"))
    H = cp.transformer.hidden_size
    z = jnp.zeros((B, H), jnp.float32)
    try:
        jcp.predict_subcodes(cp, params, None, z, z, jax.random.PRNGKey(0),
                             lambda k, lg: jnp.argmax(lg, -1), sp=jsamp.SamplingParams.create())
    except _Route as r:
        return JAX_CHAINS.get(str(r), str(r))
    raise AssertionError("no route recorded")


@pytest.mark.parametrize("impl", ["fused", "cached", "dense"])
@pytest.mark.parametrize("head_mode", ["per_step", "shared"])
@pytest.mark.parametrize("resident,env", [(None, None), (None, "0"), (True, None), (False, None)])
@pytest.mark.parametrize("gate", ["passes", "fails", "fails, stream off"])
def test_chain_route_table_matches_jax(kw, monkeypatch, impl, head_mode, resident, env, gate):
    """For every knob of the chain's dispatch (impl, head topology, the
    resident switch from the config or QTTS_MTP_RESIDENT, the residency gate
    and QTTS_MTP_STREAM) at 1, 4 and 40 rows, the port's route is JAX's,
    apart from Queue 3's standing difference: where the resident chain is on
    the port's batched chain is K5 at any residency and any rows, where JAX
    runs its per-step batched kernel or (past 32 rows) its cached chain."""
    cfg, _, _, jcpp, tc, _, tcpp = kw
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")  # JAX's switches' TPU defaults
    stream = "0" if "off" in gate else None
    for var, val in (("QTTS_MTP_RESIDENT", env), ("QTTS_MTP_STREAM", stream)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    if gate != "passes":
        monkeypatch.setattr(jfm, "supports_resident", lambda *a, **k: False)
        monkeypatch.setattr(tcp, "supports_resident", lambda *a, **k: False)
    jc = dataclasses.replace(cfg.code_predictor, impl=impl, head_mode=head_mode,
                             resident=resident)
    tcc = dataclasses.replace(tc.code_predictor, impl=impl, head_mode=head_mode,
                              resident=resident)
    # the engines pack the trunk for impl="fused" only
    jparams = jcpp if impl == "fused" else {k: v for k, v in jcpp.items() if k != "fused_step"}
    tparams = tcpp if impl == "fused" else {k: v for k, v in tcpp.items()
                                           if k not in ("fused_step", "fused_heads")}
    for B in (1, 4, 40):
        want = _jax_chain_route(monkeypatch, jc, jparams, B)
        got = tcp.chain_route(tcc, tparams, B)
        standing = (B > 1 and got == "resident" and want in ("per_step", "cached")
                    and tcp.resident_enabled(tcc) and head_mode == "per_step")
        assert got == want or standing, (B, got, want)


@pytest.mark.parametrize("decode_impl", ["fused", "xla"])
@pytest.mark.parametrize("kvq", [False, True])
@pytest.mark.parametrize("B,uniform", [(1, True), (1, False), (4, True), (4, False)])
def test_talker_route_table_matches_jax(kw, monkeypatch, decode_impl, kvq, B, uniform):
    """The talker step on the kernels or the plain layers, the port's
    ``step_on_kernel`` against JAX's ``talker_decode_step`` dispatch at
    buckets of 256, 320 and 512 slots: the plain layers exactly where JAX's
    go, apart from Queue 3's standing difference (the port's K4 takes 2-32
    rows at a bucket off JAX's batched window, 320 slots here)."""
    cfg, _, _, _, tc, _, _ = kw
    jt = dataclasses.replace(cfg.talker, decode_impl=decode_impl, transformer=dataclasses.replace(
        cfg.talker.transformer, kv_cache_quant=kvq))
    tt = tcfg.TalkerConfig(**{**dataclasses.asdict(tc.talker), "decode_impl": decode_impl,
                              "transformer": dataclasses.replace(tc.talker.transformer,
                                                                 kv_cache_quant=kvq)})
    monkeypatch.setattr(jfs, "fused_decode_step", _recorder("kernel"))
    monkeypatch.setattr(jfs, "fused_decode_step_batched", _recorder("kernel"))
    monkeypatch.setattr(jtalker, "transformer_forward", _recorder("plain"))
    params = {"fused_step": object(), "transformer": None}
    H = jt.hidden_size
    for T in (256, 320, 512):
        cache = jlayers.init_kv_cache(jt.transformer, B, T)
        try:
            jtalker.talker_decode_step(jt, params, jnp.zeros((B, H)), jnp.zeros((B,), jnp.int32),
                                       cache, jnp.zeros((B, T), bool), uniform_fill=uniform)
        except _Route as r:
            want = str(r)
        tcache = tlayers.init_kv_cache(tt.transformer, 1, T, "meta")
        got = "kernel" if ttalker.step_on_kernel(tt, params, tcache) else "plain"
        standing = B > 1 and T == 320 and not kvq and got == "kernel"
        assert got == want or standing, (T, got, want)


def test_assert_fused_matches_jax(tiny_model, monkeypatch):
    """QTTS_ASSERT_FUSED=1: a packed talker's step at an int8 bucket the
    kernels do not take (72 slots) raises with the JAX package's message
    (its tests/test_engine.py case); unset, both decode it on the plain
    layers, the logits within 2e-4."""
    cfg, params = tiny_model
    jtt = dataclasses.replace(cfg.talker.transformer, kv_cache_quant=True)
    jt = dataclasses.replace(cfg.talker, decode_impl="fused", transformer=jtt)
    jp = dict(params["talker"], fused_step=object())
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tt = tcfg.TalkerConfig(**{**dataclasses.asdict(tc.talker), "decode_impl": "fused",
                              "transformer": dataclasses.replace(tc.talker.transformer,
                                                                 kv_cache_quant=True)})
    tp = dict(params_from_jax(flatten_params(jax.device_get(params)))["talker"],
              fused_step=object())
    H = jt.hidden_size
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((1, H)).astype(np.float32)

    def run_jax():
        return jtalker.talker_decode_step(
            jt, jp, jnp.asarray(embed), jnp.zeros((1,), jnp.int32),
            jlayers.init_kv_cache(jtt, batch=1, max_len=72), jnp.zeros((1, 72), bool))

    def run_port():
        return ttalker.talker_decode_step(
            tt, tp, torch.from_numpy(embed), torch.zeros(1, dtype=torch.long),
            tlayers.init_kv_cache(tt.transformer, 1, 72, "cpu"), torch.zeros(1, 72, dtype=bool))

    monkeypatch.setenv("QTTS_ASSERT_FUSED", "1")
    with pytest.raises(RuntimeError, match="QTTS_ASSERT_FUSED") as want:
        run_jax()
    with pytest.raises(RuntimeError, match="QTTS_ASSERT_FUSED") as got:
        run_port()
    assert str(got.value) == str(want.value)
    monkeypatch.delenv("QTTS_ASSERT_FUSED")
    np.testing.assert_allclose(run_port()[0].numpy(), np.asarray(run_jax()[0]), atol=2e-4,
                               rtol=2e-4)


def test_plain_fall_logged_once_on_card(caplog, monkeypatch):
    """A standing difference from the JAX package (ROADMAP Queue 3): on the
    card a packed talker's step or verify pass that falls to the plain
    layers logs a warning, once per (pass, bucket, cache type), where JAX
    falls silently unless QTTS_ASSERT_FUSED is set; on the CPU it stays
    silent."""
    monkeypatch.setattr(ttalker, "_FALLS_LOGGED", set())
    with caplog.at_level("WARNING", logger="leaxer_qwen3_tts_torch"):
        ttalker._log_plain_fall("decode step", 72, True, on_card=False)
        assert not caplog.records
        for _ in range(2):
            ttalker._log_plain_fall("decode step", 72, True, on_card=True)
        ttalker._log_plain_fall("verify pass", 72, True, on_card=True)
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 2, msgs
    assert "decode step at a 72-slot bucket" in msgs[0] and "QTTS_ASSERT_FUSED=1" in msgs[0]
    assert "verify pass" in msgs[1]


@pytest.mark.parametrize("knob", [
    {}, {"decode_impl": "xla"}, {"impl": "cached"}, {"impl": "dense"}, {"head_mode": "shared"},
    {"resident": False}, {"stream": "0"},
])
def test_card_gate_takes_every_route(monkeypatch, knob):
    """On the card every knob of the 1.7B preset is past the engine's gate,
    decided before any tensor moves (an engine of (config, params={}) then
    stops at the params)."""
    monkeypatch.delenv("QTTS_MTP_RESIDENT", raising=False)
    monkeypatch.delenv("QTTS_MTP_STREAM", raising=False)
    if "stream" in knob:
        monkeypatch.setenv("QTTS_MTP_STREAM", knob["stream"])
    cfg = tcfg.QWEN3_TTS_17B
    t = dataclasses.replace(cfg.talker, decode_impl=knob.get("decode_impl", "fused"))
    cp = dataclasses.replace(cfg.code_predictor, impl=knob.get("impl", "fused"),
                             head_mode=knob.get("head_mode", "per_step"),
                             resident=knob.get("resident"))
    eng = TTSEngine(config=dataclasses.replace(cfg, talker=t, code_predictor=cp), params={},
                    quantize="int8", device="cuda")
    assert not eng.is_ready() and eng.get_error().strip("'") in ("code_predictor", "talker")


def test_card_gate_refuses_the_step_kernels_reach():
    """An architecture that JAX's unit gate takes and the step kernels do not
    (head_dim 64) is refused on the card where it is packed (ROADMAP K1a);
    unpacked (``decode_impl="xla"``, ``impl="cached"``), as JAX leaves it, it
    passes; an architecture JAX's gate refuses decodes unpacked there too."""
    cfg = tcfg.QWEN3_TTS_06B
    wide = dataclasses.replace(cfg.talker.transformer, num_heads=16, num_kv_heads=8, head_dim=64)
    t = dataclasses.replace(cfg.talker, transformer=wide)
    eng = TTSEngine(config=dataclasses.replace(cfg, talker=t), params={}, device="cuda")
    assert "K1a" in eng.get_error() and "talker" in eng.get_error()
    plain = dataclasses.replace(cfg, talker=dataclasses.replace(t, decode_impl="xla"))
    eng = TTSEngine(config=plain, params={}, device="cuda")
    assert "CUDA kernel path" not in eng.get_error()
    odd = dataclasses.replace(cfg.talker.transformer, intermediate_size=1536)  # 1536 % 1024
    eng = TTSEngine(config=dataclasses.replace(cfg, talker=dataclasses.replace(
        cfg.talker, transformer=odd)), params={}, device="cuda")
    assert "CUDA kernel path" not in eng.get_error()


def test_default_impls_engine_matches_jax(tiny_vocab_files):
    """The kernel-width model at the JAX package's default implementations
    (decode_impl="xla", impl="cached"), int8: greedy codes of ``synthesize``
    and ``synthesize_batch`` equal the JAX engine's (on the CPU the JAX
    engine packs nothing either), the audio within the fixture's tolerance."""
    cfg = _kernel_width_cfg()
    # the vocoder takes the model's 1 + num_steps codebooks
    jcfg_ = dataclasses.replace(cfg, talker=dataclasses.replace(cfg.talker, decode_impl="xla"),
                                code_predictor=dataclasses.replace(cfg.code_predictor,
                                                                   impl="cached"),
                                vocoder=dataclasses.replace(
                                    cfg.vocoder, num_codebooks=cfg.code_predictor.num_steps + 1))
    raw = j_init(jcfg_, jax.random.PRNGKey(0))
    tcfg_ = tcfg.TTSModelConfig.from_json(jcfg_.to_json())
    vocab_path, merges_path, _ = tiny_vocab_files
    jeng = JEngine(config=jcfg_, params=raw, tokenizer=JTokenizer(vocab_path, merges_path),
                   quantize="int8", max_frames=6, chunk_len=3)
    teng = TTSEngine(config=tcfg_, params=params_from_jax(flatten_params(jax.device_get(raw))),
                     tokenizer=Tokenizer(vocab_path, merges_path), quantize="int8",
                     max_frames=6, chunk_len=3, device="cpu")
    assert "fused_step" not in teng.params["talker"]
    assert "fused_step" not in teng.params["code_predictor"]
    want = jeng.synthesize("hello world", temperature=0.0, max_tokens=6)
    got = teng.synthesize("hello world", temperature=0.0, max_tokens=6)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_allclose(got.audio, want.audio, atol=ATOL)
    for g, w in zip(teng.synthesize_batch(["hello", "hello world"], temperature=0.0, max_tokens=4),
                    jeng.synthesize_batch(["hello", "hello world"], temperature=0.0, max_tokens=4)):
        np.testing.assert_array_equal(g.codes, w.codes)


@pytest.mark.parametrize("head_mode", ["per_step", "shared"])
def test_dense_chain_matches_jax(head_mode):
    """``impl="dense"``: the cache-free chain against JAX
    ``predict_subcodes_dense`` on the tiny trunk (float32), greedy: codes
    exact, the sum within 1e-5."""
    from conftest_util import build_tiny_cfg

    base = build_tiny_cfg()
    cfg = dataclasses.replace(base, code_predictor=dataclasses.replace(
        base.code_predictor, impl="dense", head_mode=head_mode))
    raw = j_init(cfg, jax.random.PRNGKey(4), with_speaker_encoder=False)
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = params_from_jax(flatten_params(jax.device_get(raw)))
    cp = cfg.code_predictor
    H = cp.transformer.hidden_size
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, H)).astype(np.float32)
    c0e = (0.1 * rng.standard_normal((3, H))).astype(np.float32)
    j_subs, j_sum = jcp.predict_subcodes(
        cp, raw["code_predictor"], raw["embeddings"]["pred_embed"], jnp.asarray(hidden),
        jnp.asarray(c0e), jax.random.PRNGKey(0), lambda k, lg: jnp.argmax(lg, -1))
    assert tcp.chain_route(tc.code_predictor, tp["code_predictor"], 3) == "dense"
    t_subs, t_sum = tcp.predict_subcodes(
        tc.code_predictor, tp["code_predictor"], tp["embeddings"]["pred_embed"],
        torch.from_numpy(hidden), torch.from_numpy(c0e), lambda lg, j: lg.argmax(-1),
        sp=SamplingParams.create(0.0))
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), atol=1e-5, rtol=1e-5)


def test_prefill_all_logits_matches_jax(tiny_model):
    """M4: the logits of every prompt position (and the hidden states, the
    cache and the valid mask) against JAX ``talker_prefill_all_logits``,
    within 1e-4; its last real position's logits are ``talker_prefill``'s."""
    cfg, params = tiny_model
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = params_from_jax(flatten_params(jax.device_get(params)))
    H = cfg.talker.hidden_size
    rng = np.random.default_rng(5)
    emb = (0.1 * rng.standard_normal((2, 7, H))).astype(np.float32)
    lens = np.array([7, 5], np.int32)
    jl, jh, jc, jv = jtalker.talker_prefill_all_logits(
        cfg.talker, params["talker"], jnp.asarray(emb), jnp.asarray(lens),
        jtalker.talker_init_cache(cfg.talker, 2, 16))
    cache = ttalker.talker_init_cache(tc.talker, 2, 16, "cpu")
    tl, th, tcache, tv = ttalker.talker_prefill_all_logits(
        tc.talker, tp["talker"], torch.from_numpy(emb), torch.from_numpy(lens).long(), cache)
    assert tl.shape == (2, 7, cfg.talker.codec_vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    last, _, _, _ = ttalker.talker_prefill(tc.talker, tp["talker"], torch.from_numpy(emb),
                                           torch.from_numpy(lens).long(),
                                           ttalker.talker_init_cache(tc.talker, 2, 16, "cpu"))
    rows = torch.arange(2)
    np.testing.assert_allclose(last.numpy(), tl[rows, torch.from_numpy(lens).long() - 1].numpy(),
                               atol=1e-5, rtol=1e-5)
