"""bf16 weight units (the unquantized config, ``quantize=None``: the JAX
package's bits=16 pack, raw weights cast to bf16 with scales of one) in the
port: the pack against the JAX pack; the plain versions of K1, K4, K3 and K5
on bf16 packs against the JAX kernels in interpret mode on the same packs
and seed-made inputs; the kernel-width generate loop at bits=16 against
the JAX loop (both chains streamed, ``QTTS_MTP_STREAM=1``); and the engine's
``quantize=None``: the packs it builds, the route, and what it refuses on
the card, each error naming its ROADMAP item."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.models.code_predictor import init_code_predictor_params
from leaxer_qwen3_tts_tpu.models.code_predictor import prepare_fused_step as j_prep_cp
from leaxer_qwen3_tts_tpu.models.layers import init_transformer_params
from leaxer_qwen3_tts_tpu.ops import fused_mtp as j_fm
from leaxer_qwen3_tts_tpu.ops import fused_mtp_stream as j_stream
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.ops import fused_mtp as tfm
from leaxer_qwen3_tts_torch.ops import fused_mtp_stream as tstream
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.ops import quant as tquant
from leaxer_qwen3_tts_torch.parallel import make_mesh
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

# x_out and the caches agree to 1e-3: both sides round the same operands to
# bf16 and accumulate in float32, in different orders (test_torch_fused_step.py)
TOL = dict(atol=1e-3, rtol=1e-3)
SUM_ABS = 1e-5  # sub_sum of one chain: sums of the same table rows in the same order
L, NK, D, H = 2, 4, 128, 1024
N, V = 3, 256  # chain steps and sub-code vocabulary (the JAX streamed chain's test shapes)
KNOBS = ((0.0, 50, 0.9), (0.8, 50, 0.95), (1.0, 0, 0.5))  # greedy, then two sampled sets


def _trunk_cfg(dtype="float32", I=3072):
    return jcfg.TransformerConfig(hidden_size=H, num_layers=L, num_heads=8, num_kv_heads=NK,
                                  head_dim=D, intermediate_size=I, dtype=dtype)


def _port_cfg(t):
    return tcfg.TransformerConfig(**{f: getattr(t, f) for f in t.__dataclass_fields__})


@pytest.fixture(scope="module")
def packs():
    """The bits=16 packs of one random two-layer trunk, JAX's and the port's."""
    t = _trunk_cfg()
    params = init_transformer_params(t, jax.random.PRNGKey(0))
    jfw = jfs.pack_fused_weights(t, params["layers"], bits=16)
    layers = params_from_jax(flatten_params(jax.device_get(params["layers"])))
    tt = _port_cfg(t)
    return t, jfw, tt, tfs.pack_fused_weights(tt, layers, bits=16), layers


def test_bf16_pack_matches_jax(packs):
    """bf16 rows of the raw weights with float32 scales of one: the JAX
    units' values, column for column; a quantized input raises at bits=16,
    as JAX's does, and so does one at bits=4 (test_torch_int4.py)."""
    t, jfw, tt, tfw, layers = packs
    assert jfw.units.dtype == jnp.bfloat16 and bool((np.asarray(jfw.scales) == 1.0).all())
    for w in (tfw.wqkv, tfw.wo, tfw.wgu, tfw.wd):
        assert w.dtype == torch.bfloat16 and w.is_contiguous()
    for s in (tfw.sqkv, tfw.so, tfw.sgu, tfw.sd):
        assert s.dtype == torch.float32 and bool((s == 1.0).all())
    wqkv = torch.cat([layers["wq"], layers["wk"], layers["wv"]], -1)
    assert torch.equal(tfw.wqkv, wqkv.to(torch.bfloat16).transpose(1, 2))
    assert torch.equal(tfw.wd, layers["wd"].to(torch.bfloat16).transpose(1, 2))
    # the JAX qkv units side by side are the same [L, H, A] bf16 matrix
    A = tfw.wqkv.shape[1]
    units = np.asarray(jfw.units[:, : A // 1024].astype(jnp.float32))
    np.testing.assert_array_equal(np.concatenate(list(units.transpose(1, 0, 2, 3)), -1),
                                  tfw.wqkv.float().transpose(1, 2).numpy())
    quantized = tquant.quantize_params(tquant.fuse_params({"m": {"transformer": {
        "layers": layers}}}, modules=("m",)), modules=("m",))["m"]["transformer"]["layers"]
    with pytest.raises(ValueError, match="raw weights"):
        tfs.pack_fused_weights(tt, quantized, bits=16)
    jq = j_quant(j_fuse({"talker": {"transformer": init_transformer_params(
        t, jax.random.PRNGKey(0))}}))["talker"]["transformer"]["layers"]
    with pytest.raises(ValueError, match="raw weights"):  # JAX's pack refuses it too
        jfs.pack_fused_weights(t, jq, bits=16)
    with pytest.raises(ValueError, match="raw weights"):
        tfs.pack_fused_weights(tt, quantized, bits=4)


@pytest.mark.parametrize("T,mode,pos,cache", [
    (64, None, 37, "bfloat16"),  # manual vmem kernel, bf16 cache
    (1024, "hbm", 300, "float32"),  # whole-cache DMA mode
])
def test_k1_bits16_matches_jax(packs, T, mode, pos, cache):
    """K1's plain version on the bf16 pack against JAX ``fused_decode_step``
    on its bits=16 pack (interpret mode), as test_torch_fused_step.py holds
    the int8 packs: untouched slots bit for bit, x and the caches within
    TOL (float32 cache), the written slot within 2 bf16 ulps and x within
    1e-2 (bf16 cache: a flipped rounding moves the next layer)."""
    t, jfw, tt, tfw, _ = packs
    rng = np.random.default_rng(T + pos + 16)
    x = (rng.standard_normal((1, H)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((L, 1, NK, T, D)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((L, 1, NK, T, D)) * 0.2).astype(np.float32)
    kc[:, :, :, pos:] = 0.0
    vc[:, :, :, pos:] = 0.0
    jdt = jnp.bfloat16 if cache == "bfloat16" else jnp.float32
    kwargs = {} if mode is None else {"mode": mode}
    jx, jk, jv = jfs.fused_decode_step(t, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                       jnp.asarray(kc).astype(jdt), jnp.asarray(vc).astype(jdt),
                                       interpret=True, **kwargs)
    tdt = tcfg.torch_dtype(cache)
    tk, tv = torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt)
    tx, _, _ = tfs.fused_decode_step(tt, tfw, torch.from_numpy(x), pos, tk, tv)
    jk = np.asarray(jk.astype(jnp.float32))
    jv = np.asarray(jv.astype(jnp.float32))
    tk, tv = tk.float().numpy(), tv.float().numpy()
    others = np.arange(T) != pos
    np.testing.assert_array_equal(tk[:, :, :, others], jk[:, :, :, others])
    np.testing.assert_array_equal(tv[:, :, :, others], jv[:, :, :, others])
    if cache == "float32":
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        np.testing.assert_allclose(tk, jk, **TOL)
        np.testing.assert_allclose(tv, jv, **TOL)
    else:
        np.testing.assert_allclose(tk[:, :, :, pos], jk[:, :, :, pos], atol=1.6e-2)
        np.testing.assert_allclose(tv[:, :, :, pos], jv[:, :, :, pos], atol=1.6e-2)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-2)


def test_k4_bits16_matches_jax(packs):
    """K4's plain version on the bf16 pack against JAX
    ``fused_decode_step_batched`` on its bits=16 pack, streams at their own
    positions (one past the bucket), within TOL; row b equals the B=1 plain
    step on row b bit for bit."""
    t, jfw, tt, tfw, _ = packs
    T, pos = 256, [0, 130, 255, 300]
    B = len(pos)
    rng = np.random.default_rng(44)
    x = (rng.standard_normal((B, H)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((L, B, NK, T, D)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((L, B, NK, T, D)) * 0.2).astype(np.float32)
    for b, p in enumerate(pos):
        kc[:, b, :, min(p, T - 1):] = 0.0
        vc[:, b, :, min(p, T - 1):] = 0.0
    jx, jk, jv = jfs.fused_decode_step_batched(
        t, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jnp.asarray(kc), jnp.asarray(vc),
        interpret=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tx, _, _ = tfs.fused_decode_step_batched(tt, tfw, torch.from_numpy(x), torch.tensor(pos),
                                             tk, tv)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    for b, p in enumerate(pos):
        k1 = torch.from_numpy(kc[:, b : b + 1].copy())
        v1 = torch.from_numpy(vc[:, b : b + 1].copy())
        x1, _, _ = tfs.fused_decode_step(tt, tfw, torch.from_numpy(x[b : b + 1]), p, k1, v1)
        assert torch.equal(x1[0], tx[b]) and torch.equal(k1[:, 0], tk[:, b])


@pytest.fixture(scope="module")
def chains():
    """A two-layer MTP trunk packed at bits=16 on both sides (raw heads: the
    JAX chains cast them to bf16, the port's ``pack_heads`` makes bf16 rows
    with unit scales), with seed-made tables."""
    cfg = jcfg.CodePredictorConfig(transformer=_trunk_cfg(), num_steps=N, subcode_vocab_size=V,
                                   max_seq_len=N + 2, impl="fused")
    raw = init_code_predictor_params(cfg, jax.random.PRNGKey(0))
    jq = j_prep_cp(cfg, j_fuse({"code_predictor": raw})["code_predictor"], bits=16)
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = tcfg.TransformerConfig(**fields["transformer"])
    tc = tcfg.CodePredictorConfig(**fields)
    traw = params_from_jax(flatten_params({"code_predictor": jax.device_get(raw)}))
    tq = tcp.prepare_fused_step(tc, tquant.fuse_params(traw)["code_predictor"], bits=16)
    rng = np.random.default_rng(0)
    tables = (rng.standard_normal((N, V, H)) * 0.02).astype(np.float32)
    return cfg, jq, tc, tq, tables


def _chain_inputs(B, seed):
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0e = (rng.standard_normal((B, H)) * 0.02).astype(np.float32)
    return hidden, c0e, rng.gumbel(size=(N, B, V)).astype(np.float32)


def test_bf16_heads_pack(chains):
    """Raw [n, H, V] heads -> bf16 [n, V, H] rows with float32 scales of one;
    the B=1 route of a bf16 trunk is K3 (JAX's residency gate refuses bf16
    packs), and the batched route stays K5."""
    _, jq, tc, tq, _ = chains
    heads = tq["fused_heads"]
    assert heads.q.dtype == torch.bfloat16 and heads.q.shape == (N, V, H)
    assert heads.scale.dtype == torch.float32 and bool((heads.scale == 1.0).all())
    want = np.asarray(jnp.asarray(jq["heads"]).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(heads.q.float().transpose(1, 2).numpy(), want)
    assert not tfm.supports_resident(tq["fused_step"])
    assert not j_fm.supports_resident(jq["fused_step"])
    assert tcp.chain_kernel(tc, tq, 1) is tstream.fused_mtp_chain_streamed
    assert tcp.chain_kernel(tc, tq, 4) is tfm.fused_mtp_chain_batched


@pytest.mark.parametrize("knobs", KNOBS)
def test_k3_bits16_matches_jax(chains, knobs):
    """K3's plain version on the bf16 trunk and heads against JAX
    ``fused_mtp_chain_streamed`` on its bits=16 pack with raw heads, greedy
    and sampled on the same noise: sub-codes equal, sub_sum within SUM_ABS."""
    cfg, jq, tc, tq, tables = chains
    hidden, c0e, gumbel = _chain_inputs(1, 7)
    temp, top_k, top_p = knobs
    j_subs, j_sum = j_stream.fused_mtp_chain_streamed(
        cfg.transformer, jq["fused_step"], jq["transformer"]["final_norm"], jq["heads"],
        jnp.asarray(tables), jnp.asarray(hidden), jnp.asarray(c0e), jnp.asarray(gumbel),
        jnp.float32(temp), jnp.int32(top_k), jnp.float32(top_p), interpret=True)
    t_subs, t_sum = tstream.fused_mtp_chain_streamed(
        tc.transformer, tq["fused_step"], tq["transformer"]["final_norm"], tq["fused_heads"],
        torch.from_numpy(tables), torch.from_numpy(hidden), torch.from_numpy(c0e),
        torch.from_numpy(gumbel), temp, top_k, top_p)
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), atol=SUM_ABS, rtol=0)


def test_k5_bits16_matches_jax(chains):
    """K5's plain version on the bf16 trunk and heads (float32 cache, K3's)
    against JAX ``fused_mtp_chain_batched`` on its bits=16 pack with raw
    heads (float32 cache, its default), per-row knobs on the same noise:
    sub-codes equal, sub_sum within 1e-3 (test_torch_fused_mtp_batched.py);
    and row b equals K3's plain version on row b's inputs and noise, bit for
    bit."""
    cfg, jq, tc, tq, tables = chains
    knobs = KNOBS + ((0.7, 1, 0.9),)
    B = len(knobs)
    hidden, c0e, gumbel = _chain_inputs(B, 11)
    temps, ks, ps = zip(*knobs)
    j_subs, j_sum = j_fm.fused_mtp_chain_batched(
        cfg.transformer, jq["fused_step"], jq["transformer"]["final_norm"], jq["heads"],
        jnp.asarray(tables), jnp.asarray(hidden), jnp.asarray(c0e), jnp.asarray(gumbel),
        jnp.asarray(temps, jnp.float32), jnp.asarray(ks, jnp.int32),
        jnp.asarray(ps, jnp.float32), interpret=True)
    args = (tc.transformer, tq["fused_step"], tq["transformer"]["final_norm"], tq["fused_heads"],
            torch.from_numpy(tables))
    t_subs, t_sum = tfm.fused_mtp_chain_batched(
        *args, torch.from_numpy(hidden), torch.from_numpy(c0e), torch.from_numpy(gumbel), temps,
        ks, ps, cache_dtype=torch.float32)
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), atol=1e-3, rtol=1e-3)
    for b, (t, k, p) in enumerate(knobs):
        s1, sum1 = tstream.fused_mtp_chain_streamed(
            *args, torch.from_numpy(hidden[b : b + 1]), torch.from_numpy(c0e[b : b + 1]),
            torch.from_numpy(gumbel[:, b : b + 1]), t, k, p)
        assert torch.equal(s1[0], t_subs[b]) and torch.equal(sum1[0], t_sum[b])


def test_kernel_width_generate_bits16_matches_jax(monkeypatch):
    """test_torch_slice's kernel-width generate loop on bits=16 packs
    (``fuse_params``, no ``quantize_params``: the JAX engine's
    ``quantize=None`` order) with the streamed chain on for both sides: the
    JAX loop runs its talker step and its streamed chain as Pallas kernels
    in interpret mode, the port K1's and K3's plain versions; greedy frames
    over 2 decode chunks are equal."""
    from test_torch_slice import _kernel_width_cfg

    from leaxer_qwen3_tts_tpu.models.talker import prepare_fused_talker as j_prep_talker
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns as j_make
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init
    from leaxer_qwen3_tts_torch.models.talker import prepare_fused_talker
    from leaxer_qwen3_tts_torch.ops.quant import fuse_params
    from leaxer_qwen3_tts_torch.runtime.generate import make_generate_fns
    from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams

    monkeypatch.setenv("QTTS_MTP_STREAM", "1")
    monkeypatch.delenv("QTTS_MTP_RESIDENT", raising=False)
    monkeypatch.delenv("QTTS_FRAME_FUSED", raising=False)
    cfg = _kernel_width_cfg()
    raw = j_init(cfg, jax.random.PRNGKey(0))
    jp = j_fuse(raw)
    jp["code_predictor"] = j_prep_cp(cfg.code_predictor, jp["code_predictor"], bits=16)
    jp["talker"] = j_prep_talker(cfg.talker, jp["talker"], bits=16)
    assert jp["talker"]["fused_step"].units.dtype == jnp.bfloat16

    ids = np.array([[5, 6, 7, 8]], np.int32)
    lens = np.array([4], np.int32)
    jfns = j_make(cfg, batch=1, max_len=64, chunk_len=2, donate=False)
    st, bd = jfns.prefill(jp, jnp.asarray(ids), jnp.asarray(lens), jax.random.PRNGKey(1))
    jframes = []
    for _ in range(2):
        st, fr, _ = jfns.decode(jp, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed,
                                JSP.create(temperature=0.0))
        jframes.append(np.asarray(fr))

    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = fuse_params(params_from_jax(flatten_params(jax.device_get(raw))))
    tp["code_predictor"] = tcp.prepare_fused_step(tc.code_predictor, tp["code_predictor"],
                                                  bits=16)
    tp["talker"] = prepare_fused_talker(tc.talker, tp["talker"], bits=16)
    assert tcp.chain_kernel(tc.code_predictor, tp["code_predictor"], 1) is (
        tstream.fused_mtp_chain_streamed)
    calls = []
    real = tcp.fused_mtp_chain_streamed
    monkeypatch.setattr(tcp, "fused_mtp_chain_streamed",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    tfns = make_generate_fns(tc, batch=1, max_len=64, chunk_len=2)
    state, bundle = tfns.prefill(tp, torch.from_numpy(ids).long(), torch.from_numpy(lens))
    tframes = []
    for _ in range(2):
        state, fr, _ = tfns.decode(tp, state, bundle.trailing, bundle.trailing_len,
                                   bundle.tts_pad_embed, SamplingParams.create(0.0))
        tframes.append(fr.numpy())
    assert len(calls) == 4  # one K3 chain per decoded frame
    np.testing.assert_array_equal(np.concatenate(tframes, 1), np.concatenate(jframes, 1))


def _kernel_width_engine_cfg():
    from test_torch_slice import _kernel_width_cfg

    return tcfg.TTSModelConfig.from_json(_kernel_width_cfg().to_json())


def test_engine_quantize_none_packs_bf16(tiny_vocab_files, monkeypatch):
    """``quantize=None`` builds bits=16 packs on the CPU as on the card (no
    ``quantize_params``; the raw lm_head stays, so K7 is not taken): one K1
    and one K3 plain call per decoded frame, also with ``frame_fused=True``
    (JAX's frame gate refuses bf16 trunks), and the batched chain on K3's
    float32 cache."""
    from leaxer_qwen3_tts_torch.frontend import Tokenizer
    from leaxer_qwen3_tts_torch.runtime.weights import init_params

    monkeypatch.delenv("QTTS_MTP_STREAM", raising=False)
    monkeypatch.delenv("QTTS_MTP_RESIDENT", raising=False)
    tc = _kernel_width_engine_cfg()
    vocab_path, merges_path, _ = tiny_vocab_files
    params = init_params(tc, seed=0)
    kw = dict(params=params, tokenizer=Tokenizer(vocab_path, merges_path), device="cpu",
              max_frames=4, chunk_len=2)
    eng = TTSEngine(config=tc, **kw)
    assert eng.is_ready(), eng.get_error()
    for m in ("talker", "code_predictor"):
        assert eng.params[m]["fused_step"].wqkv.dtype == torch.bfloat16
    assert eng.params["code_predictor"]["fused_heads"].q.dtype == torch.bfloat16
    assert eng.params["talker"]["fused_lm_head"].q.dtype == torch.bfloat16  # K7's raw lm_head
    assert not isinstance(eng.params["talker"]["lm_head"], tquant.QuantizedLinear)
    k1, k3, caches = [], [], []
    real_k1, real_k3, real_k5 = (tfs.fused_decode_step, tcp.fused_mtp_chain_streamed,
                                 tcp.fused_mtp_chain_batched)
    import leaxer_qwen3_tts_torch.models.talker as ttalker

    monkeypatch.setattr(ttalker, "fused_decode_step",
                        lambda *a, **k: (k1.append(1), real_k1(*a, **k))[1])
    monkeypatch.setattr(tcp, "fused_mtp_chain_streamed",
                        lambda *a, **k: (k3.append(1), real_k3(*a, **k))[1])
    monkeypatch.setattr(tcp, "fused_mtp_chain_batched",
                        lambda *a, **k: (caches.append(k["cache_dtype"]), real_k5(*a, **k))[1])
    r = eng.synthesize("hello", temperature=0.0, max_tokens=4)
    assert len(k1) == len(k3) == r.metrics.decoded_frames > 0
    ff = TTSEngine(config=tc, frame_fused=True, **kw)
    k1.clear()
    k3.clear()
    f = ff.synthesize("hello", temperature=0.0, max_tokens=4)
    assert f.metrics.frame_fused_frames == 0 and len(k1) == len(k3) == f.metrics.decoded_frames
    np.testing.assert_array_equal(f.codes, r.codes)
    eng.synthesize_batch(["hello", "hello world"], temperature=0.0, max_tokens=2)
    assert caches and set(caches) == {torch.float32}


def test_quantize_none_refusals_on_the_card(monkeypatch):
    """On the card ``quantize=None`` is ready in itself (decided before any
    tensor moves), with spec_k (K6 at bf16 units), with an ``mtp_quantize``
    of another precision (int8 or int4 trunks with bf16 heads in K2 / K3 /
    K5), with both, and at the 1.7B widths (B17: the batched plans take 48
    KB slots), and with the streamed chain off (F4: the per-step chain, one
    K1 step per chain position, now runs on the card, so that engine too
    stops only at the params), and on a mesh with a data axis (M15 done: its
    batches take the plain step and the cached chain); on the CPU spec_k
    runs the plain versions."""
    monkeypatch.delenv("QTTS_MTP_STREAM", raising=False)
    monkeypatch.delenv("QTTS_MTP_RESIDENT", raising=False)
    cfg = tcfg.QWEN3_TTS_06B
    spec = TTSEngine(config=cfg, params={}, spec_k=4, device="cuda")
    assert "ROADMAP" not in spec.get_error() and "code_predictor" in spec.get_error()
    mix = TTSEngine(config=cfg, params={}, mtp_quantize="int8", device="cuda")
    assert "ROADMAP" not in mix.get_error() and "code_predictor" in mix.get_error()
    mix_spec = TTSEngine(config=cfg, params={}, mtp_quantize="int8", spec_k=4, device="cuda")
    assert "ROADMAP" not in mix_spec.get_error() and "code_predictor" in mix_spec.get_error()
    spec17 = TTSEngine(config=tcfg.QWEN3_TTS_17B, params={}, spec_k=4, device="cuda")
    assert "ROADMAP" not in spec17.get_error() and "code_predictor" in spec17.get_error()
    monkeypatch.setenv("QTTS_MTP_STREAM", "0")
    off = TTSEngine(config=cfg, params={}, device="cuda")
    assert not off.is_ready() and "CUDA kernel path" not in off.get_error()
    assert "code_predictor" in off.get_error()
    assert "need model_dir" in TTSEngine(config=cfg, params=None, device="cuda").get_error()
    monkeypatch.delenv("QTTS_MTP_STREAM")
    # past the checks an engine of (config, params={}) stops only at the params
    ready = TTSEngine(config=cfg, params={}, device="cuda")
    assert "K1v" not in ready.get_error() and "int8" not in ready.get_error()
    for preset in (tcfg.QWEN3_TTS_06B, tcfg.QWEN3_TTS_17B):
        for t in (preset.talker.transformer, preset.code_predictor.transformer):
            plan = persistent.make_plan(t, 132, batch=32, unit_bytes=2)
            assert plan.n_slots >= persistent.MIN_SLOTS
        cards = [torch.device("cuda", 0)] * 4
        meshed = TTSEngine(config=preset, params={}, mesh=make_mesh(2, 2, devices=cards))
        assert "ROADMAP" not in meshed.get_error() and "talker" in meshed.get_error()


def test_cpu_quantize_none_spec_runs(tiny_vocab_files):
    """On the CPU ``quantize=None`` with spec_k is ready (the plain
    versions take bf16 packs); the card's refusal is the kernel's."""
    from leaxer_qwen3_tts_torch.frontend import Tokenizer
    from leaxer_qwen3_tts_torch.runtime.weights import init_params

    tc = _kernel_width_engine_cfg()
    vocab_path, merges_path, _ = tiny_vocab_files
    eng = TTSEngine(config=tc, params=init_params(tc, seed=0), spec_k=2, device="cpu",
                    tokenizer=Tokenizer(vocab_path, merges_path), max_frames=4, chunk_len=2)
    assert eng.is_ready(), eng.get_error()
    r = eng.synthesize("hello", temperature=0.0, max_tokens=3)
    assert r.codes.shape[1] == 1 + tc.code_predictor.num_steps and np.isfinite(r.audio).all()

