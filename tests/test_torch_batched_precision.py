"""Every weight precision in the batched kernels (K4, K5, K6) of the port, on
the CPU, against the JAX package: K4's and K6's plain versions on int4 units
against JAX ``fused_decode_step_batched`` / ``fused_verify_step`` on its
bits=4 pack (interpret mode) on float32 and int8 caches; K5's plain version
on an int4 trunk with int8 heads and on int8 / int4 trunks with bf16 heads
against JAX ``fused_mtp_chain_batched`` under shared noise; the batched
generate loop at kernel widths under ``quantize="int4"`` and under an unset
``quantize`` with ``mtp_quantize="auto"`` (K5 on the int4 alt trunk that
JAX's ``resident_pack`` takes) against the JAX loop; the tiny engines'
``synthesize_batch`` and pool at those settings against the JAX engine; the
1.7B bf16 batched plans (B17); K5 on K3's float32 cache where the B=1 chain
is K3; and the M12b refusals.

The JAX unit pack takes hidden sizes that are multiples of its 1024-wide
units, so the kernel tests run at H = 1024 (eight 128-column int4 groups a
row) with two layers."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.models import code_predictor as jcp
from leaxer_qwen3_tts_tpu.models import layers as jlayers
from leaxer_qwen3_tts_tpu.ops import fused_mtp as j_fm
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.ops.fused_verify import fused_verify_step as j_verify
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.ops import fused_mtp as tfm
from leaxer_qwen3_tts_torch.ops import fused_mtp_stream as tstream
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import fused_verify as tfv
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.ops import quant as tquant
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.serve import ContinuousBatcher

torch.set_num_threads(2)

# The int4 step against the JAX kernel: both round the same operands to
# bf16 and sum in float32 in other orders (the JAX kernel adds each group's
# low- and high-half dots in pairs, the plain version each group in column
# order; test_torch_int4.py holds one row within 1e-3).
X_TOL = dict(atol=1e-2, rtol=1e-2)
# A batched step's rows (streams, candidates) against the JAX kernel: a
# last-bit difference that moves a GEMV input across a bf16 rounding edge in
# layer 1 reaches x at ~1e-3 of its max (a flip: measured 5e-4 to 3.3e-3
# relative in most rows of four seeds at four rows and two layers, the
# other rows 1e-7 to 6e-5), so x is held to X_TOL, the int8-cache bound of
# test_torch_int4.py and test_torch_fused_verify.py's; a written slot within
# SLOT_ATOL (test_torch_mixed_precision.py's K6 bound), every other slot bit
# for bit.  Faults in the units (a scale, a nibble) move x by O(1).
SLOT_ATOL = 1.6e-2
# K5 against the JAX batched chain: sub-codes equal, sub_sum within 1e-3
# (test_torch_fused_mtp_batched.py: the trunks' x reach the sums through the
# same table rows; the bound covers the float32 order of the two kernels)
SUM_TOL = dict(atol=1e-3, rtol=1e-3)
ATOL = 2e-4  # the regression fixture's audio tolerance (test_regression.py)
L, NK, D, H = 2, 4, 128, 1024
N, V = 3, 256  # chain steps and sub-code vocabulary
KNOBS = ((0.0, 50, 0.9), (0.8, 50, 0.95), (1.0, 0, 0.5))


def _to_torch(tree):
    return params_from_jax(flatten_params(jax.device_get(tree)))


def _trunk_cfg(kvq=False, I=2048):
    return jcfg.TransformerConfig(hidden_size=H, num_layers=L, num_heads=8, num_kv_heads=NK,
                                  head_dim=D, intermediate_size=I, dtype="float32",
                                  kv_cache_quant=kvq)


def _port_cfg(t):
    return tcfg.TransformerConfig(**dataclasses.asdict(t))


@pytest.fixture(scope="module")
def packs():
    """The bits=4 packs of one random two-layer trunk, JAX's and the port's,
    from the same raw weights (the engines pack int4 from raw weights)."""
    t = _trunk_cfg()
    params = jlayers.init_transformer_params(t, jax.random.PRNGKey(0))
    jfw = jfs.pack_fused_weights(t, params["layers"], bits=4)
    tt = _port_cfg(t)
    return t, jfw, tt, tfs.pack_fused_weights(tt, _to_torch(params["layers"]), bits=4)


def _caches(B, T, filled, seed):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((2, L, B, NK, T, D)) * 0.2).astype(np.float32)
    for b, p in enumerate(filled):
        kv[:, :, b, :, min(p, T):] = 0.0
    return kv


def _quantized(kv):
    q, s = jlayers.quantize_kv(jnp.asarray(kv))
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_k4_int4_matches_jax(packs, cache):
    """K4's plain version on the int4 pack against JAX
    ``fused_decode_step_batched`` on its bits=4 pack, four streams at their
    own positions (one past the bucket, clamped): x within X_TOL, the
    written slots within SLOT_ATOL on a float32
    cache and within one grid step on an int8 cache, every other slot and
    scale bit for bit; row b equals the B=1 int4 step on row b bit for
    bit."""
    t, jfw, tt, tfw = packs
    T, pos = 256, [0, 130, 255, 300]  # the last one past the bucket: clamped
    B = len(pos)
    kv = _caches(B, T, pos, 31)
    x = (np.random.default_rng(32).standard_normal((B, H)) * 0.3).astype(np.float32)
    if cache == "float32":
        caches = [kv[0], kv[1]]
        jo = jfs.fused_decode_step_batched(t, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                           jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                           interpret=True)
        cfg = tt
    else:
        (kq, vq), (ks, vs) = _quantized(kv)
        caches = [kq, vq, ks, vs]
        tq = dataclasses.replace(t, kv_cache_quant=True)
        jo = jfs.fused_decode_step_batched(tq, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                           *map(jnp.asarray, caches), interpret=True)
        cfg = _port_cfg(tq)
    got = [torch.from_numpy(c.copy()) for c in caches]
    tx = tfs.fused_decode_step_batched(cfg, tfw, torch.from_numpy(x), torch.tensor(pos), *got)[0]
    np.testing.assert_allclose(tx.numpy(), np.asarray(jo[0]), **X_TOL)
    if cache == "float32":
        for g, w in zip(got, jo[1:]):
            g, w = g.numpy(), np.asarray(w)
            for b, p in enumerate(pos):
                other = np.arange(T) != min(p, T - 1)
                np.testing.assert_array_equal(g[:, b, :, other], w[:, b, :, other])
            np.testing.assert_allclose(g, w, atol=SLOT_ATOL, rtol=0)
    else:
        for g, w in zip(got, jo[1:]):
            g, w = g.numpy(), np.asarray(w)
            for b, p in enumerate(pos):
                other = np.arange(T) != min(p, T - 1)
                np.testing.assert_array_equal(g[:, b, ..., other] if g.ndim == 4 else
                                              g[:, b, :, other], w[:, b, ..., other]
                                              if w.ndim == 4 else w[:, b, :, other])
            if g.dtype == np.int8:
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
    for b, p in enumerate(pos):
        one = [torch.from_numpy(c[:, b : b + 1].copy()) for c in caches]
        x1 = tfs.fused_decode_step(cfg, tfw, torch.from_numpy(x[b : b + 1]), min(p, T - 1),
                                   *one)[0]
        assert torch.equal(x1[0], tx[b])
        assert all(torch.equal(o[:, 0], g[:, b]) for o, g in zip(one, got))


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_k6_int4_matches_jax(packs, cache):
    """K6's plain version on the int4 pack against JAX ``fused_verify_step``
    on its bits=4 pack, S=4 candidates from slot 60: x within X_TOL, the
    written slots within SLOT_ATOL (one grid step on an int8 cache),
    every other slot bit for bit; its rows equal the S successive B=1 int4
    steps bit for bit."""
    t, jfw, tt, tfw = packs
    T, S, start = 128, 4, 60
    kv = _caches(1, T, [start], 41)
    x = (np.random.default_rng(42).standard_normal((1, S, H)) * 0.3).astype(np.float32)
    if cache == "float32":
        caches = [kv[0], kv[1]]
        jo = j_verify(t, jfw, jnp.asarray(x[0]), jnp.asarray(start, jnp.int32),
                      jnp.asarray(kv[0]), jnp.asarray(kv[1]), interpret=True)
        cfg = tt
    else:
        (kq, vq), (ks, vs) = _quantized(kv)
        caches = [kq, vq, ks, vs]
        tq = dataclasses.replace(t, kv_cache_quant=True)
        jo = j_verify(tq, jfw, jnp.asarray(x[0]), jnp.asarray(start, jnp.int32),
                      *map(jnp.asarray, caches), interpret=True)
        cfg = _port_cfg(tq)
    got = [torch.from_numpy(c.copy()) for c in caches]
    tx = tfv.fused_verify_step(cfg, tfw, torch.from_numpy(x), start, *got)[0]
    np.testing.assert_allclose(tx[0].numpy(), np.asarray(jo[0]), **X_TOL)
    new = np.zeros(T, bool)
    new[start : start + S] = True
    for g, w in zip(got, jo[1:]):
        g, w = g.numpy(), np.asarray(w)
        if g.ndim == 4:  # int8 scales [L, 1, nk, T]
            np.testing.assert_array_equal(g[..., ~new], w[..., ~new])
        else:
            np.testing.assert_array_equal(g[..., ~new, :], w[..., ~new, :])
            if g.dtype == np.int8:
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(g, w, atol=SLOT_ATOL, rtol=0)
    steps = [torch.from_numpy(c.copy()) for c in caches]
    for s in range(S):
        x1 = tfs.fused_decode_step(cfg, tfw, torch.from_numpy(x[:, s]), start + s, *steps)[0]
        assert torch.equal(x1[0], tx[0, s])
    assert all(torch.equal(a, b) for a, b in zip(steps, got))


@pytest.fixture(scope="module")
def chain_models():
    """A two-layer MTP trunk, fused, in both packages (heads raw), with
    seed-made tables."""
    cfg = jcfg.CodePredictorConfig(transformer=_trunk_cfg(I=3072), num_steps=N,
                                   subcode_vocab_size=V, max_seq_len=N + 2, impl="fused",
                                   resident=True)
    raw = j_fuse({"code_predictor": jcp.init_code_predictor_params(cfg, jax.random.PRNGKey(0))})
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = _port_cfg(cfg.transformer)
    tc = tcfg.CodePredictorConfig(**fields)
    traw = tquant.fuse_params(_to_torch(raw))
    tables = (np.random.default_rng(0).standard_normal((N, V, H)) * 0.02).astype(np.float32)
    return cfg, raw["code_predictor"], tc, traw["code_predictor"], tables


def _chain_packs(models, trunk_bits, heads):
    """The chain packs at ``trunk_bits`` from the raw weights, the heads int8
    (quantized after packing: ``--quantize int4``) or raw (bf16 rows: an
    unquantized talker beside ``--mtp-quantize``)."""
    cfg, jraw, tc, traw, _ = models
    jp = jcp.prepare_fused_step(cfg, jraw, bits=trunk_bits)
    tp = tcp.prepare_fused_step(tc, traw, bits=trunk_bits)
    if heads == "int8":
        jp = j_quant({"code_predictor": jp})["code_predictor"]
        tp = tcp.attach_heads(tc, tquant.quantize_params({"code_predictor": tp})[
            "code_predictor"])
    assert tp["fused_heads"].q.dtype == (torch.int8 if heads == "int8" else torch.bfloat16)
    return jp, tp


@pytest.mark.parametrize("trunk_bits,heads", [(4, "int8"), (8, "bf16"), (4, "bf16")])
def test_k5_mixed_matches_jax(chain_models, trunk_bits, heads):
    """K5's plain version on an int4 trunk with int8 heads and on int8 /
    int4 trunks with bf16 heads against JAX ``fused_mtp_chain_batched`` on
    the same packs, heads and Gumbel noise, per-row knobs, float32 cache:
    sub-codes equal, sub_sum within SUM_TOL; row b equals K2's plain chain
    on row b's inputs and noise bit for bit."""
    cfg, _, tc, _, tables = chain_models
    jp, tp = _chain_packs(chain_models, trunk_bits, heads)
    B = len(KNOBS)
    rng = np.random.default_rng(50 + trunk_bits)
    hidden = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0e = (rng.standard_normal((B, H)) * 0.02).astype(np.float32)
    gumbel = rng.gumbel(size=(N, B, V)).astype(np.float32)
    temps, ks, ps = zip(*KNOBS)
    j_subs, j_sum = j_fm.fused_mtp_chain_batched(
        cfg.transformer, jp["fused_step"], jp["transformer"]["final_norm"], jp["heads"],
        jnp.asarray(tables), jnp.asarray(hidden), jnp.asarray(c0e), jnp.asarray(gumbel),
        jnp.asarray(temps, jnp.float32), jnp.asarray(ks, jnp.int32),
        jnp.asarray(ps, jnp.float32), interpret=True)
    args = (tc.transformer, tp["fused_step"], tp["transformer"]["final_norm"], tp["fused_heads"],
            torch.from_numpy(tables))
    t_subs, t_sum = tfm.fused_mtp_chain_batched(
        *args, torch.from_numpy(hidden), torch.from_numpy(c0e), torch.from_numpy(gumbel), temps,
        ks, ps, cache_dtype=torch.float32)
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), **SUM_TOL)
    for b, (tb, kb, pb) in enumerate(KNOBS):
        s1, sum1 = tfm.fused_mtp_chain(
            *args, torch.from_numpy(hidden[b : b + 1]), torch.from_numpy(c0e[b : b + 1]),
            torch.from_numpy(gumbel[:, b : b + 1]), tb, kb, pb, cache_dtype=torch.float32)
        assert torch.equal(s1[0], t_subs[b]) and torch.equal(sum1[0], t_sum[b])


def test_k5_takes_k3_scratch_where_b1_is_k3(chain_models, monkeypatch):
    """Where no pack passes the residency gate the B=1 chain is K3, on its
    float32 scratch; the batched chain (a pool slot, a spec candidate) then
    runs K5 on a float32 cache, so that its rows equal K3's chain bit for
    bit (a standing difference: JAX's per-step chain keeps the model dtype
    there).  Greedy sub-codes through ``predict_subcodes`` at B=3."""
    _, _, tc, _, tables = chain_models
    _, tp = _chain_packs(chain_models, 8, "int8")
    monkeypatch.setattr(tcp, "supports_resident", lambda fw, batch=1: False)
    assert tcp.chain_kernel(tc, tp, 1) is tstream.fused_mtp_chain_streamed
    assert tcp.chain_cache_dtype(tc, tp, tp["fused_step"]) == torch.float32
    seen = []
    real = tcp.fused_mtp_chain_batched
    monkeypatch.setattr(tcp, "fused_mtp_chain_batched",
                        lambda *a, **k: (seen.append(k["cache_dtype"]), real(*a, **k))[1])
    from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams

    rng = np.random.default_rng(60)
    hidden = torch.from_numpy((rng.standard_normal((3, H)) * 0.5).astype(np.float32))
    c0e = torch.from_numpy((rng.standard_normal((3, H)) * 0.02).astype(np.float32))
    tt = torch.from_numpy(tables)
    subs, sums = tcp.predict_subcodes(tc, tp, tt, hidden, c0e, None, SamplingParams.create(0.0))
    assert seen == [torch.float32]
    args = (tc.transformer, tp["fused_step"], tp["transformer"]["final_norm"], tp["fused_heads"],
            tt)
    for b in range(3):
        s1, sum1 = tstream.fused_mtp_chain_streamed(*args, hidden[b : b + 1], c0e[b : b + 1],
                                                    None, 0.0, 50, 0.9)
        assert torch.equal(s1[0], subs[b].to(s1.dtype)) and torch.equal(sum1[0], sums[b])


@pytest.mark.parametrize("quantize,mtp_quantize", [("int4", None), (None, "auto")])
def test_kernel_width_batched_generate_matches_jax(quantize, mtp_quantize):
    """The batched generate loop at kernel widths, two streams at their own
    fill, greedy over two chunks: at ``quantize="int4"`` (K4 and K5 on int4
    units, int8 heads) and at an unset ``quantize`` with
    ``mtp_quantize="auto"`` (K4 on bf16 units; K5 on the int4 alt trunk
    with bf16 heads, the pack JAX's ``resident_pack`` takes at two rows),
    packed in the JAX engine's order on both sides.  The JAX loop runs its
    batched Pallas kernels in interpret mode, the port K4's and K5's plain
    versions: frames equal."""
    from test_torch_slice import _kernel_width_cfg

    from leaxer_qwen3_tts_tpu.models.talker import prepare_fused_talker as j_prep_talker
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns as j_make
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init
    from leaxer_qwen3_tts_torch.models import talker as ttalker
    from leaxer_qwen3_tts_torch.runtime.generate import make_generate_fns
    from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams

    cfg = _kernel_width_cfg()
    bits = 4 if quantize == "int4" else 16
    raw = j_init(cfg, jax.random.PRNGKey(0))
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    jp, tp = j_fuse(raw), tquant.fuse_params(_to_torch(raw))
    if mtp_quantize == "auto":  # the int4 alt trunk, from the raw weights
        jp["code_predictor"] = jcp.prepare_fused_step(cfg.code_predictor, jp["code_predictor"],
                                                      bits=4, alt=True)
        tp["code_predictor"] = tcp.prepare_fused_step(tc.code_predictor, tp["code_predictor"],
                                                      bits=4, alt=True)
    jp["code_predictor"] = jcp.prepare_fused_step(cfg.code_predictor, jp["code_predictor"],
                                                  bits=bits)
    jp["talker"] = j_prep_talker(cfg.talker, jp["talker"], bits=bits)
    tp["code_predictor"] = tcp.prepare_fused_step(tc.code_predictor, tp["code_predictor"],
                                                  bits=bits)
    tp["talker"] = ttalker.prepare_fused_talker(tc.talker, tp["talker"], bits=bits)
    if bits == 4:
        jp = j_quant(jp, bits=4)
        tp = tquant.quantize_params(tp, bits=4)
    tp["code_predictor"] = tcp.attach_heads(tc.code_predictor, tp["code_predictor"])
    want_pack = tp["code_predictor"]["fused_step_alt" if mtp_quantize else "fused_step"]
    assert jcp.resident_pack(jp["code_predictor"], 2) is jp["code_predictor"][
        "fused_step_alt" if mtp_quantize else "fused_step"]
    assert tcp.chain_pack(tp["code_predictor"], tfm.fused_mtp_chain_batched, 2) is want_pack

    ids = np.array([[5, 6, 7, 8], [9, 10, 0, 0]], np.int32)
    lens = np.array([4, 2], np.int32)
    jfns = j_make(cfg, batch=2, max_len=64, chunk_len=2, donate=False, uniform_fill=False)
    st, bd = jfns.prefill(jp, jnp.asarray(ids), jnp.asarray(lens), jax.random.PRNGKey(1))
    st, jframes, _ = jfns.decode(jp, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed,
                                 JSP.create(temperature=0.0))
    tfns = make_generate_fns(tc, batch=2, max_len=64, chunk_len=2, uniform_fill=False)
    state, bundle = tfns.prefill(tp, torch.from_numpy(ids).long(), torch.from_numpy(lens))
    state = state._replace(cache=state.cache._replace(length=state.pos.clone()))  # per-row fill
    packs = []
    k5 = tcp.fused_mtp_chain_batched
    tcp.fused_mtp_chain_batched = lambda *a, **k: (packs.append(a[1]), k5(*a, **k))[1]
    try:
        state, tframes, _ = tfns.decode(tp, state, bundle.trailing, bundle.trailing_len,
                                        bundle.tts_pad_embed, SamplingParams.create(0.0))
    finally:
        tcp.fused_mtp_chain_batched = k5
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
    assert len(packs) == 2 and all(p is want_pack for p in packs)
    assert want_pack.wqkv.dtype == torch.uint8


@pytest.mark.parametrize("kw", [dict(quantize="int4"), dict(mtp_quantize="auto")])
def test_tiny_engine_batched_matches_jax(tiny_model, tiny_vocab_files, kw):
    """The tiny engine's ``synthesize_batch`` (greedy) at ``quantize="int4"``
    and at ``mtp_quantize="auto"`` against the JAX engine's: codes equal,
    audio within the fixture's tolerance; a pool's greedy request equals
    the engine's B=1 request (and so JAX's)."""
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    texts = ["hello world", "hello"]
    j = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path),
                max_frames=8, chunk_len=4, **kw)
    t = TTSEngine(config=tcfg.TTSModelConfig.from_json(cfg.to_json()), params=_to_torch(params),
                  tokenizer=Tokenizer(vocab_path, merges_path), max_frames=8, chunk_len=4,
                  device="cpu", **kw)
    assert j.is_ready() and t.is_ready(), (j.get_error(), t.get_error())
    want = j.synthesize_batch(texts, temperature=0.0, max_tokens=6)
    got = t.synthesize_batch(texts, temperature=0.0, max_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, np.asarray(w.codes))
        np.testing.assert_allclose(g.audio, w.audio, atol=ATOL)
    pool = ContinuousBatcher(t, pool_size=2, chunk_len=2, kv_bucket=64, text_bucket_max=16)
    try:
        pooled = pool.synthesize("hello world", temperature=0.0, max_tokens=6)
    finally:
        pool.shutdown()
    alone = j.synthesize("hello world", temperature=0.0, max_tokens=6)
    np.testing.assert_array_equal(pooled.codes, np.asarray(alone.codes))


@pytest.mark.parametrize("B,groups", [(2, 1), (8, 2), (32, 6)])
def test_17b_bf16_batched_plans(B, groups):
    """B17: the 1.7B bf16 batched plans (K4 on the talker, K5 on the MTP
    trunk with its heads, K6 at B rows) take 48 KB slots, four 12 KB down
    rows a stage, MIN_SLOTS slots beside the largest group's inputs (about
    six rows a group), within the 227 KB a block may use."""
    c = tcfg.QWEN3_TTS_17B
    for t, heads in ((c.talker.transformer, 0),
                     (c.code_predictor.transformer, c.code_predictor.subcode_vocab_size)):
        plan = persistent.make_plan(t, 132, head_rows=heads, batch=B, unit_bytes=2,
                                    head_bytes=2 if heads else 0)
        assert plan.slot_bytes == persistent.WIDE_SLOT_BYTES
        assert plan.n_slots == persistent.MIN_SLOTS and plan.groups == groups
        assert plan.stage_rows[:4] == (12, 12, 12, 4)
        if heads:
            assert plan.stage_rows[persistent.KINDS.index("head")] == 12
        assert plan.smem_bytes + persistent.STATIC_SMEM <= persistent.SMEM_PER_BLOCK
        rows = max(persistent.group_rows(plan, blk)[1] - persistent.group_rows(plan, blk)[0]
                   for blk in range(132))
        assert rows == -(-B // groups) and rows <= 6
        assert plan.union_bytes >= persistent.act_bytes(t, rows)


def test_m12b_refusals_name_their_item():
    """M12b is done: on the card a pool past 32 slots and one whose slots x
    spec_k pass 32 rows pass the pool's row checks (the wrappers split the
    rows into launches; this bare engine stops at the config it lacks), and
    so does a pool of one slot (its step is K4 at one row, K1's arithmetic;
    JAX's one-slot pool steps on its B=1 kernel) (the engine's batch past
    32: test_torch_int4.py)."""
    eng = types.SimpleNamespace(is_ready=lambda: True, get_error=lambda: "",
                                mesh=None, device=torch.device("cuda"))
    with pytest.raises(AttributeError, match="cfg"):
        ContinuousBatcher(eng, pool_size=33)
    with pytest.raises(AttributeError, match="cfg"):
        ContinuousBatcher(eng, pool_size=16, spec_k=3)
    with pytest.raises(AttributeError, match="cfg"):
        ContinuousBatcher(eng, pool_size=1)
