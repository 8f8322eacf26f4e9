"""The int8 KV cache (per-(slot, kv head) float32 scales) of the PyTorch port,
on the CPU, against the JAX package: ``quantize_kv`` bit for bit, the plain
layers' prefill and decode, the cache splice, the plain versions of kernels
K1, K4, K6 and K7 against the JAX kernels in interpret mode, and the engine
(B=1, ``synthesize_batch``, ``spec_k``, the pool, ``frame_fused``, the bucket
ladder and its growth), the port of ``tests/test_kv_quant.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.models import layers as jlayers
from leaxer_qwen3_tts_tpu.ops import fused_frame as j_ff
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.ops.fused_verify import fused_verify_step as j_verify
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import layers as tlayers
from leaxer_qwen3_tts_torch.ops import fused_frame as tff
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import fused_verify as tfv
from leaxer_qwen3_tts_torch.runtime import generate as tgen
from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.serve import ContinuousBatcher
from test_torch_fused_frame import (  # noqa: F401  (frame_models: a fixture)
    HIDDEN_TOL,
    LOGITS_TOL,
    IDS,
    LENS,
    _frame_inputs,
    _loop_models,
    frame_models,
)

torch.set_num_threads(2)

# The plain kernels against the JAX kernels (interpret mode), on the same int8
# weights and the same int8 cache: x within the verify test's 1e-2 (both sides
# round the same operands to bf16 and sum in float32 in other orders, and 2
# layers let a bf16 rounding flip reach x).  In the first layer, where no flip
# has happened, a written slot's int8 value is within one step of the grid (a
# pre-quantization value ~1e-7 off can round the other way at a half) and its
# scale within 1e-5 relative (amax / 127 of values that agree to ~1e-7); in
# every layer its dequantized value is within the verify test's slot bound
# 1.6e-2 plus that one step.  Every other slot and scale bit for bit.
X_TOL = dict(atol=1e-2, rtol=1e-2)
SCALE_RTOL = 1e-5
SLOT_ATOL = 1.6e-2
# the float32 slice tolerance of tests/test_torch_slice.py's layer checks
F32_TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 2e-4  # the regression fixture's audio tolerance (test_regression.py)
L, NK, D, H = 2, 4, 128, 1024


def _tiny_tr(quant: bool):
    """tests/test_kv_quant.py's tiny transformer, in both packages."""
    t = jcfg.TransformerConfig(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                               head_dim=16, intermediate_size=128, dtype="float32",
                               kv_cache_quant=quant)
    return t, tcfg.TransformerConfig(**dataclasses.asdict(t))


def _to_torch(tree):
    return params_from_jax(flatten_params(jax.device_get(tree)))


# ---------------------------------------------------------------------------
# quantize_kv and the plain layers
# ---------------------------------------------------------------------------


def _ties():
    """Exact half ties: amax 127 gives scale 1 (x / scale = k + 0.5 exactly),
    amax 254 scale 2; negative ties and a zero lane beside them."""
    a = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, 0.0], np.float32)
    b = np.array([254.0, 5.0, -7.0, 1.0, 3.0, -1.0, 253.0, -0.0], np.float32)
    return np.stack([a, b])[None]


@pytest.mark.parametrize("case", ["random", "ties", "zero", "tiny"])
def test_quantize_kv_matches_jax(case):
    """int8 values and float32 scales bit for bit, rounding half to even
    (2.5 -> 2, -3.5 -> -4, 0.5 -> 0); a zero vector gives q = 0 and the
    1e-8 floor."""
    rng = np.random.default_rng(0)
    x = {
        "random": rng.normal(size=(3, 5, 2, 16)).astype(np.float32) * 2.0,
        "ties": _ties(),
        "zero": np.zeros((1, 1, 1, 16), np.float32),
        "tiny": rng.normal(size=(2, 16)).astype(np.float32) * 1e-9,
    }[case]
    jq, js = jlayers.quantize_kv(jnp.asarray(x))
    tq, ts = tlayers.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "ties":
        assert tq[0, 0, 1:7].tolist() == [2, -4, 0, 0, 2, 126]
        assert tq[0, 1, 1:7].tolist() == [2, -4, 0, 2, 0, 126]
    if case == "zero":
        assert tq.abs().max() == 0 and float(ts.max()) == np.float32(1e-8)


def test_prefill_then_decode_matches_jax():
    """A 6-token prefill and 4 decode steps through the plain layers with an
    int8 cache: hidden states within the float32 slice tolerance, the int8
    cache within one grid step of JAX's and its scales within SCALE_RTOL
    (XLA's and PyTorch's float32 products differ in the last bit, and so
    do amax / 127 and, at a half, the rounding)."""
    jt, tt = _tiny_tr(True)
    params = jlayers.init_transformer_params(jt, jax.random.PRNGKey(0))
    tparams = _to_torch(params)
    B, S, T, steps = 2, 6, 16, 4
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S + steps, 64)).astype(np.float32) * 0.3
    jc, tc = jlayers.init_kv_cache(jt, B, T), tlayers.init_kv_cache(tt, B, T, "cpu")
    assert tc.quantized and tc.k.dtype == torch.int8 and tc.k_scale.shape == (2, B, 2, T)
    jv, tv = jnp.zeros((B, T), bool), torch.zeros((B, T), dtype=torch.bool)
    for lo, hi in [(0, S)] + [(S + i, S + i + 1) for i in range(steps)]:
        pos = np.broadcast_to(np.arange(lo, hi), (B, hi - lo))
        jh, jc, jv = jlayers.transformer_forward(jt, params, jnp.asarray(x[:, lo:hi]),
                                                 jnp.asarray(pos, jnp.int32), jc, jv)
        th, tc, tv = tlayers.transformer_forward(tt, tparams, torch.from_numpy(x[:, lo:hi]),
                                                 torch.from_numpy(pos.copy()), tc, tv)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32_TOL)
    assert tc.length == S + steps
    for got, want in zip((tc.k, tc.v), (jc.k, jc.v)):
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 0.01
    for got, want in zip((tc.k_scale, tc.v_scale), (jc.k_scale, jc.v_scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCALE_RTOL, atol=0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_splice_kv_cache_quantized():
    """The splice writes the stream's int8 rows and scales into its slot, and
    nothing else (tests/test_kv_quant.py::test_splice_kv_cache_quantized)."""
    _, tt = _tiny_tr(True)
    pool = tlayers.init_kv_cache(tt, 4, 8, "cpu")._replace(length=torch.zeros(4, dtype=torch.long))
    one = tlayers.init_kv_cache(tt, 1, 8, "cpu")
    one = one._replace(k=torch.ones_like(one.k), k_scale=torch.full_like(one.k_scale, 0.5),
                       v_scale=torch.full_like(one.v_scale, 0.25), length=3)
    out = tlayers.splice_kv_cache(pool, one, 2)
    assert out.k is pool.k and out.k_scale is pool.k_scale  # in place
    assert int(out.k[:, 2].min()) == 1 and int(out.k[:, [0, 1, 3]].abs().max()) == 0
    assert float(out.k_scale[:, 2].min()) == 0.5 and float(out.v_scale[:, 2].max()) == 0.25
    assert float(out.k_scale[:, [0, 1, 3]].abs().max()) == 0.0
    assert out.length.tolist() == [0, 0, 3, 0]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attend_matches_jax(impl):
    """``attend`` over an int8 cache with its scales: the plain path in the
    score and weight domains, and K8 on the dequantized cache, each against
    JAX's on a bf16 model's operands (the bf16 product rules) within the
    dtype's tolerance."""
    from leaxer_qwen3_tts_tpu.ops.attention import attend as j_attend
    from leaxer_qwen3_tts_torch.ops.attention import attend as t_attend

    rng = np.random.default_rng(2)
    B, S, nq, nk, T, d = 1, 3, 4, 2, 64, 128
    q = rng.normal(size=(B, S, nq, d)).astype(np.float32)
    kf = rng.normal(size=(B, nk, T, d)).astype(np.float32)
    vf = rng.normal(size=(B, nk, T, d)).astype(np.float32)
    mask = np.tril(np.ones((S, T), bool), k=T - S)[None]
    kq, ks = jlayers.quantize_kv(jnp.asarray(kf))
    vq, vs = jlayers.quantize_kv(jnp.asarray(vf))
    want = j_attend(jnp.asarray(q, jnp.bfloat16), kq, vq, jnp.asarray(mask), impl=impl,
                    k_scale=ks, v_scale=vs)
    got = t_attend(torch.from_numpy(q).bfloat16(), torch.from_numpy(np.asarray(kq)),
                   torch.from_numpy(np.asarray(vq)), torch.from_numpy(mask), impl=impl,
                   k_scale=torch.from_numpy(np.asarray(ks)),
                   v_scale=torch.from_numpy(np.asarray(vs)))
    assert got.dtype == torch.bfloat16
    # bf16 outputs: one ulp of the largest (|out| < 2) apart at most
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -7, rtol=0)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packs():
    t = jcfg.TransformerConfig(hidden_size=H, num_layers=L, num_heads=8, num_kv_heads=NK,
                               head_dim=D, intermediate_size=3072, dtype="float32",
                               kv_cache_quant=True)
    params = jlayers.init_transformer_params(t, jax.random.PRNGKey(0))
    tt = tcfg.TransformerConfig(**dataclasses.asdict(t))
    return t, jfs.pack_fused_weights(t, params["layers"]), tt, tfs.pack_fused_weights(
        tt, _to_torch(params["layers"]))


def _int8_cache(B, T, filled, seed):
    """An int8 cache [L, B, NK, T, D] and its scales on quantize_kv's grid,
    row b filled before ``filled[b]`` (zero after, scales at the floor)."""
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((2, L, B, NK, T, D)) * 0.2).astype(np.float32)
    for b, p in enumerate(filled):
        kv[:, :, b, :, p:] = 0.0
    q, s = jlayers.quantize_kv(jnp.asarray(kv))
    return np.asarray(q), np.asarray(s)


def _check_int8_slots(got, want, before, new):
    """got / want: (k, v, k_scale, v_scale) arrays; ``new`` [B, T] marks the
    written slots.  Every other slot and scale equal ``before`` and ``want``
    bit for bit; the written slots as the bounds above say."""
    m = new[None, :, None, :]
    keep = np.broadcast_to(~m, got[0].shape[:4])
    for g, w, b0 in zip(got, want, before):
        np.testing.assert_array_equal(g[keep], w[keep])
        np.testing.assert_array_equal(g[keep], b0[keep])
    sel = np.broadcast_to(m, got[0].shape[:4])
    for q, s in ((0, 2), (1, 3)):
        gq, wq = got[q][sel].astype(np.int32), want[q][sel].astype(np.int32)
        gs, ws = got[s][sel], want[s][sel]
        first = sel[: 1].sum()  # the first layer's written (row, head) vectors lead
        assert np.abs(gq[:first] - wq[:first]).max() <= 1
        np.testing.assert_allclose(gs[:first], ws[:first], rtol=SCALE_RTOL, atol=0)
        step = np.maximum(gs, ws)[:, None]
        assert (np.abs(gq * gs[:, None] - wq * ws[:, None]) <= SLOT_ATOL + step).all()


def _torch_caches(q, s):
    return [torch.from_numpy(a.copy()) for a in (q[0], q[1], s[0], s[1])]


@pytest.mark.parametrize("pos", [0, 77, 127])
def test_k1_plain_matches_jax(packs, pos):
    """K1's plain version on an int8 cache against JAX ``fused_decode_step``
    (interpret, its "vmem" mode at T=128): x, the written slot and scales."""
    t, jfw, tt, tfw = packs
    T = 128
    q, s = _int8_cache(1, T, [pos], pos)
    x = (np.random.default_rng(pos + 1).standard_normal((1, H)) * 0.3).astype(np.float32)
    jo = jfs.fused_decode_step(t, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                               *map(jnp.asarray, (q[0], q[1], s[0], s[1])), interpret=True)
    caches = _torch_caches(q, s)
    to = tfs.fused_decode_step(tt, tfw, torch.from_numpy(x), pos, *caches)
    assert len(to) == 5 and all(a is b for a, b in zip(to[1:], caches))  # in place
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), **X_TOL)
    new = np.zeros((1, T), bool)
    new[0, pos] = True
    _check_int8_slots([c.numpy() for c in caches], [np.asarray(a) for a in jo[1:]],
                      (q[0], q[1], s[0], s[1]), new)


def test_k4_plain_matches_jax(packs):
    """K4's plain version on an int8 cache against JAX
    ``fused_decode_step_batched`` (interpret, "bwin" at B=4, T=128), rows at
    the first slot, both sides of a split edge and the last slot."""
    t, jfw, tt, tfw = packs
    T, pos = 128, [0, 63, 64, 127]
    B = len(pos)
    q, s = _int8_cache(B, T, pos, 4)
    x = (np.random.default_rng(5).standard_normal((B, H)) * 0.3).astype(np.float32)
    jo = jfs.fused_decode_step_batched(t, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                       *map(jnp.asarray, (q[0], q[1], s[0], s[1])),
                                       interpret=True)
    caches = _torch_caches(q, s)
    to = tfs.fused_decode_step_batched(tt, tfw, torch.from_numpy(x), torch.tensor(pos), *caches)
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), **X_TOL)
    new = np.zeros((B, T), bool)
    new[np.arange(B), pos] = True
    _check_int8_slots([c.numpy() for c in caches], [np.asarray(a) for a in jo[1:]],
                      (q[0], q[1], s[0], s[1]), new)


@pytest.mark.parametrize("S,start", [(2, 63), (4, 124)])
def test_k6_plain_matches_jax(packs, S, start):
    """K6's plain version on an int8 cache against JAX ``fused_verify_step``
    (interpret, T=128): candidates across a split edge and up to the last
    slot."""
    t, jfw, tt, tfw = packs
    T = 128
    q, s = _int8_cache(1, T, [start], start)
    x = (np.random.default_rng(S).standard_normal((1, S, H)) * 0.3).astype(np.float32)
    jo = j_verify(t, jfw, jnp.asarray(x[0]), jnp.asarray(start, jnp.int32),
                  *map(jnp.asarray, (q[0], q[1], s[0], s[1])), interpret=True)
    caches = _torch_caches(q, s)
    to = tfv.fused_verify_step(tt, tfw, torch.from_numpy(x), start, *caches)
    assert len(to) == 5
    np.testing.assert_allclose(to[0].numpy()[0], np.asarray(jo[0]), **X_TOL)
    new = np.zeros((1, T), bool)
    new[0, start : start + S] = True
    _check_int8_slots([c.numpy() for c in caches], [np.asarray(a) for a in jo[1:]],
                      (q[0], q[1], s[0], s[1]), new)


def test_k4_k6_rows_are_k1_steps(packs):
    """On an int8 cache a K4 row is the K1 step on that row, and a K6 row the
    S successive K1 steps it stands for, bit for bit (x, cache and scales):
    the plain versions keep the anchors the card's kernels are held to."""
    _, _, tt, tfw = packs
    T, S, starts = 128, 3, [0, 62, 125, 200]  # the last past T - S: clamped
    B = len(starts)
    q, s = _int8_cache(B, T, [min(p, T - S) for p in starts], 9)
    x = torch.from_numpy((np.random.default_rng(9).standard_normal((B, S, H)) * 0.3)
                         .astype(np.float32))
    c4, c6 = _torch_caches(q, s), _torch_caches(q, s)
    x4 = tfs.fused_decode_step_batched(tt, tfw, x[:, 0], torch.tensor(starts), *c4)[0]
    x6 = tfv.fused_verify_step(tt, tfw, x, torch.tensor(starts), *c6)[0]
    for b, p in enumerate(starts):
        c1 = [c[:, b : b + 1].clone() for c in _torch_caches(q, s)]
        x1 = tfs.fused_decode_step(tt, tfw, x[b, :1], p, *c1)[0]
        assert torch.equal(x4[b : b + 1], x1)
        assert all(torch.equal(a[:, b : b + 1], c) for a, c in zip(c4, c1))
        c1 = [c[:, b : b + 1].clone() for c in _torch_caches(q, s)]
        for i in range(S):
            x1 = tfs.fused_decode_step(tt, tfw, x[b, i : i + 1], min(p, T - S) + i, *c1)[0]
            assert torch.equal(x6[b, i : i + 1], x1), (b, i)
        assert all(torch.equal(a[:, b : b + 1], c) for a, c in zip(c6, c1))


@pytest.mark.parametrize("knobs,forbid_eos,pos", [
    ((0.8, 50, 0.9), True, 7),  # sampled, EOS forbidden
    ((0.0, 50, 0.9), False, 100),  # greedy, EOS allowed
])
def test_k7_plain_matches_jax(frame_models, knobs, forbid_eos, pos):
    """K7's plain version with an int8 talker cache (and a float32 chain
    cache) against JAX ``fused_frame_step`` (interpret, T=128): code0 and the
    sub-codes exact, hidden and logits within tests/test_fused_frame.py's
    tolerances, the talker slot and scales as in the K1 test."""
    port, jax_packs = frame_models
    T = 128
    ll, sup, lh, drip, kc, vc, g0, gm = _frame_inputs(pos, T)
    kc[:, :, :, pos:] = 0
    vc[:, :, :, pos:] = 0
    q, s = (np.asarray(a) for a in zip(*(jlayers.quantize_kv(jnp.asarray(c)) for c in (kc, vc))))
    temp, top_k, top_p = knobs
    jo = j_ff.fused_frame_step(
        *jax_packs, jnp.asarray(ll), jnp.asarray(lh), jnp.asarray(sup), jnp.asarray(drip),
        jnp.int32(pos), jnp.asarray(q[0]), jnp.asarray(q[1]), jnp.asarray(g0), jnp.asarray(gm),
        jnp.float32(temp), jnp.int32(top_k), jnp.float32(top_p), jnp.bool_(forbid_eos),
        k_scale=jnp.asarray(s[0]), v_scale=jnp.asarray(s[1]), interpret=True,
    )
    caches = _torch_caches(q, s)
    to = tff.fused_frame_step(
        **port, last_logits=torch.from_numpy(ll), last_hidden=torch.from_numpy(lh),
        suppress=torch.from_numpy(sup), drip=torch.from_numpy(drip), pos=pos,
        k_cache=caches[0], v_cache=caches[1], g0=torch.from_numpy(g0),
        gumbel=torch.from_numpy(gm), temperature=temp, top_k=top_k, top_p=top_p,
        forbid_eos=forbid_eos, k_scale=caches[2], v_scale=caches[3],
    )
    assert len(to) == 8
    assert to[0].tolist() == np.asarray(jo[0]).tolist()
    assert to[1].tolist() == np.asarray(jo[1]).tolist()
    np.testing.assert_allclose(to[3].numpy(), np.asarray(jo[3]), atol=HIDDEN_TOL, rtol=HIDDEN_TOL)
    np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    new = np.zeros((1, T), bool)
    new[0, pos] = True
    _check_int8_slots([c.numpy() for c in caches], [np.asarray(a) for a in jo[4:]],
                      (q[0], q[1], s[0], s[1]), new)


def test_gates(packs, frame_models):
    """JAX's int8-KV bucket gates: ``supports_frame`` (T=96 refused with kvq,
    as tests/test_fused_frame.py), the step gates, and the pool refusing an
    unaligned bucket on the card only."""
    port, jax_packs = frame_models
    for T, want in ((96, False), (128, True), (256, True), (640, False), (1024, True)):
        assert tff.supports_frame(port["mfw"], T, port["tcfg"], kvq=True) is want
        assert j_ff.supports_frame(jax_packs[6], T, jax_packs[0], kvq=True) is want
    assert tff.supports_frame(port["mfw"], 96, port["tcfg"])
    assert [tfs.kvq_bucket_ok(T) for T in (96, 128, 640, 1024)] == [False, True, True, True]
    assert [tfs.kvq_bucket_ok(T, window=True) for T in (128, 512, 640, 1024)] == [
        True, True, False, True]
    # an int8 cache without its scales, or scales beside a bf16 cache, raise
    _, _, tt, tfw = packs
    meta = torch.empty((L, 1, NK, 128, D), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="scales"):
        tfs._check_cuda_inputs(tfw, meta, meta)
    with pytest.raises(ValueError, match="scales"):
        sc = torch.empty((L, 1, NK, 128), device="meta")
        tfs._check_cuda_inputs(tfw, meta.bfloat16(), meta.bfloat16(), True, sc, sc)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _engines(tiny_model, tiny_vocab_files, **kw):
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    j = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path),
                kv_quant=True, **kw)
    t = TTSEngine(config=tcfg.TTSModelConfig.from_json(cfg.to_json()),
                  params=_to_torch(params), tokenizer=Tokenizer(vocab_path, merges_path),
                  kv_quant=True, device="cpu", **kw)
    assert j.is_ready() and t.is_ready(), (j.get_error(), t.get_error())
    return j, t


@pytest.fixture(scope="module")
def engines(tiny_model, tiny_vocab_files):
    return _engines(tiny_model, tiny_vocab_files, max_frames=10, chunk_len=4,
                    first_chunk_len=2)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got.codes), np.asarray(want.codes))
    np.testing.assert_allclose(got.audio, want.audio, atol=ATOL)


def test_engine_kv_quant_matches_jax(engines):
    """A B=1 greedy request with the int8 cache: the JAX engine's codes, and
    audio within the fixture's tolerance; a seeded one repeats itself."""
    j, t = engines
    assert t.cfg.talker.transformer.kv_cache_quant
    assert not t.cfg.code_predictor.transformer.kv_cache_quant  # the MTP cache stays
    _same(t.synthesize("hello world", temperature=0.0, seed=1),
          j.synthesize("hello world", temperature=0.0, seed=1))
    # sampled: the port's generators are not JAX's; the same seed, the same codes
    a, b = (t.synthesize("hello world", temperature=0.9, seed=3) for _ in range(2))
    np.testing.assert_array_equal(a.codes, b.codes)


def test_synthesize_batch_kv_quant_matches_jax(engines):
    j, t = engines
    texts = ["hello world", "hello", "hello world hello"]
    for g, w in zip(t.synthesize_batch(texts, temperature=0.0, max_tokens=8),
                    j.synthesize_batch(texts, temperature=0.0, max_tokens=8)):
        _same(g, w)


def test_spec_kv_quant_matches_jax_and_sequential(tiny_model, tiny_vocab_files, engines):
    """spec_k=2 greedy with the int8 cache: the JAX spec engine's codes, and
    the sequential engine's (both read the same quantized values)."""
    j, t = _engines(tiny_model, tiny_vocab_files, max_frames=10, chunk_len=4,
                    first_chunk_len=2, spec_k=2, spec_iters=2)
    got = t.synthesize("hello world", temperature=0.0, seed=5)
    _same(got, j.synthesize("hello world", temperature=0.0, seed=5))
    np.testing.assert_array_equal(got.codes, engines[1].synthesize(
        "hello world", temperature=0.0, seed=5).codes)


def test_pool_kv_quant_matches_engine(engines):
    """The continuous pool on an int8 cache (the scales spliced with each
    admission): greedy codes equal the B=1 engine's."""
    _, t = engines
    pool = ContinuousBatcher(t, pool_size=2, chunk_len=2, kv_bucket=64, text_bucket_max=16)
    try:
        assert pool._groups[0].state.cache.quantized
        for text in ("hello world", "hello"):
            r = pool.synthesize(text, temperature=0.0, max_tokens=6)
            np.testing.assert_array_equal(
                r.codes, t.synthesize(text, temperature=0.0, max_tokens=6).codes)
    finally:
        pool.shutdown()


def test_ladder_and_growth_match_jax(tiny_model, tiny_vocab_files):
    """The top bucket is 128-aligned under kv_quant (416 -> 512, JAX
    tests/test_engine.py::test_kvq_ladder_top_is_128_aligned), and a request
    that grows through tiny buckets (16 -> 32 -> 128) keeps JAX's codes: the
    growth pads the scales with the cache."""
    cfg, params = tiny_model
    j, t = _engines(tiny_model, tiny_vocab_files, max_frames=384, chunk_len=4)
    assert t.kv_ladder == j.kv_ladder and t.kv_ladder[-1] == 512
    j, t = _engines(tiny_model, tiny_vocab_files, max_frames=24, chunk_len=4,
                    first_chunk_len=2, kv_buckets=(16, 32))
    assert t.kv_ladder == j.kv_ladder == (16, 32, 128)
    _same(t.synthesize("hello world", temperature=0.0, seed=0),
          j.synthesize("hello world", temperature=0.0, seed=0))
    _, tt = _tiny_tr(True)
    state = tgen.GenerateState(
        cache=tlayers.init_kv_cache(tt, 1, 16, "cpu")._replace(length=3),
        valid_mask=torch.ones((1, 16), dtype=torch.bool), last_logits=None, last_hidden=None,
        pos=None, step=None, done=None, generators=None)
    state.cache.k_scale.fill_(0.5)
    grown = TTSEngine._grow_state(state, 32)
    assert grown.cache.k.shape[3] == grown.cache.k_scale.shape[3] == 32
    assert float(grown.cache.k_scale[..., :16].min()) == 0.5
    assert float(grown.cache.k_scale[..., 16:].abs().max()) == 0.0
    assert grown.cache.v_scale.shape == grown.cache.k_scale.shape


def test_frame_fused_loop_kv_quant_matches_jax(monkeypatch):
    """The frame-fused loop (K7's plain version once per frame) with an int8
    talker cache at T=128: JAX's greedy frames with its interpret kernel."""
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns as j_make
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP

    cfg, jp, tc, tp = _loop_models()

    def quant(c):
        return dataclasses.replace(c, talker=dataclasses.replace(
            c.talker, transformer=dataclasses.replace(c.talker.transformer,
                                                      kv_cache_quant=True)))

    cfg, tc = quant(cfg), quant(tc)
    jfns = j_make(cfg, batch=1, max_len=128, chunk_len=2, donate=False)
    st, bd = jfns.prefill(jp, jnp.asarray(IDS), jnp.asarray(LENS), jax.random.PRNGKey(1))
    assert st.cache.quantized
    _, jfr, _ = jfns.decode(jp, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed,
                            JSP.create(temperature=0.0, forbid_eos=True))
    calls = []
    real = tgen.fused_frame_step
    monkeypatch.setattr(tgen, "fused_frame_step",
                        lambda *a, **k: (calls.append(a[23] is not None), real(*a, **k))[1])
    fns = tgen.make_generate_fns(tc, batch=1, max_len=128, chunk_len=2)
    state, b = fns.prefill(tp, torch.from_numpy(IDS).long(), torch.from_numpy(LENS),
                           torch.Generator().manual_seed(0))
    assert state.cache.quantized
    state, fr, _ = fns.decode(tp, state, b.trailing, b.trailing_len, b.tts_pad_embed,
                              SamplingParams.create(0.0, forbid_eos=True))
    assert calls == [True, True]  # both frames through K7, with the scales
    np.testing.assert_array_equal(fr.numpy(), np.asarray(jfr))
