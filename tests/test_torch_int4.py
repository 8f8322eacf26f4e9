"""int4 weights (``quantize="int4"``, the CLI's ``--quantize int4``) in the
port, on the CPU, against the JAX package: ``quantize_weight_int4`` /
``unpack_int4`` / ``_dense4`` / ``quantize_params(bits=4)`` bit for bit, the
int4 unit pack (every unit element's dequantized value, the integers and the
group scales), kernel K1's plain version at int4 units against JAX
``fused_decode_step`` on its bits=4 pack (interpret mode) on a float32 and
an int8 cache, a tiny engine at ``quantize="int4"`` against the JAX engine,
and what stays refused, each error naming its ROADMAP item (the batched
int4 kernels' plain versions and engines: test_torch_batched_precision.py)."""

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
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.ops import quant as jquant
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.ops import fused_mtp as tfm
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.ops import quant as tquant
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

# _dense4: both sides sum the same float32 products per group in their own
# orders (XLA's dot against torch's einsum), ~1e-7 relative apart
DENSE_TOL = dict(rtol=1e-5, atol=1e-5)
# K1 at int4 against the JAX kernel: both round the same operands to bf16 and
# sum in float32 in other orders (the JAX kernel adds each group's low- and
# high-half dots in pairs; the plain version groups in column order), as
# test_torch_bf16_units.py's 1e-3 at two layers (float32 cache); an int8
# cache: test_torch_kv_quant.py's x bound (a written slot's int8 value may
# sit one step off where its pre-quantization value is at a half)
TOL = dict(atol=1e-3, rtol=1e-3)
X_TOL = dict(atol=1e-2, rtol=1e-2)
ATOL = 2e-4  # the regression fixture's audio tolerance (test_regression.py)
L, NK, D, H = 2, 4, 128, 1024


def _to_torch(tree):
    return params_from_jax(flatten_params(jax.device_get(tree)))


@pytest.mark.parametrize("shape", [(256, 96), (2, 1024, 40), (64, 10), (6, 3)])
def test_quantize_weight_int4_matches_jax(shape):
    """The integers (packed bytes) and group scales bit for bit, including
    the group shrunk to a divisor of K/2 (K = 64: groups of 32; K = 6:
    groups of 3); unpack_int4 bit for bit; _dense4 within DENSE_TOL."""
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero column: scale one
    j = jquant.quantize_weight_int4(jnp.asarray(w))
    t = tquant.quantize_weight_int4(torch.from_numpy(w))
    assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(tquant.unpack_int4(t.q).numpy(),
                                  np.asarray(jquant.unpack_int4(j.q)))
    if len(shape) == 2:
        x = rng.standard_normal((3, shape[0])).astype(np.float32)
        np.testing.assert_allclose(tquant.dense(torch.from_numpy(x), t).numpy(),
                                   np.asarray(jquant.dense(jnp.asarray(x), j)), **DENSE_TOL)
    with pytest.raises(ValueError, match="even K"):
        tquant.quantize_weight_int4(torch.zeros((5, 4)))
    # the API beside it: the compute dtype of a quantized weight is bf16 (JAX's
    # weight_dtype), and index_weight slices a stacked one along its lead axis
    assert tquant.weight_dtype(t) == torch.bfloat16 and jquant.weight_dtype(j) == jnp.bfloat16
    assert tquant.weight_dtype(torch.from_numpy(w)) == torch.float32
    if len(shape) == 3:
        one = tquant.index_weight(t, 1)
        np.testing.assert_array_equal(one.q.numpy(), np.asarray(jquant.index_weight(j, 1).q))
        np.testing.assert_array_equal(one.scale.numpy(),
                                      np.asarray(jquant.index_weight(j, 1).scale))


def test_quantize_params_bits4_matches_jax(tiny_model):
    """``quantize_params(bits=4)`` of the tiny model: int4 transformer
    products, int8 lm_head / heads and odd-K weights, everything else
    untouched; every leaf's type, integers and scales as JAX's."""
    cfg, params = tiny_model
    fused = jquant.fuse_params(params)
    jq = jquant.quantize_params(fused, bits=4)
    tq = tquant.quantize_params(tquant.fuse_params(_to_torch(params)), bits=4)
    kinds = set()

    def walk(j, t, path):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], path + (k,))
        elif isinstance(j, (jquant.QuantizedLinear, jquant.QuantizedLinear4)):
            assert type(t).__name__ == type(j).__name__, path
            kinds.add((path[-1], type(j).__name__))
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        elif isinstance(j, (list, tuple)):
            for i, (a, b) in enumerate(zip(j, t)):
                walk(a, b, path + (i,))
        else:
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))

    walk(jq, tq, ())
    assert ("wqkv", "QuantizedLinear4") in kinds and ("lm_head", "QuantizedLinear") in kinds
    assert ("heads", "QuantizedLinear") in kinds
    with pytest.raises(ValueError, match="bits"):
        tquant.quantize_params(params_from_jax({}), bits=2)


def _trunk_cfg(kvq=False):
    return jcfg.TransformerConfig(hidden_size=H, num_layers=L, num_heads=8, num_kv_heads=NK,
                                  head_dim=D, intermediate_size=2048, dtype="float32",
                                  kv_cache_quant=kvq)


@pytest.fixture(scope="module")
def packs():
    """The bits=4 packs of one random two-layer trunk, JAX's and the port's
    (from the same raw weights, as the engines pack them)."""
    t = _trunk_cfg()
    params = jlayers.init_transformer_params(t, jax.random.PRNGKey(0))
    jfw = jfs.pack_fused_weights(t, params["layers"], bits=4)
    layers = _to_torch(params["layers"])
    tt = tcfg.TransformerConfig(**dataclasses.asdict(t))
    return t, jfw, tt, tfs.pack_fused_weights(tt, layers, bits=4), layers


def _jax_matrices(t, jfw):
    """The JAX unit pack's dequantized units reassembled into the four
    [L, K, N] matrices (qkv and gate|up split along N, o and down along K
    and N, k-major), as float32 numpy."""
    units = np.asarray(jquant.unpack_int4(jfw.units)).astype(np.float32)  # [L, U, H, NU]
    scales = np.asarray(jfw.scales)  # [L, U, G, NU]
    G = scales.shape[2]
    deq = units * np.repeat(scales, H // G, axis=2)
    A, qd, I = t.q_dim + 2 * t.kv_dim, t.q_dim, t.intermediate_size
    NU = jfs.N_UNIT
    at = 0

    def n_split(N):
        nonlocal at
        n = N // NU
        m = np.concatenate([deq[:, at + i] for i in range(n)], axis=-1)
        at += n
        return m

    def k_split(K, N):
        nonlocal at
        k, n = K // H, N // NU
        rows = [np.concatenate([deq[:, at + i * n + j] for j in range(n)], axis=-1)
                for i in range(k)]
        at += k * n
        return np.concatenate(rows, axis=1)

    return [n_split(A), k_split(qd, H), n_split(2 * I), k_split(I, H)]


def test_int4_pack_matches_jax(packs):
    """Every unit element's dequantized value equals the JAX bits=4 unit
    pack's (integers on quantize_weight_int4's grid, whose group-128 scales
    the unit slices keep), bit for bit; the rows are uint8 (a dtype of their
    own), the scales [L, N, K/128]; the meta pack has the real shapes; a
    quantized input raises, as JAX's pack needs raw weights."""
    t, jfw, tt, tfw, layers = packs
    mats = _jax_matrices(t, jfw)
    for (w, s), m in zip(((tfw.wqkv, tfw.sqkv), (tfw.wo, tfw.so), (tfw.wgu, tfw.sgu),
                          (tfw.wd, tfw.sd)), mats):
        assert w.dtype == torch.uint8 and s.dtype == torch.float32
        assert s.shape == (w.shape[0], w.shape[1], 2 * w.shape[2] // 128)
        deq = tfs.unpack_rows4(w).float() * s.repeat_interleave(128, dim=-1)
        np.testing.assert_array_equal(deq.transpose(1, 2).numpy(), m)
    # the integers and scales of one wqkv row straight from quantize_weight_int4
    wqkv = torch.cat([layers["wq"], layers["wk"], layers["wv"]], -1)
    q4 = tquant.quantize_weight_int4(wqkv)
    vals = tquant.unpack_int4(q4.q)  # [L, K, N]
    assert torch.equal(tfs.unpack_rows4(tfw.wqkv), vals.transpose(1, 2))
    assert torch.equal(tfw.sqkv, q4.scale.transpose(1, 2))
    meta = tfs.meta_pack(tt, 4)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(meta, tfw))
    assert tfs.unit_bits(tfw) == 4 and tfs.unit_bytes(tfw) == 0.5
    quantized = tquant.quantize_params(tquant.fuse_params({"m": {"transformer": {
        "layers": layers}}}, modules=("m",)), modules=("m",), bits=4)["m"]["transformer"]
    with pytest.raises(ValueError, match="raw weights"):
        tfs.pack_fused_weights(tt, quantized["layers"], bits=4)
    with pytest.raises(ValueError, match="bits"):
        tfs.pack_fused_weights(tt, layers, bits=2)


def test_int4_pack_refused_where_int8_is_expected(packs):
    """An int4 pack never passes for int8 units: the int8-only entries (the
    launch-per-op sequences) refuse it, naming the units they take; the
    residency and frame gates read its own dtype (the frame gate admits it,
    as JAX's admits its int8-typed int4 units); K1-K7 take it (K4's and
    K6's input check and K5's chain rules pass it)."""
    t, jfw, tt, tfw, _ = packs
    meta = torch.empty((L, 1, NK, 128, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="int4 units: this kernel takes int8 and bf16"):
        tfs._check_cuda_inputs(tfw, meta, meta, True)  # an entry that takes int8 and bf16
    with pytest.raises(NotImplementedError, match="int4"):
        tfs._check_cuda_inputs(tfw, meta, meta)  # the int8-only entries'
    with pytest.raises(ValueError, match="CUDA"):  # K1's, K4's and K6's: past the unit check
        tfs._check_cuda_inputs(tfw, meta, meta, True, int4_units=True)
    heads = tfm.HeadPack(torch.zeros((3, 256, H), dtype=torch.int8), torch.ones((3, 256)))
    tfm._check_chain_units("K5", tfw, heads, torch.float32, True)
    tfm._check_chain_units("K2", tfw, heads, torch.bfloat16, False)
    assert tfm.supports_resident(tfw)  # 2 layers: JAX's int8-typed int4 units pass too
    from leaxer_qwen3_tts_tpu.ops.fused_frame import supports_frame as j_supports_frame
    from leaxer_qwen3_tts_torch.ops.fused_frame import supports_frame

    assert supports_frame(tfw, 256, tt) and j_supports_frame(jfw, 256, t)
    # the plans of int4 rows, one row and batched: K / 2 bytes and K / 128
    # scales a row
    for B in (1, 8, 32):
        plan = persistent.make_plan(tt, 132, batch=B, unit_bytes=0.5)
        for (N, K), r in zip(plan.shapes[:4], plan.stage_rows[:4]):
            assert r * K // 2 <= plan.slot_bytes and r * K // 128 <= plan.slot_rows
    with pytest.raises(ValueError, match="int4"):
        persistent.make_plan(tt, 132, unit_bytes=0.25)


def _cache(T, pos, seed):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((2, L, 1, NK, T, D)) * 0.2).astype(np.float32)
    kv[:, :, :, :, pos:] = 0.0
    return kv


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_k1_int4_matches_jax(packs, cache):
    """K1's plain version on the int4 pack against JAX ``fused_decode_step``
    on its bits=4 pack (interpret mode, T=128, pos 77): x within TOL on a
    float32 cache (every untouched slot bit for bit, the written slot within
    TOL), within X_TOL on an int8 cache (the written slot's values within
    one grid step, every other slot and scale bit for bit)."""
    t, jfw, tt, tfw, _ = packs
    T, pos = 128, 77
    kv = _cache(T, pos, 3)
    x = (np.random.default_rng(4).standard_normal((1, H)) * 0.3).astype(np.float32)
    if cache == "float32":
        jo = jfs.fused_decode_step(t, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                   jnp.asarray(kv[0]), jnp.asarray(kv[1]), interpret=True)
        tk, tv = torch.from_numpy(kv[0].copy()), torch.from_numpy(kv[1].copy())
        to = tfs.fused_decode_step(tt, tfw, torch.from_numpy(x), pos, tk, tv)
        np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), **TOL)
        others = np.arange(T) != pos
        for got, want in ((tk, jo[1]), (tv, jo[2])):
            np.testing.assert_array_equal(got.numpy()[..., others, :],
                                          np.asarray(want)[..., others, :])
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    q, s = jlayers.quantize_kv(jnp.asarray(kv))
    q, s = np.asarray(q), np.asarray(s)
    tq = dataclasses.replace(t, kv_cache_quant=True)
    jo = jfs.fused_decode_step(tq, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                               *map(jnp.asarray, (q[0], q[1], s[0], s[1])), interpret=True)
    caches = [torch.from_numpy(a.copy()) for a in (q[0], q[1], s[0], s[1])]
    to = tfs.fused_decode_step(tcfg.TransformerConfig(**dataclasses.asdict(tq)), tfw,
                               torch.from_numpy(x), pos, *caches)
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), **X_TOL)
    others = np.arange(T) != pos
    for got, want, before in zip(caches, jo[1:], (q[0], q[1], s[0], s[1])):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(got[..., others], want[..., others]) if got.ndim == 4 else (
            np.testing.assert_array_equal(got[..., others, :], want[..., others, :]))
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_int4_gemv_is_per_group(packs):
    """The plain int4 product scales each 128-column group after its own
    dot: equal to the dequantized product in float32 up to its rounding, and
    a weight moved by one step in group g moves the output by h . step *
    scale_g alone."""
    _, _, _, tfw, _ = packs
    h = torch.from_numpy(np.random.default_rng(8).standard_normal((1, H)).astype(np.float32))
    w, s = tfw.wqkv[0], tfw.sqkv[0]
    got = tfs._gemv(h, w, s)
    deq = tfs.unpack_rows4(w).float() * s.repeat_interleave(128, dim=-1)
    want = tfs._bf16(h).double() @ deq.double().t()
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tiny_model, tiny_vocab_files):
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    kw = dict(quantize="int4", max_frames=10, chunk_len=4, first_chunk_len=2)
    j = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path), **kw)
    t = TTSEngine(config=tcfg.TTSModelConfig.from_json(cfg.to_json()), params=_to_torch(params),
                  tokenizer=Tokenizer(vocab_path, merges_path), device="cpu", **kw)
    assert j.is_ready() and t.is_ready(), (j.get_error(), t.get_error())
    return j, t


def test_engine_int4_matches_jax(engines):
    """A greedy request at ``quantize="int4"``: the JAX engine's codes, and
    audio within the fixture's tolerance (the tiny model takes the plain
    path on both sides: ``_dense4`` on int4 transformer products, int8
    heads); a seeded sampled request repeats itself."""
    j, t = engines
    layers = t.params["talker"]["transformer"]["layers"]
    assert isinstance(layers["wqkv"], tquant.QuantizedLinear4)
    assert isinstance(t.params["talker"]["lm_head"], tquant.QuantizedLinear)
    got = t.synthesize("hello world", temperature=0.0, seed=1)
    want = j.synthesize("hello world", temperature=0.0, seed=1)
    np.testing.assert_array_equal(np.asarray(got.codes), np.asarray(want.codes))
    np.testing.assert_allclose(got.audio, want.audio, atol=ATOL)
    a, b = (t.synthesize("hello world", temperature=0.9, seed=3) for _ in range(2))
    np.testing.assert_array_equal(a.codes, b.codes)


def test_int4_refusals(monkeypatch):
    """``quantize="int4"`` on the card: ready with spec_k (K6 / K5 int4) and
    beside every ``mtp_quantize``, at both presets, and its batched decoding
    runs (K4 / K5 int4), with ``frame_fused`` too (K7 int4, anywhere) and
    past 32 rows (the wrappers split the rows into launches): no ROADMAP
    item refuses any of these now.  Readiness is decided before any tensor
    moves: the engine stops only at the missing params."""
    monkeypatch.delenv("QTTS_MTP_STREAM", raising=False)
    monkeypatch.delenv("QTTS_MTP_RESIDENT", raising=False)
    monkeypatch.delenv("QTTS_FRAME_FUSED", raising=False)
    cfg = tcfg.QWEN3_TTS_06B
    for preset in (tcfg.QWEN3_TTS_06B, tcfg.QWEN3_TTS_17B):
        for m in (None, "int8", "auto"):
            spec = TTSEngine(config=preset, params={}, quantize="int4", mtp_quantize=m, spec_k=4,
                             device="cuda")
            assert "ROADMAP" not in spec.get_error() and "code_predictor" in spec.get_error()
    for device in ("cuda", "cpu"):
        ff = TTSEngine(config=cfg, params={}, quantize="int4", frame_fused=True, device=device)
        assert "ROADMAP" not in ff.get_error() and "code_predictor" in ff.get_error()
    ff = TTSEngine(config=cfg, params={}, quantize="int8", mtp_quantize="int4",
                   frame_fused=True, device="cuda")
    assert "ROADMAP" not in ff.get_error() and "code_predictor" in ff.get_error()
    ready = TTSEngine(config=cfg, params={}, quantize="int4", device="cuda")
    assert "ROADMAP" not in ready.get_error() and "code_predictor" in ready.get_error()
    for preset in (tcfg.QWEN3_TTS_06B, tcfg.QWEN3_TTS_17B):
        eng = TTSEngine.__new__(TTSEngine)
        eng.cfg, eng.device, eng._bits = preset, torch.device("cuda"), 4
        eng._ready, eng.spec_k = True, None
        # a batch of 33 passes the engine's checks (it stops at the state
        # this bare engine lacks, not at a row cap)
        with pytest.raises(AttributeError, match="max_frames"):
            list(eng._ids_stream_impl([[1]] * 33, "en", 0.0, 50, 0.95, 8, 0, None))
