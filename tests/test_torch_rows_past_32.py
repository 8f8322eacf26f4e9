"""Calls of kernels K4, K5 and K6 past the rows one launch takes, on the
CPU: each wrapper splits its rows into ``persistent.row_launches``
launches of nearly equal size in row order (K6 by whole streams), above
the device dispatch, so the plain versions run the same split here.  With
the per-launch limit (``persistent.LAUNCH_ROWS``, 32 on the card) lowered
to 4: the wrappers at 6 rows (K6: 3 streams x 2 candidates) on float32 and
int8 caches, ``synthesize_batch`` at B=6 (int8 cache included), a pool of 6
slots and spec at B=3 x k=2 each go through the split and equal the
unsplit run bit for bit; the split kernel-width batched loop equals the JAX
loop at the same B (greedy frames exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.models import talker as ttalker
from leaxer_qwen3_tts_torch.models.layers import init_transformer_params, quantize_kv
from leaxer_qwen3_tts_torch.ops import fused_mtp as tfm
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import fused_verify as tfv
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params, quantize_weight
from leaxer_qwen3_tts_torch.serve import ContinuousBatcher
from test_torch_voice import _kernel_width

torch.set_num_threads(2)

LIMIT = 4  # rows a launch takes in these tests
T = 32  # cache slots of the wrapper cases
H = 1024
TEXTS = ["hello world", "hello", "a quick test", "world", "hello hello", "the last"]


@pytest.fixture
def limit(monkeypatch):
    """The per-launch row limit lowered to LIMIT; returns a setter (restore
    the card's with ``limit(persistent.MAX_BATCH)``)."""
    monkeypatch.setattr(persistent, "LAUNCH_ROWS", LIMIT)
    return lambda n: monkeypatch.setattr(persistent, "LAUNCH_ROWS", n)


def _counted(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a plain version: one per launch)."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


def test_row_launches(monkeypatch):
    """ceil(B / s) launches of nearly equal size in row order, s the streams
    whose rows fit in a launch: B=40 is 20 + 20 (not 32 + 8), B=48 24 + 24,
    B=34 17 + 17; K6's 12 streams x 4 candidates 6 + 6 streams; at most the
    limit's rows one launch of every row; a stream wider than a launch
    raises."""
    rl = persistent.row_launches
    assert rl(40) == ((0, 20), (20, 20)) and rl(48) == ((0, 24), (24, 24))
    assert rl(34) == ((0, 17), (17, 17)) and rl(33) == ((0, 16), (16, 17))
    assert rl(32) == ((0, 32),) and rl(1) == ((0, 1),) and rl(64) == ((0, 32), (32, 32))
    assert rl(12, 4) == ((0, 6), (6, 6)) and rl(8, 4) == ((0, 8),) and rl(10, 4) == ((0, 5), (5, 5))
    monkeypatch.setattr(persistent, "LAUNCH_ROWS", LIMIT)
    assert rl(6) == ((0, 3), (3, 3)) and rl(3, 2) == ((0, 1), (1, 2)) and rl(4) == ((0, 4),)
    with pytest.raises(ValueError, match="a launch takes 4"):
        rl(2, 5)


def _trunk():
    """A random one-layer int8 pack at H=1024 (the packs' least width) and
    its config."""
    t = tcfg.TransformerConfig(hidden_size=H, num_layers=1, num_heads=8, num_kv_heads=4,
                               head_dim=128, intermediate_size=1024, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    layers = quantize_params(fuse_params({"m": {"transformer": init_transformer_params(
        t, gen, "cpu")}}, modules=("m",)), modules=("m",))["m"]["transformer"]["layers"]
    return t, tfs.pack_fused_weights(t, layers)


def _caches(t, B, cache, seed):
    """Random [L, B, nk, T, d] k and v caches (int8: on quantize_kv's grid,
    with their scales)."""
    g = torch.Generator().manual_seed(seed)
    kv = [torch.randn((t.num_layers, B, t.num_kv_heads, T, t.head_dim), generator=g) * 0.5
          for _ in range(2)]
    if cache == "int8":
        (kq, ks), (vq, vs) = (quantize_kv(c) for c in kv)
        return [kq, vq, ks, vs]
    return kv


def _both(limit, fn, caches):
    """``fn(caches)`` under the lowered limit and under the card's, each on
    its own copy of the caches: (outputs, caches) of each."""
    runs = []
    for n in (LIMIT, persistent.MAX_BATCH):
        limit(n)
        c = [x.clone() for x in caches]
        runs.append((fn(c), c))
    return runs


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_k4_split_equals_unsplit(limit, monkeypatch, cache):
    """K4 at 6 rows (per-row positions) in two launches of 3 rows, on cache
    rows 0-2 and 3-5 of the one cache: x and every cache row (and scale)
    equal the one-launch step's bit for bit."""
    t, fw = _trunk()
    x = torch.randn((6, H), generator=torch.Generator().manual_seed(1)) * 0.3
    pos = torch.tensor([0, 5, 31, 12, 40, 7])
    calls = _counted(monkeypatch, tfs, "fused_decode_step_batched_reference")
    (a, ca), (b, cb) = _both(limit, lambda c: tfs.fused_decode_step_batched(t, fw, x, pos, *c)[0],
                             _caches(t, 6, cache, 2))
    assert len(calls) == 3  # two launches, then one
    assert torch.equal(a, b) and all(torch.equal(p, q) for p, q in zip(ca, cb))


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_k6_split_equals_unsplit(limit, monkeypatch, cache):
    """K6 at 3 streams x 2 candidates in launches of whole streams (1, then
    2): x and every cache row equal the one-launch pass's bit for bit."""
    t, fw = _trunk()
    x = torch.randn((3, 2, H), generator=torch.Generator().manual_seed(3)) * 0.3
    starts = torch.tensor([4, 30, 11])
    calls = _counted(monkeypatch, tfv, "fused_verify_step_reference")
    (a, ca), (b, cb) = _both(limit, lambda c: tfv.fused_verify_step(t, fw, x, starts, *c)[0],
                             _caches(t, 3, cache, 4))
    assert len(calls) == 3
    assert torch.equal(a, b) and all(torch.equal(p, q) for p, q in zip(ca, cb))


def test_k5_split_equals_unsplit(limit, monkeypatch):
    """K5 at 6 rows with per-row knobs in two launches of 3 rows, each on
    its rows' inputs, knobs and the slice [:, rows] of the noise: sub-codes
    and sub_sum equal the one-launch chain's bit for bit."""
    t, fw = _trunk()
    n, V, B = 3, 64, 6
    g = torch.Generator().manual_seed(5)
    heads = tfm.pack_heads(quantize_weight(torch.randn((n, H, V), generator=g) * H ** -0.5))
    tables = torch.randn((n, V, H), generator=g) * 0.02
    lh, c0 = torch.randn((B, H), generator=g) * 0.5, torch.randn((B, H), generator=g) * 0.02
    noise = -torch.log(-torch.log(torch.rand((n, B, V), generator=g).clamp(1e-9, 1 - 1e-9)))
    knobs = [(0.0, 50, 0.9), (0.8, 50, 0.95), (1.0, 0, 1.0), (0.7, 1, 0.9), (0.9, 10, 0.5),
             (0.0, 1, 1.0)]
    fnorm = torch.ones(H)
    calls = _counted(monkeypatch, tfm, "fused_mtp_chain_batched_reference")
    (a, _), (b, _) = _both(limit, lambda c: tfm.fused_mtp_chain_batched(
        t, fw, fnorm, heads, tables, lh, c0, noise, *map(list, zip(*knobs))), [])
    assert len(calls) == 3
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_synthesize_batch_split_equals_unsplit(tiny_vocab_files, limit, monkeypatch, kv_quant):
    """``synthesize_batch`` of 6 streams on the kernel-width engine (int8
    units; with ``kv_quant`` its int8 cache): every decoded frame's K4 and
    K5 run as two launches of 3 rows, and every stream's codes and audio
    equal the unsplit batch's bit for bit."""
    tc, params, tok = _kernel_width(tiny_vocab_files)
    eng = TTSEngine(config=tc, params=params, tokenizer=tok, quantize="int8", device="cpu",
                    max_frames=6, chunk_len=2, first_chunk_len=2, kv_quant=kv_quant)
    k4 = _counted(monkeypatch, tfs, "fused_decode_step_batched_reference")
    runs = []
    for n in (LIMIT, persistent.MAX_BATCH):
        limit(n)
        k4.clear()
        runs.append(eng.synthesize_batch(TEXTS, temperature=0.8, top_k=50, top_p=0.95,
                                         seed=list(range(6)), max_tokens=4))
        assert len(k4) == (2 if n == LIMIT else 1) * runs[-1][0].metrics.decoded_frames
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.audio, b.audio)


def test_pool_split_equals_unsplit(tiny_vocab_files, limit, monkeypatch):
    """A pool of 6 slots (K4 and K5 in two launches of 3 rows a frame)
    serves the same seeded requests, sampled and greedy, as the unsplit
    pool: every request's codes equal bit for bit."""
    tc, params, tok = _kernel_width(tiny_vocab_files)
    eng = TTSEngine(config=tc, params=params, tokenizer=tok, quantize="int8", device="cpu",
                    max_frames=6)
    k5 = _counted(monkeypatch, tfm, "fused_mtp_chain_batched_reference")
    runs = []
    for n in (LIMIT, persistent.MAX_BATCH):
        limit(n)
        pool = ContinuousBatcher(eng, pool_size=6, chunk_len=2, kv_bucket=64)
        try:
            futs = [pool.submit(text, temperature=0.0 if i % 3 == 0 else 0.8, seed=i,
                                max_tokens=4) for i, text in enumerate(TEXTS)]
            runs.append([f.result(timeout=300) for f in futs])
        finally:
            pool.shutdown()
        if n == LIMIT:
            assert k5 and len(k5) % 2 == 0  # two launches a pooled frame
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.codes, b.codes)


def test_spec_split_equals_unsplit(tiny_vocab_files, limit, monkeypatch):
    """Spec at B=3 x k=2 (6 verify rows): K6 in launches of whole streams (1,
    then 2) and K5 on the candidates' 6 rows in two launches of 3; every
    stream's codes and audio equal the unsplit run's bit for bit."""
    # the 15-step chain the verify loop's 16 codebooks assume
    tc, params, tok = _kernel_width(tiny_vocab_files, num_steps=15, max_seq_len=17)
    eng = TTSEngine(config=tc, params=params, tokenizer=tok, quantize="int8", device="cpu",
                    max_frames=6, spec_k=2, spec_iters=1, spec_accept_floor=0.0)
    k6 = _counted(monkeypatch, tfv, "fused_verify_step_reference")
    runs = []
    for n in (LIMIT, persistent.MAX_BATCH):
        limit(n)
        k6.clear()
        runs.append(eng.synthesize_batch(TEXTS[:3], temperature=0.0, max_tokens=5))
        its = runs[-1][0].metrics.spec_iterations
        assert its > 0 and len(k6) == (2 if n == LIMIT else 1) * its
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.audio, b.audio)


def test_split_batched_loop_matches_jax(limit, monkeypatch):
    """The kernel-width batched loop at B=6 with per-row fill, its K4 and K5
    split into two launches of 3 rows, against the JAX loop at B=6 (its
    batched Pallas kernels in interpret mode): greedy frames equal."""
    from test_torch_slice import _kernel_width_cfg

    from leaxer_qwen3_tts_tpu.models.code_predictor import prepare_fused_step as j_prep_cp
    from leaxer_qwen3_tts_tpu.models.talker import prepare_fused_talker as j_prep_talker
    from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
    from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns as j_make
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP
    from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init
    from leaxer_qwen3_tts_torch.runtime.generate import make_generate_fns
    from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams
    from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

    cfg = _kernel_width_cfg()
    raw = j_init(cfg, jax.random.PRNGKey(0))
    jp = j_quant(j_fuse(raw))
    jp["code_predictor"] = j_prep_cp(cfg.code_predictor, jp["code_predictor"])
    jp["talker"] = j_prep_talker(cfg.talker, jp["talker"])
    ids = np.array([[5, 6, 7, 8], [9, 10, 0, 0], [11, 0, 0, 0], [5, 9, 6, 0], [12, 13, 14, 15],
                    [7, 8, 0, 0]], np.int32)
    lens = np.array([4, 2, 1, 3, 4, 2], np.int32)
    jfns = j_make(cfg, batch=6, max_len=64, chunk_len=2, donate=False, uniform_fill=False)
    st, bd = jfns.prefill(jp, jnp.asarray(ids), jnp.asarray(lens), jax.random.PRNGKey(1))
    _, jframes, _ = jfns.decode(jp, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed,
                                JSP.create(temperature=0.0))

    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = quantize_params(fuse_params(params_from_jax(flatten_params(jax.device_get(raw)))))
    tp["code_predictor"] = tcp.prepare_fused_step(tc.code_predictor, tp["code_predictor"])
    tp["talker"] = ttalker.prepare_fused_talker(tc.talker, tp["talker"])
    tfns = make_generate_fns(tc, batch=6, max_len=64, chunk_len=2, uniform_fill=False)
    state, bundle = tfns.prefill(tp, torch.from_numpy(ids).long(), torch.from_numpy(lens))
    state = state._replace(cache=state.cache._replace(length=state.pos.clone()))  # per-row fill
    k4 = _counted(monkeypatch, tfs, "fused_decode_step_batched_reference")
    k5 = _counted(monkeypatch, tfm, "fused_mtp_chain_batched_reference")
    _, tframes, _ = tfns.decode(tp, state, bundle.trailing, bundle.trailing_len,
                                bundle.tts_pad_embed, SamplingParams.create(0.0))
    assert len(k4) == len(k5) == 2 * 2  # two frames, two launches each
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
