"""Chain heads of another type than the trunk (``--mtp-quantize``), int4
trunks in the chains, and bf16 units in the verify kernel (``--spec-k`` at
the default ``quantize``) in the port, on the CPU, against the JAX package:
the plain chains (K2, K3) at an int4 trunk with int8 heads and at int8 /
int4 trunks with bf16 heads against JAX ``fused_mtp_chain`` /
``fused_mtp_chain_streamed`` on the same packs, heads and noise; K6's plain
version on bf16 units against JAX ``fused_verify_step`` at bits=16 on bf16
and int8 caches (its rows the K1 bf16 steps bit for bit); the engine's packs
and chain route against JAX ``resident_pack`` / ``supports_resident`` /
``supports_stream`` at both presets for every ``quantize`` x
``mtp_quantize`` pair, at B=1 and batched; and spec_k beside each."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.models import code_predictor as jcp
from leaxer_qwen3_tts_tpu.models import layers as jlayers
from leaxer_qwen3_tts_tpu.ops import fused_mtp as j_fm
from leaxer_qwen3_tts_tpu.ops import fused_mtp_stream as j_stream
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.ops.fused_verify import fused_verify_step as j_verify
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.ops import fused_mtp as tfm
from leaxer_qwen3_tts_torch.ops import fused_mtp_stream as tstream
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import fused_verify as tfv
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.ops import quant as tquant
from leaxer_qwen3_tts_torch.parallel import make_mesh
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

# sub_sum of one chain: the same table rows summed in the same order
# (test_torch_bf16_units.py); sub-codes equal
SUM_ABS = 1e-5
# K6 at bf16 units against the JAX kernel: test_torch_fused_verify.py's
# bounds (both sides round the same operands to bf16 and sum in float32 in
# other orders; 2 layers let a bf16 rounding flip reach x): x within 1e-2,
# each written slot within 1.6e-2 (an int8 cache: within one grid step, its
# scales within 1e-5 relative), every other slot bit for bit.  On a bf16
# cache the JAX kernel attends the candidates' new slots with their
# unrounded register values where the port reads the cache's bf16 values
# (ROADMAP Queue 3, a standing difference of K1 and K6): x within 2e-2 there.
X_TOL = {"float32": dict(atol=1e-2, rtol=1e-2), "int8": dict(atol=1e-2, rtol=1e-2),
         "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SLOT_ATOL = 1.6e-2
L, NK, D, H = 2, 4, 128, 1024
N, V = 3, 256  # chain steps and sub-code vocabulary (the JAX streamed chain's test shapes)


def _to_torch(tree):
    return params_from_jax(flatten_params(jax.device_get(tree)))


def _trunk_cfg(dtype="float32", I=3072, kvq=False):
    return jcfg.TransformerConfig(hidden_size=H, num_layers=L, num_heads=8, num_kv_heads=NK,
                                  head_dim=D, intermediate_size=I, dtype=dtype,
                                  kv_cache_quant=kvq)


@pytest.fixture(scope="module")
def chain_models():
    """A two-layer MTP trunk, fused, in both packages: raw (heads raw) and
    int8-quantized (heads int8), with seed-made tables."""
    cfg = jcfg.CodePredictorConfig(transformer=_trunk_cfg(), num_steps=N, subcode_vocab_size=V,
                                   max_seq_len=N + 2, impl="fused")
    raw = j_fuse({"code_predictor": jcp.init_code_predictor_params(cfg, jax.random.PRNGKey(0))})
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = tcfg.TransformerConfig(**fields["transformer"])
    tc = tcfg.CodePredictorConfig(**fields)
    traw = tquant.fuse_params(_to_torch(raw))
    tables = (np.random.default_rng(0).standard_normal((N, V, H)) * 0.02).astype(np.float32)
    return cfg, raw["code_predictor"], tc, traw["code_predictor"], tables


def _packs(models, trunk_bits, heads):
    """JAX's and the port's chain packs: the trunk packed from the raw
    weights at ``trunk_bits`` (the engine's mixed-precision pack), the heads
    int8 (``quantize_params`` after packing, JAX int4 mode's int8 heads) or
    raw (bf16 rows: an unquantized talker's heads)."""
    cfg, jraw, tc, traw, tables = models
    jp = jcp.prepare_fused_step(cfg, jraw, bits=trunk_bits)
    tp = tcp.prepare_fused_step(tc, traw, bits=trunk_bits)
    if heads == "int8":
        jp = j_quant({"code_predictor": jp})["code_predictor"]
        tp = tcp.attach_heads(tc, tquant.quantize_params({"code_predictor": tp})[
            "code_predictor"])
    want = torch.int8 if heads == "int8" else torch.bfloat16
    assert tp["fused_heads"].q.dtype == want
    assert tfs.unit_bits(tp["fused_step"]) == trunk_bits
    return jp, tp


def _chain_inputs(seed):
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((1, H)) * 0.5).astype(np.float32)
    c0e = (rng.standard_normal((1, H)) * 0.02).astype(np.float32)
    return hidden, c0e, rng.gumbel(size=(N, 1, V)).astype(np.float32)


@pytest.mark.parametrize("chain,trunk_bits,heads,knobs", [
    ("K2", 4, "int8", (0.0, 50, 0.9)),
    ("K2", 8, "bf16", (1.0, 0, 0.5)),
    ("K2", 4, "bf16", (0.8, 50, 0.95)),
    ("K3", 4, "int8", (0.8, 50, 0.95)),
    ("K3", 8, "bf16", (0.0, 50, 0.9)),
])
def test_chain_matches_jax(chain_models, chain, trunk_bits, heads, knobs):
    """The plain K2 / K3 on an int4 trunk with int8 heads and on int8 / int4
    trunks with bf16 heads against the JAX chain kernel (interpret mode) on
    the same packs, heads and Gumbel noise, greedy and sampled: sub-codes
    equal, sub_sum within SUM_ABS."""
    cfg, _, tc, _, tables = chain_models
    jp, tp = _packs(chain_models, trunk_bits, heads)
    hidden, c0e, gumbel = _chain_inputs(7 + trunk_bits)
    temp, top_k, top_p = knobs
    jfn = j_fm.fused_mtp_chain if chain == "K2" else j_stream.fused_mtp_chain_streamed
    tfn = tfm.fused_mtp_chain if chain == "K2" else tstream.fused_mtp_chain_streamed
    j_subs, j_sum = jfn(
        cfg.transformer, jp["fused_step"], jp["transformer"]["final_norm"], jp["heads"],
        jnp.asarray(tables), jnp.asarray(hidden), jnp.asarray(c0e), jnp.asarray(gumbel),
        jnp.float32(temp), jnp.int32(top_k), jnp.float32(top_p), interpret=True)
    t_subs, t_sum = tfn(
        tc.transformer, tp["fused_step"], tp["transformer"]["final_norm"], tp["fused_heads"],
        torch.from_numpy(tables), torch.from_numpy(hidden), torch.from_numpy(c0e),
        torch.from_numpy(gumbel), temp, top_k, top_p)
    assert t_subs.tolist() == np.asarray(j_subs).tolist()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), atol=SUM_ABS, rtol=0)


def test_chain_units_rules(chain_models):
    """Which chains take which heads: K2, K3 and K5 take int8 or bf16 heads
    beside int8 and int4 trunks; a bf16 trunk takes bf16 heads only, on K3's
    float32 cache (K3, K5; not K2: ROADMAP item K1v-b / K2v)."""
    _, tp8 = _packs(chain_models, 8, "bf16")
    _, tp4 = _packs(chain_models, 4, "int8")
    fw8, h_bf16 = tp8["fused_step"], tp8["fused_heads"]
    fw4, h_int8 = tp4["fused_step"], tp4["fused_heads"]
    for fw, h in ((fw8, h_bf16), (fw8, h_int8), (fw4, h_bf16), (fw4, h_int8)):
        tfm._check_chain_units("K2", fw, h, torch.bfloat16, False)
        tfm._check_chain_units("K3", fw, h, torch.float32, True)
        tfm._check_chain_units("K5", fw, h, torch.bfloat16, True)
    _, tp16 = _packs(chain_models, 16, "bf16")
    tfm._check_chain_units("K5", tp16["fused_step"], tp16["fused_heads"], torch.float32, True)
    with pytest.raises(ValueError, match="float32 cache"):
        tfm._check_chain_units("K5", tp16["fused_step"], tp16["fused_heads"], torch.bfloat16,
                               True)
    with pytest.raises(NotImplementedError, match="ROADMAP item K1v-b / K2v"):
        tfm._check_chain_units("K2", tp16["fused_step"], tp16["fused_heads"], torch.float32,
                               False)
    with pytest.raises(NotImplementedError, match="bf16 heads"):
        tfm._check_chain_units("K3", tp16["fused_step"], h_int8, torch.float32, True)


# ---------------------------------------------------------------------------
# K6 at bf16 units
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def verify_packs():
    t = _trunk_cfg(I=1024)
    params = jlayers.init_transformer_params(t, jax.random.PRNGKey(1))
    tt = tcfg.TransformerConfig(**dataclasses.asdict(t))
    return (t, jfs.pack_fused_weights(t, params["layers"], bits=16), tt,
            tfs.pack_fused_weights(tt, _to_torch(params["layers"]), bits=16))


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_k6_bits16_matches_jax(verify_packs, cache):
    """K6's plain version on the bf16 pack against JAX ``fused_verify_step``
    on its bits=16 pack (interpret mode, S=3 candidates at 62: across a
    split edge) on float32, bf16 and int8 caches: x within X_TOL; every slot but the written ones bit for bit,
    the written ones within SLOT_ATOL (bf16) or one grid step (int8, its
    scales within 1e-5 relative); and each row equals the K1 bf16 steps it
    stands for, bit for bit."""
    t, jfw, tt, tfw = verify_packs
    T, S, start = 128, 3, 62
    rng = np.random.default_rng(11)
    kv = (rng.standard_normal((2, L, 1, NK, T, D)) * 0.2).astype(np.float32)
    kv[..., start:, :] = 0.0
    x = (rng.standard_normal((1, S, H)) * 0.3).astype(np.float32)
    if cache != "int8":
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if cache == "bfloat16" else (
            jnp.float32, torch.float32)
        jin = [jnp.asarray(kv[0]).astype(jdt), jnp.asarray(kv[1]).astype(jdt)]
        tin = [torch.from_numpy(kv[0].copy()).to(tdt), torch.from_numpy(kv[1].copy()).to(tdt)]
        jt, ttt = t, tt
    else:
        q, s = jlayers.quantize_kv(jnp.asarray(kv))
        jin = [jnp.asarray(a) for a in (q[0], q[1], s[0], s[1])]
        tin = [torch.from_numpy(np.asarray(a).copy()) for a in (q[0], q[1], s[0], s[1])]
        jt = dataclasses.replace(t, kv_cache_quant=True)
        ttt = tcfg.TransformerConfig(**dataclasses.asdict(jt))
    before = [a.clone() for a in tin]
    jo = j_verify(jt, jfw, jnp.asarray(x[0]), jnp.asarray(start, jnp.int32), *jin,
                  interpret=True)
    to = tfv.fused_verify_step(ttt, tfw, torch.from_numpy(x), start, *tin)
    np.testing.assert_allclose(to[0].numpy()[0], np.asarray(jo[0]), **X_TOL[cache])
    new = (np.arange(T) >= start) & (np.arange(T) < start + S)
    for got, want in zip(tin, jo[1:]):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        if got.ndim == 5:
            np.testing.assert_array_equal(got[..., ~new, :], want[..., ~new, :])
            bound = 1 if cache == "int8" else SLOT_ATOL
            assert np.abs(got[..., new, :] - want[..., new, :]).max() <= bound
        else:
            np.testing.assert_array_equal(got[..., ~new], want[..., ~new])
            np.testing.assert_allclose(got[..., new], want[..., new], rtol=1e-5, atol=0)
    c1 = [a.clone() for a in before]
    for i in range(S):
        x1 = tfs.fused_decode_step(ttt, tfw, torch.from_numpy(x[0, i : i + 1]), start + i,
                                   *c1)[0]
        assert torch.equal(to[0][0, i : i + 1], x1), i
    assert all(torch.equal(a, b) for a, b in zip(tin, c1))


# ---------------------------------------------------------------------------
# The engine: packs, routes and refusals against JAX's rules
# ---------------------------------------------------------------------------

QUANTIZE = (None, "int8", "int4")
MTP_QUANTIZE = (None, "int8", "int4", "auto")


class _Abstract:
    """A stand-in for an array: the shape, dtype and byte count the JAX
    gates read."""

    def __init__(self, sds):
        self.shape, self.dtype = sds.shape, sds.dtype
        self.size = int(np.prod(sds.shape))
        self.nbytes = self.size * np.dtype(sds.dtype).itemsize


def _jax_pack(t, bits):
    """JAX's pack of ``t`` at ``bits`` with abstract arrays (no memory):
    what the engine's TPU path attaches (from raw weights; int8 from raw
    quantizes the same values)."""
    layers = jax.eval_shape(lambda: jlayers.init_transformer_params(
        dataclasses.replace(t, dtype="bfloat16"), jax.random.PRNGKey(0))["layers"])
    out = jax.eval_shape(lambda p: jfs.pack_fused_weights(t, j_fuse(
        {"talker": {"transformer": {"layers": p}}})["talker"]["transformer"]["layers"],
        bits=bits), layers)
    return jfs.FusedStepWeights(*(_Abstract(a) for a in out))


def _jax_packs(cp, quantize, mtp_quantize):
    """The JAX engine's MTP packs (``api/engine.py:212-303``): the trunk at
    mtp_bits (``quantize``'s unless ``mtp_quantize`` sets it), and under
    "auto" an int4 ``fused_step_alt`` where the trunk is not int4 already."""
    bits = {None: 16, "int8": 8, "int4": 4}[quantize]
    mtp_bits = bits if mtp_quantize in (None, "auto") else {"int8": 8, "int4": 4}[mtp_quantize]
    packs = {"fused_step": _jax_pack(cp.transformer, mtp_bits)}
    if mtp_quantize == "auto" and mtp_bits != 4:
        packs["fused_step_alt"] = _jax_pack(cp.transformer, 4)
    return packs


@pytest.fixture(scope="module")
def jax_packs():
    out = {}
    for name, preset in (("0.6B", jcfg.QWEN3_TTS_06B), ("1.7B", jcfg.QWEN3_TTS_17B)):
        cache = {}
        for q, m in itertools.product(QUANTIZE, MTP_QUANTIZE):
            bits = {None: 16, "int8": 8, "int4": 4}[q]
            mb = bits if m in (None, "auto") else {"int8": 8, "int4": 4}[m]
            key = (mb, m == "auto" and mb != 4)
            if key not in cache:
                cache[key] = _jax_packs(preset.code_predictor, q, m)
            out[name, q, m] = cache[key]
    return out


@pytest.mark.parametrize("preset", ["0.6B", "1.7B"])
def test_engine_packs_and_route_match_jax(jax_packs, preset, monkeypatch):
    """For every ``quantize`` x ``mtp_quantize`` pair at both presets' full
    widths: the port engine's MTP packs (decided on the meta device) have
    JAX's unit types, bytes and alt trunk; its B=1 chain is K2 exactly where
    JAX ``resident_pack(params, 1)`` gives a pack, on that pack (primary or
    alt), else K3 where JAX ``supports_stream`` passes the primary; its
    batched chain at 2..32 rows is K5 on the pack JAX's ``resident_pack``
    gives at that batch (the primary where none passes), on K3's float32
    cache where the B=1 chain is K3 or the trunk is bf16, and its plan
    fits."""
    monkeypatch.delenv("QTTS_MTP_STREAM", raising=False)
    monkeypatch.delenv("QTTS_MTP_RESIDENT", raising=False)
    cfg = tcfg.QWEN3_TTS_06B if preset == "0.6B" else tcfg.QWEN3_TTS_17B
    jcfg_ = jcfg.QWEN3_TTS_06B if preset == "0.6B" else jcfg.QWEN3_TTS_17B
    cp = cfg.code_predictor
    routes = {}
    for q, m in itertools.product(QUANTIZE, MTP_QUANTIZE):
        eng = TTSEngine(config=cfg, params={}, quantize=q, mtp_quantize=m, device="cuda")
        assert "ROADMAP" not in eng.get_error(), (q, m, eng.get_error())
        # the MTP packs the engine builds, on the meta device
        packs = {"fused_step": tfs.meta_pack(cp.transformer, eng._mtp_bits or eng._bits)}
        if eng._mtp_alt:
            packs["fused_step_alt"] = tfs.meta_pack(cp.transformer, 4)
        jp = jax_packs[preset, q, m]
        assert set(packs) == set(jp), (q, m)
        for k in packs:
            assert tfm.trunk_bytes(packs[k]) == jp[k].units.nbytes, (q, m, k)
            assert tfm.supports_resident(packs[k]) == j_fm.supports_resident(jp[k]), (q, m, k)
        chain = tcp.chain_kernel(cp, packs, 1)
        jres = jcp.resident_pack(jp, 1)
        if jres is not None:
            which = [k for k in jp if jp[k] is jres][0]
            assert chain is tfm.fused_mtp_chain and tcp.chain_pack(packs, chain) is packs[which]
        else:
            assert j_stream.supports_stream(jp["fused_step"], cp.num_steps,
                                            cp.subcode_vocab_size)
            assert chain is tstream.fused_mtp_chain_streamed
            assert tcp.chain_pack(packs, chain) is packs["fused_step"]
        routes[q, m] = (chain.__name__, tcp.chain_pack(packs, chain).wqkv.dtype)
        k3_scratch = jres is None  # the B=1 chain is K3, on its float32 scratch
        for rows in (2, 16, 32):
            assert tcp.chain_kernel(cp, packs, rows) is tfm.fused_mtp_chain_batched
            jpack = jcp.resident_pack(jp, rows)
            which = [k for k in jp if jp[k] is jpack][0] if jpack is not None else "fused_step"
            fw = tcp.chain_pack(packs, tfm.fused_mtp_chain_batched, rows)
            assert fw is packs[which], (q, m, rows)
            want = torch.float32 if k3_scratch or fw.wqkv.dtype == torch.bfloat16 else (
                cp.transformer.torch_dtype)
            assert tcp.chain_cache_dtype(cp, packs, fw) == want, (q, m, rows)
            # K5's plan at these rows and heads, 1.7B bf16 included (B17)
            heads = 2 if q is None else 1
            plan = persistent.make_plan(cp.transformer, 132, head_rows=cp.subcode_vocab_size,
                                        batch=rows, unit_bytes=tfs.unit_bytes(fw),
                                        head_bytes=heads)
            assert plan.smem_bytes + persistent.STATIC_SMEM <= persistent.SMEM_PER_BLOCK
    # the issue's expected routes: 0.6B int4 trunks on K2, 1.7B ones on K3;
    # an unquantized talker under "auto" takes the int4 alt at 0.6B
    if preset == "0.6B":
        assert routes["int4", None] == ("fused_mtp_chain", torch.uint8)
        assert routes[None, "auto"] == ("fused_mtp_chain", torch.uint8)
        assert routes[None, "int8"] == ("fused_mtp_chain", torch.int8)
    else:
        assert routes["int4", None] == ("fused_mtp_chain_streamed", torch.uint8)
        assert routes[None, "auto"] == ("fused_mtp_chain_streamed", torch.bfloat16)


def test_mixed_precision_refusals(monkeypatch):
    """The mixed flags on the card: ``spec_k`` beside every MTP trunk and at
    both presets is ready (decided before any tensor moves: the engine stops
    only at the missing params), bf16 units at the 1.7B widths included
    (B17 done); a mesh engine with a data axis stops only at the params too
    (M15 done)."""
    monkeypatch.delenv("QTTS_MTP_STREAM", raising=False)
    monkeypatch.delenv("QTTS_MTP_RESIDENT", raising=False)
    for cfg in (tcfg.QWEN3_TTS_06B, tcfg.QWEN3_TTS_17B):
        for q, m in itertools.product((None, "int8", "int4"), (None, "int8", "int4", "auto")):
            spec = TTSEngine(config=cfg, params={}, quantize=q, mtp_quantize=m, spec_k=4,
                             device="cuda")
            assert "ROADMAP" not in spec.get_error(), (q, m, spec.get_error())
            assert "code_predictor" in spec.get_error()
    cards = [torch.device("cuda", 0)] * 4
    for cfg in (tcfg.QWEN3_TTS_06B, tcfg.QWEN3_TTS_17B):
        meshed = TTSEngine(config=cfg, params={}, mesh=make_mesh(2, 2, devices=cards), spec_k=4)
        assert "ROADMAP" not in meshed.get_error() and "talker" in meshed.get_error()