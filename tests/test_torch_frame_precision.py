"""Kernel K7 (the whole-frame step) at every unit mix the JAX frame kernel
takes, on the CPU: its plain version at int4 talker and trunk units, and at
a bf16 talker (raw lm_head and heads, bf16 rows) beside an int8 or int4
trunk, against JAX ``fused_frame_step`` in interpret mode on JAX's own packs
of the same raw weights (an int8-cache case among them); the port's
``supports_frame`` against JAX's at bits 4, 8 and 16; the frame plans of
each mix (per-set stage rows and scale floats) beside the one-row plans of
K1-K3, which this change leaves byte for byte as they were; and the engine's
repaired frame gate (``frame_fused_frames == decoded_frames`` at
``quantize=None`` beside ``mtp_quantize="int8"``, and at ``quantize="int4"``).

The JAX unit pack takes H in multiples of 1024, so the kernel cases run at
tests/test_fused_frame.py's widths (H=1024, two layers, 4 chain steps over
256 sub-codes), eight 128-column int4 groups a row."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.models import layers as jlayers
from leaxer_qwen3_tts_tpu.models.code_predictor import init_code_predictor_params
from leaxer_qwen3_tts_tpu.models.talker import init_talker_params
from leaxer_qwen3_tts_tpu.ops import fused_frame as j_ff
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.ops import fused_frame as tff
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.ops.fused_mtp import pack_heads
from leaxer_qwen3_tts_torch.ops.fused_step import pack_fused_weights
from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params
from leaxer_qwen3_tts_torch.runtime import generate as tgen
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from test_torch_fused_frame import H, N_STEPS, V, VC, _frame_inputs
from test_torch_voice import _kernel_width

torch.set_num_threads(2)

BITS = {"int4": 4, "int8": 8, "bf16": 16}
# hidden and logits: both packages round the same operands to bf16 and sum
# in float32 in other orders, so a GEMV input on a bf16 rounding edge can
# flip by one bf16 ulp (2^-8 relative) and move later layers' values by a
# few 1e-3 (measured: 4.0e-3 at the bf16 talker; the batched int4 rows of
# tests/test_torch_batched_precision.py: up to 3.3e-3 relative);
# tests/test_torch_int4.py's X_TOL
MIX_TOL = dict(atol=1e-2, rtol=1e-2)
SLOT_ABS = 1.6e-2  # the written cache slot: 2 bf16 ulps (tests/test_torch_bf16_units.py)


@pytest.fixture(scope="module")
def mix_models():
    """tests/test_fused_frame.py's two-layer talker and trunk (float32,
    H=1024) packed at every unit type in both packages from the same raw
    weights, as the engines pack them: int8 units from the int8-quantized
    layers, int4 and bf16 units from the raw ones; the lm_head and heads
    int8 (quantized) and raw (the JAX kernel casts them to bf16; the port
    packs them as bf16 rows with scales of one)."""
    tt = jcfg.TransformerConfig(hidden_size=H, num_layers=2, num_heads=8, num_kv_heads=4,
                                head_dim=128, intermediate_size=1024, dtype="float32")
    jt = jcfg.TalkerConfig(transformer=tt, codec_vocab_size=VC, text_vocab_size=152000,
                           decode_impl="fused")
    jm = jcfg.CodePredictorConfig(transformer=tt, num_steps=N_STEPS, subcode_vocab_size=V,
                                  max_seq_len=N_STEPS + 2, impl="fused")
    raw = {"talker": init_talker_params(jt, jax.random.PRNGKey(0)),
           "code_predictor": init_code_predictor_params(jm, jax.random.PRNGKey(1))}
    jf = j_fuse(raw)
    jq = j_quant(jf)
    tc = tcfg.TransformerConfig(**dataclasses.asdict(tt))
    tf = fuse_params(params_from_jax(flatten_params(jax.device_get(raw))))
    tq = quantize_params(tf)
    packs = {}
    for m in ("talker", "code_predictor"):
        for units, bits in BITS.items():
            jsrc, tsrc = (jq, tq) if units == "int8" else (jf, tf)
            packs[m, units] = (
                jfs.pack_fused_weights(tt, jsrc[m]["transformer"]["layers"], bits=bits),
                pack_fused_weights(tc, tsrc[m]["transformer"]["layers"], bits=bits))
    heads = {("lm", "int8"): (jq["talker"]["lm_head"], pack_heads(tq["talker"]["lm_head"])),
             ("lm", "raw"): (jf["talker"]["lm_head"], pack_heads(tf["talker"]["lm_head"])),
             ("heads", "int8"): (jq["code_predictor"]["heads"],
                                 pack_heads(tq["code_predictor"]["heads"])),
             ("heads", "raw"): (jf["code_predictor"]["heads"],
                                pack_heads(tf["code_predictor"]["heads"]))}
    norms = {m: (jf[m]["transformer"]["final_norm"], tf[m]["transformer"]["final_norm"])
             for m in ("talker", "code_predictor")}
    rng = np.random.default_rng(0)
    codec = (rng.standard_normal((VC, H)) * 0.02).astype(np.float32)
    tables = (rng.standard_normal((N_STEPS, V, H)) * 0.02).astype(np.float32)
    return tt, tc, packs, heads, norms, codec, tables


def _args(mix_models, talker, trunk):
    """Both packages' first ten frame arguments at this unit mix: the lm_head
    and heads raw beside a bf16 talker (quantize=None), else int8."""
    tt, tc, packs, heads, norms, codec, tables = mix_models
    rows = "raw" if talker == "bf16" else "int8"
    j = (tt, tt, packs["talker", talker][0], norms["talker"][0], heads["lm", rows][0],
         jnp.asarray(codec), packs["code_predictor", trunk][0], norms["code_predictor"][0],
         heads["heads", rows][0], jnp.asarray(tables))
    port = dict(tcfg=tc, mcfg=tc, tfw=packs["talker", talker][1],
                talker_fnorm=norms["talker"][1], lm_head=heads["lm", rows][1],
                codec_table=torch.from_numpy(codec), mfw=packs["code_predictor", trunk][1],
                mtp_fnorm=norms["code_predictor"][1], heads=heads["heads", rows][1],
                tables=torch.from_numpy(tables))
    return j, port


@pytest.mark.parametrize("talker,trunk,kvq,knobs,pos", [
    ("int4", "int4", False, (0.8, 50, 0.9), 7),
    ("bf16", "int8", False, (0.8, 50, 0.9), 40),
    ("bf16", "int4", False, (0.0, 50, 0.9), 21),
    ("int4", "int4", True, (0.8, 50, 0.9), 100),
])
def test_frame_mix_plain_matches_jax(mix_models, talker, trunk, kvq, knobs, pos):
    """The plain version at this unit mix against JAX ``fused_frame_step``
    (interpret) on the same raw weights, inputs and noise, EOS forbidden:
    code0 and sub-codes exact; hidden and logits within MIX_TOL; every slot
    but the written one untouched on both sides, the written slot within
    SLOT_ABS (float32 caches) or (``kvq``, an int8 talker cache beside a
    float32 chain cache) its int8 values within one step and its scales
    within MIX_TOL."""
    j, port = _args(mix_models, talker, trunk)
    assert port["tfw"].wqkv.dtype == {"int4": torch.uint8, "bf16": torch.bfloat16}[talker]
    assert port["lm_head"].q.dtype == port["heads"].q.dtype == (
        torch.bfloat16 if talker == "bf16" else torch.int8)
    T = 128 if kvq else 64
    ll, sup, lh, drip, kc, vc, g0, gm = _frame_inputs(pos, T)
    kc[:, :, :, pos:] = 0
    vc[:, :, :, pos:] = 0
    extra, caches = {}, [kc, vc]
    if kvq:
        q, s = (np.asarray(a) for a in zip(*(jlayers.quantize_kv(jnp.asarray(c))
                                                 for c in (kc, vc))))
        caches = [q[0], q[1], s[0], s[1]]
        extra = dict(k_scale=jnp.asarray(s[0]), v_scale=jnp.asarray(s[1]))
    temp, top_k, top_p = knobs
    jo = j_ff.fused_frame_step(
        *j, jnp.asarray(ll), jnp.asarray(lh), jnp.asarray(sup), jnp.asarray(drip),
        jnp.int32(pos), jnp.asarray(caches[0]), jnp.asarray(caches[1]), jnp.asarray(g0),
        jnp.asarray(gm), jnp.float32(temp), jnp.int32(top_k), jnp.float32(top_p),
        jnp.bool_(True), interpret=True, **extra)
    tc = [torch.from_numpy(c.copy()) for c in caches]
    to = tff.fused_frame_step(
        **port, last_logits=torch.from_numpy(ll), last_hidden=torch.from_numpy(lh),
        suppress=torch.from_numpy(sup), drip=torch.from_numpy(drip), pos=pos, k_cache=tc[0],
        v_cache=tc[1], g0=torch.from_numpy(g0), gumbel=torch.from_numpy(gm), temperature=temp,
        top_k=top_k, top_p=top_p, forbid_eos=True,
        **dict(zip(("k_scale", "v_scale"), tc[2:])))
    assert to[0].tolist() == np.asarray(jo[0]).tolist() and to[0].item() != tcfg.CODEC_EOS
    assert to[1].tolist() == np.asarray(jo[1]).tolist()
    np.testing.assert_allclose(to[3].numpy(), np.asarray(jo[3]), **MIX_TOL)
    np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), **MIX_TOL)
    for got, want, before in zip(tc, jo[4:], caches):
        got, want = got.numpy(), np.asarray(want)
        other = np.ones(got.shape, bool)
        other[:, :, :, pos] = False
        np.testing.assert_array_equal(got[other], before[other])
        np.testing.assert_array_equal(want[other], before[other])
        if got.dtype == np.int8:
            assert np.abs(got[:, :, :, pos].astype(int) - want[:, :, :, pos]).max() <= 1
        elif kvq:  # the slot's scales
            np.testing.assert_allclose(got[:, :, :, pos], want[:, :, :, pos], **MIX_TOL)
        else:
            np.testing.assert_allclose(got[:, :, :, pos], want[:, :, :, pos], atol=SLOT_ABS)


@pytest.mark.parametrize("units", ["int4", "int8", "bf16"])
def test_supports_frame_units_match_jax(mix_models, units):
    """The port's frame gate against JAX's on packs of the same raw trunk at
    bits 4, 8 and 16: the int4 and int8 trunks pass (JAX's int4 units are
    int8-typed, the port's uint8 pairs), the bf16 one does not, at the
    buckets and int8-cache alignments tests/test_fused_frame.py gates."""
    tt, tc, packs, *_ = mix_models
    jfw, tfw = packs["code_predictor", units]
    for T, kvq in ((512, False), (1024, False), (1000, False), (96, True), (128, True)):
        want = j_ff.supports_frame(jfw, T, tt, kvq=kvq)
        assert tff.supports_frame(tfw, T, tc, kvq=kvq) is want
        assert want is (units != "bf16" and T != 1000 and T != 96)


# sha256 of every field of the one-row plans (and the int8 frame plan) as
# they came out before the frame's plans took a unit type per weight set:
# (preset, plan, unit bytes, head bytes) -> the digest's first 16 digits
PLANS_BEFORE = {
    ("QWEN3_TTS_06B", "step", 1, 0): "0d9b984d5a7dcded",
    ("QWEN3_TTS_06B", "step", 2, 0): "f6fc0efe2e2a3bdc",
    ("QWEN3_TTS_06B", "step", 0.5, 0): "5fcd3a366bdd30eb",
    ("QWEN3_TTS_06B", "chain", 1, 0): "27f2d9a7dcfd1840",
    ("QWEN3_TTS_06B", "chain", 1, 1): "aebe7b5acc8d03b9",
    ("QWEN3_TTS_06B", "chain", 1, 2): "b17f0f583249de18",
    ("QWEN3_TTS_06B", "chain", 2, 0): "d182bdf707d876a1",
    ("QWEN3_TTS_06B", "chain", 2, 1): "f789b9a455f099cf",
    ("QWEN3_TTS_06B", "chain", 2, 2): "dd1c136a880ec54b",
    ("QWEN3_TTS_06B", "chain", 0.5, 0): "fa132b94972cad57",
    ("QWEN3_TTS_06B", "chain", 0.5, 1): "91da635e775d0aff",
    ("QWEN3_TTS_06B", "chain", 0.5, 2): "02f7432b9d3ebe0e",
    ("QWEN3_TTS_06B", "frame", 1, 0): "5c9aa0e4b6845027",
    ("QWEN3_TTS_17B", "step", 1, 0): "2473bb4f1198a2a7",
    ("QWEN3_TTS_17B", "step", 2, 0): "ab7ca443a06cf78b",
    ("QWEN3_TTS_17B", "step", 0.5, 0): "9545dfbd5639827d",
    ("QWEN3_TTS_17B", "chain", 1, 0): "2c6da5f09e1090c1",
    ("QWEN3_TTS_17B", "chain", 1, 1): "15764b52c16b9e4b",
    ("QWEN3_TTS_17B", "chain", 1, 2): "561518f3b1541ddf",
    ("QWEN3_TTS_17B", "chain", 2, 0): "4770e1120d8dbfb7",
    ("QWEN3_TTS_17B", "chain", 2, 1): "b23f008f1fe7b427",
    ("QWEN3_TTS_17B", "chain", 2, 2): "9b453d58d7636fa6",
    ("QWEN3_TTS_17B", "chain", 0.5, 0): "43085bf2efaadabc",
    ("QWEN3_TTS_17B", "chain", 0.5, 1): "bdce05e78f5ae3f7",
    ("QWEN3_TTS_17B", "chain", 0.5, 2): "939426b4f4407c40",
    ("QWEN3_TTS_17B", "frame", 1, 0): "9183077769c8b867",
}


@pytest.mark.parametrize("preset", ["QWEN3_TTS_06B", "QWEN3_TTS_17B"])
def test_one_row_plans_unchanged(preset):
    """The one-row plans of K1 (step), K2 / K3 (chain; heads of the trunk's
    type, int8 or bf16) at every unit type, and the int8 frame's, on 132
    SMs: every field as before, byte for byte (the per-set unit type of the
    frame's plans adds a field, zero on these)."""
    cfg = getattr(tcfg, preset)
    t, m = cfg.talker.transformer, cfg.code_predictor.transformer
    V, Vc = cfg.code_predictor.subcode_vocab_size, cfg.talker.codec_vocab_size
    for (name, kind, ub, hb), want in PLANS_BEFORE.items():
        if name != preset:
            continue
        if kind == "step":
            plan = persistent.make_plan(t, 132, unit_bytes=ub)
        elif kind == "chain":
            plan = persistent.make_plan(m, 132, head_rows=V, unit_bytes=ub, head_bytes=hb)
        else:
            plan = persistent.make_plan(m, 132, head_rows=V, talker=t, lm_rows=Vc)
        assert plan.talker_bytes == 0
        got = hashlib.sha256(repr(tuple(plan)[:-1]).encode()).hexdigest()[:16]
        assert got == want, (name, kind, ub, hb)


MIXES = [("int4", "int4"), ("int8", "int4"), ("int4", "int8"), ("bf16", "int8"),
         ("bf16", "int4")]


@pytest.mark.parametrize("talker,trunk", MIXES)
def test_frame_plans_per_set(talker, trunk):
    """The 0.6B frame plan at each unit mix (132 SMs): each kind's stage
    rows fill a slot with rows of its own set's bytes (int4: K / 2 bytes
    and K / 128 scale floats a row; bf16: 2K; the lm_head bf16 beside a
    bf16 talker, the chain heads likewise), every stage within the slot and
    its scale area, and set 1's stage rows those of the talker's one-set
    plan at the same slot size."""
    cfg = tcfg.QWEN3_TTS_06B
    t, m = cfg.talker.transformer, cfg.code_predictor.transformer
    V, Vc = cfg.code_predictor.subcode_vocab_size, cfg.talker.codec_vocab_size
    ub = {"int4": 0.5, "int8": 1, "bf16": 2}
    heads = 2 if talker == "bf16" else 1
    plan = persistent.make_plan(m, 132, head_rows=V, talker=t, lm_rows=Vc,
                                unit_bytes=ub[trunk], head_bytes=heads, talker_bytes=ub[talker])
    assert plan.n_sets == 2 and plan.talker_bytes == ub[talker]
    for kind, ((N, K), rows) in enumerate(zip(plan.shapes, plan.stage_rows)):
        units = ub[trunk if kind < len(persistent.KINDS) else talker]
        head = kind % len(persistent.KINDS) == persistent.KINDS.index("head")
        row_bytes = K * (heads if head else units)
        scales = K // 128 if units == 0.5 and not head else 1
        assert rows == min(64, int(plan.slot_bytes // row_bytes)) // 4 * 4, kind
        assert rows * row_bytes <= plan.slot_bytes and rows * scales <= plan.slot_rows
    alone = persistent._plan_at(plan.slot_bytes, t, 132, persistent.kind_shapes(t, Vc), 1, 1,
                                ub[talker], heads if talker == "bf16" else 0)
    assert plan.stage_rows[len(persistent.KINDS):] == alone.stage_rows
    assert persistent.layer_share(plan, 1) == persistent.layer_share(alone)


@pytest.mark.parametrize("flags", [dict(mtp_quantize="int8"), dict(quantize="int4")])
def test_engine_frame_gate_repaired(tiny_vocab_files, monkeypatch, flags):
    """The kernel-width engine with frame_fused=True at an unset quantize
    beside mtp_quantize="int8" (a bf16 talker with its raw lm_head as bf16
    rows beside the int8 trunk) and at quantize="int4": every decoded frame
    runs K7's plain version, as JAX's frame gate admits both (before the
    repair the first decoded on K1 + K2 with ``frame_fused_frames`` 0: the
    gate also asked for an int8 ``fused_lm_head``)."""
    tc, params, tok = _kernel_width(tiny_vocab_files)
    eng = TTSEngine(config=tc, params=params, tokenizer=tok, device="cpu", max_frames=6,
                    chunk_len=2, first_chunk_len=2, frame_fused=True, **flags)
    assert eng.is_ready(), eng.get_error()
    tp, cp = eng.params["talker"], eng.params["code_predictor"]
    bf16 = "quantize" not in flags
    assert tp["fused_step"].wqkv.dtype == (torch.bfloat16 if bf16 else torch.uint8)
    assert tp["fused_lm_head"].q.dtype == cp["fused_heads"].q.dtype == (
        torch.bfloat16 if bf16 else torch.int8)
    calls = []
    real = tgen.fused_frame_step
    monkeypatch.setattr(tgen, "fused_frame_step",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    r = eng.synthesize("hello world", temperature=0.8, seed=3, max_tokens=4)
    m = r.metrics
    assert m.frame_fused_frames == m.decoded_frames == len(calls) > 0
    assert np.isfinite(r.audio).all() and r.codes.shape[1] == 1 + tc.code_predictor.num_steps
