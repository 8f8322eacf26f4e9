"""Kernel K10 (PyTorch port): the plain version of the tensor-parallel MTP
chain (on the ranks' row packs) against the JAX package's
``fused_mtp_chain_tp`` in interpret mode on the ``tp_chain_setup`` model of
``tests/test_fused_mtp_tp.py`` (H=512, 2 layers, 3 steps, V=256), int8 and
bf16 heads, greedy and on the same fixed Gumbel noise; the routing gate
``supports_tp_resident`` against JAX's; the heads' row shards; the plain
chain's pieces in the kernel's orders; and the ``predict_subcodes`` route
under a mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.models.code_predictor import init_code_predictor_params
from leaxer_qwen3_tts_tpu.ops import fused_mtp_tp as jmtp
from leaxer_qwen3_tts_tpu.ops import fused_tp as jtp
from leaxer_qwen3_tts_tpu.ops.quant import QuantizedLinear as JQ
from leaxer_qwen3_tts_tpu.ops.quant import quantize_weight as jquant
from leaxer_qwen3_tts_tpu.parallel import make_mesh as jmake_mesh
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.ops import fused_mtp_tp as tmtp
from leaxer_qwen3_tts_torch.ops import fused_tp as ttp
from leaxer_qwen3_tts_torch.ops.quant import QuantizedLinear as TQ
from leaxer_qwen3_tts_torch.parallel import make_mesh
from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

CPU = torch.device("cpu")
# sub_sum when every sub-code matches: sums of the same table rows in the
# same (step) order on both sides, so equal up to float32 addition.
SUM_ABS = 1e-6


@pytest.fixture(scope="module")
def setup():
    t = jcfg.TransformerConfig(hidden_size=512, num_layers=2, num_heads=8, num_kv_heads=4,
                               head_dim=128, intermediate_size=1024, dtype="float32")
    cfg = jcfg.CodePredictorConfig(transformer=t, num_steps=3, subcode_vocab_size=256,
                                   max_seq_len=5, impl="fused")
    params = init_code_predictor_params(cfg, jax.random.PRNGKey(0))
    qs = [jquant(params["heads"][j]) for j in range(cfg.num_steps)]
    jheads = JQ(q=jnp.stack([q.q for q in qs]), scale=jnp.stack([q.scale for q in qs]))
    tp_params = params_from_jax(flatten_params({"cp": jax.device_get(params)}))["cp"]
    theads = TQ(q=torch.from_numpy(np.array(jheads.q)), scale=torch.from_numpy(np.array(jheads.scale)))
    rng = np.random.default_rng(0)
    tables = (rng.standard_normal((3, 256, 512)) * 0.02).astype(np.float32)
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = tcfg.TransformerConfig(**fields["transformer"])
    return cfg, params, jheads, tcfg.CodePredictorConfig(**fields), tp_params, theads, tables


def _inputs(seed):
    rng = np.random.default_rng(seed)
    lh = (rng.standard_normal((1, 512)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((1, 512)) * 0.02).astype(np.float32)
    gumbel = rng.gumbel(size=(3, 1, 256)).astype(np.float32)
    return lh, c0, gumbel


GREEDY, SAMPLED = (0.0, 0, 1.0), (0.8, 50, 0.9)


# Each JAX reference runs once (the interpreted chain takes ~10 s): every tp
# with both head types, each head type greedy at one tp and sampled at the
# other.
@pytest.mark.parametrize("tp,head_kind,knobs", [
    (2, "int8", GREEDY), (2, "bf16", SAMPLED), (4, "int8", SAMPLED), (4, "bf16", GREEDY),
])
def test_plain_chain_matches_jax(setup, tp, head_kind, knobs):
    """Sub-codes equal; sub_sum within SUM_ABS."""
    cfg, params, jheads, tc, tparams, theads, tables = setup
    t = cfg.transformer
    lh, c0, gumbel = _inputs(5)
    jm = jmake_mesh(1, tp, devices=jax.devices()[:tp])
    jfw = jtp.pack_fused_tp(t, params["transformer"]["layers"], tp, mesh=jm)
    with jax.set_mesh(jm):
        js, jsum = jmtp.fused_mtp_chain_tp(
            t, tp, jm, jfw, params["transformer"]["final_norm"],
            jheads if head_kind == "int8" else params["heads"], jnp.asarray(tables),
            jnp.asarray(lh), jnp.asarray(c0), jnp.asarray(gumbel), jnp.float32(knobs[0]),
            jnp.int32(knobs[1]), jnp.float32(knobs[2]), interpret=True)
        js, jsum = np.asarray(jax.device_get(js)), np.asarray(jax.device_get(jsum))

    tm = make_mesh(1, tp, devices=[CPU] * tp)
    tfw = ttp.pack_rows(tc.transformer, tp, ttp.pack_fused_tp(
        tc.transformer, tparams["transformer"]["layers"], tp, mesh=tm))
    heads = tmtp.shard_heads(theads if head_kind == "int8" else tparams["heads"],
                             tm.model_devices())
    assert heads.q[0].dtype == (torch.int8 if head_kind == "int8" else torch.bfloat16)
    ts, tsum = tmtp.fused_mtp_chain_tp(
        tc.transformer, tp, tm, tfw, tparams["transformer"]["final_norm"], heads,
        torch.from_numpy(tables), torch.from_numpy(lh), torch.from_numpy(c0),
        torch.from_numpy(gumbel), *knobs)
    assert tmtp.fused_mtp_chain_tp.launches == 0  # the plain version on the CPU
    assert ts.dtype == torch.int32 and ts.shape == (1, 3)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert np.abs(tsum.numpy() - jsum).max() <= SUM_ABS


# (preset, tp) -> supports_tp_resident of the MTP trunk, the JAX gate's values
RESIDENT_TABLE = {
    ("QWEN3_TTS_06B", 2): True, ("QWEN3_TTS_06B", 4): True, ("QWEN3_TTS_06B", 8): False,
    ("QWEN3_TTS_17B", 2): False, ("QWEN3_TTS_17B", 4): True, ("QWEN3_TTS_17B", 8): True,
}


@pytest.mark.parametrize("preset,tp", list(RESIDENT_TABLE))
def test_supports_tp_resident_matches_jax(preset, tp):
    cp = getattr(jcfg, preset).code_predictor
    tt = tcfg.TransformerConfig(**dataclasses.asdict(cp.transformer))
    got = tmtp.supports_tp_resident(tt, tp, cp.num_steps, cp.subcode_vocab_size)
    assert got == jmtp.supports_tp_resident(cp.transformer, tp, cp.num_steps,
                                            cp.subcode_vocab_size) == RESIDENT_TABLE[preset, tp]
    assert not tmtp.supports_tp_resident(tt, 3, cp.num_steps, cp.subcode_vocab_size)


def test_hypercube_sum_is_every_ranks_value():
    """Round r gives rank i its value plus rank i ^ (1 << r)'s, the value
    first; commutativity makes every rank's result the same bits."""
    rng = np.random.default_rng(1)
    for tp in (2, 4, 8):
        parts = [torch.from_numpy(rng.standard_normal(64).astype(np.float32)) for _ in range(tp)]
        vals = list(parts)
        r = 1
        while r < tp:
            vals = [vals[i] + vals[i ^ r] for i in range(tp)]
            r <<= 1
        for v in vals:
            assert torch.equal(v, vals[0])
        assert torch.equal(tmtp.hypercube_sum(parts), vals[0])


def test_shard_heads(setup):
    """int8 heads keep their scales; raw heads go to bf16 with scales of one
    (the JAX chain's two branches); rank r holds inputs r H/tp.. of every
    head as rows [n, V, H/tp] (one per output column, contiguous)."""
    _, _, _, _, tparams, theads, _ = setup
    h8 = tmtp.shard_heads(theads, [CPU] * 4)
    assert [q.shape for q in h8.q] == [(3, 256, 128)] * 4
    assert all(q.is_contiguous() for q in h8.q)
    np.testing.assert_array_equal(h8.q[2].numpy(),
                                  theads.q[:, 256:384].numpy().transpose(0, 2, 1))
    assert h8.q[2][1, 7, 5] == theads.q[1, 256 + 5, 7]
    np.testing.assert_array_equal(h8.scale[0].numpy(), theads.scale[:, 0].numpy())
    h16 = tmtp.shard_heads(tparams["heads"], [CPU] * 2)
    assert h16.q[1].dtype == torch.bfloat16 and torch.equal(h16.scale[0], torch.ones(3, 256))
    torch.testing.assert_close(
        h16.q[1].float(), tparams["heads"][:, 256:].to(torch.bfloat16).float().transpose(1, 2))


def test_predict_subcodes_routes_to_tp_chain(setup):
    """With a mesh, a ``fused_tp`` pack and the resident chain on, the B=1
    chain is K10 (ahead of a single-device pack), on the noise the
    single-device chain draws for the frame; it equals the direct call."""
    cfg, _, _, tc, tparams, _, tables = setup
    tc = dataclasses.replace(tc, resident=True)
    tm = make_mesh(1, 2, devices=[CPU] * 2)
    fw = ttp.pack_rows(tc.transformer, 2, ttp.pack_fused_tp(
        tc.transformer, tparams["transformer"]["layers"], 2, mesh=tm))
    cp = dict(tparams, fused_tp=fw, fused_tp_heads=tmtp.shard_heads(tparams["heads"], [CPU] * 2),
              fused_step=object())  # a single-device pack must not shadow the route
    lh, c0, gumbel = _inputs(7)
    sp = SamplingParams.create(0.8, 50, 0.9)
    drawn = []

    def noise_fn():
        drawn.append(1)
        return torch.from_numpy(gumbel)

    tab = torch.from_numpy(tables)
    subs, ssum = tcp.predict_subcodes(tc, cp, tab, torch.from_numpy(lh), torch.from_numpy(c0),
                                      None, sp=sp, noise_fn=noise_fn, mesh=tm)
    assert drawn == [1]
    ds, dsum = tmtp.fused_mtp_chain_tp(tc.transformer, 2, tm, fw, tparams["transformer"]["final_norm"],
                                       cp["fused_tp_heads"], tab, torch.from_numpy(lh),
                                       torch.from_numpy(c0), torch.from_numpy(gumbel), 0.8, 50, 0.9)
    assert torch.equal(subs, ds) and torch.equal(ssum, dsum)
    # without the mesh the route is not taken (here: the cached plain chain)
    plain, _ = tcp.predict_subcodes(tc, dict(tparams, fused_tp=fw), tab, torch.from_numpy(lh),
                                    torch.from_numpy(c0), lambda lg, j: lg.argmax(-1),
                                    sp=SamplingParams.create(0.0), noise_fn=noise_fn)
    assert plain.shape == (1, 3) and drawn == [1]


def test_raise_on_timeout():
    """No status word set: no error; a set word names its ranks (one word
    per rank, or a device's words in one tensor)."""
    tmtp.raise_on_timeout([torch.zeros(1, dtype=torch.int32)] * 4)
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1, 3\]"):
        tmtp.raise_on_timeout([torch.tensor([v], dtype=torch.int32) for v in (0, 1, 0, 1)])
    with pytest.raises(RuntimeError, match=r"fused_mtp_chain_tp: .* rank\(s\) \[2\]"):
        tmtp.raise_on_timeout([torch.tensor([0, 0, 1, 0], dtype=torch.int32)])


# The plain chain's pieces sum in the kernel's orders; against the plain math
# they reorder (torch's own reductions) they differ by float32 rounding only:
# ~1e-7 relative; a wrong slice, tree or slot moves them by O(1).
ORDER_REL = 2e-6


@pytest.mark.parametrize("part", ["norm", "head_norm", "units", "attend", "rope"])
def test_kernel_order_pieces_equal_the_plain_math(part):
    from leaxer_qwen3_tts_torch.ops import fused_step as tfs

    rng = np.random.default_rng(3)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    if part == "norm":  # H = 1024: four values per thread; H = 320: threads left idle
        xs = [(rand(H), rand(H)) for H in (1024, 320)]
        got = torch.cat([tmtp._norm(x, w, 1e-6) for x, w in xs])
        want = torch.cat([tfs._rms(x[None], w, 1e-6)[0] for x, w in xs])
    elif part == "head_norm":
        x, w = rand(2, 3, 128), rand(128)
        got, want = tmtp._head_norm(x, w, 1e-6), tfs._rms(x, w, 1e-6)
    elif part == "units":  # a K-split product of two ranks on rows: 3 chunks of 256 inputs
        KC, NU, N, nc = 256, 128, 256, 3
        h = tfs._bf16(rand(2, nc * KC))
        rows = torch.from_numpy(rng.integers(-127, 128, (2, N, nc * KC), dtype=np.int8))
        scales = rand(2, N, scale=0.01).abs()
        got = tmtp._units(h, rows, scales, KC)
        want = torch.cat([ttp._ksplit(h[r : r + 1], rows[r], scales[r], KC, NU)
                          for r in range(2)])
    elif part == "attend":
        q, kc, vc = rand(2, 2, 2, 128, scale=0.3), rand(2, 2, 7, 128), rand(2, 2, 7, 128)
        got = tmtp._attend(q, kc, vc, 128 ** -0.5)
        want = torch.stack([tfs._attend_slots(q[r], (kc[r][None], vc[r][None], None, None), 0, 7,
                                              128 ** -0.5) for r in range(2)])
    else:
        inv = 1.0 / (10000.0 ** (torch.arange(0, 128, 2, dtype=torch.float32) / 128))
        x = rand(3, 128)
        table = tmtp.rope_table(inv, 17)
        ang = torch.tensor(13.0) * inv
        got = tmtp._rope_at(x, table, 13)
        want = tfs._rope(x, torch.cos(ang)[None], torch.sin(ang)[None])
    rel = float((got - want).abs().max() / want.abs().max())
    assert got.shape == want.shape and rel < ORDER_REL, rel


def test_check_timeouts_reads_tracked_words_once():
    """Tracked status words raise at the next check, naming the ranks, and
    are read once: the check after it passes."""
    tmtp.check_timeouts()
    tmtp.track([torch.zeros(1, dtype=torch.int32)] * 2)
    tmtp.check_timeouts()
    tmtp.track([torch.tensor([v], dtype=torch.int32) for v in (1, 0)])
    tmtp.track([torch.zeros(1, dtype=torch.int32)] * 2)
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0\]"):
        tmtp.check_timeouts()
    tmtp.check_timeouts()
