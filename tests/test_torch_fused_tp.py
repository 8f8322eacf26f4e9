"""Kernel K9 and the mesh (PyTorch port) against the JAX package on the CPU.

The port's ``parallel/mesh.py`` (make_mesh, auto_mesh, the TP rules,
shard_params) against JAX's on the 8 virtual CPU devices of conftest.py; the
tensor-parallel pack (``pack_fused_tp``) bit for bit, and the ranks' row
packs (``pack_rows``) that the kernel K9 takes, element for element against
JAX's units; the shard predicate and the ranks' plans; and the plain version
of the TP decode step (both halves per rank on the rows, the ranks' partials
summed in the hypercube's order) against JAX ``fused_decode_step_tp`` in
interpret mode on a ``make_mesh(8 // tp, tp)`` mesh, at the dims of
``tests/test_fused_tp.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.models.layers import init_transformer_params
from leaxer_qwen3_tts_tpu.ops import fused_tp as jtp
from leaxer_qwen3_tts_tpu.parallel import mesh as jmesh
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_tpu.runtime.weights import init_params as jinit
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import fused_tp as ttp
from leaxer_qwen3_tts_torch.ops import persistent
from leaxer_qwen3_tts_torch.parallel import mesh as tmesh
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

CPU = torch.device("cpu")
# The plain step against JAX: the same bf16-rounded operands and float32
# products summed in other orders (XLA's dot vs torch's matmul, XLA's psum
# order), so x moves by ~1e-7 relative and the written k (after QK-norm and
# RoPE) by ~3e-6 absolute (measured on this host); a wrong unit, scale, head
# or slot moves them by O(1).
X_REL = 1e-5
SLOT_ABS = 1e-4


def _tr(H, heads, kv, I):
    return jcfg.TransformerConfig(hidden_size=H, num_layers=2, num_heads=heads, num_kv_heads=kv,
                                  head_dim=128, intermediate_size=I, dtype="float32")


CFG_06B = _tr(1024, 16, 8, 3072)  # tests/test_fused_tp.py's 0.6B dims
CFG_17B = _tr(2048, 16, 8, 6144)  # and 1.7B dims, 2 layers


def join_heads(shards):
    """The per-rank head shards as one [L, B, nk, T, d] tensor."""
    return torch.cat(list(shards), dim=2)


def _port_cfg(cfg):
    return tcfg.TransformerConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def layers():
    """Raw stacked layers of both configs, JAX's and the port's (same values)."""
    out = {}
    for name, cfg in (("0.6B", CFG_06B), ("1.7B", CFG_17B)):
        p = init_transformer_params(cfg, jax.random.PRNGKey(0))
        tl = params_from_jax(flatten_params({"layers": jax.device_get(p["layers"])}))["layers"]
        out[name] = (cfg, p["layers"], tl)
    return out


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,model", [(1, 2), (2, 4), (1, 8), (4, 1)])
def test_make_mesh_matches_jax(data, model):
    j = jmesh.make_mesh(data, model)
    t = tmesh.make_mesh(data, model, devices=[CPU] * 8)
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == dict(j.shape)
    assert t.devices.shape == j.devices.shape
    assert t.model_devices() == [CPU] * model and t.lead == CPU


def test_mesh_errors_match_jax():
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh(2, 8)
    with pytest.raises(ValueError) as te:
        tmesh.make_mesh(2, 8, devices=[CPU] * 8)
    assert str(te.value) == str(je.value) == "mesh 2x8 needs 16 devices, have 8"
    with pytest.raises(ValueError) as je:
        jmesh.auto_mesh(8, 3)
    with pytest.raises(ValueError) as te:
        tmesh.auto_mesh(8, 3)
    assert str(te.value) == str(je.value)
    # devices=None takes the visible CUDA devices only: none here, never the
    # CPU listed twice on its own
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 0"):
            tmesh.make_mesh(1, 2)
        with pytest.raises(ValueError, match="needs 4 devices, have 0"):
            tmesh.auto_mesh(4, 2)


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jmesh._path_str(path) for path, _ in flat]


@pytest.mark.parametrize("preset", ["QWEN3_TTS_06B", "QWEN3_TTS_17B"])
def test_param_pspec_matches_jax_on_every_path(preset):
    """Every parameter path of the preset's tree (shapes only) gets the JAX
    rule's spec."""
    cfg = getattr(jcfg, preset)
    shapes = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
    paths = _jax_paths(shapes)
    assert len(paths) > 50
    sharded = 0
    for path in paths:
        want = tuple(jmesh.param_pspec(path))
        assert tmesh.param_pspec(path) == want, path
        sharded += "model" in want
    assert sharded >= 10  # q/k/v/o/gate/up/down of both trunks, heads, lm_head, text embed


def test_shard_params_matches_jax_shards(tiny_model):
    """The port's tree has JAX's paths; shard_params gives each rank the
    slice JAX places on that rank's device, and leaves the rest as is."""
    cfg, params = tiny_model
    tp = params_from_jax(flatten_params(jax.device_get(params)))
    assert sorted(_jax_paths(params)) == sorted(
        p for p, _ in _leaves(tmesh.param_shardings(tmesh.make_mesh(1, 2, [CPU] * 2), tp)))
    jm = jmesh.make_mesh(1, 2, devices=jax.devices()[:2])
    js = jmesh.shard_params(jm, params)
    ts = tmesh.shard_params(tmesh.make_mesh(1, 2, devices=[CPU] * 2), tp)
    checked = 0
    for (path, jleaf), (tpath, tleaf) in zip(_jleaves(js), _leaves(ts)):
        assert path == tpath
        if "model" in tmesh.param_pspec(path):
            shards = sorted(jleaf.addressable_shards, key=lambda s: s.device.id)
            assert len(tleaf) == 2
            for r in range(2):
                np.testing.assert_array_equal(np.asarray(shards[r].data), tleaf[r].numpy())
            checked += 1
        else:
            assert isinstance(tleaf, torch.Tensor)
    assert checked >= 10


def _jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return sorted(((jmesh._path_str(p), leaf) for p, leaf in flat), key=lambda x: x[0])


def _leaves(tree, path=""):
    """(path, leaf) of a port tree; a list of rank shards is one leaf."""
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, list) and not all(isinstance(v, torch.Tensor) for v in tree):
        for i, v in enumerate(tree):
            out += _leaves(v, f"{path}/{i}" if path else str(i))
    else:
        out.append((path, tree))
    return sorted(out, key=lambda x: x[0])


# ---------------------------------------------------------------------------
# The gate and the pack
# ---------------------------------------------------------------------------

# (preset, tp) -> supports_tp of the talker and of the MTP trunk
TP_TABLE = {
    ("QWEN3_TTS_06B", 2): (True, True), ("QWEN3_TTS_06B", 4): (True, True),
    ("QWEN3_TTS_06B", 8): (False, False), ("QWEN3_TTS_17B", 2): (True, True),
    ("QWEN3_TTS_17B", 4): (True, True), ("QWEN3_TTS_17B", 8): (True, True),
}


@pytest.mark.parametrize("preset,tp", list(TP_TABLE))
def test_supports_tp_and_dims_match_jax(preset, tp):
    cfg = getattr(jcfg, preset)
    for t, want in zip((cfg.talker.transformer, cfg.code_predictor.transformer),
                       TP_TABLE[preset, tp]):
        tt = _port_cfg(t)
        assert ttp.supports_tp(tt, tp) == jtp.supports_tp(t, tp) == want
        assert ttp._dims(tt, tp) == jtp._dims(t, tp)
    assert not ttp.supports_tp(_port_cfg(CFG_06B), 3)


@pytest.mark.parametrize("name", ["0.6B", "1.7B"])
@pytest.mark.parametrize("tp", [2, 4])
def test_pack_bit_for_bit(layers, name, tp):
    """int8 units, float32 scales per unit column (over the shard's rows for
    wo and down), norms: equal to JAX's pack leaf for leaf."""
    cfg, jl, tl = layers[name]
    jfw = jtp.pack_fused_tp(cfg, jl, tp)
    tfw = ttp.pack_fused_tp(_port_cfg(cfg), tl, tp, devices=[CPU] * tp)
    for field in ("qkv_u", "qkv_s", "wo_u", "wo_s", "gu_u", "gu_s", "wd_u", "wd_s"):
        want = np.asarray(getattr(jfw, field))
        got = torch.stack(getattr(tfw, field)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    for field in ("attn_norm", "mlp_norm", "q_norm", "k_norm"):
        for r in range(tp):
            np.testing.assert_array_equal(getattr(tfw, field)[r].numpy(),
                                          np.asarray(getattr(jfw, field)))
    # the K-split scales are the shard's, not the whole tensor's: at tp >= 2
    # they differ from a per-column scale over all rows
    full = np.abs(np.asarray(jl["wo"], np.float32)).max(axis=1) / 127.0  # [L, H]
    assert not np.allclose(tfw.wo_s[0][:, 0, 0].numpy(), full[:, : tfw.wo_s[0].shape[-1]])


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _step_inputs(cfg):
    rng = np.random.default_rng(3)
    L, nk, d, T, pos = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 64, 13
    x = (rng.standard_normal((1, cfg.hidden_size)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((L, 1, nk, T, d)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((L, 1, nk, T, d)) * 0.2).astype(np.float32)
    kc[:, :, :, pos:] = 0.0
    vc[:, :, :, pos:] = 0.0
    return x, kc, vc, pos


@pytest.mark.parametrize("tp", [2, 4])
def test_plain_step_matches_jax(layers, tp):
    """x_out within X_REL, every rank's written slot within SLOT_ABS and every
    other slot untouched, against JAX's shard_map'd halves (interpret mode)."""
    cfg, jl, tl = layers["0.6B"]
    x, kc, vc, pos = _step_inputs(cfg)
    jm = jmesh.make_mesh(8 // tp, tp)
    jfw = jtp.pack_fused_tp(cfg, jl, tp, mesh=jm)
    with jax.set_mesh(jm):
        xj, kj, vj = jtp.fused_decode_step_tp(cfg, jfw, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                              jnp.asarray(kc), jnp.asarray(vc), jm, interpret=True)
        xj, kj, vj = (np.asarray(jax.device_get(a)) for a in (xj, kj, vj))

    tm = tmesh.make_mesh(1, tp, devices=[CPU] * tp)
    tfw = ttp.pack_rows(_port_cfg(cfg), tp, ttp.pack_fused_tp(_port_cfg(cfg), tl, tp, mesh=tm))
    ks = ttp.split_heads(torch.from_numpy(kc), tm.model_devices())
    vs = ttp.split_heads(torch.from_numpy(vc), tm.model_devices())
    assert ks[0].shape == (cfg.num_layers, 1, cfg.num_kv_heads // tp, 64, cfg.head_dim)
    xt, ks, vs = ttp.fused_decode_step_tp(_port_cfg(cfg), tfw, torch.from_numpy(x), pos, ks, vs,
                                          tm)
    assert ttp.fused_decode_step_tp.launches == 0  # plain on the CPU
    rel = np.abs(xt.numpy() - xj).max() / np.abs(xj).max()
    assert rel < X_REL, rel
    kt, vt = join_heads(ks).numpy(), join_heads(vs).numpy()
    for got, want in ((kt, kj), (vt, vj)):
        assert np.abs(got[:, 0, :, pos] - want[:, 0, :, pos]).max() < SLOT_ABS
        np.testing.assert_array_equal(np.delete(got, pos, axis=3), np.delete(want, pos, axis=3))
    # each rank wrote its own kv heads
    nk_s = cfg.num_kv_heads // tp
    for r in range(tp):
        np.testing.assert_array_equal(ks[r].numpy(), kt[:, :, r * nk_s : (r + 1) * nk_s])


def test_step_clamps_pos_and_splits_heads(layers):
    """pos past the bucket is clamped to the last slot (JAX's jnp.minimum);
    split_heads / join_heads round-trip the cache."""
    cfg, _, tl = layers["0.6B"]
    tc = _port_cfg(cfg)
    tm = tmesh.make_mesh(1, 2, devices=[CPU] * 2)
    tfw = ttp.pack_rows(tc, 2, ttp.pack_fused_tp(tc, tl, 2, mesh=tm))
    x, kc, vc, _ = _step_inputs(cfg)
    full = torch.from_numpy(kc)
    np.testing.assert_array_equal(join_heads(ttp.split_heads(full, [CPU] * 2)).numpy(), kc)
    a = ttp.fused_decode_step_tp(tc, tfw, torch.from_numpy(x), 10_000,
                                 ttp.split_heads(full, [CPU] * 2),
                                 ttp.split_heads(torch.from_numpy(vc), [CPU] * 2), tm)
    b = ttp.fused_decode_step_tp(tc, tfw, torch.from_numpy(x), 63,
                                 ttp.split_heads(full, [CPU] * 2),
                                 ttp.split_heads(torch.from_numpy(vc), [CPU] * 2), tm)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The ranks' row packs, the shard predicate and the ranks' plans (kernel K9)
# ---------------------------------------------------------------------------


def _unit_of_row(jfw, field, r, l, n, k, KC, NU, nn):
    """JAX's unit value behind row n, input k of a product (a K-split
    product: chunk k // KC of column n; an N-split one: KC = K)."""
    u = np.asarray(getattr(jfw, field))[r, l]
    return u[(k // KC) * nn + n // NU, k % KC, n % NU]


@pytest.mark.parametrize("name", ["0.6B", "1.7B"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_pack_rows_hold_jax_units_and_scales(layers, name, tp):
    """Each rank's rows are JAX's units transposed (row n, input k: the unit
    of column n and chunk k // KC, its row k % KC, column n % NU) and its
    scales JAX's unit-column scales, exactly; the norms and frequencies are
    the pack's."""
    cfg, jl, tl = layers[name]
    pc = _port_cfg(cfg)
    jfw = jtp.pack_fused_tp(cfg, jl, tp)
    rows = ttp.pack_rows(pc, tp, ttp.pack_fused_tp(pc, tl, tp, devices=[CPU] * tp))
    H, d, nq_s, nk_s, qd_s, kvd_s, A_s, I_s, NU, KCo, KCd = ttp._dims(pc, tp)
    L = cfg.num_layers
    shapes = {"wqkv": (L, A_s, H), "wo": (L, H, qd_s), "wgu": (L, 2 * I_s, H), "wd": (L, H, I_s)}
    plan = (("wqkv", "qkv", H, A_s), ("wo", "wo", KCo, H), ("wgu", "gu", H, 2 * I_s),
            ("wd", "wd", KCd, H))
    rng = np.random.default_rng(tp)
    for r in range(tp):
        w = rows.ranks[r]
        for leaf, field, KC, N in plan:
            got = getattr(w, leaf).numpy()
            assert got.dtype == np.int8 and got.shape == shapes[leaf], leaf
            units = np.asarray(getattr(jfw, field + "_u"))[r]  # [L, U, KC, NU]
            nc = got.shape[2] // KC
            want = units.reshape(L, nc, N // NU, KC, NU).transpose(0, 2, 4, 1, 3).reshape(got.shape)
            np.testing.assert_array_equal(got, want, err_msg=leaf)
            for _ in range(16):  # the index rule itself, element by element
                l, n, k = rng.integers(L), rng.integers(N), rng.integers(got.shape[2])
                assert got[l, n, k] == _unit_of_row(jfw, field + "_u", r, l, n, k, KC, NU,
                                                    N // NU)
            scales = np.asarray(getattr(jfw, field + "_s"))[r].reshape(L, nc, N)
            np.testing.assert_array_equal(getattr(w, "s" + leaf[1:]).numpy(), scales[:, 0])
            assert (scales == scales[:, :1]).all()  # one scale per column over the shard's K
        for leaf in ("attn_norm", "mlp_norm", "q_norm", "k_norm"):
            np.testing.assert_array_equal(getattr(w, leaf).numpy(),
                                          np.asarray(getattr(jfw, leaf))[:, 0])
        assert all(t.is_contiguous() for t in w)


def test_pack_rows_at_tp1_are_k1s_pack(layers):
    """At tp = 1 the shard is the whole tensor: the row pack equals K1's
    pack of the same raw weights leaf for leaf (what the card's check of K9
    against K1 bit for bit rests on), and the plain step (unit by unit, as
    the JAX halves) is K1's plain step up to float32 rounding: within
    X_REL, the written slot within SLOT_ABS."""
    cfg, _, tl = layers["0.6B"]
    pc = _port_cfg(cfg)
    rows = ttp.pack_rows(pc, 1, ttp.pack_fused_tp(pc, tl, 1, devices=[CPU]))
    k1 = tfs.pack_fused_weights(pc, tl)
    for got, want in zip(rows.ranks[0], k1):
        assert got.dtype == want.dtype and torch.equal(got, want)
    x, kc, vc, pos = _step_inputs(cfg)
    tm = tmesh.make_mesh(1, 1, devices=[CPU])
    k, v = torch.from_numpy(kc), torch.from_numpy(vc)
    k1_k, k1_v = k.clone(), v.clone()
    xt, ks, vs = ttp.fused_decode_step_tp(pc, rows, torch.from_numpy(x), pos, [k.clone()],
                                          [v.clone()], tm)
    xk, _, _ = tfs.fused_decode_step_reference(pc, k1, torch.from_numpy(x), pos, k1_k, k1_v)
    rel = float((xt - xk).abs().max() / xk.abs().max())
    assert 0 < rel < X_REL, rel
    assert float((ks[0][:, :, :, pos] - k1_k[:, :, :, pos]).abs().max()) < SLOT_ABS


def test_pack_rows_refuses_chunk_scales_that_differ(layers):
    """A pack whose K-split chunks carry different scales has no row form."""
    cfg, _, tl = layers["0.6B"]
    pc = _port_cfg(cfg)
    fw = ttp.pack_fused_tp(pc, tl, 2, devices=[CPU] * 2)
    assert fw.wd_s[0].shape[1] == 3  # down: 3 chunks of KCd = 512 inputs, one column unit
    bad = [s.clone() for s in fw.wd_s]
    bad[1][:, 0] *= 2
    with pytest.raises(ValueError, match="chunks carry different scales"):
        ttp.pack_rows(pc, 2, fw._replace(wd_s=bad))


@pytest.mark.parametrize("preset", ["QWEN3_TTS_06B", "QWEN3_TTS_17B"])
def test_shard_predicate_admits_what_supports_tp_admits(preset):
    """Every (trunk, tp) that the JAX gate admits, the ring step takes; both
    presets' talkers and MTP trunks at tp = 2 and 4; not a tp that is no
    power of two (the exchange's hypercube) or splits no head."""
    cfg = getattr(jcfg, preset)
    for t in (cfg.talker.transformer, cfg.code_predictor.transformer):
        pt = _port_cfg(t)
        for tp in (1, 2, 4, 8, 16):
            if jtp.supports_tp(t, tp):
                assert ttp.supports_shard(pt, tp), (preset, tp)
        assert ttp.supports_shard(pt, 2) and ttp.supports_shard(pt, 4)
        assert not ttp.supports_shard(pt, 3) and not ttp.supports_shard(pt, 32)
        s = ttp.shard_config(pt, 4)
        assert (s.num_heads, s.num_kv_heads, s.intermediate_size) == (
            t.num_heads // 4, t.num_kv_heads // 4, t.intermediate_size // 4)
        assert (s.hidden_size, s.head_dim, s.num_layers) == (t.hidden_size, t.head_dim,
                                                              t.num_layers)


SMS = 132  # the H100 SXM's SMs


@pytest.mark.parametrize("preset", ["QWEN3_TTS_06B", "QWEN3_TTS_17B"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_rank_plans(preset, tp):
    """The ranks on one device split its SMs (ranks x blocks <= SMs); every
    rank's plan over its shard has the same bounds (block b of every rank
    owns the same rows of every product, the exchange's premise), every
    block's rows come in quads of 4 and no block owns none; K10's plan also
    takes the heads' rank slice of H in bf16 or int8."""
    from collections import OrderedDict

    cfg = getattr(tcfg, preset)
    bpr = SMS // tp
    assert tp * bpr <= SMS
    for t, heads in ((cfg.talker.transformer, 0), (cfg.code_predictor.transformer, 2048)):
        s = ttp.shard_config(t, tp)
        for head_bytes in ((1, 2) if heads else (0,)):
            plans = [persistent.make_plan(s, bpr, head_rows=heads, head_k=t.hidden_size // tp,
                                          head_bytes=head_bytes) for _ in range(tp)]
            assert all(p == plans[0] for p in plans)
            p = plans[0]
            assert p.grid == bpr and p.batch == 1 and p.n_sets == 1
            for kind, (N, K) in enumerate(p.shapes):
                if not N:
                    continue
                b = p.bounds[kind]
                assert b[0] == 0 and b[-1] == N and len(b) == bpr + 1
                assert all((b1 - b0) % 4 == 0 and b1 - b0 >= 4 for b0, b1 in zip(b, b[1:]))
                unit = head_bytes if kind == 4 else 1
                assert p.stage_rows[kind] * K * unit <= p.slot_bytes
            if heads:
                assert p.shapes[4] == (heads, t.hidden_size // tp)
    groups = OrderedDict([(torch.device("cuda", 0), list(range(tp)))])
    real = persistent.grid_size
    try:
        persistent.grid_size = lambda dev: SMS
        assert ttp.blocks_per_rank(groups) == bpr
        two = OrderedDict([(torch.device("cuda", 0), [0, 1]), (torch.device("cuda", 1), [2, 3])])
        assert ttp.blocks_per_rank(two) == SMS // 2
    finally:
        persistent.grid_size = real
    with pytest.raises(ValueError, match="consecutive"):
        ttp.device_groups([torch.device("cuda", 0), torch.device("cuda", 1),
                           torch.device("cuda", 0)], "K9")


def test_plain_step_hypercube_order(layers):
    """The plain step sums the ranks' partials in the kernels' order: the
    hypercube's, ((p0 + p1) + (p2 + p3)) at tp = 4, which rank order
    ((p0 + p1) + p2) + p3 rounds otherwise on some element."""
    rng = np.random.default_rng(7)
    parts = [torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096))
                              .astype(np.float32)) for _ in range(4)]
    want = (parts[0] + parts[1]) + (parts[2] + parts[3])
    assert torch.equal(ttp.allreduce(parts, CPU), want)
    assert torch.equal(ttp.hypercube_sum(parts), want)
    assert not torch.equal(((parts[0] + parts[1]) + parts[2]) + parts[3], want)
    assert torch.equal(ttp.allreduce(parts[:2], CPU), parts[0] + parts[1])


def test_step_status_words_raise_through_check_timeouts():
    """K9's status words: tracked behind each launch, a set word raises at
    the next check naming the step and its ranks, once; the chain's check
    before its launch (wait=False) reads only launches already done."""
    ttp.check_timeouts()
    ttp.track([torch.zeros(2, dtype=torch.int32)], "fused_decode_step_tp")
    ttp.check_timeouts(wait=False)
    ttp.track([torch.tensor([0, 1, 0, 0], dtype=torch.int32)], "fused_decode_step_tp")
    with pytest.raises(RuntimeError, match=r"fused_decode_step_tp: .* rank\(s\) \[1\]"):
        ttp.check_timeouts()
    ttp.check_timeouts()
    with pytest.raises(ValueError, match="the mesh's devices must be CUDA"):
        tm = tmesh.make_mesh(1, 2, devices=[CPU] * 2)
        ttp.launch_step_tp(None, ttp.FusedTPRows([]), torch.zeros(1, 8), 0, [], [], tm)
