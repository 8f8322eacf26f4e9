"""The port's engine, pool and server on a mesh with a data axis, on the CPU,
against the JAX engine on the same mesh shape: ``make_mesh(d, m,
devices=[cpu] * d * m)`` (one device listed d x m times: d data groups of m
logical ranks) against JAX's ``make_mesh(d, m)`` over virtual CPU devices.

A batch splits over the data groups where it divides (JAX's ``P("data")``)
and stays on group 0 where it does not (JAX's ``P()``); every route is the
one JAX's predicates give at the batch's whole B: the plain step and the
cached chain at B > 1, in pools and in the verify pass, K9 and K10 (their
plain versions here) at B=1 where the packs are.  Greedy codes equal JAX's
and the audio agrees within the regression fixture's tolerance."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.ops import fused_mtp_tp as j_mtp_tp
from leaxer_qwen3_tts_tpu.parallel import make_mesh as jmake_mesh
from leaxer_qwen3_tts_torch.api import engine as tengine
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import code_predictor as tcp
from leaxer_qwen3_tts_torch.models import talker as ttalker
from leaxer_qwen3_tts_torch.ops import fused_mtp_tp as t_mtp_tp
from leaxer_qwen3_tts_torch.parallel import make_mesh, split_rows
from leaxer_qwen3_tts_torch.serve import BatchingServer, ContinuousBatcher
from test_torch_engine_mesh import IDS, _tp_cfg
from test_torch_speculative import _port

torch.set_num_threads(2)

CPU = torch.device("cpu")
ATOL = 2e-4  # the regression fixture's audio tolerance
TEXTS = ["hello world", "hello", "world hello", "hello hello"]
ENGINE = dict(max_frames=6, chunk_len=2)
POOL = dict(chunk_len=2, kv_bucket=64, text_bucket_max=16)
SPEC = dict(spec_k=3, spec_iters=2)
FRAMES = 4


def _mesh(d, m):
    return make_mesh(d, m, devices=[CPU] * (d * m))


def _jmesh(d, m):
    return jmake_mesh(d, m, devices=jax.devices()[: d * m])


@pytest.fixture(scope="module")
def toks(tiny_vocab_files):
    vocab_path, merges_path, _ = tiny_vocab_files
    return JTokenizer(vocab_path, merges_path), Tokenizer(vocab_path, merges_path)


@pytest.fixture(scope="module")
def port(tiny_model):
    return _port(*tiny_model)


@pytest.fixture(scope="module")
def jax_runs(tiny_model, toks):
    """The JAX engine's greedy runs on its (2, 2) mesh, each computed once
    (the (4, 1) pool is held against the same streams: JAX's greedy codes
    do not depend on the mesh shape, as its own pool test asserts)."""
    cfg, params = tiny_model
    jtok = toks[0]
    out = {}
    jm = _jmesh(2, 2)
    with jax.set_mesh(jm):
        je = JEngine(config=cfg, params=params, tokenizer=jtok, mesh=jm, **ENGINE)
        assert je.is_ready(), je.get_error()
        for B in (2, 3, 4):
            out[f"batch{B}"] = je.synthesize_batch(TEXTS[:B], temperature=0.0,
                                                   max_tokens=FRAMES)
        kvq = JEngine(config=cfg, params=params, tokenizer=jtok, mesh=jm, kv_quant=True,
                      **ENGINE)
        out["kvq"] = kvq.synthesize_batch(TEXTS[:2], temperature=0.0, max_tokens=FRAMES)
        spec = JEngine(config=cfg, params=params, tokenizer=jtok, mesh=jm, **SPEC, **ENGINE)
        out["spec1"] = spec.synthesize(TEXTS[0], temperature=0.0, max_tokens=FRAMES)
        out["spec2"] = spec.synthesize_batch(TEXTS[:2], temperature=0.0, max_tokens=FRAMES)
    return out


def _engine(port, toks, d, m, **kw):
    tc, tparams = port
    eng = TTSEngine(config=tc, params=tparams, tokenizer=toks[1], mesh=_mesh(d, m),
                    **ENGINE, **kw)
    assert eng.is_ready(), eng.get_error()
    return eng


def _same(got, want, audio=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, np.asarray(w.codes))
        if audio:
            np.testing.assert_allclose(g.audio, np.asarray(w.audio), atol=ATOL)


def test_split_rows_mirrors_the_data_axis():
    """B rows over d groups: d equal slices where d divides B, else the
    whole batch on group 0; a mesh's groups and leads are its data rows."""
    assert split_rows(4, 2) == [slice(0, 2), slice(2, 4)]
    assert split_rows(3, 2) == [slice(0, 3)]
    assert split_rows(1, 4) == [slice(0, 1)]
    assert split_rows(5, 1) == [slice(0, 5)]
    devs = [torch.device("cuda", i) for i in range(4)]
    mesh = make_mesh(2, 2, devices=devs)
    assert mesh.data_groups() == [devs[:2], devs[2:]]
    assert mesh.model_devices() == devs[:2] and mesh.data_leads() == [devs[0], devs[2]]


@pytest.mark.parametrize("B", [2, 3])
def test_synthesize_batch_on_a_data_mesh_matches_jax(port, toks, jax_runs, B):
    """synthesize_batch at (2, 2): B=2 splits into one row per group, B=3
    stays on group 0 (replicated in JAX); greedy codes and audio equal."""
    eng = _engine(port, toks, 2, 2)
    got = eng.synthesize_batch(TEXTS[:B], temperature=0.0, max_tokens=FRAMES)
    _same(got, jax_runs[f"batch{B}"])


def test_kv_quant_on_a_data_mesh_matches_jax(port, toks, jax_runs):
    """The int8 KV cache at (2, 2): the plain step on the int8 cache."""
    eng = _engine(port, toks, 2, 2, kv_quant=True)
    assert eng.cfg.talker.transformer.kv_cache_quant
    _same(eng.synthesize_batch(TEXTS[:2], temperature=0.0, max_tokens=FRAMES), jax_runs["kvq"])


def test_spec_on_a_data_mesh_matches_jax(port, toks, jax_runs):
    """spec_k=3 at (2, 2), at B=1 (group 0) and B=2 (a row per group): the
    verify pass on the plain layers, the candidates' chain cached."""
    eng = _engine(port, toks, 2, 2, **SPEC)
    one = eng.synthesize(TEXTS[0], temperature=0.0, max_tokens=FRAMES)
    np.testing.assert_array_equal(one.codes, np.asarray(jax_runs["spec1"].codes))
    np.testing.assert_allclose(one.audio, np.asarray(jax_runs["spec1"].audio), atol=ATOL)
    _same(eng.synthesize_batch(TEXTS[:2], temperature=0.0, max_tokens=FRAMES),
          jax_runs["spec2"], audio=False)


@pytest.mark.parametrize("d,m", [(2, 2), (4, 1)])
def test_pool_on_a_data_mesh_matches_jax(port, toks, jax_runs, d, m):
    """A pool of 4 slots over the data groups (2 or 1 slots a group), 4
    texts: each request's greedy codes equal the JAX mesh engine's stream."""
    eng = _engine(port, toks, d, m)
    pool = ContinuousBatcher(eng, pool_size=4, **POOL)
    try:
        assert [grp.slots for grp in pool._groups] == split_rows(4, d)
        got = [f.result(timeout=300) for f in
               [pool.submit(t, temperature=0.0, max_tokens=FRAMES) for t in TEXTS]]
    finally:
        pool.shutdown()
    _same(got, jax_runs["batch4"], audio=False)
    spf = eng.cfg.vocoder.samples_per_frame
    for g in got:
        assert np.isfinite(g.audio).all() and g.audio.size == len(g.codes) * spf


def test_pool_refuses_a_size_off_the_data_axis(port, toks):
    """pool_size 3 over 4 data groups raises, naming the data axis (JAX's
    ``test_pool_mesh_rejects_indivisible_pool_size``)."""
    eng = _engine(port, toks, 4, 1)
    with pytest.raises(EngineError, match="data axis"):
        ContinuousBatcher(eng, pool_size=3, **POOL)


def test_spec_pool_on_a_data_mesh(port, toks, jax_runs):
    """A spec pool (spec_k=3) of 2 slots at (2, 2): greedy codes equal the
    JAX mesh engine's."""
    eng = _engine(port, toks, 2, 2)
    pool = ContinuousBatcher(eng, pool_size=2, spec_k=3, spec_iters=1, **POOL)
    try:
        got = [f.result(timeout=300) for f in
               [pool.submit(t, temperature=0.0, max_tokens=FRAMES) for t in TEXTS[:2]]]
    finally:
        pool.shutdown()
    _same(got, jax_runs["batch2"], audio=False)


def test_server_over_a_data_mesh_engine(port, toks, jax_runs):
    """BatchingServer over a (2, 2) engine: the requests' greedy codes equal
    the JAX mesh engine's streams, the audio within the tolerance."""
    eng = _engine(port, toks, 2, 2)
    s = BatchingServer(eng, max_batch=2, max_wait_ms=200.0)
    try:
        got = [f.result(timeout=300) for f in
               [s.submit(t, temperature=0.0, max_tokens=FRAMES) for t in TEXTS[:2]]]
    finally:
        s.shutdown()
    _same(got, jax_runs["batch2"])


def test_groups_decode_their_rows_on_their_leads(port, toks, monkeypatch):
    """A spy on the generate callables: at B=4 on (2, 2) group g prefills
    and decodes rows [2g, 2g + 2) on data row g's lead, routed without the
    mesh (JAX's K9 / K10 gates take B=1 only); B=3 stays whole on group 0;
    B=1 takes the mesh's routes."""
    eng = _engine(port, toks, 2, 2)
    calls = []
    real = tengine.make_generate_fns

    def spy(cfg, batch, max_len, chunk_len, lang_id=None, mesh=None, **kw):
        fns = real(cfg, batch=batch, max_len=max_len, chunk_len=chunk_len, lang_id=lang_id,
                   mesh=mesh, **kw)

        def prefill(params, ids, lens, gens=None, **seg):
            calls.append(("prefill", ids.tolist(), ids.device, mesh, params))
            return fns.prefill(params, ids, lens, gens, **seg)

        def decode(params, state, *a):
            calls.append(("decode", state.last_hidden.shape[0], state.last_hidden.device, mesh,
                          params))
            return fns.decode(params, state, *a)

        return fns._replace(prefill=prefill, decode=decode)

    monkeypatch.setattr(tengine, "make_generate_fns", spy)
    ids = [eng._tokenize(t) for t in TEXTS]
    width = 16
    padded = [i + [0] * (width - len(i)) for i in ids]
    leads = eng.mesh.data_leads()
    eng.synthesize_batch(TEXTS, temperature=0.0, max_tokens=2)
    pre = [c for c in calls if c[0] == "prefill"]
    assert [c[1] for c in pre] == [padded[0:2], padded[2:4]]
    assert [c[2] for c in pre] == leads and all(c[3] is None for c in calls)
    assert all(c[4] is eng.params for c in calls)  # one copy on the one device
    dec = [c for c in calls if c[0] == "decode"]
    assert dec and all(c[1] == 2 for c in dec) and [c[2] for c in dec[:2]] == leads
    calls.clear()
    eng.synthesize_batch(TEXTS[:3], temperature=0.0, max_tokens=2)
    pre = [c for c in calls if c[0] == "prefill"]
    assert [c[1] for c in pre] == [padded[:3]] and pre[0][2] == leads[0]
    assert all(c[1] == 3 for c in calls if c[0] == "decode")
    calls.clear()
    eng.synthesize(TEXTS[0], temperature=0.0, max_tokens=2)
    assert calls and all(c[3] is eng.mesh for c in calls)


# The tensor-parallel mixes: K9 beside the cached chain (the MTP trunk past
# K10's resident budget, as the 1.7B trunk at tp=2), and the plain step on an
# int8 cache beside K10 (kv_quant).
MIXES = {"k9_cached": (True, False), "plain_k10": (False, True)}
MIX_FRAMES = 2  # one chunk: the JAX engine's kernels run interpreted


@pytest.fixture(scope="module")
def tp_model():
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params as jinit

    cfg = _tp_cfg()
    return cfg, jinit(cfg, jax.random.PRNGKey(0), with_speaker_encoder=False)


def _mix(mix, monkeypatch):
    """Engine kwargs and the budget patch that give ``mix``'s gates."""
    if mix == "k9_cached":
        for mod in (j_mtp_tp, t_mtp_tp):
            monkeypatch.setattr(mod, "RESIDENT_MAX_BYTES", 1)
        return {}
    return dict(kv_quant=True)


@pytest.mark.parametrize("mix", list(MIXES))
def test_tp_mixes_route_and_decode_like_jax(tp_model, mix, monkeypatch):
    """At tp=2 on a (1, 2) mesh: K9's plain version beside the cached chain,
    and the plain step on an int8 cache beside K10's plain version, each
    frame's routes counted; greedy codes equal the JAX mesh engine's (its
    kernels interpreted)."""
    cfg, params = tp_model
    kw = dict(max_frames=2, chunk_len=2, first_chunk_len=2, kv_buckets=(12,), **_mix(
        mix, monkeypatch))
    jm = _jmesh(1, 2)
    with jax.set_mesh(jm):
        je = JEngine(config=cfg, params=params, mesh=jm, **kw)
        assert je.is_ready(), je.get_error()
        jr = je.synthesize_tokens(IDS, temperature=0.0, max_tokens=MIX_FRAMES)
    tc, tparams = _port(cfg, params)
    eng = TTSEngine(config=tc, params=tparams, mesh=_mesh(1, 2), **kw)
    assert eng.is_ready(), eng.get_error()
    k9, k10 = MIXES[mix]
    assert TTSEngine.mesh_routes(eng.cfg, 2) == (k9, k10)
    for sub, on in (("talker", k9), ("code_predictor", k10)):
        assert ("fused_tp" in eng.params[sub]) == ("fused_tp" in je.params[sub]) == on
    calls = {"k9": 0, "k10": 0, "plain": 0, "cached": 0}
    spies = ((ttalker, "fused_decode_step_tp", "k9"), (tcp, "fused_mtp_chain_tp", "k10"),
             (ttalker, "transformer_forward", "plain"), (tcp, "predict_subcodes_cached",
                                                         "cached"))
    for mod, name, key in spies:
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **k))[1])
    r = eng.synthesize_tokens(IDS, temperature=0.0, max_tokens=MIX_FRAMES)
    n = r.metrics.decoded_frames
    assert n == MIX_FRAMES
    want = {"k9": n if k9 else 0, "k10": n if k10 else 0, "cached": 0 if k10 else n,
            "plain": 1 + (0 if k9 else n)}  # the prefill, then each plain step
    assert calls == want, calls
    np.testing.assert_array_equal(r.codes, np.asarray(jr.codes))
    np.testing.assert_allclose(r.audio, np.asarray(jr.audio), atol=ATOL)


def test_spec_fallback_steps_on_the_mesh_kernels(tp_model, monkeypatch):
    """spec_k on a tp=2 mesh at B=1: the verify passes on the plain layers
    and the candidates' chains cached; once the acceptance floor trips, the
    sequential steps are K9 and the chains K10 (their plain versions), one
    each per decoded frame after the conversion step."""
    cfg, params = tp_model
    tc, tparams = _port(cfg, params)
    eng = TTSEngine(config=tc, params=tparams, mesh=_mesh(1, 2), max_frames=8, chunk_len=2,
                    first_chunk_len=2, kv_buckets=(16,), spec_k=2, spec_iters=1,
                    spec_accept_floor=1.1, spec_adapt_window=1)
    assert eng.is_ready(), eng.get_error()
    calls = {"k9": 0, "k10": 0}
    for mod, name, key in ((ttalker, "fused_decode_step_tp", "k9"),
                           (tcp, "fused_mtp_chain_tp", "k10")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **k))[1])
    r = eng.synthesize_tokens(IDS, temperature=0.0, max_tokens=6)
    m = r.metrics
    assert m.spec_fallback and m.spec_iterations == 1
    seq = m.decoded_frames - 1 - m.spec_iterations * eng.spec_k
    assert seq > 0 and calls == {"k9": seq, "k10": seq}
    eng.spec_k = None  # the same engine, sequential: the same greedy codes
    np.testing.assert_array_equal(
        eng.synthesize_tokens(IDS, temperature=0.0, max_tokens=6).codes, r.codes)
