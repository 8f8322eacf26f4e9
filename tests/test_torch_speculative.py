"""Speculative decoding in the PyTorch port, on the CPU, against the JAX
package: greedy frames of ``decode_frames_spec`` at B=1 and B=3 (per-stream
commits), the replay draft and ``force_accept`` at full acceptance, the
``spec_to_seq`` continuation, frozen done streams and EOS latching, the
engine's spec, fallback and ``synthesize_batch`` paths, the trained draft
head, and a kernel-width verify (kernels K6 and K5's plain versions against
the JAX loop with its interpret-mode Pallas verify kernel)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.config import CODEC_EOS, DraftConfig as JDraftConfig
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.models import draft as jdraft
from leaxer_qwen3_tts_tpu.runtime import speculative as jspec
from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns as j_make
from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.models import draft as tdraft
from leaxer_qwen3_tts_torch.runtime import speculative as tspec
from leaxer_qwen3_tts_torch.runtime.generate import make_generate_fns
from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax

torch.set_num_threads(2)

JGREEDY = JSP.create(temperature=0.0)
GREEDY = SamplingParams.create(temperature=0.0)
IDS = np.array([[5, 6, 7, 0], [9, 10, 0, 0], [11, 3, 2, 8]], np.int32)
LENS = np.array([3, 2, 4], np.int32)
ATOL = 2e-4  # the regression fixture's audio tolerance (test_regression.py)


def _port(cfg, params):
    return (tcfg.TTSModelConfig.from_json(cfg.to_json()),
            params_from_jax(flatten_params(jax.device_get(params))))


@pytest.fixture(scope="module")
def port(tiny_model):
    return _port(*tiny_model)


def _run_jax(cfg, params, B, k, iters, n_dispatch, draft_fn=jspec.repeat_draft, sp=JGREEDY,
             force_accept=False, seed=7):
    fns = jspec.make_spec_generate_fns(cfg, max_len=64, k=k, num_iters=iters, batch=B,
                                       lang_id=None, donate=False, draft_fn=draft_fn,
                                       force_accept=force_accept)
    st, bd, f0, v0 = fns.prefill(params, jnp.asarray(IDS[:B]), jnp.asarray(LENS[:B]),
                                 jax.random.PRNGKey(seed), sp)
    frames, valid = [np.asarray(f0)[:, None]], [np.asarray(v0)[:, None]]
    for _ in range(n_dispatch):
        st, fr, vd = fns.decode(params, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed, sp)
        frames.append(np.asarray(fr))
        valid.append(np.asarray(vd))
    return np.concatenate(frames, 1), np.concatenate(valid, 1), np.asarray(st.step)


def _run_port(cfg, params, B, k, iters, n_dispatch, draft_fn=tspec.repeat_draft, sp=GREEDY,
              force_accept=False, state_hook=None):
    fns = tspec.make_spec_generate_fns(cfg, max_len=64, k=k, num_iters=iters, batch=B,
                                       draft_fn=draft_fn, force_accept=force_accept)
    st, bd, f0, v0 = fns.prefill(params, torch.from_numpy(IDS[:B]).long(),
                                 torch.from_numpy(LENS[:B]).long(), None, sp)
    if state_hook is not None:
        st = state_hook(st)
    frames, valid = [f0[:, None].numpy()], [v0[:, None].numpy()]
    for _ in range(n_dispatch):
        st, fr, vd = fns.decode(params, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed, sp)
        frames.append(fr.numpy())
        valid.append(vd.numpy())
    return np.concatenate(frames, 1), np.concatenate(valid, 1), st, bd


@pytest.mark.parametrize("B", [1, 3])
def test_decode_frames_spec_matches_jax(tiny_model, port, B):
    """Random tiny weights: the repeat draft rarely accepts, so streams commit
    at their own rates; greedy frames and validity equal the JAX package's."""
    jf, jv, jsteps = _run_jax(*tiny_model, B, 4, 3, 3)
    tf, tv, st, _ = _run_port(*port, B, 4, 3, 3)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert st.step.tolist() == jsteps.tolist()
    assert torch.equal(st.rope_pos, st.cache.length)


def _sequential(cfg, params, n_frames, forbid_eos=False):
    fns = make_generate_fns(cfg, batch=1, max_len=64, chunk_len=n_frames)
    st, bd = fns.prefill(params, torch.from_numpy(IDS[:1]).long(), torch.from_numpy(LENS[:1]))
    st, fr, vd = fns.decode(params, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed,
                            SamplingParams.create(0.0, forbid_eos=forbid_eos))
    return fr[0].numpy(), vd[0].numpy()


@pytest.mark.parametrize("probe", ["replay", "force_accept"])
def test_full_acceptance(tiny_model, port, probe):
    """The replay draft of the greedy trajectory, and force_accept with an
    always-wrong draft, commit k frames every iteration; the replayed
    frames equal the sequential loop's and the JAX package's."""
    k, iters, n = 4, 2, 2
    seq, seq_valid = _sequential(*port, 1 + n * iters * k, forbid_eos=True)
    if probe == "replay":
        jd, td, fa = jspec.make_replay_draft(seq), tspec.make_replay_draft(seq), False
    else:
        def jd(state, kk):
            return jnp.broadcast_to((state.pending[:, None] + 1) % 2048, (1, kk - 1, 16)), None

        def td(state, kk):
            return ((state.pending[:, None] + 1) % 2048).expand(1, kk - 1, 16), None
        fa = True
    jf, jv, jsteps = _run_jax(*tiny_model, 1, k, iters, n, draft_fn=jd, force_accept=fa)
    tf, tv, st, _ = _run_port(*port, 1, k, iters, n, draft_fn=td, force_accept=fa)
    assert st.step.tolist() == jsteps.tolist() == [1 + n * iters * k]
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    if probe == "replay":
        got = tf[0][tv[0]]
        m = min(len(got), int(seq_valid.sum()))
        assert m >= 8
        np.testing.assert_array_equal(got[:m], seq[:m])


def test_spec_to_seq_continuation(tiny_model, port):
    """Spec for one dispatch, spec_to_seq, then the sequential loop: greedy
    frames equal a pure sequential decode (the JAX package's too)."""
    cfg, params = port
    ref, _ = _sequential(cfg, params, 8, forbid_eos=True)
    sp = SamplingParams.create(0.0, forbid_eos=True)
    tf, tv, st, bd = _run_port(cfg, params, 1, 3, 1, 1, sp=sp)
    committed = list(tf[0][tv[0]])
    gs = tspec.spec_to_seq(cfg, params, st._replace(cache=st.cache._replace(
        length=int(st.rope_pos[0]))), bd.trailing, bd.trailing_len, bd.tts_pad_embed)
    fns = make_generate_fns(cfg, batch=1, max_len=64, chunk_len=8 - len(committed))
    gs, fr, vd = fns.decode(params, gs, bd.trailing, bd.trailing_len, bd.tts_pad_embed, sp)
    committed.extend(fr[0].numpy()[vd[0].numpy()])
    np.testing.assert_array_equal(np.stack(committed), ref)
    jfns = j_make(tiny_model[0], batch=1, max_len=64, chunk_len=8, donate=False)
    jst, jbd = jfns.prefill(tiny_model[1], jnp.asarray(IDS[:1]), jnp.asarray(LENS[:1]),
                            jax.random.PRNGKey(0))
    _, jfr, _ = jfns.decode(tiny_model[1], jst, jbd.trailing, jbd.trailing_len,
                            jbd.tts_pad_embed, JSP.create(0.0, forbid_eos=True))
    np.testing.assert_array_equal(ref, np.asarray(jfr)[0])


def test_done_stream_frozen_and_eos_latches(tiny_model, port):
    """A stream that enters an iteration done keeps its fill, step and
    position and commits nothing; an EOS-boosted lm_head latches EOS at
    frame 0 and nothing is committed after."""
    cfg, params = port

    def mark_done(st):
        return st._replace(done=torch.tensor([True, False]))

    _, tv, st, _ = _run_port(cfg, params, 2, 4, 3, 1, state_hook=mark_done)
    assert not tv[0, 1:].any() and tv[1, 1:].any()
    assert st.step[0] == 1 and st.step[1] > 1
    assert st.rope_pos[0] == st.rope_pos[1] - st.step[1] + 1  # stream 0 kept its fill
    boosted = dict(params)
    boosted["talker"] = dict(params["talker"])
    boosted["talker"]["lm_head"] = params["talker"]["lm_head"].clone()
    boosted["talker"]["lm_head"][:, CODEC_EOS] += 100.0
    _, tv, st, _ = _run_port(cfg, boosted, 1, 4, 2, 1)
    assert not tv.any() and bool(st.done.all())


def test_spec_sampled_deterministic(port):
    """temperature > 0: the same seed commits the same frames, codes in range."""
    cfg, params = port
    sp = SamplingParams.create(0.8, 50, 0.95)

    def run():
        fns = tspec.make_spec_generate_fns(cfg, max_len=64, k=4, num_iters=3, batch=1)
        gen = torch.Generator()
        gen.manual_seed(11)
        st, bd, f0, v0 = fns.prefill(params, torch.from_numpy(IDS[:1]).long(),
                                     torch.from_numpy(LENS[:1]).long(), gen, sp)
        st, fr, vd = fns.decode(params, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed, sp)
        return fr[0][vd[0]].numpy()

    a, b = run(), run()
    np.testing.assert_array_equal(a, b)
    assert len(a) >= 3 and (a >= 0).all() and (a[:, 0] < cfg.talker.codec_vocab_size).all()


def _engines(tiny_model, tiny_vocab_files, **kw):
    cfg, params = tiny_model
    tc, tp = _port(cfg, params)
    vocab_path, merges_path, _ = tiny_vocab_files
    base = dict(max_frames=12, chunk_len=4, first_chunk_len=2)
    base.update(kw.pop("base", {}))
    j = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path),
                **base, **kw)
    t = TTSEngine(config=tc, params=tp, tokenizer=Tokenizer(vocab_path, merges_path),
                  device="cpu", **base, **kw)
    return j, t


@pytest.mark.parametrize("knobs", [
    dict(spec_k=3, spec_iters=2),
    dict(spec_k=3, spec_iters=1, spec_accept_floor=1.01, spec_adapt_window=1),  # fallback
])
def test_engine_spec_matches_jax(tiny_model, tiny_vocab_files, knobs):
    """TTSEngine(spec_k) greedy codes equal the JAX engine's and the port's
    sequential engine's, audio to the fixture tolerance; the fallback fires
    when asked and changes nothing."""
    jeng, teng = _engines(tiny_model, tiny_vocab_files, **knobs)
    want = jeng.synthesize("hello world", temperature=0.0, seed=5)
    got = teng.synthesize("hello world", temperature=0.0, seed=5)
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
    np.testing.assert_allclose(got.audio, np.asarray(want.audio), atol=ATOL)
    assert got.metrics.spec_fallback == want.metrics.spec_fallback == (
        "spec_accept_floor" in knobs)
    assert got.metrics.spec_iterations == want.metrics.spec_iterations > 0
    teng.spec_k = None
    seq = teng.synthesize("hello world", temperature=0.0, seed=5)
    np.testing.assert_array_equal(got.codes, seq.codes)
    chunks = list(TTSEngine.synthesize_stream(teng, "hello world", temperature=0.0))
    np.testing.assert_array_equal(np.concatenate(chunks[:-1]), chunks[-1].audio)


def test_engine_spec_batch_matches_jax(tiny_model, tiny_vocab_files):
    """synthesize_batch with spec_k: per-stream greedy codes equal the JAX
    engine's spec batch and the port's sequential batch."""
    texts = ["hello world", "hello", "world hello world"]
    jeng, teng = _engines(tiny_model, tiny_vocab_files, base=dict(max_frames=8),
                          spec_k=3, spec_iters=2)
    want = jeng.synthesize_batch(texts, temperature=0.0, seed=4)
    got = teng.synthesize_batch(texts, temperature=0.0, seed=4)
    teng.spec_k = None
    seq = teng.synthesize_batch(texts, temperature=0.0, seed=4)
    for g, w, q in zip(got, want, seq):
        np.testing.assert_array_equal(g.codes, np.asarray(w.codes))
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), atol=ATOL)
        n = min(len(g.codes), len(q.codes))
        assert n >= 4
        np.testing.assert_array_equal(g.codes[:n], q.codes[:n])
        assert g.metrics.spec_iterations > 0


def test_draft_head_matches_jax(tiny_model, tiny_vocab_files):
    """The trained draft head: draft_predict codes equal the JAX head's on the
    same weights and inputs; an engine whose parameters carry a draft drafts
    with it and its greedy codes still equal the sequential engine's."""
    cfg, params = tiny_model
    H = cfg.talker.transformer.hidden_size
    jd = JDraftConfig(hidden_size=H, d_model=64, codec_vocab_size=cfg.talker.codec_vocab_size,
                      subcode_vocab_size=cfg.code_predictor.subcode_vocab_size, dtype="float32")
    dp = jdraft.init_draft_params(jd, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((2, H)).astype(np.float32)
    embed = (rng.standard_normal((2, H)) * 0.1).astype(np.float32)
    want = jdraft.draft_predict(jd, dp, params["embeddings"], jnp.asarray(hidden),
                                jnp.asarray(embed), 3)
    dcfg = tcfg.TTSModelConfig.from_json(dataclasses.replace(cfg, draft=jd).to_json())
    assert dcfg.draft == tcfg.DraftConfig(**{f: getattr(jd, f) for f in jd.__dataclass_fields__})
    tp = params_from_jax(flatten_params(jax.device_get(dict(params, draft=dp))))
    got = tdraft.draft_predict(dcfg.draft, tp["draft"], tp["embeddings"],
                               torch.from_numpy(hidden), torch.from_numpy(embed), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vocab_path, merges_path, _ = tiny_vocab_files
    eng = TTSEngine(config=dcfg, params=tp, tokenizer=Tokenizer(vocab_path, merges_path),
                    device="cpu", max_frames=12, chunk_len=4, first_chunk_len=2, spec_k=3,
                    spec_iters=2)
    calls = []
    real = tdraft.draft_predict
    tdraft.draft_predict = lambda *a: (calls.append(1), real(*a))[1]
    try:
        got = eng.synthesize("hello world", temperature=0.0)
    finally:
        tdraft.draft_predict = real
    assert calls
    eng.spec_k = None
    np.testing.assert_array_equal(got.codes, eng.synthesize("hello world", temperature=0.0).codes)


def test_kernel_width_spec_matches_jax(monkeypatch):
    """At kernel widths the verify pass is kernel K6 and the candidates'
    chain kernel K5 (their plain versions here), one each per iteration; the
    JAX loop runs its Pallas verify kernel in interpret mode.  Greedy frames
    equal, and equal the port's sequential loop (K1, K2)."""
    from test_torch_slice import _kernel_width_cfg

    from leaxer_qwen3_tts_tpu.models.code_predictor import prepare_fused_step as j_prep_cp
    from leaxer_qwen3_tts_tpu.models.talker import prepare_fused_talker as j_prep_talker
    from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
    from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init
    from leaxer_qwen3_tts_torch.models import code_predictor as tcp
    from leaxer_qwen3_tts_torch.models import talker as ttalker
    from leaxer_qwen3_tts_torch.models.code_predictor import prepare_fused_step
    from leaxer_qwen3_tts_torch.models.talker import prepare_fused_talker
    from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params

    cfg = _kernel_width_cfg()  # with the 15-step chain the JAX verify loop assumes
    cfg = dataclasses.replace(cfg, code_predictor=dataclasses.replace(
        cfg.code_predictor, num_steps=15, max_seq_len=17))
    raw = j_init(cfg, jax.random.PRNGKey(0))
    jp = j_quant(j_fuse(raw))
    jp["code_predictor"] = j_prep_cp(cfg.code_predictor, jp["code_predictor"])
    jp["talker"] = j_prep_talker(cfg.talker, jp["talker"])
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = quantize_params(fuse_params(params_from_jax(flatten_params(jax.device_get(raw)))))
    tp["code_predictor"] = prepare_fused_step(tc.code_predictor, tp["code_predictor"])
    tp["talker"] = prepare_fused_talker(tc.talker, tp["talker"])
    sp = SamplingParams.create(0.0, forbid_eos=True)
    seq, _ = _sequential(tc, tp, 8, forbid_eos=True)
    k, iters = 3, 2
    traj = jnp.asarray(seq)

    def jreplay(state, kk):  # make_replay_draft's lookup for 1 + num_steps codes
        start = jnp.clip(state.step[0], 0, traj.shape[0] - (kk - 1))
        return jax.lax.dynamic_slice(traj, (start, 0), (kk - 1, traj.shape[1]))[None], None

    jf, jv, _ = _run_jax(cfg, jp, 1, k, iters, 1, draft_fn=jreplay,
                         sp=JSP.create(0.0, forbid_eos=True))
    calls = []
    k6, k5 = ttalker.fused_verify_step, tcp.fused_mtp_chain_batched
    monkeypatch.setattr(ttalker, "fused_verify_step",
                        lambda *a: (calls.append("K6"), k6(*a))[1])
    monkeypatch.setattr(tcp, "fused_mtp_chain_batched",
                        lambda *a, **kw: (calls.append("K5"), k5(*a, **kw))[1])
    tf, tv, st, _ = _run_port(tc, tp, 1, k, iters, 1, draft_fn=tspec.make_replay_draft(seq),
                              sp=sp)
    assert calls == ["K6", "K5"] * iters
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tf[0][tv[0]], seq[: 1 + iters * k])
    assert st.step.tolist() == [1 + iters * k]
