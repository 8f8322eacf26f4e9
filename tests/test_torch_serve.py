"""Batched serving in the PyTorch port, on the CPU: ``synthesize_batch``
against the JAX package's, the per-row cache fill and splice against the JAX
layers, a kernel-width batched decode (kernels K4 and K5's plain versions)
against the JAX loop with its interpret-mode Pallas kernels, and the
continuous pool, the batching server and the HTTP facade against the
port's own B=1 engine."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JTokenizer
from leaxer_qwen3_tts_tpu.models import layers as jlayers
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer, read_wav
from leaxer_qwen3_tts_torch.models import layers as tlayers
from leaxer_qwen3_tts_torch.parallel import make_mesh
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.serve import BatchingServer, ContinuousBatcher, make_http_server, wav_bytes

torch.set_num_threads(2)

TEXTS = ["hello world", "hello", "hello world hello world"]
ATOL = 2e-4  # the regression fixture's audio tolerance (test_regression.py)


def _port(tiny_model):
    cfg, params = tiny_model
    return (
        tcfg.TTSModelConfig.from_json(cfg.to_json()),
        params_from_jax(flatten_params(jax.device_get(params))),
    )


@pytest.fixture(scope="module")
def engine(tiny_model, tiny_vocab_files):
    cfg, params = _port(tiny_model)
    vocab_path, merges_path, _ = tiny_vocab_files
    return TTSEngine(config=cfg, params=params, tokenizer=Tokenizer(vocab_path, merges_path),
                     max_frames=8, chunk_len=4, device="cpu")


@pytest.fixture(scope="module")
def pool(engine):
    p = ContinuousBatcher(engine, pool_size=4, chunk_len=2, kv_bucket=64, text_bucket_max=16)
    yield p
    p.shutdown()


def test_synthesize_batch_matches_jax(engine, tiny_model, tiny_vocab_files):
    """Greedy frames equal the JAX package's per stream (EOS latched per
    stream), and the audio agrees to the fixture's tolerance."""
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    jeng = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path),
                   max_frames=8, chunk_len=4)
    want = jeng.synthesize_batch(TEXTS, temperature=0.0, max_tokens=8)
    got = engine.synthesize_batch(TEXTS, temperature=0.0, max_tokens=8)
    assert len(got) == len(TEXTS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_allclose(g.audio, w.audio, atol=ATOL)
        assert g.metrics.frames == len(g.codes)


def test_synthesize_batch_seeds_and_limits(engine):
    """Per-stream seeds: a stream's sampled codes depend on its own seed, not
    on its batch-mates; a greedy batch equals B=1 synthesis per text; bad
    seed lists raise."""
    a = engine.synthesize_batch(TEXTS, temperature=0.9, seed=[1, 2, 3], max_tokens=8)
    b = engine.synthesize_batch(["hi", TEXTS[1], "hello hello"], temperature=0.9,
                                seed=[7, 2, 5], max_tokens=8)
    np.testing.assert_array_equal(a[1].codes, b[1].codes)
    greedy = engine.synthesize_batch(TEXTS[:2], temperature=(0.0, 0.0), max_tokens=6)
    for text, g in zip(TEXTS, greedy):
        np.testing.assert_array_equal(g.codes, engine.synthesize(text, temperature=0.0,
                                                                 max_tokens=6).codes)
    with pytest.raises(EngineError, match="seed sequence"):
        engine.synthesize_batch(TEXTS, seed=[1, 2])


def test_per_row_fill_matches_jax(tiny_model):
    """transformer_forward(uniform_fill=False): each row writes and attends
    at its own fill level, as the JAX layers do; splice_kv_cache writes one
    stream's cache into a pool row."""
    cfg, params = tiny_model
    t = cfg.talker.transformer
    tc, tp = _port(tiny_model)
    tt = tc.talker.transformer
    B, T, H = 3, 16, t.hidden_size
    rng = np.random.default_rng(0)
    lens = np.array([2, 9, 15], np.int32)
    kc = (rng.standard_normal((t.num_layers, B, t.num_kv_heads, T, t.head_dim)) * 0.3)
    vc = (rng.standard_normal(kc.shape) * 0.3)
    kc, vc = kc.astype(np.float32), vc.astype(np.float32)
    valid = np.arange(T)[None, :] < lens[:, None]
    x = (rng.standard_normal((B, 1, H)) * 0.5).astype(np.float32)
    jcache = jlayers.KVCache(k=jnp.asarray(kc), v=jnp.asarray(vc), length=jnp.asarray(lens))
    jh, jc, jv = jlayers.transformer_forward(
        t, params["talker"]["transformer"], jnp.asarray(x), jnp.asarray(lens)[:, None], jcache,
        jnp.asarray(valid), uniform_fill=False,
    )
    tcache = tlayers.KVCache(k=torch.from_numpy(kc.copy()), v=torch.from_numpy(vc.copy()),
                             length=torch.from_numpy(lens).long())
    th, out, tv = tlayers.transformer_forward(
        tt, tp["talker"]["transformer"], torch.from_numpy(x), torch.from_numpy(lens)[:, None].long(),
        tcache, torch.from_numpy(valid), uniform_fill=False,
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert out.length.tolist() == np.asarray(jc.length).tolist()
    one = tlayers.KVCache(k=torch.ones((t.num_layers, 1) + kc.shape[2:]),
                          v=torch.full((t.num_layers, 1) + kc.shape[2:], 2.0), length=5)
    spliced = tlayers.splice_kv_cache(out, one, 1)
    assert torch.equal(spliced.k[:, 1], one.k[:, 0]) and torch.equal(spliced.v[:, 1], one.v[:, 0])
    assert spliced.length.tolist() == [3, 5, 16]


def test_kernel_width_batched_generate_matches_jax(monkeypatch):
    """At kernel widths the batched decode runs K4 and K5 (their plain
    versions here) with per-row positions; the JAX loop runs its batched
    Pallas kernels in interpret mode.  Greedy frames equal."""
    from test_torch_slice import _kernel_width_cfg

    from leaxer_qwen3_tts_tpu.models.code_predictor import prepare_fused_step as j_prep_cp
    from leaxer_qwen3_tts_tpu.models.talker import prepare_fused_talker as j_prep_talker
    from leaxer_qwen3_tts_tpu.ops.quant import fuse_params as j_fuse
    from leaxer_qwen3_tts_tpu.ops.quant import quantize_params as j_quant
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns as j_make
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams as JSP
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params as j_init
    from leaxer_qwen3_tts_torch.models import code_predictor as tcp
    from leaxer_qwen3_tts_torch.models import talker as ttalker
    from leaxer_qwen3_tts_torch.ops.quant import fuse_params, quantize_params
    from leaxer_qwen3_tts_torch.runtime.generate import make_generate_fns
    from leaxer_qwen3_tts_torch.runtime.sampling import SamplingParams

    cfg = _kernel_width_cfg()
    raw = j_init(cfg, jax.random.PRNGKey(0))
    jp = j_quant(j_fuse(raw))
    jp["code_predictor"] = j_prep_cp(cfg.code_predictor, jp["code_predictor"])
    jp["talker"] = j_prep_talker(cfg.talker, jp["talker"])
    ids = np.array([[5, 6, 7, 8], [9, 10, 0, 0]], np.int32)
    lens = np.array([4, 2], np.int32)
    jfns = j_make(cfg, batch=2, max_len=64, chunk_len=2, donate=False, uniform_fill=False)
    st, bd = jfns.prefill(jp, jnp.asarray(ids), jnp.asarray(lens), jax.random.PRNGKey(1))
    st, jframes, _ = jfns.decode(jp, st, bd.trailing, bd.trailing_len, bd.tts_pad_embed,
                                 JSP.create(temperature=0.0))

    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    tp = quantize_params(fuse_params(params_from_jax(flatten_params(jax.device_get(raw)))))
    tp["code_predictor"] = tcp.prepare_fused_step(tc.code_predictor, tp["code_predictor"])
    tp["talker"] = ttalker.prepare_fused_talker(tc.talker, tp["talker"])
    tfns = make_generate_fns(tc, batch=2, max_len=64, chunk_len=2, uniform_fill=False)
    state, bundle = tfns.prefill(tp, torch.from_numpy(ids).long(), torch.from_numpy(lens))
    state = state._replace(cache=state.cache._replace(length=state.pos.clone()))  # per-row fill
    calls = []
    k4, k5 = ttalker.fused_decode_step_batched, tcp.fused_mtp_chain_batched
    monkeypatch.setattr(ttalker, "fused_decode_step_batched",
                        lambda *a: (calls.append("K4"), k4(*a))[1])
    monkeypatch.setattr(tcp, "fused_mtp_chain_batched",
                        lambda *a, **k: (calls.append("K5"), k5(*a, **k))[1])
    state, tframes, _ = tfns.decode(tp, state, bundle.trailing, bundle.trailing_len,
                                    bundle.tts_pad_embed, SamplingParams.create(0.0))
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
    assert calls == ["K5", "K4"] * 2
    assert state.pos.tolist() == np.asarray(st.pos).tolist()


def test_pool_matches_engine_greedy(pool, engine):
    got = pool.synthesize("hello world", temperature=0.0, max_tokens=6)
    want = engine.synthesize("hello world", temperature=0.0, max_tokens=6)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_allclose(got.audio, want.audio, atol=ATOL)


def test_pool_seeded_request_independent_of_slot_and_mates(pool):
    """A seeded sampled request gives the same codes alone and behind three
    co-tenants (another slot, other requests in the batch)."""
    alone = pool.synthesize("hello world", temperature=0.8, seed=5, max_tokens=6)
    mates = [pool.submit(t, temperature=0.9, seed=i, max_tokens=6) for i, t in enumerate(TEXTS)]
    among = pool.submit("hello world", temperature=0.8, seed=5, max_tokens=6)
    for f in mates:
        f.result(timeout=300)
    np.testing.assert_array_equal(among.result(timeout=300).codes, alone.codes)


def test_pool_more_requests_than_slots(pool):
    """Queue drains through admissions: 10 requests through 4 slots."""
    futs = [pool.submit("hello", temperature=0.0, max_tokens=3) for _ in range(10)]
    results = [f.result(timeout=300) for f in futs]
    assert all(len(r.codes) <= 3 for r in results)
    for r in results[1:]:
        np.testing.assert_array_equal(r.codes, results[0].codes)
    assert pool.stats["queued"] == 0


def test_pool_streaming_matches_retired(pool):
    """Streamed chunks concatenate to the retired audio bit for bit; the
    codes equal a non-streaming request with the same seed."""
    base = pool.synthesize("hello world", temperature=0.7, seed=11, max_tokens=6)
    h = pool.submit_stream("hello world", temperature=0.7, seed=11, max_tokens=6)
    items = list(h)
    result = items[-1]
    assert result is h.future.result() and len(items) > 1
    np.testing.assert_array_equal(np.concatenate(items[:-1]), result.audio)
    np.testing.assert_array_equal(result.codes, base.codes)
    np.testing.assert_allclose(result.audio, base.audio, atol=ATOL)
    assert result.metrics.ttfa_seconds is not None


def test_batching_server_matches_solo(engine):
    server = BatchingServer(engine, max_batch=4, max_wait_ms=200.0)
    try:
        futs = [server.submit(t, temperature=0.0, max_tokens=6) for t in TEXTS]
        results = [f.result(timeout=300) for f in futs]
    finally:
        server.shutdown()
    for text, r in zip(TEXTS, results):
        solo = engine.synthesize(text, temperature=0.0, max_tokens=6)
        np.testing.assert_array_equal(r.codes, solo.codes)
    assert server.stats["requests"] == 3 and server.stats["batches"] <= 2


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


@pytest.mark.parametrize("kind", ["pool", "batching"])
def test_http_facade(kind, pool, engine):
    server = pool if kind == "pool" else BatchingServer(engine, max_batch=2, max_wait_ms=50.0)
    httpd = make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    body = json.dumps({"text": "hello", "temperature": 0.0, "max_tokens": 3}).encode()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            assert json.loads(r.read())["ok"] is True
        with _post(port, "/synthesize", body) as r:
            assert r.headers["Content-Type"] == "audio/wav" and r.read()[:4] == b"RIFF"
        with pytest.raises(urllib.error.HTTPError):
            _post(port, "/synthesize", b"not json")
        if kind == "pool":
            with _post(port, "/synthesize_stream", body) as r:
                assert r.headers["Content-Type"].startswith("audio/L16") and r.read()
        else:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, "/synthesize_stream", body)
            assert e.value.code == 501
    finally:
        httpd.shutdown()
        httpd.server_close()
        if kind != "pool":
            server.shutdown()


def test_wav_bytes_roundtrip(tmp_path):
    audio = np.sin(np.linspace(0, 50, 2000)).astype(np.float32) * 0.5
    p = tmp_path / "x.wav"
    p.write_bytes(wav_bytes(audio))
    back, sr = read_wav(str(p))
    assert sr == 24000
    np.testing.assert_allclose(back, audio, atol=2.0 / 32768.0)


def test_unported_modes_raise(engine, tiny_model):
    """What a pool still refuses: a spec_k the verify pass does not take, a
    pool size that does not divide over a mesh's data axis (JAX's error), and
    an engine that is not ready (an object that is no mesh); an engine on a
    mesh with a data axis, or on a tensor-parallel one, gives a pool (its
    slots over the data groups)."""
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatcher(engine, pool_size=2, spec_k=9)
    cfg, params = _port(tiny_model)
    cpu = [torch.device("cpu")] * 4
    for shape in ((2, 2), (1, 2)):
        meshed = TTSEngine(config=cfg, params=params, mesh=make_mesh(*shape, devices=cpu))
        assert meshed.is_ready(), meshed.get_error()
        ContinuousBatcher(meshed, pool_size=2).shutdown()
    data = TTSEngine(config=cfg, params=params, mesh=make_mesh(2, 2, devices=cpu))
    with pytest.raises(EngineError, match="data axis"):
        ContinuousBatcher(data, pool_size=3)
    bogus = TTSEngine(config=cfg, params=params, mesh=object(), device="cpu")
    assert not bogus.is_ready() and "make_mesh" in bogus.get_error()
    with pytest.raises(EngineError, match="engine not ready: .*make_mesh"):
        ContinuousBatcher(bogus, pool_size=2)


@pytest.fixture(scope="module")
def spec_pool(engine):
    """A spec pool (3 candidates, 2 iterations per decode) with the adaptive
    fallback off, so sampled requests do not depend on pool-wide acceptance."""
    floor = engine.spec_accept_floor
    engine.spec_accept_floor = 0.0
    p = ContinuousBatcher(engine, pool_size=4, kv_bucket=64, text_bucket_max=16, spec_k=3,
                          spec_iters=2)
    yield p
    p.shutdown()
    engine.spec_accept_floor = floor


def test_spec_pool_matches_engine_and_jax(spec_pool, engine, tiny_model, tiny_vocab_files):
    """Greedy spec-pool output equals B=1 ``synthesize`` of the port and of
    the JAX package, alone and among co-tenants; streamed chunks concatenate
    to the retired audio; the pool never fell back."""
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    jeng = JEngine(config=cfg, params=params, tokenizer=JTokenizer(vocab_path, merges_path),
                   max_frames=8, chunk_len=4)
    futs = [spec_pool.submit(t, temperature=0.0, max_tokens=6) for t in TEXTS]
    stream = spec_pool.submit_stream(TEXTS[0], temperature=0.0, max_tokens=6)
    items = list(stream)
    for text, f in zip(TEXTS, futs):
        got = f.result(timeout=300)
        want = jeng.synthesize(text, temperature=0.0, max_tokens=6)
        np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
        np.testing.assert_array_equal(got.codes, engine.synthesize(text, temperature=0.0,
                                                                   max_tokens=6).codes)
        np.testing.assert_allclose(got.audio, np.asarray(want.audio), atol=ATOL)
    np.testing.assert_array_equal(items[-1].codes, futs[0].result().codes)
    np.testing.assert_array_equal(np.concatenate(items[:-1]), items[-1].audio)
    assert spec_pool.stats["spec_fallback"] is False


def test_spec_pool_seeded_request_independent_of_mates(spec_pool):
    """A seeded sampled request gives the same codes alone and among three
    co-tenants in the spec pool."""
    alone = spec_pool.synthesize("hello world", temperature=0.8, seed=5, max_tokens=6)
    mates = [spec_pool.submit(t, temperature=0.9, seed=i, max_tokens=6)
             for i, t in enumerate(TEXTS)]
    among = spec_pool.submit("hello world", temperature=0.8, seed=5, max_tokens=6)
    for f in mates:
        f.result(timeout=300)
    np.testing.assert_array_equal(among.result(timeout=300).codes, alone.codes)


def test_spec_pool_fallback(engine):
    """A floor no acceptance reaches switches the whole pool to sequential
    decode after its window; greedy output still equals B=1 synthesize."""
    floor, window = engine.spec_accept_floor, engine.spec_adapt_window
    engine.spec_accept_floor, engine.spec_adapt_window = 1.01, 1
    pool = ContinuousBatcher(engine, pool_size=2, kv_bucket=64, text_bucket_max=16, spec_k=3,
                             spec_iters=1)
    try:
        results = [f.result(timeout=300) for f in
                   [pool.submit(t, temperature=0.0, max_tokens=8) for t in TEXTS]]
        assert pool.stats["spec_fallback"] is True
    finally:
        pool.shutdown()
        engine.spec_accept_floor, engine.spec_adapt_window = floor, window
    for text, r in zip(TEXTS, results):
        np.testing.assert_array_equal(r.codes, engine.synthesize(text, temperature=0.0,
                                                                 max_tokens=8).codes)


def test_engine_warmup_leaves_outputs_alone(engine):
    """Engine warmup over two languages returns the seconds it spent (above
    0); a seeded sampled request gives the same codes and audio after it."""
    before = engine.synthesize("hello world", temperature=0.8, seed=5, max_tokens=8)
    assert engine.warmup(languages=("auto", "en")) > 0
    after = engine.synthesize("hello world", temperature=0.8, seed=5, max_tokens=8)
    np.testing.assert_array_equal(after.codes, before.codes)
    np.testing.assert_array_equal(after.audio, before.audio)


@pytest.mark.parametrize("spec_k", [None, 3])
def test_pool_warmup_leaves_no_state(engine, spec_k):
    """Pool warmup (two languages, the streamed path) returns seconds above
    0 and puts the pool's counters back: an unseeded sampled request (noise
    from the admission counter) and a greedy one give a warmed pool the codes
    and stats they give a fresh pool of the same seed.  A spec pool, under a
    floor no acceptance reaches and a one-iteration window, is still
    speculative after warmup (its requests feed no acceptance window) and
    falls back on the real requests as the fresh pool does."""
    def requests(p):
        return [p.synthesize("hello world", temperature=0.8, max_tokens=6),
                p.synthesize("hello", temperature=0.0, max_tokens=6)]

    def make():
        return ContinuousBatcher(engine, pool_size=2, chunk_len=2, kv_bucket=64,
                                 text_bucket_max=16, spec_k=spec_k, spec_iters=1)

    floor, window = engine.spec_accept_floor, engine.spec_adapt_window
    if spec_k:
        engine.spec_accept_floor, engine.spec_adapt_window = 1.01, 1
    fresh, warmed = make(), make()
    try:
        want = requests(fresh)
        assert warmed.warmup(languages=("auto", "en")) > 0
        assert warmed.stats == dict(fresh.stats, requests=0, chunks=0, spec_fallback=False)
        assert warmed.spec_k == spec_k
        got = requests(warmed)
        assert warmed.stats == fresh.stats
        assert fresh.stats["spec_fallback"] is bool(spec_k)
    finally:
        fresh.shutdown()
        warmed.shutdown()
        engine.spec_accept_floor, engine.spec_adapt_window = floor, window
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.audio, w.audio)


@pytest.mark.parametrize("batcher", ["continuous", "static"])
def test_serve_main_answers_and_shuts_down(batcher, tiny_model, tiny_vocab_files, tmp_path,
                                           monkeypatch, capsys):
    """``serve.__main__.main`` on a checkpoint directory with --device cpu
    and --port 0, in a thread: it warms up, serves one request (HTTP 200,
    WAV bytes) and returns 0 when its HTTP server shuts down."""
    from leaxer_qwen3_tts_tpu.runtime.weights import save_checkpoint
    from leaxer_qwen3_tts_torch.serve import server as srv
    from leaxer_qwen3_tts_torch.serve.__main__ import main as serve_main

    cfg, params = tiny_model
    d = str(tmp_path / "model")
    save_checkpoint(d, cfg, jax.device_get(params))
    for src in tiny_vocab_files[:2]:
        with open(src) as f, open(f"{d}/{src.rsplit('/', 1)[1]}", "w") as g:
            g.write(f.read())
    made = []
    real = srv.make_http_server
    monkeypatch.setattr(srv, "make_http_server", lambda *a, **k: made.append(real(*a, **k))
                        or made[-1])
    rc = []
    t = threading.Thread(target=lambda: rc.append(serve_main(
        ["-m", d, "--device", "cpu", "--port", "0", "--max-tokens", "8", "--pool-size", "2",
         "--kv-bucket", "64", "--batcher", batcher, "--max-wait-ms", "5"])), daemon=True)
    t.start()
    for _ in range(3000):
        if made or not t.is_alive():
            break
        t.join(0.1)
    assert made, f"the server did not start: {rc}"
    httpd = made[0]
    body = json.dumps({"text": "hello", "temperature": 0.0, "max_tokens": 3}).encode()
    try:
        with _post(httpd.server_address[1], "/synthesize", body) as r:
            assert r.status == 200 and r.read()[:4] == b"RIFF"
    finally:
        httpd.shutdown()
    t.join(120)
    assert rc == [0] and not t.is_alive()
    out = capsys.readouterr().out
    assert "warmup done in" in out and f"serving on http://127.0.0.1:{httpd.server_address[1]}" in out
