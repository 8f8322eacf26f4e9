"""Pool soak of the PyTorch port (the JAX package's tests/test_pool_soak.py on
the port's ContinuousBatcher, on the CPU): a randomized admit / stream /
retire / fail schedule over many mixed requests (languages, seeds, lengths,
streaming, rejected inputs), asserting per-request determinism whatever the
pool's occupancy, streamed chunks equal to the retired audio, no leaked
slot, and a drained queue.

The request count is ``QTTS_SOAK_N``, 200 by default as in the JAX test
(~30 s on one worker)."""

import os
import random
import time

import jax
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import TTSEngine
from leaxer_qwen3_tts_torch.frontend import Tokenizer
from leaxer_qwen3_tts_torch.runtime.weights import params_from_jax
from leaxer_qwen3_tts_torch.serve import ContinuousBatcher

N_REQUESTS = int(os.environ.get("QTTS_SOAK_N", "200"))

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engine(tiny_model, tiny_vocab_files):
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    return TTSEngine(
        config=tcfg.TTSModelConfig.from_json(cfg.to_json()),
        params=params_from_jax(flatten_params(jax.device_get(params))),
        tokenizer=Tokenizer(vocab_path, merges_path),
        max_frames=8,
        chunk_len=4,
        device="cpu",
    )


def test_pool_soak(engine):
    rng = random.Random(0xC0FFEE)
    pool = ContinuousBatcher(
        engine, pool_size=4, chunk_len=2, kv_bucket=64, text_bucket_max=16
    )
    try:
        texts = ["hello", "hello world", "abc", "one two three"]
        langs = ["auto", "en", "zh", "ja"]
        seeds = [1, 2, 3]  # small set so duplicate keys occur often

        # (text, lang, temp, max_tokens, seed) -> first observed codes;
        # every later duplicate must reproduce them exactly, regardless of
        # what else occupied the pool at the time (determinism contract)
        first_codes = {}
        pending = []  # (key_or_None, kind, handle)
        n_rejected = 0

        for i in range(N_REQUESTS):
            kind = rng.random()
            if kind < 0.06:
                # failure injection: overlong text is rejected in admission
                # (the slot must come back; the queue must keep moving)
                f = pool.submit("hello " * 40, temperature=0.0)
                pending.append((None, "reject", f))
                n_rejected += 1
            else:
                text = rng.choice(texts)
                lang = rng.choice(langs)
                greedy = rng.random() < 0.5
                temp = 0.0 if greedy else 0.8
                mt = rng.randint(1, 6)
                seed = rng.choice(seeds)
                key = (text, lang, temp, mt, seed)
                kw = dict(language=lang, temperature=temp, max_tokens=mt, seed=seed)
                if rng.random() < 0.2:
                    stream = pool.submit_stream(text, **kw)
                    pending.append((key, "stream", stream))
                else:
                    pending.append((key, "future", pool.submit(text, **kw)))
            # drain opportunistically so in-flight depth varies over the run
            # (different occupancy mixes for identical keys)
            while len(pending) > rng.randint(4, 12):
                _consume(pending.pop(0), first_codes)

        while pending:
            _consume(pending.pop(0), first_codes)

        # queue drained, nothing stuck, no leaked slots
        deadline = time.time() + 60
        while pool.stats["active"] > 0 or pool.stats["queued"] > 0:
            assert time.time() < deadline, f"pool did not drain: {pool.stats}"
            time.sleep(0.02)
        st = pool.stats
        # rejected admissions fail their future without counting as done
        assert st["requests"] == N_REQUESTS - n_rejected
        assert n_rejected > 0  # the schedule actually exercised rejection
        assert len(first_codes) >= 10  # and a real mix of request keys
    finally:
        pool.shutdown()


def _consume(item, first_codes):
    key, kind, handle = item
    if kind == "reject":
        with pytest.raises(Exception, match="too long"):
            handle.result(timeout=600)
        return
    if kind == "stream":
        chunks = []
        result = None
        for x in handle:
            if isinstance(x, np.ndarray):
                chunks.append(x)
            else:
                result = x
        assert result is not None
        streamed = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        # streamed chunks re-assemble the retired waveform
        np.testing.assert_allclose(streamed, result.audio, atol=2e-4)
    else:
        result = handle.result(timeout=600)
    assert result.codes.shape[0] <= key[3]
    assert np.isfinite(result.audio).all()
    got = np.asarray(result.codes)
    if key in first_codes:
        np.testing.assert_array_equal(
            got, first_codes[key], err_msg=f"occupancy-dependent output for {key}",
        )
    else:
        first_codes[key] = got
