"""Checkpoints in the PyTorch port, on the CPU: a directory written by the
JAX package's ``save_checkpoint`` loads bit for bit (float32, and bf16, which
npz keeps as ``|V2``), the port's ``save_checkpoint`` writes the JAX
package's files member for member, flatten / unflatten round-trip, and an
engine built from the directory decodes the JAX engine's greedy codes."""

import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.api.engine import TTSEngine as JEngine
from leaxer_qwen3_tts_tpu.runtime import weights as jw
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_torch.runtime import weights as tw

torch.set_num_threads(2)

FORMATS = ["npz", "safetensors"]


def _bf16(tree):
    """The tiny model with every float32 leaf cast to bf16."""
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, tree)


def _jax_dir(tmp_path, tiny_model, dtype, fmt):
    cfg, params = tiny_model
    if dtype == "bf16":
        params = _bf16(params)
    d = str(tmp_path / f"jax-{dtype}-{fmt}")
    jw.save_checkpoint(d, cfg, params, fmt=fmt)
    return d, cfg, params


def _bits(x) -> np.ndarray:
    """A leaf's bytes as unsigned integers of its width (bf16 -> uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    return np.ascontiguousarray(x).view(f"u{x.dtype.itemsize}")


def _tensor_dtype(x) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32,
            "int8": torch.int8}[str(x.dtype)]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jax_checkpoint_loads_bit_for_bit(tmp_path, tiny_model, dtype, fmt):
    """Every leaf of the JAX params, by key: the same dtype, shape and bits
    (bf16 npz members are ``|V2`` on disk, whatever wrote them)."""
    d, cfg, params = _jax_dir(tmp_path, tiny_model, dtype, fmt)
    if fmt == "npz" and dtype == "bf16":
        with np.load(os.path.join(d, jw.WEIGHTS_NPZ)) as z:
            assert z["talker/lm_head"].dtype.str == "|V2"
    tc, tp = tw.load_checkpoint(d)
    assert tc == tcfg.TTSModelConfig.from_json(cfg.to_json())
    want = jw.flatten_params(jax.device_get(params))
    got = dict(tw._leaves(tp))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu"
        assert got[k].dtype == _tensor_dtype(v) and tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)


def _npz_members(path):
    """{member name: (dtype.str, shape, raw bytes)} of an npz file."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                version = np.lib.format.read_magic(f)
                shape, _, dtype = np.lib.format._read_array_header(f, version)
                out[name] = (dtype.str, shape, f.read())
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_npz_equals_jax_member_for_member(tmp_path, tiny_model, dtype):
    """The port's save_checkpoint of the loaded params writes the JAX
    package's npz members (names, ``dtype.str``, shapes, bytes) and the same
    ``config.json``."""
    d, _, _ = _jax_dir(tmp_path, tiny_model, dtype, "npz")
    tc, tp = tw.load_checkpoint(d)
    out = str(tmp_path / "port")
    tw.save_checkpoint(out, tc, tp)
    want, got = _npz_members(os.path.join(d, jw.WEIGHTS_NPZ)), _npz_members(
        os.path.join(out, tw.WEIGHTS_NPZ))
    assert set(got) == set(want)
    for name, (dstr, shape, raw) in want.items():
        assert got[name][:2] == (dstr, shape), name
        assert got[name][2] == raw, name
    with open(os.path.join(d, jw.CONFIG_FILE)) as a, open(os.path.join(out, tw.CONFIG_FILE)) as b:
        assert json.load(a) == json.load(b)


def test_port_safetensors_roundtrip(tmp_path, tiny_model):
    """A bf16 safetensors checkpoint written by the port loads back bit for
    bit in the port and in the JAX package."""
    _, params = tiny_model
    d, cfg, _ = _jax_dir(tmp_path, tiny_model, "bf16", "npz")
    tc, tp = tw.load_checkpoint(d)
    out = str(tmp_path / "port-st")
    tw.save_checkpoint(out, tc, tp, fmt="safetensors")
    _, back = tw.load_checkpoint(out)
    _, jback = jw.load_checkpoint(out)
    want = jw.flatten_params(jax.device_get(_bf16(params)))
    got, jgot = dict(tw._leaves(back)), jw.flatten_params(jax.device_get(jback))
    for k, v in want.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
        np.testing.assert_array_equal(_bits(jgot[k]), _bits(v), err_msg=k)


def test_jax_loader_refuses_its_own_bf16_npz(tmp_path, tiny_model):
    """The standing difference the port's loader closes: the JAX package's
    load_checkpoint raises on the ``|V2`` members of a bf16 npz."""
    d, _, _ = _jax_dir(tmp_path, tiny_model, "bf16", "npz")
    with pytest.raises(TypeError, match="V2"):
        jw.load_checkpoint(d)


def test_unknown_void_member_raises(tmp_path, tiny_model):
    d, cfg, params = _jax_dir(tmp_path, tiny_model, "f32", "npz")
    flat = jw.flatten_params(jax.device_get(params))
    flat["talker/odd"] = np.zeros((3,), "V4")
    np.savez(os.path.join(d, jw.WEIGHTS_NPZ), **flat)
    with pytest.raises(ValueError, match="talker/odd"):
        tw.load_checkpoint(d)


def test_flatten_unflatten_roundtrip():
    """Lists become digit segments and come back as lists; tensors and
    arrays flatten alike (bf16 as ``|V2``)."""
    params = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "layers": [{"w": torch.ones(2, dtype=torch.bfloat16)}, {"w": torch.zeros(2)}],
        "nested": {"list": [np.int32(3), np.array([1, 2], np.int8)]},
    }
    flat = tw.flatten_params(params)
    assert sorted(flat) == ["a", "layers/0/w", "layers/1/w", "nested/list/0", "nested/list/1"]
    assert flat["layers/0/w"].dtype == np.dtype("V2")
    back = tw.unflatten_params(flat)
    assert isinstance(back["layers"], list) and isinstance(back["nested"]["list"], list)
    assert set(tw.flatten_params(back)) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(_bits(tw.flatten_params(back)[k]), _bits(flat[k]))
    assert tw.param_count(params) == 6 + 2 + 2 + 1 + 2


def test_model_dir_is_checkpoint(tmp_path, tiny_model):
    d, _, _ = _jax_dir(tmp_path, tiny_model, "f32", "npz")
    assert tw.model_dir_is_checkpoint(d) and jw.model_dir_is_checkpoint(d)
    assert not tw.model_dir_is_checkpoint(str(tmp_path))
    os.remove(os.path.join(d, jw.WEIGHTS_NPZ))
    assert not tw.model_dir_is_checkpoint(d) and not jw.model_dir_is_checkpoint(d)


def test_init_params_with_speaker_encoder(tiny_model):
    """The port's init_params carries the speaker encoder of the JAX
    package's shapes and dtypes (both topologies), drawn after the other
    modules, whose values it leaves as they were."""
    cfg, params = tiny_model
    tc = tcfg.TTSModelConfig.from_json(cfg.to_json())
    for topology in ("transformer", "ecapa"):
        se = dataclasses.replace(cfg.speaker_encoder, topology=topology, ecapa_channels=32,
                                 ecapa_scale=4, ecapa_mfa_dim=48, ecapa_att_dim=16)
        jc, c = dataclasses.replace(cfg, speaker_encoder=se), dataclasses.replace(
            tc, speaker_encoder=tcfg.SpeakerEncoderConfig(**dataclasses.asdict(se)))
        want = dict(tw._leaves(jax.eval_shape(lambda: jw.init_params(jc, jax.random.PRNGKey(0)))))
        got = tw.flatten_params(tw.init_params(c, seed=3))
        assert {k: (v.shape, v.dtype.itemsize) for k, v in got.items()} == {
            k: (v.shape, v.dtype.itemsize) for k, v in want.items()}
    without = tw.flatten_params(tw.init_params(tc, seed=3, with_speaker_encoder=False))
    assert not any(k.startswith("speaker_encoder/") for k in without)
    full = tw.flatten_params(tw.init_params(tc, seed=3))
    for k, v in without.items():
        np.testing.assert_array_equal(_bits(full[k]), _bits(v), err_msg=k)


def test_engine_from_directory_matches_jax(tmp_path, tiny_model, tiny_vocab_files):
    """TTSEngine(model_dir) reads the checkpoint and the tokenizer beside it
    and decodes the JAX engine's greedy codes; without vocab.json it warns
    and keeps the token-level API."""
    d, _, _ = _jax_dir(tmp_path, tiny_model, "f32", "npz")
    vocab_path, merges_path, _ = tiny_vocab_files
    for src in (vocab_path, merges_path):
        with open(src) as f, open(os.path.join(d, os.path.basename(src)), "w") as g:
            g.write(f.read())
    kw = dict(max_frames=8, chunk_len=4, first_chunk_len=2)
    teng, jeng = TTSEngine(d, device="cpu", **kw), JEngine(d, **kw)
    assert teng.is_ready() and jeng.is_ready(), teng.get_error()
    assert teng.has_speaker_encoder() and jeng.has_speaker_encoder()
    t = teng.synthesize("hello world", temperature=0.0, max_tokens=8)
    j = jeng.synthesize("hello world", temperature=0.0, max_tokens=8)
    np.testing.assert_array_equal(t.codes, np.asarray(j.codes))
    os.remove(os.path.join(d, "vocab.json"))
    bare = TTSEngine(d, device="cpu", **kw)
    assert bare.is_ready() and bare.tokenizer is None
    with pytest.raises(EngineError, match="tokenizer not loaded"):
        bare.synthesize("hello world")
    assert bare.synthesize_tokens([5, 6, 7], temperature=0.0, max_tokens=4).codes.shape[1] == 16


def test_missing_directory_recorded_like_jax(tmp_path):
    """A missing directory is the construction error, not an exception, in
    both engines: the same error class (no such file) named in both."""
    missing = str(tmp_path / "nope")
    teng, jeng = TTSEngine(missing, device="cpu"), JEngine(missing)
    assert not teng.is_ready() and not jeng.is_ready()
    for err in (teng.get_error(), jeng.get_error()):
        assert "No such file or directory" in err and "config.json" in err
    with pytest.raises(EngineError, match="engine not ready: .*No such file"):
        teng.synthesize("hello")
