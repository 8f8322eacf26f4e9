"""The checkpoint loader's npz reader (``runtime/weights.py::_npz_arrays``):
every member equal to what ``np.load`` gives, bit for bit (dtype, shape,
memory order, bytes), for stored and compressed archives, bf16 bits under
``|V2``, Fortran-ordered and 0-d members; truncated and pickled members
refused; and a checkpoint of the JAX package's writer loaded through it
equal to the JAX package's own reader."""

import os

import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_torch.runtime import weights as tw


def _members(rng):
    return {
        "talker/layers/0/wq": rng.integers(-30000, 30000, (64, 48), dtype=np.int16).view("V2"),
        "f32": rng.standard_normal((300, 7), dtype=np.float32),
        "i8": rng.integers(-5, 5, (33,), dtype=np.int8),
        "fortran": np.asfortranarray(rng.standard_normal((5, 6)).astype(np.float32)),
        "scalar": np.float32(3.0),
        "empty": np.zeros((0, 4), np.float32),
    }


@pytest.mark.parametrize("save", [np.savez, np.savez_compressed])
def test_npz_reader_matches_np_load(tmp_path, save):
    path = os.path.join(tmp_path, "p.npz")
    save(path, **_members(np.random.default_rng(0)))
    with np.load(path) as data:
        want = {k: data[k] for k in data.files}
    got = dict(tw._npz_arrays(path))
    assert list(got) == list(want)
    for k, a in want.items():
        b = got[k]
        assert (b.dtype, b.shape, b.flags.f_contiguous) == (a.dtype, a.shape, a.flags.f_contiguous)
        assert b.tobytes() == a.tobytes(), k


def test_npz_reader_refuses_truncated_and_pickled(tmp_path):
    path = os.path.join(tmp_path, "p.npz")
    np.savez(path, a=np.arange(1000, dtype=np.float32))
    with open(path, "rb") as f:
        data = f.read()
    cut = os.path.join(tmp_path, "cut.npz")
    with open(cut, "wb") as f:  # the member's last bytes gone, the directory kept
        i = data.index(b"PK\x01\x02")
        f.write(data[:i - 400] + data[i:])
    with pytest.raises(Exception):
        list(tw._npz_arrays(cut))
    pick = os.path.join(tmp_path, "pick.npz")
    np.savez(pick, o=np.array([{"x": 1}], dtype=object))
    with pytest.raises(ValueError, match="Python objects"):
        list(tw._npz_arrays(pick))


def test_checkpoint_of_jax_writer_loads_equal(tmp_path):
    """A directory the JAX package's save_checkpoint wrote, at its tiny
    config, read by the port's loader: every leaf equal to the JAX
    package's own loader's, bit for bit (bf16 through its bits)."""
    import jax

    from conftest_util import build_tiny_cfg
    from leaxer_qwen3_tts_tpu.runtime import weights as jw

    cfg = build_tiny_cfg()
    params = jw.init_params(cfg, jax.random.PRNGKey(0))
    d = os.path.join(tmp_path, "ckpt")
    jw.save_checkpoint(d, cfg, params)
    _, want = jw.load_checkpoint(d)
    _, got = tw.load_checkpoint(d)
    flat_want = jw.flatten_params(jax.device_get(want))
    flat_got = dict(tw._leaves(got))
    assert set(flat_got) == set(flat_want)
    for k, a in flat_want.items():
        t = flat_got[k]
        b = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        a = np.asarray(a)
        a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert b.shape == a.shape and b.tobytes() == a.tobytes(), k
