"""Kernel K8 (PyTorch port): the plain version of ``flash_attend`` against
the JAX package's Pallas kernel in interpret mode on the same seed-made
inputs, and the ``attend`` dispatch on the config's ``attn_impl``.  The
kernel's schedule on the CPU: the plain version run over only each block's
key-tile range, with the closed form for rows that allow no key, against
the JAX kernel; the query positions per block; P.V with P split into bf16
hi + lo against float32 P.V."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu.ops.flash_attention import flash_attend as j_flash
from leaxer_qwen3_tts_torch.ops import attention as tattn
from leaxer_qwen3_tts_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

# both sides run the same float32 online softmax over the same key tiles;
# only the order of the dot products' sums differs
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 outputs: one bf16 ulp (2^-8 relative) where a float32 difference
# crosses a rounding edge
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _inputs(seed, B, S, T, nq, nk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, nq, d)).astype(np.float32)
    k = rng.standard_normal((B, nk, T, d)).astype(np.float32)
    v = rng.standard_normal((B, nk, T, d)).astype(np.float32)
    return q, k, v


def _causal(B, S, T):
    """Queries at positions T-S..T-1 over a T-long key history."""
    qpos = np.arange(S) + (T - S)
    return np.broadcast_to(np.arange(T)[None, None, :] <= qpos[None, :, None], (B, S, T)).copy()


def _both(q, k, v, mask, dtype="f32"):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = j_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                   jnp.asarray(mask), interpret=True)
    got = tflash.flash_attend(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                              torch.from_numpy(v).to(td), torch.from_numpy(mask))
    assert got.dtype == td and got.shape == q.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize(
    "B,S,T,nq,nk,d",
    [
        (1, 16, 16, 4, 2, 16),  # GQA 2:1
        (2, 8, 32, 4, 4, 16),  # MHA, longer keys
        (1, 5, 23, 8, 2, 16),  # non-multiple-of-block sizes (padding path)
        (2, 1, 17, 4, 2, 16),  # decode shape
        (1, 7, 300, 4, 2, 16),  # three 128-key tiles, the last one padded
        (2, 9, 150, 16, 2, 16),  # GQA 8:1, T past a 64-key tile
        (1, 1, 150, 8, 8, 16),  # MHA decode row over a ragged T
        # K8's reach: the head_dims the kernel pads (64, 80, 96 -> 128, 256)
        # and the q-per-kv groups past one m16 tile of heads (16, 32), and
        # head_dims off the 8-value copy run (17, 100)
        (1, 6, 40, 4, 2, 64),
        (1, 5, 23, 2, 2, 80),
        (1, 5, 23, 4, 1, 96),
        (1, 4, 20, 2, 2, 128),
        (1, 3, 20, 2, 1, 256),
        (1, 4, 30, 16, 1, 16),
        (1, 3, 30, 32, 1, 16),
        (1, 3, 17, 6, 2, 17),
        (1, 2, 9, 2, 1, 100),
    ],
)
def test_flash_matches_jax(B, S, T, nq, nk, d):
    q, k, v = _inputs(0, B, S, T, nq, nk, d)
    got, want = _both(q, k, v, _causal(B, S, T))
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_flash_invalid_keys_match_jax():
    """A right-padded prompt: some cache slots are invalid for every query."""
    B, S, T, nq, nk, d = 2, 8, 24, 4, 2, 16
    q, k, v = _inputs(1, B, S, T, nq, nk, d)
    valid = np.arange(T)[None, :] < np.array([20, 13])[:, None]
    got, want = _both(q, k, v, _causal(B, S, T) & valid[:, None, :])
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("T", [16, 23, 150, 200])
def test_flash_fully_masked_rows_match_jax(T):
    """A row masked everywhere: every score is the finite -1e30, so each
    visited key weighs exp(0) = 1 and the row's output is the sum of V over
    the padded key count -- the JAX kernel's value, not zeros."""
    B, S, nq, nk, d = 1, 4, 2, 2, 16
    q, k, v = _inputs(2, B, S, T, nq, nk, d)
    mask = np.zeros((B, S, T), bool)
    mask[:, :2] = True
    got, want = _both(q, k, v, mask)
    np.testing.assert_allclose(got, want, **F32_TOL)
    Tp = tflash.padded_keys(T)
    np.testing.assert_allclose(got[0, 2:, 0], np.broadcast_to(v[0, 0].sum(0) / Tp, (2, d)),
                               **F32_TOL)


def test_flash_bf16_matches_jax():
    """bf16 q, k and v (the talker's prefill dtype): float32 arithmetic
    inside, the output rounded to bf16."""
    B, S, T, nq, nk, d = 1, 12, 40, 4, 2, 32
    q, k, v = _inputs(3, B, S, T, nq, nk, d)
    mask = _causal(B, S, T)
    mask[:, :, 30:] = False
    got, want = _both(q, k, v, mask, "bf16")
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_attend_dispatch():
    """``attend`` runs attend_xla for "xla", K8 for "pallas" and raises on
    any other impl, as the JAX dispatch does."""
    q, k, v = _inputs(4, 1, 6, 20, 4, 2, 16)
    q, k, v = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    mask = torch.from_numpy(_causal(1, 6, 20))
    assert torch.equal(tattn.attend(q, k, v, mask), tattn.attend_xla(q, k, v, mask))
    assert torch.equal(tattn.attend(q, k, v, mask, impl="pallas"),
                       tflash.flash_attend_reference(q, k, v, mask))
    torch.testing.assert_close(tattn.attend(q, k, v, mask, impl="pallas"),
                               tattn.attend_xla(q, k, v, mask), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attend(q, k, v, mask, impl="flash")


def test_flash_tiles():
    """The JAX kernel's key tile and padded key count."""
    assert [tflash.block_t(T) for T in (1, 8, 23, 128, 256, 300)] == [8, 8, 23, 128, 128, 128]
    assert [tflash.padded_keys(T) for T in (1, 8, 23, 128, 256, 300)] == [8, 8, 23, 128, 256, 384]


# the kernel's schedule: (kind, S) of the mask; T = 150 is not a multiple of
# either key tile (64 on the tensor cores, 32 on the CUDA cores)
SCHEDULE_MASKS = {
    "causal prefill": 9,  # query i at position i over a T-slot bucket
    "random lengths": 9,  # queries at T-S..T-1, each batch row valid below a random length
    "dead rows": 9,  # random lengths, and batch row 0 with rows masked everywhere
    "last tile only": 9,  # every allowed key in the last key tile
    "S = 1": 1,  # one query row per batch row
}
SCHEDULE_T = 150


def _schedule_mask(kind, B, S, T, rng):
    keys = np.arange(T)[None, None, :]
    if kind == "causal prefill":
        return np.broadcast_to(keys <= np.arange(S)[None, :, None], (B, S, T)).copy()
    if kind == "last tile only":
        return np.broadcast_to(keys >= (T - 1) // 64 * 64, (B, S, T)).copy()
    valid = rng.integers(T // 2, T + 1, (B,))
    mask = _causal(B, S, T) & (keys < valid[:, None, None])
    if kind == "dead rows":
        mask[0, [0, 2, S - 1]] = False
    return mask


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("kind", list(SCHEDULE_MASKS))
def test_flash_schedule_matches_jax(kind, g):
    """The plain version over only each block's key-tile range (for each key
    tile and for query tiles of 16 // g and 8 // g positions), with
    sum_{t<T} v_t / Tp for the rows that allow no key, equals the JAX kernel
    over every key."""
    B, S, T, nk, d = 2, SCHEDULE_MASKS[kind], SCHEDULE_T, 2, 16
    nq = g * nk
    rng = np.random.default_rng(5 + g)
    q, k, v = _inputs(10 + g, B, S, T, nq, nk, d)
    mask = _schedule_mask(kind, B, S, T, rng)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                              interpret=True))
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    for key_tile in sorted(set(tflash.KEY_TILE.values())):
        for sms in (1, 132):
            qt = tflash.query_tile(g, B, nk, S, sms)
            lo, hi, alive = tflash.key_schedule(tm, qt, key_tile)
            if kind == "last tile only":
                assert (lo == hi).all() and (hi == (T - 1) // key_tile).all()
            if kind == "dead rows":
                assert not alive[0, 0] and alive[0, 1] and alive[1].all()
            got = tflash.flash_attend_scheduled(tq, tk, tv, tm, qt, key_tile)
            np.testing.assert_allclose(got.numpy(), want, **F32_TOL, err_msg=f"{key_tile} {qt}")


def test_key_schedule_ranges():
    """Each block's tiles: from the first to the last key that any of its
    positions allows; a block whose positions allow none visits no tile."""
    mask = torch.zeros((1, 6, 200), dtype=torch.bool)
    mask[0, 0, 70] = True  # block 0 (positions 0-1): keys 70 and 129
    mask[0, 1, 129] = True
    mask[0, 4, 5:10] = True  # block 2: keys 5-9; block 1 (positions 2-3): none
    lo, hi, alive = tflash.key_schedule(mask, 2, 64)
    assert lo.tolist() == [[1, 0, 0]] and hi.tolist() == [[2, -1, 0]]
    assert alive.tolist() == [[True, True, False, False, True, False]]


def test_query_tile():
    """16 // g positions per block when every SM gets a block, else 8 // g:
    the 1.7B prefill (B=1, nk=8, g=2, S=57) on 132 SMs runs 4 positions per
    block, 120 blocks.  Past 16 q heads per kv head a block holds 16 of them
    at one position (a kv head's heads over ceil(g / 16) blocks)."""
    assert tflash.query_tile(2, 1, 8, 57, 132) == 4
    assert tflash.query_tile(2, 1, 8, 57, 64) == 8
    assert [tflash.query_tile(g, 1, 1, 1, 132) for g in (1, 2, 4, 8, 16)] == [8, 4, 2, 1, 1]
    assert [tflash.query_tile(g, 4, 8, 512, 132) for g in (1, 2, 4, 8, 16)] == [16, 8, 4, 2, 1]
    assert [tflash.query_tile(g, 1, 1, 1, 132) for g in (17, 32, 48)] == [1, 1, 1]
    with pytest.raises(ValueError):
        tflash.query_tile(0, 1, 1, 1, 132)


@pytest.mark.parametrize("seed,rows,keys", [(0, 16, 64), (1, 57, 256), (2, 8, 150)])
def test_split_pv_within_2_to_minus_15(seed, rows, keys):
    """P.V with P as bf16 hi + lo stays within 2^-15 of float32 P.V,
    relative to |P|.|V| per output; P rounded once to bf16 does not."""
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.standard_normal((rows, keys)).astype(np.float32)) * 3
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    v = torch.from_numpy(rng.standard_normal((keys, 128)).astype(np.float32)).to(torch.bfloat16)
    exact = torch.matmul(p.double(), v.double())
    scale = torch.matmul(p.double(), v.double().abs())
    err = ((tflash.split_pv(p, v).double() - exact).abs() / scale).max()
    one = ((torch.matmul(p.to(torch.bfloat16).double(), v.double()) - exact).abs() / scale).max()
    assert err <= 2 ** -15 and one > 2 ** -15, (float(err), float(one))
