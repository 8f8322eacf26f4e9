"""The PyTorch port's building blocks against the JAX package on the same
seed-made inputs: int8 quantization, the kernel pack, RMSNorm, RoPE, the
prefill forward, build_prompt, the tokenizer, the vocoder, configs and
parameter shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaxer_qwen3_tts_tpu import config as jcfg
from leaxer_qwen3_tts_tpu.models import layers as jlayers
from leaxer_qwen3_tts_tpu.ops import fused_step as jfs
from leaxer_qwen3_tts_tpu.ops import quant as jquant
from leaxer_qwen3_tts_tpu.runtime import prompt as jprompt
from leaxer_qwen3_tts_tpu.runtime.weights import flatten_params
from leaxer_qwen3_tts_torch import config as tcfg
from leaxer_qwen3_tts_torch.models import layers as tlayers
from leaxer_qwen3_tts_torch.ops import fused_step as tfs
from leaxer_qwen3_tts_torch.ops import quant as tquant
from leaxer_qwen3_tts_torch.runtime import prompt as tprompt
from leaxer_qwen3_tts_torch.runtime.weights import init_params, params_from_jax

torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port_transformer_cfg(t):
    return tcfg.TransformerConfig(**dataclasses.asdict(t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_equal(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 96, 40)) * 0.05).astype(np.float32)
    w[1, :, 7] = 0.0  # an all-zero column keeps scale 1
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = _t(w).to(tcfg.torch_dtype(dtype))
    jq = jquant.quantize_weight(jw)
    tq = tquant.quantize_weight(tw)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


def test_pack_dequantizes_to_equal_values():
    """The Hopper [N, K] pack and the JAX [H, 1024] unit pack dequantize to
    the same matrices (units re-assembled into whole matrices)."""
    t = jcfg.TransformerConfig(
        hidden_size=1024, num_layers=1, num_heads=16, num_kv_heads=8, head_dim=128,
        intermediate_size=2048, dtype="float32",
    )
    params = jlayers.init_transformer_params(t, jax.random.PRNGKey(3))
    jfw = jfs.pack_fused_weights(t, params["layers"])
    tfw = tfs.pack_fused_weights(
        _port_transformer_cfg(t), params_from_jax(flatten_params(jax.device_get(params["layers"])))
    )
    units = np.asarray(jfw.units, np.float32)[0] * np.asarray(jfw.scales)[0]  # [U, H, 1024]
    n_qkv, n_wo, n_gu, n_wd = jfs._unit_counts(t)
    H, N = 1024, 1024

    def n_cat(lo, n):
        return np.concatenate([units[u] for u in range(lo, lo + n)], axis=1)

    def k_cat(lo, n_k):  # k-major units of [H, N] with one N tile (H == N_UNIT)
        return np.concatenate([units[lo + i] for i in range(n_k)], axis=0)

    want = {
        "qkv": n_cat(0, n_qkv),
        "o": k_cat(n_qkv, n_wo),
        "gu": n_cat(n_qkv + n_wo, n_gu),
        "d": k_cat(n_qkv + n_wo + n_gu, n_wd),
    }
    got = {
        "qkv": (tfw.wqkv[0].float() * tfw.sqkv[0][:, None]).T,
        "o": (tfw.wo[0].float() * tfw.so[0][:, None]).T,
        "gu": (tfw.wgu[0].float() * tfw.sgu[0][:, None]).T,
        "d": (tfw.wd[0].float() * tfw.sd[0][:, None]).T,
    }
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_rms_norm_and_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **F32,
    )
    pos = np.array([[0, 1, 2, 7, 30], [3, 4, 5, 6, 9]], np.int32)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 16, 1e6)
    tc, ts = tlayers.rope_angles(_t(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **F32)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(x), tc, ts).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jc, js)), **F32,
    )


@pytest.mark.parametrize("fused,quantized", [(False, False), (True, True)])
def test_transformer_forward_prefill(fused, quantized):
    """Prefill through a small GQA stack (QK-norm, RoPE), raw or fused+int8."""
    t = jcfg.TransformerConfig(
        hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        intermediate_size=128, dtype="float32",
    )
    params = jlayers.init_transformer_params(t, jax.random.PRNGKey(1))
    tparams = params_from_jax(flatten_params(jax.device_get({"m": {"transformer": params}})))
    jparams = {"m": {"transformer": params}}
    if fused:
        jparams = jquant.fuse_params(jparams, modules=("m",))
        tparams = tquant.fuse_params(tparams, modules=("m",))
    if quantized:
        jparams = jquant.quantize_params(jparams, modules=("m",))
        tparams = tquant.quantize_params(tparams, modules=("m",))
    rng = np.random.default_rng(2)
    B, S, T = 1, 7, 12
    emb = rng.standard_normal((B, S, 64)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    qv = np.ones((B, S), bool)
    qv[0, 6] = False  # one pad query
    jc = jlayers.init_kv_cache(t, B, T)
    jh, jcache, jvalid = jlayers.transformer_forward(
        t, jparams["m"]["transformer"], jnp.asarray(emb), jnp.asarray(pos), jc,
        jnp.zeros((B, T), bool), query_valid=jnp.asarray(qv),
    )
    tc = tlayers.init_kv_cache(_port_transformer_cfg(t), B, T, "cpu")
    th, tcache, tvalid = tlayers.transformer_forward(
        _port_transformer_cfg(t), tparams["m"]["transformer"], _t(emb), _t(pos).long(), tc,
        torch.zeros((B, T), dtype=torch.bool), query_valid=_t(qv),
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **F32)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **F32)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tcache.length == S


@pytest.mark.parametrize("lang", [None, jcfg.LANG_ENGLISH])
def test_build_prompt_and_trailing(tiny_model, lang):
    cfg, params = tiny_model
    temb = params_from_jax(flatten_params(jax.device_get({"e": params["embeddings"]})))["e"]
    ids = np.array([[101, 2002, 30303, 4, 55555, 0, 0]], np.int32)
    lens = np.array([5], np.int32)
    jb = jprompt.build_prompt(params["embeddings"], jnp.asarray(ids), jnp.asarray(lens), lang)
    tb = tprompt.build_prompt(temb, _t(ids).long(), _t(lens), lang)
    np.testing.assert_allclose(tb.prompt_embeds.numpy(), np.asarray(jb.prompt_embeds), atol=1e-6)
    np.testing.assert_allclose(tb.trailing.numpy(), np.asarray(jb.trailing), atol=1e-6)
    np.testing.assert_allclose(tb.tts_pad_embed.numpy(), np.asarray(jb.tts_pad_embed), atol=1e-6)
    assert tb.prompt_len == int(np.asarray(jb.prompt_len)[0]) == tprompt.prompt_length(lang)


@pytest.mark.parametrize("backend", ["auto", "python"])
def test_tokenizer_matches_jax(tiny_vocab_files, backend):
    """The port's frontend copy gives the JAX package's tokens.  "auto" loads
    the shared native library (native/) when it is built, as the engine does;
    the JAX package's own tests pin native == python."""
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer as JaxTokenizer
    from leaxer_qwen3_tts_torch.frontend import Tokenizer

    vocab_path, merges_path, _ = tiny_vocab_files
    mine = Tokenizer(vocab_path, merges_path, backend=backend)
    ref = JaxTokenizer(vocab_path, merges_path, backend=backend)
    for text in ["hello world", "Hello, World! 123", "你好，世界", "  tabs\tand\nlines ",
                 "héllo wörld"]:
        ids = mine.encode(text)
        assert ids == ref.encode(text), text
        assert mine.decode(ids) == text


def test_vocoder_matches_jax_and_streams_exactly(tiny_model):
    """vocoder_forward (channels-last [B, T, C] / [K, Cin, Cout] weights) vs
    JAX on the same codes; a chunk decoded with left context equals the
    tail of the full decode."""
    from leaxer_qwen3_tts_tpu.models.codec12hz import vocoder_forward as jax_vocoder
    from leaxer_qwen3_tts_torch.models.codec12hz import vocode_chunk, vocoder_forward

    cfg, params = tiny_model
    vcfg = tcfg.TTSModelConfig.from_json(cfg.to_json()).vocoder
    vparams = params_from_jax(flatten_params(jax.device_get({"v": params["vocoder"]})))["v"]
    codes = np.random.default_rng(4).integers(0, 2048, (1, 28, 16)).astype(np.int32)
    full = vocoder_forward(vcfg, vparams, _t(codes))
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jax_vocoder(cfg.vocoder, params["vocoder"], jnp.asarray(codes))),
        atol=1e-5, rtol=1e-5,
    )
    ctx, start = vcfg.left_context_frames, 20
    assert ctx <= start
    chunk = vocode_chunk(vcfg, vparams, _t(codes[:, start - ctx :]), ctx)
    spf = vcfg.samples_per_frame
    np.testing.assert_allclose(chunk.numpy(), full[:, start * spf :].numpy(), atol=1e-6)


def test_config_json_round_trip():
    for preset in (jcfg.QWEN3_TTS_06B, jcfg.QWEN3_TTS_17B):
        port = tcfg.TTSModelConfig.from_json(preset.to_json())
        assert port.to_json() == preset.to_json()
        assert jcfg.TTSModelConfig.from_json(port.to_json()) == preset
    assert tcfg.QWEN3_TTS_06B.to_json() == jcfg.QWEN3_TTS_06B.to_json()
    assert tcfg.torch_dtype("bfloat16") is torch.bfloat16


def test_init_params_shapes_match_jax(tiny_model):
    """JAX-free init_params gives the JAX init's shapes and dtypes, and
    params_from_jax converts every leaf of the modules the port runs."""
    cfg, params = tiny_model
    port_cfg = tcfg.TTSModelConfig.from_json(cfg.to_json())
    mine = init_params(port_cfg, seed=0)
    flat_j = {k: v for k, v in flatten_params(jax.device_get(params)).items()
              if k.split("/")[0] in mine}
    conv = params_from_jax(flat_j)

    def leaves(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, f"{prefix}{k}/")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from leaves(v, f"{prefix}{i}/")
        else:
            yield prefix[:-1], node

    a, b = dict(leaves(mine)), dict(leaves(conv))
    assert a.keys() == b.keys() == flat_j.keys()
    for k in a:
        assert a[k].shape == b[k].shape == flat_j[k].shape, k
        assert a[k].dtype == b[k].dtype, k
