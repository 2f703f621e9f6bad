"""Port parity for the ``gptq``, ``awq``, ``llm_compressor`` and ``mlx``
writers (``autoround_tpu_torch/export/formats.py``, ``export/mlx.py``)
against the JAX package's.

``tiny`` preset, fp32, CPU.  Tolerances: the writers' directories are
byte-equal to the JAX package's on the same RTN result (the port's RTN is
bit-equal to JAX's, ``tests/test_torch_intq.py``); the packers' round trips
are exact (codes, scales and zero points equal).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.export import formats as jformats
from autoround_tpu.export import mlx as jmlx
from autoround_tpu.export import save_quantized as j_save
from autoround_tpu.models import llama as jl
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch.export import codes_from_qdq, formats, mlx
from autoround_tpu_torch.export import save_quantized
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401

JCFG = jl.CONFIG_PRESETS["tiny"]


@pytest.fixture(scope="module")
def tiny():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(JCFG))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ids = np.random.default_rng(1).integers(0, JCFG.vocab_size, (4, 32))
    return jp, tcfg, tp, ids


# the RTN results the tests read, by name: made once a module
SCHEMES = {
    "W4A16G32": "W4A16G32",
    "asym": {"bits": 4, "group_size": 32, "sym": False},
    "w2": {"bits": 2, "group_size": 32, "sym": True},
    "w8": {"bits": 8, "group_size": 32, "sym": True},
    "FP8_STATIC": "FP8_STATIC",
}
_RESULTS = {}


def _pair(tiny, key):
    """(JAX AutoRound, its result, port AutoRound, its result) of the RTN
    run of ``SCHEMES[key]`` with the lm_head."""
    if key not in _RESULTS:
        jp, tcfg, tp, ids = tiny
        kw = dict(scheme=SCHEMES[key], iters=0, quant_lm_head=True)
        jar = JAutoRound((jp, JCFG), **kw)
        jres = jar.quantize(jnp.asarray(ids))
        ar = AutoRound((tp, tcfg), device="cpu", **kw)
        _RESULTS[key] = (jar, jres, ar, ar.quantize(ids))
    return _RESULTS[key]


def _same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in sorted(os.listdir(a)):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("key", ["W4A16G32", "asym"])
@pytest.mark.parametrize("fmt", ["gptq", "awq", "llm_compressor", "mlx"])
def test_writers_byte_equal_jax(tiny, tmp_path, fmt, key):
    jar, jres, ar, tres = _pair(tiny, key)
    j_save(jres, jar.model_cfg, str(tmp_path / "j"), format=fmt)
    save_quantized(tres, ar.model_cfg, str(tmp_path / "t"), format=fmt)
    _same_dirs(tmp_path / "j", tmp_path / "t")


def test_llm_compressor_fp8_and_refusals(tiny, tmp_path):
    """FP8 layers go float-quantized under ``llm_compressor`` (e4m3
    weights, fp32 scales, byte-equal to JAX's); the int-only writers refuse
    them as the JAX package does."""
    jar, jres, ar, tres = _pair(tiny, "FP8_STATIC")
    j_save(jres, jar.model_cfg, str(tmp_path / "j"), format="llm_compressor")
    save_quantized(tres, ar.model_cfg, str(tmp_path / "t"),
                   format="llm_compressor")
    _same_dirs(tmp_path / "j", tmp_path / "t")
    for fmt in ("gptq", "awq", "autoround", "mlx"):
        with pytest.raises(NotImplementedError, match="fp8"):
            save_quantized(tres, ar.model_cfg, str(tmp_path / fmt),
                           format=fmt)
        with pytest.raises(NotImplementedError, match="fp8"):
            j_save(jres, jar.model_cfg, str(tmp_path / f"j{fmt}"),
                   format=fmt)
    with pytest.raises(NotImplementedError, match="A13"):
        save_quantized(tres, ar.model_cfg, str(tmp_path / "g"),
                       format="gguf:q4_k_m")


@pytest.mark.parametrize("key,bits,sym", [("w2", 2, True),
                                          ("W4A16G32", 4, True),
                                          ("w8", 8, True),
                                          ("asym", 4, False)])
def test_ct_packers_round_trip_like_jax(tiny, key, bits, sym):
    """``ct_pack_layer`` equals JAX's arrays; ``ct_unpack_layer`` gives the
    layer's codes, scales and zero points back exactly."""
    jar, jres, ar, tres = _pair(tiny, key)
    for name in ("blocks.0.q_proj", "blocks.1.down_proj"):
        tq, jq = tres.layers[name], jres.layers[name]
        t = formats.ct_pack_layer(tq)
        j = jformats.ct_pack_layer(jq)
        assert list(t) == list(j)
        for k in j:
            # the bytes each array's writer stores: a view's buffer as it
            # lies (JAX's zero points are a transposed view)
            assert t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k].ravel(), j[k].ravel("K"),
                                          err_msg=k)
        codes, scale, zp = formats.ct_unpack_layer(t, bits)
        want = codes_from_qdq(tq.qdq.numpy(), tq.scale.numpy(),
                              None if tq.zp is None else tq.zp.numpy(),
                              bits, 32)
        np.testing.assert_array_equal(codes.numpy(), want)
        np.testing.assert_array_equal(scale.numpy(),
                                      tq.scale.half().float().numpy())
        if sym:
            assert zp is None
        else:
            np.testing.assert_array_equal(zp.numpy(), tq.zp.numpy())


def test_ct_float_layer_like_jax(tiny):
    jar, jres, ar, tres = _pair(tiny, "FP8_STATIC")
    for name in ("blocks.0.q_proj", "lm_head"):
        t = formats.ct_float_layer(tres.layers[name])
        j = jformats.ct_float_layer(jres.layers[name])
        assert list(t) == list(j)
        np.testing.assert_array_equal(
            t["weight"].view(torch.uint8).numpy(),
            j["weight"].view(np.uint8))
        for k in ("weight_scale", "weight_shape"):
            np.testing.assert_array_equal(t[k].numpy(), j[k])


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
def test_mlx_packers_round_trip_like_jax(bits):
    """The MLX bit stream (codes crossing words at 3, 5, 6 bits) equals
    JAX's words; unpacking gives the codes back."""
    codes = np.random.default_rng(bits).integers(0, 2 ** bits, (8, 128),
                                                 dtype=np.uint32)
    words = mlx.pack_mlx_weight(torch.from_numpy(codes.astype(np.int64)),
                                bits)
    assert words.dtype == np.uint32
    np.testing.assert_array_equal(words, jmlx.pack_mlx_weight(codes, bits))
    np.testing.assert_array_equal(
        mlx.unpack_mlx_weight(words, bits, 128).numpy(), codes)
    np.testing.assert_array_equal(
        mlx.unpack_mlx_weight(torch.from_numpy(words.view(np.int32)), bits,
                              128).numpy(), codes)


def test_mlx_layer_and_names_like_jax(tiny):
    jar, jres, ar, tres = _pair(tiny, "W4A16G32")
    for name in ("blocks.0.q_proj", "lm_head"):
        t = mlx.mlx_pack_layer(tres.layers[name])
        j = jmlx.mlx_pack_layer(jres.layers[name])
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for flat in ("blocks.1.q_bias", "blocks.0.input_layernorm", "norm",
                 "embed_tokens", "lm_head", "blocks.0.router", "x"):
        assert mlx._hf_name(flat) == jmlx._hf_name(flat), flat
    assert formats.FORMATS == {}
    formats.register_format("probe")(len)
    assert formats.FORMATS.pop("probe") is len
