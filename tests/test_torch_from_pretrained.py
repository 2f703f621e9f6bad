"""Serving from files: ``QuantizedLlama.from_pretrained`` on the JAX
package's ``autoround`` exports (g = 128 and g = 32), and ``from_gptq`` /
``from_awq`` on the GPTQ and AWQ fixtures of ``tests/test_gptq_loader.py``
rebuilt with the port's packers (``export/formats.py``), against the JAX
loaders on the same files and the port's ``from_quantize_result`` of the
same RTN result.

Tolerances:
  * packed words, codes and zero points: exact; scales: equal to the
    in-memory fp32 scales rounded to fp16 (the files store fp16);
  * fp32 engines on the same file (port and JAX): the same products summed
    in other orders, ~1e-6 of O(1) logits; held to 1e-4;
  * a file against the in-memory result: fp16 scales move each weight by
    up to 2^-11 of itself; measured ~1e-3 on the logits; held to 1e-2;
  * the GPTQ / AWQ loaders serve bf16 (as the JAX loader does): bf16
    activations rounded in other orders on the two sides, and against the
    fp32 in-memory engine; held to the JAX test's 0.1.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.export import codes_from_qdq as j_codes_from_qdq
from autoround_tpu.export.formats import awq_pack_layer as j_awq_pack
from autoround_tpu.export.formats import awq_unpack_layer as j_awq_unpack
from autoround_tpu.export.formats import gptq_pack_layer as j_gptq_pack
from autoround_tpu.export.formats import gptq_unpack_layer as j_gptq_unpack
from autoround_tpu.models import llama as jl
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.export.formats import (awq_pack_layer,
                                                awq_unpack_layer,
                                                gptq_pack_layer,
                                                gptq_unpack_layer)
from autoround_tpu_torch.ops.qmatmul import unpack_w4
from autoround_tpu_torch.utils.convert import (config_from_jax,
                                               params_from_jax,
                                               unpack_planes)
from autoround_tpu_torch.utils.hf_loader import _BLOCK_MAP
from autoround_tpu_torch.utils.safetensors_io import save_file
from _port_threads import one_torch_thread  # noqa: F401

SAME_FILE_TOL = 1e-4
FP16_SCALE_TOL = 1e-2
BF16_TOL = 0.1
HF_CFG = {"model_type": "llama", "vocab_size": 128, "hidden_size": 1024,
          "intermediate_size": 1024, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "rope_theta": 1e4, "rms_norm_eps": 1e-5}
BASE_KEYS = [f"blocks.{i}.{n}" for i in range(2)
             for n in ("qkv", "o_proj", "gate_up", "down_proj")]


_RESULTS = {}


def _results(scheme):
    """The JAX and the port's RTN results on the same weights and ids (one
    pair per scheme in this module)."""
    key = repr(scheme)
    if key not in _RESULTS:
        _RESULTS[key] = _quantize_both(scheme)
    return _RESULTS[key]


def _quantize_both(scheme):
    jcfg = jl.LlamaConfig(vocab_size=128, hidden_size=1024,
                          intermediate_size=1024, num_layers=2, num_heads=4,
                          num_kv_heads=2, rope_theta=1e4, dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    ids = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                      128))
    jar = JAutoRound((jp, jcfg), scheme=scheme, iters=0)
    jres = jar.quantize(jnp.asarray(ids))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tres = AutoRound((tp, tcfg), scheme=scheme, iters=0,
                     device="cpu").quantize(ids)
    return dict(jcfg=jcfg, tcfg=tcfg, jar=jar, jres=jres, tres=tres,
                ids=ids)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """g → (JAX autoround export dir, results); built once per g."""
    built = {}

    def get(g):
        if g not in built:
            r = _results("W4A16" if g == 128 else
                         {"bits": 4, "group_size": g, "sym": True})
            out = r["jar"].save_quantized(
                str(tmp_path_factory.mktemp(f"g{g}") / "m"),
                format="autoround")
            built[g] = (out, r)
        return built[g]
    return get


def _logits(eng, ids, jax_side=False):
    lg, _ = eng.prefill(jnp.asarray(ids) if jax_side else ids)
    return np.asarray(lg, np.float32) if jax_side else lg.float().numpy()


@pytest.mark.parametrize("g", [128, 32])
def test_from_pretrained_packs_and_matches(exports, g):
    out, r = exports(g)
    disk = QuantizedLlama.from_pretrained(out, max_seq=64, device="cpu")
    mem = QuantizedLlama.from_quantize_result(r["tres"], r["tcfg"],
                                              max_seq=64, device="cpu")
    jdisk = JQuantizedLlama.from_pretrained(out, max_seq=64)
    assert disk.cfg == dataclasses.replace(r["tcfg"], dtype=torch.float32)
    # the port packs g = 128 and g = 32; the JAX engine packs only g >= 128
    assert sorted(disk.packed) == sorted(BASE_KEYS)
    assert set(disk.packed_kinds.values()) == {"w4a16"}
    jbase = [k for k in jdisk.packed if not k.endswith(("qkv", "gate_up"))]
    assert len(jbase) == (2 * 7 if g == 128 else 0)
    for k in BASE_KEYS:
        assert torch.equal(disk.packed[k][0], mem.packed[k][0]), k
        assert torch.equal(disk.packed[k][1],
                           mem.packed[k][1].half().float()), k
        assert disk.packed[k][1].is_contiguous()
    assert disk.params["blocks"][0]["q_proj"] is None
    ids = r["ids"][:1, :8]
    got = _logits(disk, ids)
    np.testing.assert_allclose(got, _logits(jdisk, ids, True),
                               rtol=SAME_FILE_TOL, atol=SAME_FILE_TOL)
    np.testing.assert_allclose(got, _logits(mem, ids), rtol=FP16_SCALE_TOL,
                               atol=FP16_SCALE_TOL)
    toks = disk.generate(ids[:, :4], max_new_tokens=5)
    assert torch.equal(toks, disk.generate_scan(ids[:, :4],
                                                max_new_tokens=5))


def test_from_pretrained_dense_layer_and_lm_head(tmp_path):
    """An int8 layer and an asym layer serve dense as (codes - zp) * scale
    (as in the JAX engine), a quantized lm_head packs; logits against the
    JAX engine on the same file."""
    r = _results("W4A16")
    jcfg = r["jcfg"]
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    lc = {"blocks.0.o_proj": {"bits": 8},
          "blocks.1.down_proj": {"sym": False}}
    jar = JAutoRound((jp, jcfg), scheme="W4A16", iters=0, layer_config=lc,
                     quant_lm_head=True)
    jar.quantize(jnp.asarray(r["ids"]))
    out = jar.save_quantized(str(tmp_path / "m"), format="autoround")
    disk = QuantizedLlama.from_pretrained(out, max_seq=64, device="cpu")
    jdisk = JQuantizedLlama.from_pretrained(out, max_seq=64)
    assert "lm_head" in disk.packed and disk.params["lm_head"] is None
    assert "blocks.0.o_proj" not in disk.packed
    assert "blocks.1.down_proj" not in disk.packed
    for name in ("o_proj", "down_proj"):
        bi = 0 if name == "o_proj" else 1
        np.testing.assert_array_equal(
            disk.params["blocks"][bi][name].numpy(),
            np.asarray(jdisk.params["blocks"][bi][name]))
    ids = r["ids"][:1, :8]
    np.testing.assert_allclose(_logits(disk, ids), _logits(jdisk, ids, True),
                               rtol=SAME_FILE_TOL, atol=SAME_FILE_TOL)


def test_device_none_means_the_card(exports):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out, _ = exports(128)
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantizedLlama.from_pretrained(out)
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantizedLlama.from_gptq(out)


# ------------------------------------------------------------ GPTQ and AWQ

_INV = {v: k[: -len(".weight")] for k, v in _BLOCK_MAP.items()
        if k.endswith(".weight")}
ACT_ORDER = "blocks.1.o_proj"


def _permute_groups(payload):
    """An act-order copy of a GPTQ layer that computes the same weight:
    group j becomes group j + 1 (the last the first; its scales and zero
    points move with it), and g_idx says so, so g_idx is not arange(I) //
    g.  ``chip_smoke.py``'s ``_act_order`` is a copy: the script stands
    without the tests."""
    G = payload["scales"].shape[0]
    perm = np.roll(np.arange(G), 1)
    out = dict(payload)
    for k in ("scales", "qzeros"):
        moved = np.empty_like(payload[k])
        moved[perm] = payload[k]
        out[k] = moved
    out["g_idx"] = perm[payload["g_idx"]].astype(np.int32)
    return out


def _write_hf(tmp_path, name, res, packer, qcfg, act_order=False):
    tensors = {}
    for lname, ql in res.layers.items():
        _, li, short = lname.split(".")
        payload = packer(ql)
        if act_order and lname == ACT_ORDER:
            payload = _permute_groups(payload)
        for k, v in payload.items():
            tensors[f"model.layers.{li}.{_INV[short]}.{k}"] = v
    p = res.params
    tensors["model.embed_tokens.weight"] = p["embed_tokens"]
    tensors["model.norm.weight"] = p["norm"]
    tensors["lm_head.weight"] = p["lm_head"]
    for li, b in enumerate(p["blocks"]):
        for short in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"model.layers.{li}.{short}.weight"] = b[short]
    d = tmp_path / name
    d.mkdir()
    save_file(tensors, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(
        dict(HF_CFG, quantization_config=qcfg)))
    return str(d)


@pytest.fixture(scope="module")
def quant_ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpts")
    sym = _results("W4A16")
    asym = _results({"bits": 4, "group_size": 128, "sym": False})
    gptq = {"quant_method": "gptq", "bits": 4, "group_size": 128,
            "sym": True}
    awq = {"quant_method": "awq", "bits": 4, "group_size": 128,
           "version": "gemm", "zero_point": True}
    return dict(
        sym=sym, asym=asym,
        gptq=_write_hf(tmp, "gptq", sym["tres"], gptq_pack_layer, gptq),
        act=_write_hf(tmp, "act", sym["tres"], gptq_pack_layer, gptq,
                      act_order=True),
        awq=_write_hf(tmp, "awq", asym["tres"], awq_pack_layer, awq))


@pytest.mark.parametrize("kind", ["gptq", "awq"])
def test_packers_equal_jax_and_invert(quant_ckpts, kind):
    r = quant_ckpts["sym" if kind == "gptq" else "asym"]
    pack, jpack = ((gptq_pack_layer, j_gptq_pack) if kind == "gptq"
                   else (awq_pack_layer, j_awq_pack))
    for name, ql in r["tres"].layers.items():
        got, want = pack(ql), jpack(r["jres"].layers[name])
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name}.{k}")
        O, I = ql.qdq.shape
        codes, scale, zp = (gptq_unpack_layer(got, 4, O, I) if kind == "gptq"
                            else awq_unpack_layer(got, O, I))
        # the JAX unpackers on the JAX words give the same arrays
        jwant = (j_gptq_unpack(want, 4, O, I) if kind == "gptq"
                 else j_awq_unpack(want, O, I))
        for a, b in zip((codes, scale, zp), jwant):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        # the v1 zero-point offset and AWQ's interleave both come back
        zp_mem = (np.full(zp.shape, 8) if ql.zp is None
                  else ql.zp.numpy())
        np.testing.assert_array_equal(zp.numpy(), zp_mem, err_msg=name)
        np.testing.assert_array_equal(
            codes.numpy(), j_codes_from_qdq(
                ql.qdq.numpy(), ql.scale.numpy(),
                None if ql.zp is None else zp_mem, 4, 128), err_msg=name)
        np.testing.assert_array_equal(scale.numpy(), ql.scale.numpy().astype(
            np.float16).astype(np.float32))


@pytest.mark.parametrize("bits,g,asym", [(4, 128, False), (4, 96, True),
                                          (2, 32, True), (8, -1, False),
                                          (8, 64, True)])
def test_torch_packing_equals_jax(bits, g, asym):
    """``export.packing``'s torch functions against the JAX package's numpy
    ones (``pack_quantized``, ``unpack_quantized``, ``pack_rows``,
    ``export.codes_from_qdq``): the same codes, words, zero points and fp16
    scales, a zero point of 0 included (GPTQ's zp - 1 wraps to 2^32 - 1
    there, in both)."""
    from autoround_tpu.export import codes_from_qdq as j_codes
    from autoround_tpu.export.packing import pack_quantized as j_pack
    from autoround_tpu.export.packing import pack_rows as j_pack_rows
    from autoround_tpu.export.packing import unpack_quantized as j_unpack
    from autoround_tpu_torch.export.packing import (codes_from_qdq_torch,
                                                    pack_quantized_torch,
                                                    pack_rows_torch,
                                                    unpack_quantized_torch)
    gen = torch.Generator().manual_seed(bits * 1000 + g)
    O, I = 4100 + 37, 384       # more rows than one slab of the torch path
    gg = g if g > 0 else I
    G = -(-I // gg)
    s = (torch.rand(O, G, generator=gen) * 0.01 + 1e-3) * torch.where(
        torch.rand(O, G, generator=gen) < 0.5, -1.0, 1.0)
    codes = torch.randint(0, 2 ** bits, (O, I), generator=gen)
    zp = (torch.randint(0, 2 ** bits, (O, G), generator=gen).float()
          if asym else None)
    z = (zp.repeat_interleave(gg, 1)[:, :I] if asym else 2 ** (bits - 1))
    qdq = ((codes - z).float() * s.repeat_interleave(gg, 1)[:, :I]
           ).bfloat16()
    zn = None if zp is None else zp.numpy()
    want = j_codes(qdq.float().numpy(), s.numpy(), zn, bits, gg)
    got = codes_from_qdq_torch(qdq, s, zp, bits, g)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    pw = j_pack(want, s.numpy(), zn, bits)
    pt = pack_quantized_torch(got, s, zp, bits)
    for k in pw:
        assert pt[k].numpy().dtype == pw[k].dtype, k
        np.testing.assert_array_equal(pt[k].numpy(), pw[k], err_msg=k)
    for a, b in zip(unpack_quantized_torch(pt, bits, O, I),
                    j_unpack(pw, bits, O, I)):
        np.testing.assert_array_equal(a.numpy(), b)
    edge = np.zeros((3, 32 // bits * 2), np.int64)   # zp 0 → zp - 1
    np.testing.assert_array_equal(
        pack_rows_torch(torch.from_numpy(edge - 1), bits).numpy(),
        j_pack_rows((edge - 1).astype(np.uint32), bits))


def _codes(entry, jax_side=False):
    if jax_side:
        return unpack_planes(np.asarray(entry[0]), 4, 128)
    return unpack_w4(entry[0]).numpy()


@pytest.mark.parametrize("kind", ["gptq", "awq"])
def test_loader_matches_jax_and_source(quant_ckpts, kind):
    r = quant_ckpts["sym" if kind == "gptq" else "asym"]
    path = quant_ckpts[kind]
    eng = getattr(QuantizedLlama, f"from_{kind}")(path, max_seq=32,
                                                  device="cpu")
    jeng = getattr(JQuantizedLlama, f"from_{kind}")(path, max_seq=32)
    mem = QuantizedLlama.from_quantize_result(r["tres"], r["tcfg"],
                                              max_seq=32, device="cpu")
    want_kind = "w4a16" if kind == "gptq" else "w4a16_asym"
    assert sorted(eng.packed) == sorted(BASE_KEYS)
    assert set(eng.packed_kinds.values()) == {want_kind}
    assert eng.params["blocks"][0]["q_proj"] is None
    assert eng.cfg.dtype == torch.bfloat16
    for k in BASE_KEYS:
        codes = _codes(eng.packed[k])
        np.testing.assert_array_equal(codes, _codes(mem.packed[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(codes, _codes(jeng.packed[k], True),
                                      err_msg=k)
        np.testing.assert_array_equal(eng.packed[k][1].numpy(),
                                      np.asarray(jeng.packed[k][1]))
        if kind == "awq":
            np.testing.assert_array_equal(eng.packed[k][2].numpy(),
                                          mem.packed[k][2].numpy())
    ids = r["ids"][:1, :8]
    got = _logits(eng, ids)
    np.testing.assert_allclose(got, _logits(jeng, ids, True), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(got, _logits(mem, ids), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert torch.equal(eng.generate(ids[:, :4], max_new_tokens=4),
                       eng.generate_scan(ids[:, :4], max_new_tokens=4))


def test_act_order_layer_serves_dense(quant_ckpts, caplog):
    caplog.set_level(logging.INFO, logger="autoround_tpu_torch")
    r = quant_ckpts["sym"]
    eng = QuantizedLlama.from_gptq(quant_ckpts["act"], max_seq=32,
                                   device="cpu")
    assert f"gptq loader: {ACT_ORDER} has act-order g_idx; serving dense" \
        in caplog.text
    assert ACT_ORDER not in eng.packed
    assert "blocks.0.o_proj" in eng.packed
    jeng = JQuantizedLlama.from_gptq(quant_ckpts["act"], max_seq=32)
    np.testing.assert_array_equal(
        eng.params["blocks"][1]["o_proj"].float().numpy(),
        np.asarray(jeng.params["blocks"][1]["o_proj"]).astype(np.float32))
    # the permuted groups compute the weight the contiguous file packs
    plain = QuantizedLlama.from_gptq(quant_ckpts["gptq"], max_seq=32,
                                     device="cpu")
    qw, sc = plain.packed[ACT_ORDER]
    want = ((unpack_w4(qw) - 8).float() * sc.repeat_interleave(128, 1)
            ).to(torch.bfloat16)
    assert torch.equal(eng.params["blocks"][1]["o_proj"], want)
    ids = r["ids"][:1, :8]
    mem = QuantizedLlama.from_quantize_result(r["tres"], r["tcfg"],
                                              max_seq=32, device="cpu")
    np.testing.assert_allclose(_logits(eng, ids), _logits(mem, ids),
                               rtol=BF16_TOL, atol=BF16_TOL)
