"""Port parity for model-free quantization (``autoround_tpu_torch/
quantize/model_free.py``) and the FP8-source read of
``utils/hf_loader.py`` against the JAX package.

Small checkpoints written by the tests (64-wide linears, one 256 x 384
FP8 weight with a 2 x 3 grid of 128 x 128 scales), CPU.  Tolerances: every
output file byte-equal to the JAX package's (the RTN of both packages is
bit-equal in fp32); the parallel run byte-equal to the serial one; the
loaded FP8 tree equal to JAX's leaf for leaf (the dequant is one fp32
product a weight on both sides; the 128 x 128 grids here divide their
weights, where the JAX package's blocks are the same).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.quantize.model_free import \
    model_free_quantize as j_model_free
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch.quantize.model_free import (_dequant_fp8_source,
                                                     model_free_quantize)
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.safetensors_io import save_file
from _port_threads import one_torch_thread  # noqa: F401

HF_CFG = {"model_type": "llama", "vocab_size": 96, "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
          "tie_word_embeddings": False}


def _rand(gen, shape, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen) * 0.05).to(dtype)


def _llama_tensors(gen, li, dtype=torch.bfloat16):
    H, M = HF_CFG["hidden_size"], HF_CFG["intermediate_size"]
    kv = H // 2
    p = f"model.layers.{li}."
    return {p + "self_attn.q_proj.weight": _rand(gen, (H, H), dtype),
            p + "self_attn.k_proj.weight": _rand(gen, (kv, H), dtype),
            p + "self_attn.v_proj.weight": _rand(gen, (kv, H), dtype),
            p + "self_attn.o_proj.weight": _rand(gen, (H, H), dtype),
            p + "mlp.gate_proj.weight": _rand(gen, (M, H), dtype),
            p + "mlp.up_proj.weight": _rand(gen, (M, H), dtype),
            p + "mlp.down_proj.weight": _rand(gen, (H, M), dtype),
            p + "input_layernorm.weight": torch.ones(H, dtype=dtype),
            p + "post_attention_layernorm.weight": torch.ones(H,
                                                              dtype=dtype)}


def _write(root, shards):
    """A checkpoint directory: one safetensors file a shard, the index
    when there are several, and ``config.json``."""
    os.makedirs(root, exist_ok=True)
    wmap = {}
    for fname, tensors in shards.items():
        save_file(tensors, os.path.join(root, fname))
        wmap.update({k: fname for k in tensors})
    if len(shards) > 1:
        with open(os.path.join(root, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"weight_map": wmap}, f)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(HF_CFG, f)
    return str(root)


@pytest.fixture(scope="module")
def bf16_dir(tmp_path_factory):
    gen = torch.Generator().manual_seed(0)
    H, V = HF_CFG["hidden_size"], HF_CFG["vocab_size"]
    s0 = {"model.embed_tokens.weight": _rand(gen, (V, H))}
    s0.update(_llama_tensors(gen, 0))
    s1 = _llama_tensors(gen, 1)
    s1.update({"model.norm.weight": torch.ones(H, dtype=torch.bfloat16),
               "lm_head.weight": _rand(gen, (V, H))})
    return _write(tmp_path_factory.mktemp("bf16"),
                  {"model-00001-of-00002.safetensors": s0,
                   "model-00002-of-00002.safetensors": s1})


def _same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in sorted(os.listdir(a)):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "qdq"])
def test_files_byte_equal_jax(bf16_dir, tmp_path, pack):
    j_model_free(bf16_dir, str(tmp_path / "j"), scheme="W4A16G32",
                 pack=pack, num_workers=1)
    model_free_quantize(bf16_dir, str(tmp_path / "t"), scheme="W4A16G32",
                        pack=pack, num_workers=1, device="cpu")
    _same_dirs(tmp_path / "j", tmp_path / "t")
    q = json.loads((tmp_path / "t" / "quantization_config.json")
                   .read_text())
    assert q["provider"] == "autoround_tpu.model_free"
    assert len(q["quantized_layers"]) == 14          # 2 x 7 linears


def test_parallel_equals_serial(bf16_dir, tmp_path, monkeypatch):
    model_free_quantize(bf16_dir, str(tmp_path / "s"), scheme="W4A16G32",
                        num_workers=1, device="cpu")
    monkeypatch.setenv("AR_MODEL_FREE_SHARD_PARALLELISM", "2")
    model_free_quantize(bf16_dir, str(tmp_path / "p"), scheme="W4A16G32",
                        device="cpu")
    _same_dirs(tmp_path / "s", tmp_path / "p")


@pytest.fixture(scope="module")
def fp8_dir(tmp_path_factory):
    """An FP8-source checkpoint: every linear e4m3 with a per-tensor
    ``weight_scale_inv``, one 256 x 384 weight with a 2 x 3 grid, a fused
    (E, O, I) expert stack in e4m3 with per-expert scales, and a bf16
    stack."""
    gen = torch.Generator().manual_seed(1)
    H, V = HF_CFG["hidden_size"], HF_CFG["vocab_size"]
    t = {"model.embed_tokens.weight": _rand(gen, (V, H)),
         "model.norm.weight": torch.ones(H, dtype=torch.bfloat16),
         "lm_head.weight": _rand(gen, (V, H))}
    for li in range(2):
        for k, v in _llama_tensors(gen, li, torch.float32).items():
            if v.ndim == 2:
                t[k] = (v * 8).to(torch.float8_e4m3fn)
                t[k[:-len(".weight")] + ".weight_scale_inv"] = torch.tensor(
                    [0.125 + 0.01 * li], dtype=torch.float32)
            else:
                t[k] = v.to(torch.bfloat16)
    t["model.extra.grid_proj.weight"] = (torch.randn(
        256, 384, generator=gen) * 4).to(torch.float8_e4m3fn)
    t["model.extra.grid_proj.weight_scale_inv"] = torch.rand(
        2, 3, generator=gen) * 0.01 + 0.001
    t["model.extra.experts.w1.weight"] = (torch.randn(
        3, 64, 64, generator=gen) * 4).to(torch.float8_e4m3fn)
    t["model.extra.experts.w1.weight_scale_inv"] = torch.rand(
        3, 1, 1, generator=gen) * 0.01 + 0.001
    t["model.extra.experts.w2.weight"] = _rand(gen, (2, 64, 64))
    # a weight and its scale in one shard: model-free looks a scale up in
    # its weight's shard only, as the JAX package does (ROADMAP C)
    first = {k for k in t if k.startswith(("model.layers.0.",
                                           "model.embed"))}
    return _write(tmp_path_factory.mktemp("fp8"), {
        "model-00001-of-00002.safetensors": {k: t[k] for k in first},
        "model-00002-of-00002.safetensors": {k: v for k, v in t.items()
                                             if k not in first}})


def test_fp8_source_and_fused_moe_like_jax(fp8_dir, tmp_path):
    """The FP8 weights dequantized (per tensor and by the grid), their
    scales consumed, each expert of both stacks quantized alone: the files
    byte-equal to JAX's."""
    j_model_free(fp8_dir, str(tmp_path / "j"), scheme="W4A16G32",
                 num_workers=1)
    model_free_quantize(fp8_dir, str(tmp_path / "t"), scheme="W4A16G32",
                        num_workers=1, device="cpu")
    _same_dirs(tmp_path / "j", tmp_path / "t")
    q = json.loads((tmp_path / "t" / "quantization_config.json")
                   .read_text())["quantized_layers"]
    assert "model.extra.grid_proj" in q and "model.extra.experts.w1.2" in q
    assert "model.extra.experts.w2.1" in q
    idx = json.loads((tmp_path / "t" / "model.safetensors.index.json")
                     .read_text())["weight_map"]
    assert not any(k.endswith("weight_scale_inv") for k in idx)


@pytest.mark.parametrize("kind,shape", [("tensor", (200, 300)),
                                        ("grid", (256, 384)),
                                        ("ragged", (200, 300))])
def test_dequant_fp8_source_exact(kind, shape):
    """The dequant is the fp32 product of the FP8 value and its scale: one
    number, or DeepSeek's 128 x 128 grid with its last blocks cut.  Where
    128 divides the weight the JAX package's is the same product; where it
    does not (``ragged``) the JAX package splits the weight into even
    blocks (100 x 100 here) and scales the wrong rows: the port keeps the
    128 x 128 blocks (ROADMAP C)."""
    from autoround_tpu.quantize.model_free import _dequant_fp8_source as jd
    gen = torch.Generator().manual_seed(2)
    w = (torch.randn(*shape, generator=gen) * 4).to(
        torch.float8_e4m3fn).float()
    O, I = shape
    s = (torch.rand(1, generator=gen) if kind == "tensor"
         else torch.rand(-(-O // 128), -(-I // 128), generator=gen))
    got = _dequant_fp8_source(w, s)
    full = (s if kind == "tensor" else s.repeat_interleave(
        128, 0).repeat_interleave(128, 1)[:O, :I])
    assert torch.equal(got, w * full)
    want = jd(w.numpy(), s.numpy())
    if kind == "ragged":
        assert not np.array_equal(got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_load_hf_checkpoint_fp8_equals_jax(fp8_dir):
    tp, tcfg = th.load_hf_checkpoint(fp8_dir, torch.float32, device="cpu")
    jp, jcfg = jh.load_hf_checkpoint(fp8_dir, jnp.float32)
    assert type(tcfg).__name__ == type(jcfg).__name__
    for li in range(HF_CFG["num_hidden_layers"]):
        assert sorted(tp["blocks"][li]) == sorted(jp["blocks"][li])
        for k, v in jp["blocks"][li].items():
            np.testing.assert_array_equal(tp["blocks"][li][k].numpy(),
                                          np.asarray(v), err_msg=(li, k))
    for k in ("embed_tokens", "norm", "lm_head"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
