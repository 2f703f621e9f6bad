"""The port's safetensors reader and writer (``utils/safetensors_io.py``)
against the ``safetensors`` package: the same bytes for the same tensors
and metadata, files of ``safetensors.numpy`` and of the JAX package's
``save_hf_checkpoint`` read back exactly, and sharded checkpoints read
through their index.  Every comparison is exact (bytes or bit patterns).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import save_file as st_save_torch

from autoround_tpu.models import llama as jl
from autoround_tpu.utils.hf_loader import save_hf_checkpoint as j_save_hf
from autoround_tpu_torch.utils.hf_loader import load_hf_checkpoint
from autoround_tpu_torch.utils.safetensors_io import (DTYPE_CODES, load_file,
                                                      SafeOpen, save_file)

# the dtypes the port reads and writes (the format's codes)
DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float8_e4m3fn,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool]


def _rand(dtype, shape, gen):
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen) * 3).to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -1000), min(info.max, 1000)
    return torch.randint(lo, hi, shape, generator=gen).to(dtype)


def _bits(t):
    """Bit pattern of a tensor (so fp8 / bf16 / NaN compare exactly)."""
    if t.dtype == torch.bool or t.element_size() == 1:
        return t.view(torch.uint8) if t.dtype != torch.bool else t
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("metadata", [None, {}, {"format": "pt"}],
                         ids=["no-meta", "empty-meta", "meta"])
def test_bytes_equal_safetensors_per_dtype(tmp_path, dtype, metadata):
    gen = torch.Generator().manual_seed(0)
    tensors = {"w": _rand(dtype, (5, 7), gen), "scalar": _rand(dtype, (), gen),
               "empty": _rand(dtype, (0, 3), gen)}
    st_save_torch(tensors, str(tmp_path / "ref.st"), metadata=metadata)
    save_file(tensors, str(tmp_path / "ours.st"), metadata=metadata)
    assert _same_file(tmp_path / "ref.st", tmp_path / "ours.st")


@pytest.mark.parametrize("order", ["sorted", "reversed", "shuffled"])
def test_bytes_equal_mixed_dtypes_and_key_orders(tmp_path, order):
    """Entries sort by dtype (widest first) and then by name, whatever
    order the dict has."""
    gen = torch.Generator().manual_seed(1)
    items = [(f"t{i:02d}.{str(dt)[6:]}", _rand(dt, (3, i + 1), gen))
             for i, dt in enumerate(DTYPES * 2)]
    if order == "reversed":
        items = items[::-1]
    elif order == "shuffled":
        perm = np.random.default_rng(0).permutation(len(items))
        items = [items[i] for i in perm]
    tensors = dict(items)
    st_save_torch(tensors, str(tmp_path / "ref.st"))
    save_file(tensors, str(tmp_path / "ours.st"))
    assert _same_file(tmp_path / "ref.st", tmp_path / "ours.st")


def test_metadata_with_several_keys(tmp_path):
    """``safetensors`` keeps metadata in a hash map: two or more keys come
    out in a run-dependent order, so here the headers must be equal as
    JSON and the data bytes equal."""
    gen = torch.Generator().manual_seed(2)
    tensors = {"a": _rand(torch.float32, (4, 4), gen),
               "b": _rand(torch.bfloat16, (2,), gen)}
    meta = {"z": "1", "a": "2", "m": "3"}
    st_save_torch(tensors, str(tmp_path / "ref.st"), metadata=meta)
    save_file(tensors, str(tmp_path / "ours.st"), metadata=meta)
    raw = [open(tmp_path / n, "rb").read() for n in ("ref.st", "ours.st")]
    heads = []
    for r in raw:
        n = int.from_bytes(r[:8], "little")
        heads.append((n, json.loads(r[8:8 + n]), r[8 + n:]))
    assert heads[0] == heads[1]
    with SafeOpen(str(tmp_path / "ours.st")) as f:
        assert f.metadata() == meta


def test_round_trip_every_dtype(tmp_path):
    gen = torch.Generator().manual_seed(3)
    tensors = {f"x.{str(dt)[6:]}": _rand(dt, (6, 5), gen) for dt in DTYPES}
    tensors["strided"] = torch.arange(24.0).reshape(4, 6)[:, ::2]
    save_file(tensors, str(tmp_path / "f.st"), metadata={"k": "v"})
    back = load_file(str(tmp_path / "f.st"))
    assert set(back) == set(tensors)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape, k
        assert torch.equal(_bits(back[k]), _bits(t)), k
    with SafeOpen(str(tmp_path / "f.st")) as f:
        assert f.shape("strided") == (4, 3)
        assert f.dtype_code("x.bfloat16") == "BF16"
        one = f.get_tensor("x.int32")
    # a returned tensor owns its bytes: it outlives the closed map
    assert torch.equal(one, tensors["x.int32"])
    one.add_(1)


def test_reads_safetensors_numpy_files(tmp_path):
    rng = np.random.default_rng(4)
    arrays = {"f32": rng.standard_normal((3, 4)).astype(np.float32),
              "bf16": rng.standard_normal((8,)).astype(ml_dtypes.bfloat16),
              "f16": rng.standard_normal((2, 2)).astype(np.float16),
              "i64": rng.integers(-9, 9, (5,)),
              "u8": rng.integers(0, 255, (7,)).astype(np.uint8),
              "b": rng.random(4) > 0.5}
    st_save_numpy(arrays, str(tmp_path / "n.st"))
    back = load_file(str(tmp_path / "n.st"))
    for k, a in arrays.items():
        want = (a.astype(np.float32) if k == "bf16" else a)
        got = back[k].float() if k == "bf16" else back[k]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    # and the port writes numpy arrays (ml_dtypes bf16 too) as they do
    save_file(arrays, str(tmp_path / "ours.st"))
    assert _same_file(tmp_path / "n.st", tmp_path / "ours.st")


def test_reads_jax_save_hf_checkpoint(tmp_path):
    cfg = dataclasses.replace(jl.CONFIG_PRESETS["tiny"], dtype=jnp.bfloat16)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          jl.init_params(cfg, jax.random.PRNGKey(0)))
    j_save_hf(params, cfg, str(tmp_path / "j"))
    back = load_file(str(tmp_path / "j" / "model.safetensors"))
    want = np.asarray(params["blocks"][1]["down_proj"]).astype(np.float32)
    got = back["model.layers.1.mlp.down_proj.weight"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_sharded_checkpoint_through_index(tmp_path):
    """The JAX package's ShardWriter splits a checkpoint; the port's
    loader reads it through ``model.safetensors.index.json`` and gets the
    single-file load's leaves."""
    from autoround_tpu.export.shard_writer import ShardWriter as JShardWriter
    from autoround_tpu.utils.hf_loader import _BLOCK_MAP

    cfg = jl.CONFIG_PRESETS["tiny"]
    params = jl.init_params(cfg, jax.random.PRNGKey(5))
    j_save_hf(params, cfg, str(tmp_path / "one"))
    single, _ = load_hf_checkpoint(str(tmp_path / "one"), torch.float32,
                                   device="cpu")
    inv = {v: k for k, v in _BLOCK_MAP.items()}
    w = JShardWriter(str(tmp_path / "sh"), shard_size_bytes=40_000)
    w.add("model.embed_tokens.weight", np.asarray(params["embed_tokens"]))
    for li, b in enumerate(params["blocks"]):
        for name, a in b.items():
            w.add(f"model.layers.{li}.{inv[name]}", np.asarray(a))
    w.add("model.norm.weight", np.asarray(params["norm"]))
    w.add("lm_head.weight", np.asarray(params["lm_head"]))
    w.finalize()
    with open(tmp_path / "one" / "config.json") as f:
        (tmp_path / "sh" / "config.json").write_text(f.read())
    assert len(list((tmp_path / "sh").glob("model-*-of-*"))) > 2
    sharded, _ = load_hf_checkpoint(str(tmp_path / "sh"), torch.float32,
                                    device="cpu")
    assert sharded.keys() == single.keys()
    for li in range(cfg.num_layers):
        assert sharded["blocks"][li].keys() == single["blocks"][li].keys()
        for k, t in single["blocks"][li].items():
            assert torch.equal(sharded["blocks"][li][k], t), (li, k)
    for k in ("embed_tokens", "norm", "lm_head"):
        assert torch.equal(sharded[k], single[k]), k


def test_codes_cover_the_format(tmp_path):
    """Every code the reader knows maps to the torch dtype whose bytes it
    holds; a file with a dtype it does not know raises on open."""
    for code, dt in DTYPE_CODES.items():
        assert torch.empty((), dtype=dt).element_size() == {
            "U64": 8, "I64": 8, "F64": 8, "F32": 4, "U32": 4, "I32": 4,
            "BF16": 2, "F16": 2, "U16": 2, "I16": 2, "F8_E4M3": 1,
            "F8_E5M2": 1, "I8": 1, "U8": 1, "BOOL": 1}[code]
    head = json.dumps({"x": {"dtype": "C64", "shape": [1],
                             "data_offsets": [0, 8]}}).encode()
    head += b" " * ((8 - len(head) % 8) % 8)
    (tmp_path / "c.st").write_bytes(len(head).to_bytes(8, "little") + head
                                    + bytes(8))
    with pytest.raises(ValueError, match="C64"):
        SafeOpen(str(tmp_path / "c.st"))
