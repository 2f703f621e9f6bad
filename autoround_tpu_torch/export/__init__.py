"""Export formats (counterpart of ``autoround_tpu/export/__init__.py``).

Formats:
  * ``fake``      — qdq weights serialized as safetensors + a
    quantization_config.json; loadable for eval without kernels.
  * ``autoround`` — packed int codes: qweight / qzeros int32 words and
    fp16 scales per quantized layer, the other leaves as they are.
  * ``gptq`` / ``awq`` — the CUDA ecosystem's packed layouts
    (``formats.py``).
  * ``llm_compressor`` — compressed-tensors ``pack-quantized`` int layers
    and ``float-quantized`` FP8 layers, with a ``compressed_tensors``
    entry in the config.
  * ``mlx`` — Apple mlx-lm's bit stream under HF names (``mlx.py``).

The files equal the JAX package's byte for byte on the same result.  The
``gguf`` writer is not ported yet and raises (ROADMAP A13).  Files are
written and read by ``utils/safetensors_io.py``, not the ``safetensors``
package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..models.llama import LlamaConfig
from ..utils.logger import logger
from ..utils.safetensors_io import load_file, save_file
from .packing import (codes_from_qdq_torch, pack_quantized,
                      pack_quantized_torch, unpack_quantized)

__all__ = ["save_quantized", "load_fake", "pack_quantized",
           "unpack_quantized", "codes_from_qdq", "quantization_config"]


_PACKED_FORMATS = ("autoround", "gptq", "awq", "llm_compressor")

# "model_config" of quantization_config.json: the JAX LlamaConfig's fields
# in its order, so a reader finds the same keys whichever package wrote the
# checkpoint (tuples as JSON lists, as the JAX package writes them).  A
# family's own fields follow, in its config's order (:func:`_family_keys`).
_MODEL_CONFIG_KEYS = (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "head_dim", "rope_theta", "rms_eps",
    "tie_embeddings", "attn_bias", "qk_norm", "norm_offset", "hidden_act",
    "embed_scale", "sandwich_norms", "attn_logit_softcap",
    "final_logit_softcap", "sliding_window", "layer_types",
    "chunked_attention", "rope_local_theta", "partial_rotary_factor_local",
    "rope_scaling_factor", "rope_llama3", "attn_scale", "online_r4",
    "r4_block", "partial_rotary_factor")


def _flatten_params(params: Dict[str, Any],
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts / lists of tensors → {dotted name: tensor}, on the
    tensors' own device (the writer moves one tensor at a time)."""
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, name + "."))
        elif isinstance(v, (list, tuple)):
            for i, item in enumerate(v):
                out.update(_flatten_params(item, f"{name}.{i}."))
        else:
            out[name] = v.detach()
    return out


def _unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def codes_from_qdq(qdq: np.ndarray, scale: np.ndarray, zp, bits: int,
                   group_size: int) -> np.ndarray:
    """Recover integer codes from a qdq weight: q = round(qdq/s) + zp.
    Exact because qdq lies on the grid.  :func:`codes_from_qdq_torch` on
    numpy arrays → (O, I) uint32."""
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    return codes_from_qdq_torch(
        f64(qdq), f64(scale), None if zp is None else f64(zp), bits,
        group_size).numpy().astype(np.uint32)


def quantization_config(result, model_cfg, format: str = "autoround"
                        ) -> Dict[str, Any]:
    """The ``quantization_config.json`` of ``result`` (per-layer bits,
    group size, sym and data type; the model config), as
    :func:`save_quantized` writes it; an ``immediate_save_dir`` stream of
    shards takes it beside its index to load as an export."""
    return {
        "quant_method": "auto-round",
        "provider": "autoround_tpu",
        "fmt": format,
        "layers": {
            name: {
                "bits": ql.scheme.bits,
                "group_size": (list(ql.scheme.group_size)
                               if isinstance(ql.scheme.group_size, tuple)
                               else ql.scheme.group_size),
                "sym": ql.scheme.sym,
                "data_type": ql.scheme.data_type,
            }
            for name, ql in result.layers.items()
        },
        "model_config": {
            k: getattr(model_cfg, k)
            for k in _MODEL_CONFIG_KEYS + _family_keys(model_cfg)},
    }


def _family_keys(model_cfg):
    """The fields the config's family adds after the Llama ones, in its
    dataclass's order (the port's family configs declare the JAX fields in
    the JAX order)."""
    base = {f.name for f in dataclasses.fields(LlamaConfig)}
    return tuple(f.name for f in dataclasses.fields(model_cfg)
                 if f.name not in base)


def save_quantized(result, model_cfg, output_dir: str,
                   format: str = "fake") -> str:
    """Write a quantized checkpoint.  Returns output_dir."""
    if format.startswith("gguf"):
        raise NotImplementedError(
            f"export format {format!r} is not ported yet (ROADMAP A13)")
    if format not in ("fake", "mlx") + _PACKED_FORMATS:
        raise ValueError(f"unknown export format {format!r}")
    os.makedirs(output_dir, exist_ok=True)
    qcfg = quantization_config(result, model_cfg, format)

    if format == "mlx":
        from .mlx import save_quantized_as_mlx
        save_quantized_as_mlx(result, model_cfg, output_dir)
    else:
        tensors = _flatten_params(result.params)
        if format in _PACKED_FORMATS:
            for name, ql in result.layers.items():
                tensors.pop(name, None)
                for pk, pv in _pack_layer(format, name, ql).items():
                    tensors[f"{name}.{pk}"] = pv
        save_file(tensors, os.path.join(output_dir, "model.safetensors"))
        if format == "llm_compressor":
            from .formats import llmcompressor_config
            qcfg["compressed_tensors"] = llmcompressor_config(result)

    with open(os.path.join(output_dir, "quantization_config.json"), "w") as f:
        json.dump(qcfg, f, indent=2)
    logger.info("saved %s-format checkpoint to %s", format, output_dir)
    return output_dir


def _pack_layer(format: str, name: str, ql) -> Dict[str, Any]:
    """One layer's payload in a packed format, on the layer's device (an
    FP8 layer under ``llm_compressor``: float-quantized; any other layer
    that is not an int layer raises, as in the JAX package)."""
    from . import formats
    gs = ql.scheme.group_size
    if format == "llm_compressor" and ql.scheme.data_type.startswith(
            "fp8") and not isinstance(gs, tuple):
        return formats.ct_float_layer(ql)
    if ql.scheme.data_type != "int" or isinstance(gs, tuple):
        raise NotImplementedError(
            f"{format} packed export currently covers int schemes; "
            f"layer {name} is {ql.scheme.data_type}")
    if format == "gptq":
        return formats.gptq_pack_layer(ql)
    if format == "awq":
        return formats.awq_pack_layer(ql)
    if format == "llm_compressor":
        return formats.ct_pack_layer(ql)
    # autoround: codes_from_qdq + pack_quantized, on the weights' device
    codes = codes_from_qdq_torch(ql.qdq, ql.scale, ql.zp, ql.scheme.bits,
                                 gs)
    return pack_quantized_torch(codes, ql.scale, ql.zp, ql.scheme.bits)


def load_fake(path: str, device="cpu"):
    """Load a fake-format checkpoint back into a params tree (+ config)."""
    flat = load_file(os.path.join(path, "model.safetensors"),
                     device=str(device))
    with open(os.path.join(path, "quantization_config.json")) as f:
        qcfg = json.load(f)
    return _unflatten_params(flat), qcfg
