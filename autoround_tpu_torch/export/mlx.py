"""MLX-format export writer for Apple's mlx-lm (counterpart of
``autoround_tpu/export/mlx.py``; its files equal the JAX package's byte
for byte).

MLX's QuantizedLinear dequantizes affinely, ``w = scales * w_int +
biases`` (``biases = -scale * zp``), with ``w_int`` packed as a
little-endian bit stream into uint32 words: for bits in {2, 4, 8} each
word holds ``32 // bits`` codes, the first in the low bits; for bits in
{3, 5, 6} every 32 codes span ``bits`` words, a code crossing a word
boundary.  Scales and biases are fp16 (out_features, groups);
``config.json`` carries the mlx-community ``quantization`` dict with
per-layer overrides.  The packers run on the tensors' device (the card in
an export there).  As in the JAX package, ``config.json`` says
``"model_type": "llama"`` for every family (ROADMAP C).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.logger import logger
from ..utils.safetensors_io import save_file

__all__ = ["pack_mlx_weight", "unpack_mlx_weight", "mlx_pack_layer",
           "save_quantized_as_mlx"]

_ROWS = 1024     # rows a slab of the packers takes


def _as_i64(t) -> torch.Tensor:
    """Codes or words (torch or numpy, uint32 included) → int64 holding
    their unsigned values."""
    if isinstance(t, np.ndarray) and t.dtype == np.uint32:
        t = t.view(np.int32)
    t = torch.as_tensor(t)
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    if t.dtype == torch.int32:
        return t.to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def pack_mlx_weight(codes, bits: int) -> np.ndarray:
    """(O, I) unsigned codes < 2^bits → (O, I*bits/32) uint32 words, the
    MLX bit stream (computed on the codes' device)."""
    c = _as_i64(codes)
    O, I = c.shape
    out = []
    for r in range(0, O, _ROWS):
        s = c[r:r + _ROWS]
        n = s.shape[0]
        if 32 % bits == 0:
            epw = 32 // bits
            assert I % epw == 0, (I, bits)
            shifts = torch.arange(epw, device=s.device) * bits
            w = (s.reshape(n, I // epw, epw) << shifts).sum(-1)
        else:
            # code i's bits sit at stream offset i * bits of a 32 * bits
            # bit stream per 32 codes: (n, G, 32, bits) in C order is it
            assert I % 32 == 0, (I, bits)
            bitvals = (s.reshape(n, I // 32, 32, 1)
                       >> torch.arange(bits, device=s.device)) & 1
            stream = bitvals.reshape(n, I // 32, bits, 32)
            w = (stream << torch.arange(32, device=s.device)).sum(-1)
        out.append(w.reshape(n, -1).cpu().numpy().astype(np.uint32))
    return np.concatenate(out, axis=0)


def unpack_mlx_weight(words, bits: int, in_features: int) -> torch.Tensor:
    """Inverse of :func:`pack_mlx_weight` on the words' device (numpy
    words unpack on the CPU) → (O, in_features) int64 codes."""
    w = _as_i64(words)
    O = w.shape[0]
    if 32 % bits == 0:
        shifts = torch.arange(32 // bits, device=w.device) * bits
        c = (w[..., None] >> shifts) & (2 ** bits - 1)
        return c.reshape(O, -1)[:, :in_features]
    w = w.reshape(O, in_features // 32, bits)
    stream = (w[..., None] >> torch.arange(32, device=w.device)) & 1
    bitvals = stream.reshape(O, in_features // 32, 32, bits)
    vals = (bitvals << torch.arange(bits, device=w.device)).sum(-1)
    return vals.reshape(O, in_features)


def mlx_pack_layer(ql) -> Dict[str, np.ndarray]:
    """An int ``QuantizedLayer`` → {weight (uint32), scales (fp16), biases
    (fp16)}.  A sym layer's zero point is 2^(bits-1); an asym layer's goes
    into ``biases``."""
    from .packing import codes_from_qdq_torch

    bits = ql.scheme.bits
    O, I = ql.qdq.shape
    gs = ql.scheme.group_size
    g = gs if isinstance(gs, int) and gs > 0 else I
    scale = ql.scale.to(ql.qdq.device).float()
    zp = None if ql.zp is None else ql.zp.to(ql.qdq.device).float()
    codes = codes_from_qdq_torch(ql.qdq, scale, zp, bits, g)
    zpv = float(2 ** (bits - 1)) if zp is None else zp
    return {
        "weight": pack_mlx_weight(codes, bits),
        "scales": scale.half().cpu().numpy(),
        "biases": (-scale * zpv).half().cpu().numpy(),
    }


def _hf_name(flat: str) -> Optional[str]:
    """The port's tree name → the HF / MLX tensor name prefix (None for a
    leaf the Llama layout does not name)."""
    from ..utils.hf_loader import _BLOCK_MAP, _TOP_MAP

    inv_top = {v: k for k, v in _TOP_MAP.items()}
    inv_block = {v: k for k, v in _BLOCK_MAP.items()}
    parts = flat.split(".")
    if parts[0] == "blocks":
        sub = inv_block.get(".".join(parts[2:]) + ".weight")
        if sub is None:
            sub = inv_block.get(".".join(parts[2:]))
        if sub is None:
            return None
        sub = sub[: -len(".weight")] if sub.endswith(".weight") else sub
        return f"model.layers.{parts[1]}.{sub}"
    top = inv_top.get(flat)
    return top[: -len(".weight")] if top else None


def save_quantized_as_mlx(result, model_cfg, output_dir: str) -> str:
    """Write an mlx-lm directory: ``model.safetensors`` under HF names (a
    packed layer as ``<name>.weight`` / ``.scales`` / ``.biases``, the rest
    fp16) and a ``config.json`` with the ``quantization`` dict."""
    from . import _flatten_params

    os.makedirs(output_dir, exist_ok=True)
    flat = _flatten_params(result.params)
    quant_names = set(result.layers)

    tensors: Dict[str, Any] = {}
    quant_cfg: Dict[str, Any] = {}
    bit_counts: Dict[tuple, int] = {}

    for name, ql in result.layers.items():
        if ql.scheme.data_type != "int":
            raise NotImplementedError(
                f"mlx export covers int schemes; {name} is "
                f"{ql.scheme.data_type}")
        hf = _hf_name(name)
        if hf is None:
            logger.warning("mlx export: no HF name for %s; skipping", name)
            continue
        for pk, pv in mlx_pack_layer(ql).items():
            tensors[f"{hf}.{pk}"] = pv
        gs = ql.scheme.group_size
        g = int(gs if isinstance(gs, int) and gs > 0 else ql.qdq.shape[1])
        quant_cfg[hf] = {"group_size": g, "bits": int(ql.scheme.bits)}
        key = (g, int(ql.scheme.bits))
        bit_counts[key] = bit_counts.get(key, 0) + 1

    # the rest in fp16 under HF names; an unquantized linear is marked
    # false so mlx-lm builds it as a plain Linear
    for name, arr in flat.items():
        if name in quant_names:
            continue
        hf = _hf_name(name)
        if hf is None:
            continue
        key = hf if hf.endswith(".bias") else f"{hf}.weight"
        tensors[key] = arr.half()
        if name.split(".")[-1] in ("q_proj", "k_proj", "v_proj", "o_proj",
                                   "gate_proj", "up_proj", "down_proj",
                                   "lm_head"):
            quant_cfg[hf] = False

    default_g, default_bits = (max(bit_counts, key=bit_counts.get)
                               if bit_counts else (64, 4))
    qdict: Dict[str, Any] = {"group_size": default_g, "bits": default_bits}
    for hf, entry in quant_cfg.items():
        if entry is False or (entry["group_size"], entry["bits"]) != (
                default_g, default_bits):
            qdict[hf] = entry

    save_file(tensors, os.path.join(output_dir, "model.safetensors"))
    mc = model_cfg
    config = {
        "model_type": "llama",
        "vocab_size": mc.vocab_size,
        "hidden_size": mc.hidden_size,
        "intermediate_size": mc.intermediate_size,
        "num_hidden_layers": mc.num_layers,
        "num_attention_heads": mc.num_heads,
        "num_key_value_heads": mc.num_kv_heads,
        "head_dim": mc.hd,
        "rope_theta": mc.rope_theta,
        "rms_norm_eps": mc.rms_eps,
        "tie_word_embeddings": bool(getattr(mc, "tie_embeddings", False)),
        "quantization": qdict,
        "quantization_config": qdict,
    }
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    logger.info("saved mlx checkpoint (%d packed layers) to %s",
                sum(1 for v in quant_cfg.values() if v is not False),
                output_dir)
    return output_dir
