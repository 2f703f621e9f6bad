"""Export format registry and the GPTQ, AWQ and compressed-tensors layer
packers (counterpart of ``autoround_tpu/export/formats.py``).

The layouts are the CUDA ecosystem's:

  * GPTQ v1: ``qweight (I*bits/32, O)`` int32 packed along the input axis
    LSB-first, ``qzeros (G, O*bits/32)`` storing ``zp - 1`` (the v1
    off-by-one; the unpacker adds the 1 back), ``scales (G, O)`` fp16,
    ``g_idx (I,)`` int32 group indices.
  * AWQ gemm: ``qweight (I, O*bits/32)`` packed along the output axis with
    each 32-bit word's eight outputs in the interleaved order
    [0, 2, 4, 6, 1, 3, 5, 7]; ``qzeros (G, O/8)`` the same; ``scales (G,
    O)`` fp16.
  * compressed-tensors (``llm_compressor``): ``pack-quantized`` int codes
    (:func:`ct_pack_layer`) or ``float-quantized`` FP8 weights
    (:func:`ct_float_layer`), and the ``compressed_tensors`` entry of the
    quantization config (:func:`llmcompressor_config`).

The packers compute on the layer's device (``export.packing``'s torch
functions) and return numpy arrays, equal to the JAX package's.  The
unpackers take torch tensors (or numpy arrays, through ``torch.as_tensor``)
and unpack on their device: the loaders' path on the card.
``export.save_quantized`` writes the ``gptq``, ``awq`` and
``llm_compressor`` formats with them.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .packing import codes_from_qdq_torch, pack_rows_torch, unpack_rows_torch

__all__ = ["FORMATS", "register_format", "AWQ_ORDER", "gptq_pack_layer",
           "gptq_unpack_layer", "awq_pack_layer", "awq_unpack_layer",
           "ct_pack_layer", "ct_unpack_layer", "ct_float_layer",
           "llmcompressor_config"]

FORMATS: Dict[str, Callable] = {}

AWQ_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]
_AWQ_INV = np.argsort(AWQ_ORDER)


def register_format(name: str):
    """Decorator: file ``fn`` under ``name`` in :data:`FORMATS`."""
    def deco(fn):
        FORMATS[name] = fn
        return fn
    return deco


def _codes_scale_zp(ql):
    """Integer codes (int32), fp32 scales and integer zero points (int64;
    a sym layer's is 2^(bits-1)) of an int ``QuantizedLayer``, on its
    device, and the group size."""
    scheme = ql.scheme
    O, I = ql.qdq.shape
    g = scheme.group_size if scheme.group_size > 0 else I
    codes = codes_from_qdq_torch(ql.qdq, ql.scale, ql.zp, scheme.bits, g)
    scale = ql.scale.to(codes.device).float()
    if ql.zp is None:
        zp = torch.full(tuple(scale.shape), 2 ** (scheme.bits - 1),
                        dtype=torch.int64, device=codes.device)
    else:
        zp = ql.zp.to(codes.device).float().to(torch.int64)
    return codes, scale, zp, g


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _fp16_t(scale: torch.Tensor) -> np.ndarray:
    """(O, G) fp32 scales → (G, O) fp16."""
    return _np(scale.T.contiguous().half())


def gptq_pack_layer(ql) -> Dict[str, np.ndarray]:
    codes, scale, zp, g = _codes_scale_zp(ql)
    O, I = codes.shape
    bits = ql.scheme.bits
    return {
        "qweight": _np(pack_rows_torch(codes, bits).T.contiguous()),
        "qzeros": _np(pack_rows_torch((zp - 1).T.contiguous(), bits)),
        "scales": _fp16_t(scale),                          # (G, O)
        "g_idx": (np.arange(I) // g).astype(np.int32),
    }


def gptq_unpack_layer(t: Dict[str, torch.Tensor], bits: int, O: int, I: int):
    """On the tensors' device → (codes (O, I) int32, scale (O, G) fp32,
    zp (O, G) int32, the v1 +1 added back)."""
    t = {k: torch.as_tensor(v) for k, v in t.items()}
    codes = unpack_rows_torch(t["qweight"].T, bits, I)[:O]
    scale = t["scales"].float().T.contiguous()
    zp = unpack_rows_torch(t["qzeros"], bits, O).T.contiguous() + 1
    return codes, scale, zp


def _awq_reorder(m, order):
    r, o = m.shape
    return m.reshape(r, o // 8, 8)[:, :, order].reshape(r, o)


def awq_pack_layer(ql) -> Dict[str, np.ndarray]:
    codes, scale, zp, g = _codes_scale_zp(ql)
    assert ql.scheme.bits == 4, "AWQ gemm layout is 4-bit"
    order = torch.tensor(AWQ_ORDER, device=codes.device)
    cw = _awq_reorder(codes.T.contiguous(), order)          # (I, O)
    zw = _awq_reorder(zp.T.contiguous(), order)             # (G, O)
    return {
        "qweight": _np(pack_rows_torch(cw, 4)),             # (I, O/8)
        "qzeros": _np(pack_rows_torch(zw, 4)),              # (G, O/8)
        "scales": _fp16_t(scale),
    }


def awq_unpack_layer(t: Dict[str, torch.Tensor], O: int, I: int):
    """On the tensors' device → (codes (O, I) int32, scale (O, G) fp32,
    zp (O, G) int32)."""
    t = {k: torch.as_tensor(v) for k, v in t.items()}
    inv = torch.as_tensor(_AWQ_INV, device=t["qweight"].device)
    codes = _awq_reorder(unpack_rows_torch(t["qweight"], 4, O), inv).T
    zp = _awq_reorder(unpack_rows_torch(t["qzeros"], 4, O), inv).T
    scale = t["scales"].float().T.contiguous()
    return codes[:, :I].contiguous(), scale, zp.contiguous()


def ct_pack_layer(ql) -> Dict[str, np.ndarray]:
    """compressed-tensors ``pack-quantized`` layout of an int layer.  Its
    signed range offset by 2^(bits-1) is this package's unsigned code and
    zero point, so the words are the codes packed LSB-first:

      * ``weight_packed``     (O, ceil(I*bits/32)) int32, along the input;
      * ``weight_scale``      (O, G) fp16;
      * ``weight_zero_point`` asym only: the zero points packed along the
        output axis, (G, ceil(O*bits/32)) words in C order under the shape
        (ceil(O*bits/32), G).  The JAX package hands its writer the
        transpose of the words as a view, and ``safetensors.numpy`` stores
        a view's buffer as it lies in memory, so its files hold these
        bytes (ROADMAP C); :func:`ct_unpack_layer` reads them back;
      * ``weight_shape``      [O, I] int32.
    """
    codes, scale, zp, g = _codes_scale_zp(ql)
    bits = ql.scheme.bits
    if 32 % bits:
        raise NotImplementedError(
            f"compressed-tensors pack-quantized needs bits | 32, got {bits}")
    O, I = codes.shape
    out = {
        "weight_packed": _np(pack_rows_torch(codes, bits)),
        "weight_scale": _np(scale.half()),
        "weight_shape": np.array([O, I], np.int32),
    }
    if ql.zp is not None and not ql.scheme.sym:
        zw = _np(pack_rows_torch(zp.T.contiguous(), bits))
        out["weight_zero_point"] = zw.reshape(zw.shape[1], zw.shape[0])
    return out


def ct_unpack_layer(t: Dict[str, torch.Tensor], bits: int):
    """Inverse of :func:`ct_pack_layer` on the tensors' device → (codes
    (O, I) int32, scale (O, G) fp32, zp (O, G) int32 or None)."""
    t = {k: torch.as_tensor(v) for k, v in t.items()}
    O, I = (int(x) for x in t["weight_shape"])
    codes = unpack_rows_torch(t["weight_packed"], bits, I)[:O]
    scale = t["weight_scale"].float()
    zp = None
    if "weight_zero_point" in t:
        zw = t["weight_zero_point"]
        zp = unpack_rows_torch(zw.reshape(zw.shape[1], zw.shape[0]), bits,
                               O).T.contiguous()
    return codes, scale, zp


def ct_float_layer(ql) -> Dict[str, torch.Tensor]:
    """compressed-tensors ``float-quantized`` layout of an FP8 layer, on its
    device: ``weight`` the e4m3 values qdq / scale, ``weight_scale`` (O, 1)
    or (O, G) fp32 (a per-tensor scale repeated over the rows), and
    ``weight_shape``."""
    qdq = ql.qdq.float()
    scale = ql.scale.to(qdq.device).float()
    O, I = qdq.shape
    if scale.ndim < 2:          # per-tensor (1,) or per-channel (O,)
        scale = (scale.reshape(O, 1) if scale.numel() == O
                 else scale.reshape(1, 1).expand(O, 1).contiguous())
    codes = (qdq / scale.repeat_interleave(I // scale.shape[1], dim=1)).to(
        torch.float8_e4m3fn)
    return {"weight": codes, "weight_scale": scale,
            "weight_shape": torch.tensor([O, I], dtype=torch.int32)}


def llmcompressor_config(result) -> Dict:
    """The ``compressed_tensors`` entry (vLLM's config) of a result: one
    config group per scheme key, in the layers' order."""
    groups = {}
    for name, ql in result.layers.items():
        s = ql.scheme
        groups.setdefault(s.key(), {
            "targets": [],
            "weights": {
                "num_bits": s.bits,
                "type": "int" if s.data_type == "int" else s.data_type,
                "symmetric": bool(s.sym),
                "strategy": ("group" if isinstance(s.group_size, int)
                             and s.group_size > 0 else "channel"),
                "group_size": (s.group_size
                               if isinstance(s.group_size, int) else None),
            },
        })["targets"].append(name)
    all_fp8 = all(ql.scheme.data_type.startswith("fp8")
                  for ql in result.layers.values()) and result.layers
    return {
        "quant_method": "compressed-tensors",
        "format": "float-quantized" if all_fp8 else "pack-quantized",
        "config_groups": {f"group_{i}": v
                          for i, v in enumerate(groups.values())},
    }
