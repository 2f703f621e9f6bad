"""GPTQ and AWQ layer packers (counterpart of the layer functions of
``autoround_tpu/export/formats.py``).

The layouts are the CUDA ecosystem's:

  * GPTQ v1: ``qweight (I*bits/32, O)`` int32 packed along the input axis
    LSB-first, ``qzeros (G, O*bits/32)`` storing ``zp - 1`` (the v1
    off-by-one; the unpacker adds the 1 back), ``scales (G, O)`` fp16,
    ``g_idx (I,)`` int32 group indices.
  * AWQ gemm: ``qweight (I, O*bits/32)`` packed along the output axis with
    each 32-bit word's eight outputs in the interleaved order
    [0, 2, 4, 6, 1, 3, 5, 7]; ``qzeros (G, O/8)`` the same; ``scales (G,
    O)`` fp16.

The packers compute on the layer's device (``export.packing``'s torch
functions) and return numpy arrays, equal to the JAX package's.  The
unpackers take torch tensors (or numpy arrays, through ``torch.as_tensor``)
and unpack on their device: the loaders' path on the card.

The ``gptq`` / ``awq`` / ``llm_compressor`` format writers are not ported
yet (ROADMAP A13): ``export.save_quantized`` raises for them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .packing import codes_from_qdq_torch, pack_rows_torch, unpack_rows_torch

__all__ = ["AWQ_ORDER", "gptq_pack_layer", "gptq_unpack_layer",
           "awq_pack_layer", "awq_unpack_layer"]

AWQ_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]
_AWQ_INV = np.argsort(AWQ_ORDER)


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
