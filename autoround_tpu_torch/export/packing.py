"""Integer bit-packing for export (counterpart of
``autoround_tpu/export/packing.py``).

Pack b-bit integer codes into int32 words, GPTQ-style column-major within
the word, plus the exact inverse for round-trip tests.

Layout (GPTQ / auto_round convention):
  * qweight: (ceil(I * bits / 32), O) int32 — codes of column o are the
    I codes of output-channel o packed along the input axis, ``32//bits``
    codes per word, LSB-first.
  * qzeros:  (n_groups, ceil(O * bits / 32)) int32 — zero-points packed
    along the output axis, LSB-first.
  * scales:  (n_groups, O) fp16.

The ``*_torch`` functions compute the codes and words with torch on the
tensors' own device (the card, during an export or a load there), a slab
of rows at a time: the same IEEE float64 division, round half to even,
clip, shifts and masks as the JAX package's numpy functions, so the bytes
written and the codes read are the same.  :func:`pack_quantized` and
:func:`unpack_quantized` take and give numpy arrays, as the JAX package's
do, through the torch functions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack_quantized", "unpack_quantized", "codes_from_qdq_torch",
           "pack_rows_torch", "unpack_rows_torch", "pack_quantized_torch",
           "unpack_quantized_torch"]

# rows a slab of the torch functions takes (float64 temporaries of 4096 x K)
_ROWS = 4096


def codes_from_qdq_torch(qdq: torch.Tensor, scale: torch.Tensor, zp,
                         bits: int, group_size: int) -> torch.Tensor:
    """``export.codes_from_qdq`` on qdq's device: clip(rint(qdq / s + zp),
    0, 2^bits - 1) in float64 (zp = 2^(bits-1) when None) → (O, I)
    int32."""
    O, I = qdq.shape
    g = group_size if group_size > 0 else I
    out = torch.empty((O, I), dtype=torch.int32, device=qdq.device)
    for r in range(0, O, _ROWS):
        rows = slice(r, r + _ROWS)
        s = scale[rows].to(qdq.device, torch.float64).repeat_interleave(
            g, dim=1)[:, :I]
        z = (2 ** (bits - 1) if zp is None else
             zp[rows].to(qdq.device, torch.float64).repeat_interleave(
                 g, dim=1)[:, :I])
        q = torch.round(qdq[rows].to(torch.float64) / s + z)
        out[rows] = q.clamp_(0, 2 ** bits - 1).to(torch.int32)
    return out


def pack_rows_torch(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (N, K) codes into (N, ceil(K*bits/32)) int32 words on codes'
    device, LSB-first: each code taken mod 2^32 and shifted within 32 bits,
    the fields OR-ed, as the JAX package's numpy ``pack_rows`` does (a code
    of 2^bits or more spills into the next fields there too).  Requires
    32 % bits == 0."""
    assert 32 % bits == 0, f"bits={bits} must divide 32"
    per = 32 // bits
    N, K = codes.shape
    pad = (-K) % per
    out = torch.empty((N, (K + pad) // per), dtype=torch.int32,
                      device=codes.device)
    for r in range(0, N, _ROWS):
        c = codes[r:r + _ROWS].to(torch.int64) % 2 ** 32
        if pad:
            c = torch.nn.functional.pad(c, (0, pad))
        c = c.reshape(c.shape[0], -1, per)
        words = torch.zeros(c.shape[:2], dtype=torch.int64,
                            device=codes.device)
        for j in range(per):
            words |= (c[:, :, j] << (bits * j)) & 0xFFFFFFFF
        out[r:r + _ROWS] = torch.where(words >= 2 ** 31, words - 2 ** 32,
                                       words).to(torch.int32)
    return out


def unpack_rows_torch(words: torch.Tensor, bits: int, K: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows_torch` on words' device → (N, K) int32
    codes."""
    per = 32 // bits
    N = words.shape[0]
    shifts = torch.arange(per, device=words.device, dtype=torch.int32) * bits
    out = torch.empty((N, K), dtype=torch.int32, device=words.device)
    for r in range(0, N, _ROWS):
        w = words[r:r + _ROWS].to(torch.int32)
        # int32 shifts sign-extend; the mask keeps exactly the field
        codes = (w[:, :, None] >> shifts) & (2 ** bits - 1)
        out[r:r + _ROWS] = codes.reshape(w.shape[0], -1)[:, :K]
    return out


def pack_quantized_torch(q: torch.Tensor, scale: torch.Tensor, zp,
                         bits: int):
    """Pack a layer on q's device: q (O, I) unsigned codes, scale
    (O, n_groups), zp (O, n_groups) or None (sym → implicit zp =
    2^(bits-1)) → qweight (packed along I, transposed to (words, O)),
    qzeros and fp16 scales (n_groups, O), the auto_round serialization
    naming."""
    O = q.shape[0]
    qweight = pack_rows_torch(q, bits).T.contiguous()
    if zp is None:
        zp_arr = torch.full(tuple(scale.shape), 2 ** (bits - 1),
                            dtype=torch.int64, device=q.device)
    else:
        zp_arr = zp.to(q.device).float().to(torch.int64)
    assert zp_arr.shape[0] == O
    return {
        "qweight": qweight,
        "qzeros": pack_rows_torch(zp_arr.T.contiguous(), bits),
        "scales": scale.to(q.device).float().T.contiguous().to(
            torch.float16),
    }


def unpack_quantized_torch(payload: dict, bits: int, O: int, I: int):
    """Inverse of :func:`pack_quantized_torch` on the payload's device →
    (q (O, I) int32, scale (O, G) fp32, zp (O, G) int32)."""
    q = unpack_rows_torch(payload["qweight"].T, bits, I)[:O]
    scales = payload["scales"].float().T.contiguous()
    zp = unpack_rows_torch(payload["qzeros"], bits, O).T.contiguous()
    return q, scales, zp


def pack_quantized(q: np.ndarray, scale: np.ndarray, zp, bits: int):
    """:func:`pack_quantized_torch` on numpy arrays → the same dict of
    numpy arrays."""
    out = pack_quantized_torch(
        torch.from_numpy(np.asarray(q, np.int64)),
        torch.from_numpy(np.asarray(scale, np.float32)),
        None if zp is None else torch.from_numpy(np.asarray(zp, np.float32)),
        bits)
    return {k: v.numpy() for k, v in out.items()}


def unpack_quantized(payload: dict, bits: int, O: int, I: int):
    """:func:`unpack_quantized_torch` on numpy arrays → (q (O, I) int32,
    scale (O, G) fp32, zp (O, G) int32)."""
    out = unpack_quantized_torch({k: torch.from_numpy(np.array(v))
                                  for k, v in payload.items()}, bits, O, I)
    return tuple(t.numpy() for t in out)
