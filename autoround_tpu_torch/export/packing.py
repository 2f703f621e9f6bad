"""Integer bit-packing for export (numpy, host-side; counterpart of
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
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_rows", "unpack_rows", "pack_quantized", "unpack_quantized"]


def pack_rows(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack (N, K) unsigned codes (< 2^bits) into (N, ceil(K*bits/32)) int32,
    LSB-first within each word.  Requires 32 % bits == 0."""
    assert 32 % bits == 0, f"bits={bits} must divide 32"
    per = 32 // bits
    N, K = codes.shape
    pad = (-K) % per
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
    codes = codes.reshape(N, -1, per).astype(np.uint32)
    shifts = (np.arange(per, dtype=np.uint32) * bits)[None, None, :]
    words = np.bitwise_or.reduce(codes << shifts, axis=-1)
    return words.astype(np.int32)


def unpack_rows(words: np.ndarray, bits: int, K: int) -> np.ndarray:
    """Inverse of :func:`pack_rows` → (N, K) uint8/uint16 codes."""
    per = 32 // bits
    w = words.astype(np.uint32)
    shifts = (np.arange(per, dtype=np.uint32) * bits)[None, None, :]
    codes = (w[:, :, None] >> shifts) & np.uint32(2 ** bits - 1)
    out = codes.reshape(w.shape[0], -1)[:, :K]
    return out.astype(np.uint16 if bits > 8 else np.uint8)


def pack_quantized(q: np.ndarray, scale: np.ndarray, zp, bits: int):
    """Pack a layer: q (O, I) unsigned codes, scale (O, n_groups),
    zp (O, n_groups) or None (sym → implicit zp = 2^(bits-1)).

    Returns dict with qweight (packed along I, transposed to (words, O)),
    qzeros, scales — the auto_round serialization naming.
    """
    O, I = q.shape
    qweight = pack_rows(q.astype(np.uint32), bits)          # (O, I*bits/32)
    qweight = np.ascontiguousarray(qweight.T)               # (I*bits/32, O)
    if zp is None:
        n_groups = scale.shape[1]
        zp_arr = np.full((O, n_groups), 2 ** (bits - 1), np.uint32)
    else:
        zp_arr = np.asarray(zp, np.uint32)
    qzeros = pack_rows(np.ascontiguousarray(zp_arr.T), bits)  # (n_groups, O*bits/32)
    return {
        "qweight": qweight,
        "qzeros": qzeros,
        "scales": np.ascontiguousarray(scale.T).astype(np.float16),  # (n_groups, O)
    }


def unpack_quantized(payload: dict, bits: int, O: int, I: int):
    """Inverse of :func:`pack_quantized` → (q (O,I), scale (O,G), zp (O,G))."""
    qweight = unpack_rows(np.ascontiguousarray(payload["qweight"].T), bits, I)
    scales = payload["scales"].astype(np.float32).T          # (O, G)
    zp = unpack_rows(payload["qzeros"], bits, O).T           # (O, G)
    return qweight[:O], scales, zp
