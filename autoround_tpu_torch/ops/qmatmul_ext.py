"""Weight-only dequant-matmuls beyond sym int4 (counterpart of the asym
int4 and the int8 parts of ``autoround_tpu/ops/qmatmul_ext.py``).

W4A16 asym: codes are asymmetric int4 in [0, 15], ``dq = (code - zp) *
scale`` with one fp32 scale and one fp32 zero point per group of
``group_size`` input columns.  The zero point may be fractional (GGUF-style double quant keeps
it so); the integer grids keep it integral.  The packed layout is the
port's own, that of ``ops/qmatmul.py`` (``pack_w4``).

W8A16: int8 weights ``(O, K)`` as they are, ``dq = wi * scale`` with one
signed fp32 scale per group of ``group_size`` input columns, or one per
output channel (``group_size <= 0``: scales ``(O, 1)``).

W2A16: sym full-range 2-bit codes in [0, 3], ``dq = (code - 2) * scale``,
one signed fp32 scale per group; the port packs 16 codes per int32 word in
K order (``pack_w2``: column 16w+j in bits 2j..2j+1 of word w).

FP8: float8_e4m3fn weights ``(O, K)`` as they are and one fp32 scale per
output channel ``(O,)``, ``dq = e4m3 * scale``.

MXFP4 / NVFP4: E2M1 codes in ``pack_w4``'s words (``decode_e2m1`` maps
code 0..15 to {0, .5, 1, 1.5, 2, 3, 4, 6} with bit 3 the sign) and one fp32
scale per group of 32 (MX: a power of two) or 16 (NVFP4: the e4m3 group
scale over the global scale) input columns, ``(O, K // g)``: the JAX
engine's lane padding of the scale columns is its TPU tiles', and the port
keeps the exact layout.

Each wrapper launches its ``csrc/*.cu`` kernel on a CUDA tensor (or
raises) and runs its plain version, which follows the JAX package's
``*_ref`` function, on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .qmatmul import PLANES, check_w4_operands, unpack_w4

__all__ = ["w4a16_asym_matmul", "w4a16_asym_matmul_plain", "w8a16_matmul",
           "w8a16_matmul_plain", "PLANES2", "pack_w2", "unpack_w2",
           "w2a16_matmul", "w2a16_matmul_plain", "fp8_matmul",
           "fp8_matmul_plain", "decode_e2m1", "mxfp4_matmul",
           "mxfp4_matmul_plain"]


def w4a16_asym_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                            scales: torch.Tensor, zps: torch.Tensor,
                            group_size: int = 128) -> torch.Tensor:
    """Plain version mirroring ``w4a16_asym_matmul_ref``: dequantize
    ``(code - zp) * scale`` in fp32, round to x.dtype, multiply with fp32
    accumulation, cast back to x.dtype."""
    O, Kw = qweight.shape
    K = Kw * PLANES
    codes = unpack_w4(qweight)
    s = scales.float().repeat_interleave(group_size, dim=1)[:, :K]
    z = zps.float().repeat_interleave(group_size, dim=1)[:, :K]
    w = ((codes.float() - z) * s).to(x.dtype)
    y = x.reshape(-1, K).float() @ w.float().T
    return y.to(x.dtype).reshape(*x.shape[:-1], O)


def _c_entry(name: str, n_ptr: int, n_int: int):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, x: torch.Tensor, K: int, O: int, ptrs, ints):
    """Allocate y (..., O), launch ``csrc/<name>.cu`` on the current stream
    with (x, *ptrs, y, M, K, O, *ints) and raise on a launch error."""
    if not x.is_contiguous() or x.shape[-1] != K:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be contiguous "
                         f"with K={K}")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _c_entry(name, 2 + len(ptrs), 3 + len(ints))
    _build.check(fn(x2.data_ptr(), *[t.data_ptr() for t in ptrs],
                    y.data_ptr(), M, K, O, *ints, stream), name)
    return y.reshape(*x.shape[:-1], O)


def w4a16_asym_matmul(x: torch.Tensor, qweight: torch.Tensor,
                      scales: torch.Tensor, zps: torch.Tensor,
                      group_size: int = 128) -> torch.Tensor:
    """y = x @ ((codes - zps) * scales).T for x (..., K), qweight (O, K//8)
    int32, scales and zps (O, K//g) fp32 → (..., O) in x.dtype.

    CUDA: x bf16, every tensor contiguous, K % 32 == 0, K % g == 0, g % 16
    == 0; any O (the ragged edge is masked in the kernel).  Anything else
    raises."""
    if x.device.type == "cpu":
        return w4a16_asym_matmul_plain(x, qweight, scales, zps, group_size)
    K = x.shape[-1]
    O = qweight.shape[0]
    g = group_size
    groups = (O, K // max(g, 1))
    check_w4_operands("w4a16_asym_matmul", x, K, g,
                      (("qweight", qweight, (O, K // PLANES), torch.int32),
                       ("scales", scales, groups, torch.float32),
                       ("zps", zps, groups, torch.float32)))
    y = _launch("w4a16_asym_matmul", x, K, O, (qweight, scales, zps), (g,))
    w4a16_asym_matmul.launches += 1
    return y


_build.counted(w4a16_asym_matmul)


def w8a16_matmul_plain(x: torch.Tensor, wi: torch.Tensor,
                       scales: torch.Tensor,
                       group_size: int = 0) -> torch.Tensor:
    """Plain version mirroring ``w8a16_matmul_ref``: ``float(wi) * scale``
    rounded to x.dtype, multiplied with fp32 accumulation, cast back."""
    O, K = wi.shape
    g = group_size if group_size and group_size > 0 else K
    s = scales.float().reshape(O, -1).repeat_interleave(g, dim=1)[:, :K]
    w = (wi.float() * s).to(x.dtype)
    y = x.reshape(-1, K).float() @ w.float().T
    return y.to(x.dtype).reshape(*x.shape[:-1], O)


def w8a16_matmul(x: torch.Tensor, wi: torch.Tensor, scales: torch.Tensor,
                 group_size: int = 0) -> torch.Tensor:
    """y = x @ (wi * scales).T for x (..., K), wi (O, K) int8, scales
    (O, K//g) fp32, or (O, 1) with ``group_size <= 0`` → (..., O) in
    x.dtype.

    CUDA: x bf16, every tensor contiguous, K % g == 0, g % 32 == 0 (g = K
    per channel); any O (the ragged edge is masked in the kernel).  Anything
    else raises."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, wi, scales, group_size)
    O, K = wi.shape
    g = group_size if group_size and group_size > 0 else K
    check_w4_operands("w8a16_matmul", x, K, g,
                      (("wi", wi, (O, K), torch.int8),
                       ("scales", scales, (O, K // max(g, 1)),
                        torch.float32)), g_multiple=32)
    y = _launch("w8a16_matmul", x, K, O, (wi, scales), (g,))
    w8a16_matmul.launches += 1
    return y


_build.counted(w8a16_matmul)


# ------------------------------------------------------------------ W2
PLANES2 = 16  # int2 codes per int32 word


def pack_w2(codes: torch.Tensor) -> torch.Tensor:
    """(O, K) codes in [0, 3] → (O, K // 16) int32, column 16w+j in bits
    2j..2j+1 of word w."""
    O, K = codes.shape
    if K % PLANES2:
        raise ValueError(f"K={K} must be a multiple of {PLANES2}")
    words = torch.zeros((O, K // PLANES2), dtype=torch.int64,
                        device=codes.device)
    for j in range(PLANES2):
        words |= (codes[:, j::PLANES2].to(torch.int64) & 0x3) << (2 * j)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_w2(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_w2` → (O, K) int32 codes."""
    O, Kw = words.shape
    shifts = torch.arange(PLANES2, device=words.device,
                          dtype=torch.int32) * 2
    codes = (words.to(torch.int32)[:, :, None] >> shifts) & 0x3
    return codes.reshape(O, Kw * PLANES2)


def w2a16_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                       scales: torch.Tensor,
                       group_size: int = 128) -> torch.Tensor:
    """Plain version mirroring ``w2a16_matmul_ref``: ``(code - 2) * scale``
    in fp32 rounded to x.dtype, multiplied with fp32 accumulation, cast
    back."""
    O, Kw = qweight.shape
    K = Kw * PLANES2
    s = scales.float().repeat_interleave(group_size, dim=1)[:, :K]
    w = ((unpack_w2(qweight) - 2).float() * s).to(x.dtype)
    y = x.reshape(-1, K).float() @ w.float().T
    return y.to(x.dtype).reshape(*x.shape[:-1], O)


def w2a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """y = x @ ((codes - 2) * scales).T for x (..., K), qweight (O, K//16)
    int32, scales (O, K//g) fp32 → (..., O) in x.dtype.

    CUDA: x bf16, every tensor contiguous, K % g == 0, g % 32 == 0; any O
    (the ragged edge is masked in the kernel).  Anything else raises."""
    if x.device.type == "cpu":
        return w2a16_matmul_plain(x, qweight, scales, group_size)
    K = x.shape[-1]
    O = qweight.shape[0]
    g = group_size
    check_w4_operands("w2a16_matmul", x, K, g,
                      (("qweight", qweight, (O, K // PLANES2), torch.int32),
                       ("scales", scales, (O, K // max(g, 1)),
                        torch.float32)), g_multiple=32)
    y = _launch("w2a16_matmul", x, K, O, (qweight, scales), (g,))
    w2a16_matmul.launches += 1
    return y


_build.counted(w2a16_matmul)


# ----------------------------------------------------------------- FP8
def fp8_matmul_plain(x: torch.Tensor, wf8: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """Plain version mirroring ``fp8_matmul_ref``: ``float(e4m3) * scale``
    rounded to x.dtype, multiplied with fp32 accumulation, cast back.  (The
    kernel, as the TPU kernel, applies the scale to the fp32 sum instead.)"""
    O, K = wf8.shape
    w = (wf8.float() * scales.float().reshape(O, 1)).to(x.dtype)
    y = x.reshape(-1, K).float() @ w.float().T
    return y.to(x.dtype).reshape(*x.shape[:-1], O)


def fp8_matmul(x: torch.Tensor, wf8: torch.Tensor,
               scales: torch.Tensor) -> torch.Tensor:
    """y = (x @ float(wf8).T) * scales for x (..., K), wf8 (O, K)
    float8_e4m3fn, scales (O,) fp32 → (..., O) in x.dtype.

    CUDA: x bf16, every tensor contiguous, K % 32 == 0; any O.  Anything
    else raises."""
    if x.device.type == "cpu":
        return fp8_matmul_plain(x, wf8, scales)
    O, K = wf8.shape
    check_w4_operands("fp8_matmul", x, K, K,
                      (("wf8", wf8, (O, K), torch.float8_e4m3fn),
                       ("scales", scales, (O,), torch.float32)))
    y = _launch("fp8_matmul", x, K, O, (wf8, scales), ())
    fp8_matmul.launches += 1
    return y


_build.counted(fp8_matmul)


# --------------------------------------------------------------- MXFP4
def decode_e2m1(codes: torch.Tensor) -> torch.Tensor:
    """int codes 0..15 → E2M1 values in fp32: sign = bit 3, e = bits 1-2,
    m = bit 0; e == 0 → ±0.5 m, else ±(1 + 0.5 m) * 2^(e - 1).  All 16
    values are exact in bf16 and fp32."""
    c = codes.to(torch.int32)
    sign = 1.0 - 2.0 * ((c >> 3) & 1).float()
    e = (c >> 1) & 3
    m = (c & 1).float()
    norm = (1.0 + 0.5 * m) * (1 << e.clamp_min(1)).float() * 0.5
    return sign * torch.where(e == 0, 0.5 * m, norm)


def mxfp4_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                       scales: torch.Tensor,
                       group_size: int = 32) -> torch.Tensor:
    """Plain version mirroring ``mxfp4_matmul_ref``: ``e2m1(code) * scale``
    in fp32 rounded to x.dtype (exact for power-of-two MX scales),
    multiplied with fp32 accumulation, cast back."""
    O, Kw = qweight.shape
    K = Kw * PLANES
    s = scales.float().repeat_interleave(group_size, dim=1)[:, :K]
    w = (decode_e2m1(unpack_w4(qweight)) * s).to(x.dtype)
    y = x.reshape(-1, K).float() @ w.float().T
    return y.to(x.dtype).reshape(*x.shape[:-1], O)


def mxfp4_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor, group_size: int = 32) -> torch.Tensor:
    """y = x @ (e2m1(codes) * scales).T for x (..., K), qweight (O, K//8)
    int32 E2M1 codes, scales (O, K//g) fp32 with g 32 (MXFP4) or 16
    (NVFP4) → (..., O) in x.dtype.

    CUDA: x bf16, every tensor contiguous, K % 32 == 0, g in {16, 32}; any
    O.  Anything else raises."""
    if x.device.type == "cpu":
        return mxfp4_matmul_plain(x, qweight, scales, group_size)
    K = x.shape[-1]
    O = qweight.shape[0]
    g = group_size
    if g not in (16, 32):
        raise ValueError(f"mxfp4_matmul: group_size {g} (16 or 32)")
    check_w4_operands("mxfp4_matmul", x, K, g,
                      (("qweight", qweight, (O, K // PLANES), torch.int32),
                       ("scales", scales, (O, K // g), torch.float32)))
    y = _launch("mxfp4_matmul", x, K, O, (qweight, scales), (g,))
    mxfp4_matmul.launches += 1
    return y


_build.counted(mxfp4_matmul)
