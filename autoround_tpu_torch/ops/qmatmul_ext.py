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

``w4a16_asym_matmul`` and ``w8a16_matmul`` launch
``csrc/w4a16_asym_matmul.cu`` and ``csrc/w8a16_matmul.cu`` on a CUDA tensor
(or raise) and run their plain versions on a CPU tensor.  The other kinds
of the JAX module (2-bit, FP8, MXFP4) are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .qmatmul import PLANES, check_w4_operands, unpack_w4

__all__ = ["w4a16_asym_matmul", "w4a16_asym_matmul_plain", "w8a16_matmul",
           "w8a16_matmul_plain"]


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


def _entry():
    fn = _build.load("w4a16_asym_matmul").w4a16_asym_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def w4a16_asym_matmul(x: torch.Tensor, qweight: torch.Tensor,
                      scales: torch.Tensor, zps: torch.Tensor,
                      group_size: int = 128) -> torch.Tensor:
    """y = x @ ((codes - zps) * scales).T for x (..., K), qweight (O, K//8)
    int32, scales and zps (O, K//g) fp32 → (..., O) in x.dtype.

    CUDA: x bf16, every tensor contiguous, K % g == 0, g % 32 == 0; any O
    (the ragged edge is masked in the kernel).  Anything else raises."""
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
    if not x.is_contiguous():
        raise ValueError("w4a16_asym_matmul: x must be contiguous")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                   zps.data_ptr(), y.data_ptr(), M, K, O, g, stream)
    _build.check(err, "w4a16_asym_matmul")
    w4a16_asym_matmul.launches += 1
    return y.reshape(*x.shape[:-1], O)


w4a16_asym_matmul.launches = 0


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


def _w8a16_entry():
    fn = _build.load("w8a16_matmul").w8a16_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
                        torch.float32)))
    if not x.is_contiguous() or x.shape[-1] != K:
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)} must be "
                         f"contiguous with K={K}")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _w8a16_entry()(x2.data_ptr(), wi.data_ptr(), scales.data_ptr(),
                         y.data_ptr(), M, K, O, g, stream)
    _build.check(err, "w8a16_matmul")
    w8a16_matmul.launches += 1
    return y.reshape(*x.shape[:-1], O)


w8a16_matmul.launches = 0
