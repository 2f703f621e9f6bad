"""W4A16 dequant-matmul with zero points (counterpart of the asym int4
part of ``autoround_tpu/ops/qmatmul_ext.py``).

Codes are asymmetric int4 in [0, 15], ``dq = (code - zp) * scale`` with one
fp32 scale and one fp32 zero point per group of ``group_size`` input
columns.  The zero point may be fractional (GGUF-style double quant keeps
it so); the integer grids keep it integral.  The packed layout is the
port's own, that of ``ops/qmatmul.py`` (``pack_w4``).

``w4a16_asym_matmul`` launches ``csrc/w4a16_asym_matmul.cu`` on a CUDA
tensor (or raises) and runs :func:`w4a16_asym_matmul_plain` on a CPU
tensor.  The other kinds of the JAX module (2-bit, 8-bit, FP8, MXFP4) are
not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .qmatmul import PLANES, check_w4_operands, unpack_w4

__all__ = ["w4a16_asym_matmul", "w4a16_asym_matmul_plain"]


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
