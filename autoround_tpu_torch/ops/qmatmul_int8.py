"""Int8-activation matmuls: W8A8 and W4A8 (counterpart of
``autoround_tpu/ops/qmatmul_int8.py``).

Activations are quantized per row on the fly (:func:`quantize_rows`:
dynamic symmetric int8, ``scale = max(amax * fp32(1 / 127), 1e-8)``), the integer
product is exact in int32, and the epilogue dequantizes:

* ``w8a8_matmul``: int8 weights ``(O, K)`` with one signed fp32 scale per
  output channel; ``y = float(acc) * xs * ws``.
* ``w4a8_matmul``: int4 codes in the packed words of ``ops/qmatmul.py``
  (``pack_w4``; the JAX package's byte-pair layout was for the TPU) with
  one fp32 scale per group of ``group_size`` input columns; per group the
  exact int32 dot of ``q8(x)`` with ``code - 8``, times the group's scale,
  summed in fp32, times ``xs``.  The W4A16 and the W4A8 kernels read the
  same words, so an engine holds its weights once for both.

On a CUDA tensor each wrapper launches its kernel (``csrc/w8a8_matmul.cu``,
``csrc/w4a8_matmul.cu``; the quantizer runs as a kernel of the same
source in front of the product) or raises; on a CPU tensor it runs its
plain version.  The plain versions do exact integer arithmetic on either
device: their products run in float64, where sums of K int8 x int8
products are integers far below 2^53.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .qmatmul import PLANES, check_w4_operands, unpack_w4

__all__ = ["quantize_rows", "quantize_rows_plain", "w8a8_matmul",
           "w8a8_matmul_plain", "w4a8_matmul", "w4a8_matmul_plain"]


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float → (int8 codes, (...,) fp32 per-row scale).  The scale
    is ``amax * fp32(1 / 127)``: XLA compiles the JAX package's jitted
    ``amax / 127.0`` to that product, and the codes must be its codes.
    ``x / scale`` is a true division; round half to even, clip to ±127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax * (1.0 / 127.0), min=1e-8)
    xi = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xi, s[..., 0]


def _check(what: str, x: torch.Tensor, K: int, g: int, operands=()) -> None:
    """The W4A16 family's operand check (``g = K`` where there are no
    groups), plus a contiguous x whose last axis is K."""
    check_w4_operands(what, x, K, g, operands, g_multiple=32)
    if x.shape[-1] != K or not x.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} must be contiguous "
                         f"with K={K}")


def _quantize_entry():
    fn = _build.load("w8a8_matmul").quantize_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantization, the codes and scales of
    :func:`quantize_rows_plain` bit for bit.  CUDA: x bf16, contiguous,
    K % 32 == 0; anything else raises."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    K = x.shape[-1]
    _check("quantize_rows", x, K, K)
    M = x.numel() // K
    xi = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    xs = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _quantize_entry()(x.data_ptr(), xi.data_ptr(), xs.data_ptr(), M, K,
                            stream)
    _build.check(err, "quantize_rows")
    quantize_rows.launches += 1
    return xi, xs


_build.counted(quantize_rows)


def _out(y: torch.Tensor, x: torch.Tensor, O: int, out_dtype):
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], O)


def w8a8_matmul_plain(x: torch.Tensor, wi: torch.Tensor, ws: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Plain version mirroring ``w8a8_matmul_ref``: quantize the rows, the
    exact integer product (in float64), ``float(acc) * xs * ws`` in that
    order, cast to x.dtype (or ``out_dtype``)."""
    O, K = wi.shape
    xi, xs = quantize_rows_plain(x.reshape(-1, K))
    acc = (xi.double() @ wi.double().T).float()
    y = acc * xs[:, None] * ws.float()[None, :]
    return _out(y, x, O, out_dtype)


def w4a8_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                      scales: torch.Tensor, group_size: int = 128,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Plain version in the kernel's per-group form: quantize the rows; per
    group the exact integer dot (in float64) of the codes with
    ``code - 8``, as fp32 times the group's scale, accumulated in fp32 in
    group order; times ``xs``; cast.  ``w4a8_matmul_ref`` of the JAX
    package sums all K fp32 products at once: the same sum in another
    order."""
    O, Kw = qweight.shape
    K = Kw * PLANES
    g = group_size
    xi, xs = quantize_rows_plain(x.reshape(-1, K))
    xd = xi.double()
    wd = (unpack_w4(qweight) - 8).double()
    sc = scales.float()
    acc = torch.zeros((xi.shape[0], O), dtype=torch.float32, device=x.device)
    for j in range(K // g):
        part = xd[:, j * g:(j + 1) * g] @ wd[:, j * g:(j + 1) * g].T
        acc += part.float() * sc[:, j][None, :]
    return _out(acc * xs[:, None], x, O, out_dtype)


def _scratch(x2: torch.Tensor, O: int, out_dtype):
    M, K = x2.shape
    dev = x2.device
    xi = torch.empty((M, K), dtype=torch.int8, device=dev)
    xs = torch.empty((M,), dtype=torch.float32, device=dev)
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} (bf16 or fp32)")
    y = torch.empty((M, O), dtype=out_dtype or torch.bfloat16, device=dev)
    f32 = y.dtype == torch.float32
    return xi, xs, y, (0 if f32 else y.data_ptr()), (y.data_ptr() if f32
                                                     else 0)


def _w8a8_entry():
    fn = _build.load("w8a8_matmul").w8a8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def w8a8_matmul(x: torch.Tensor, wi: torch.Tensor, ws: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = dequant(q8(x) @ wi.T) for x (..., K), wi (O, K) int8, ws (O,)
    fp32 → (..., O) in x.dtype; ``out_dtype=torch.float32`` returns the
    fp32 result before the cast.

    CUDA: x bf16, every tensor contiguous, K % 32 == 0; any O and M (the
    ragged edges are masked in the kernel).  Anything else raises."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, wi, ws, out_dtype)
    O, K = wi.shape
    _check("w8a8_matmul", x, K, K, (("wi", wi, (O, K), torch.int8),
                                    ("ws", ws, (O,), torch.float32)))
    x2 = x.reshape(-1, K)
    xi, xs, y, y16, y32 = _scratch(x2, O, out_dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _w8a8_entry()(x2.data_ptr(), wi.data_ptr(), ws.data_ptr(),
                        xi.data_ptr(), xs.data_ptr(), y16, y32, x2.shape[0],
                        K, O, stream)
    _build.check(err, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return y.reshape(*x.shape[:-1], O)


_build.counted(w8a8_matmul)


def _w4a8_entry():
    fn = _build.load("w4a8_matmul").w4a8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def w4a8_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                group_size: int = 128,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = dequant(q8(x) @ dequant4(qweight).T) for x (..., K), qweight
    (O, K//8) int32 (``pack_w4``), scales (O, K//g) fp32 → (..., O) in
    x.dtype; ``out_dtype=torch.float32`` returns the fp32 result before the
    cast.

    CUDA: x bf16, every tensor contiguous, K % g == 0, g % 32 == 0; any O
    and M (the ragged edges are masked in the kernel).  Anything else
    raises."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, qweight, scales, group_size, out_dtype)
    O = qweight.shape[0]
    K = x.shape[-1]
    g = group_size
    _check("w4a8_matmul", x, K, g,
           (("qweight", qweight, (O, K // PLANES), torch.int32),
            ("scales", scales, (O, K // max(g, 1)), torch.float32)))
    x2 = x.reshape(-1, K)
    xi, xs, y, y16, y32 = _scratch(x2, O, out_dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _w4a8_entry()(x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                        xi.data_ptr(), xs.data_ptr(), y16, y32, x2.shape[0],
                        K, O, g, stream)
    _build.check(err, "w4a8_matmul")
    w4a8_matmul.launches += 1
    return y.reshape(*x.shape[:-1], O)


_build.counted(w4a8_matmul)
