"""W4A16 dequant-matmul (counterpart of ``autoround_tpu/ops/qmatmul.py``).

Codes are symmetric full-range int4, ``dq = (code - 8) * scale`` with one
fp32 scale per group of ``group_size`` input columns; the scale's sign
carries the full-range flip, so scales may be negative.

The port's packed layout (``pack_w4``) differs from the JAX package's
nibble planes, which were chosen for the TPU's (8, 128) tiles: here word
``w`` of a row holds the codes of columns ``8w .. 8w+7``, column ``8w+j``
in nibble ``j``, so a 16-byte load brings 32 consecutive codes.  The codes
and scales going in and the numbers coming out are those of the JAX
package.

``w4a16_matmul`` launches ``csrc/w4a16_matmul.cu`` on a CUDA tensor (or
raises) and runs :func:`w4a16_matmul_plain` on a CPU tensor;
``w4a16_matmul_grouped`` (one launch for all experts of a MoE block) does
the same with ``csrc/w4a16_matmul_grouped.cu`` and
:func:`w4a16_matmul_grouped_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["PLANES", "pack_w4", "unpack_w4", "w4a16_matmul",
           "w4a16_matmul_plain", "w4a16_matmul_grouped",
           "w4a16_matmul_grouped_plain", "check_w4_operands", "W4_G_MULTIPLE",
           "w4_tileable"]

PLANES = 8  # int4 codes per int32 word
# The kernels' GEMV bodies read a 4-bit format's scale per 16-column half
# of a 32-column chunk, so its groups may be any multiple of 16; the 8- and
# 2-bit formats read one scale per chunk and pass 32.
W4_G_MULTIPLE = 16


def pack_w4(codes: torch.Tensor) -> torch.Tensor:
    """(O, K) codes in [0, 15] → (O, K // 8) int32, column 8w+j in nibble j
    of word w."""
    O, K = codes.shape
    if K % PLANES:
        raise ValueError(f"K={K} must be a multiple of {PLANES}")
    words = torch.zeros((O, K // PLANES), dtype=torch.int64,
                        device=codes.device)
    for j in range(PLANES):
        words |= (codes[:, j::PLANES].to(torch.int64) & 0xF) << (4 * j)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_w4(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_w4` → (O, K) int32 codes."""
    O, Kw = words.shape
    # int32 shifts sign-extend, the 0xF mask keeps exactly the nibble
    shifts = torch.arange(PLANES, device=words.device, dtype=torch.int32) * 4
    codes = (words.to(torch.int32)[:, :, None] >> shifts) & 0xF
    return codes.reshape(O, Kw * PLANES)


def w4a16_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                       scales: torch.Tensor,
                       group_size: int = 128) -> torch.Tensor:
    """Plain version mirroring ``w4a16_matmul_ref``: dequantize to x.dtype,
    multiply with fp32 accumulation, cast back to x.dtype."""
    O, Kw = qweight.shape
    K = Kw * PLANES
    codes = unpack_w4(qweight)
    s = scales.float().repeat_interleave(group_size, dim=1)[:, :K]
    w = ((codes - 8).float() * s).to(x.dtype)
    y = x.reshape(-1, K).float() @ w.float().T
    return y.to(x.dtype).reshape(*x.shape[:-1], O)


def w4_tileable(K: int, g: int, g_multiple: int = W4_G_MULTIPLE) -> bool:
    """Whether the W4A16-family kernels take K columns in groups of g:
    K % 32 == 0, K % g == 0 and g % g_multiple == 0."""
    return g > 0 and g % g_multiple == 0 and K > 0 and K % g == 0 \
        and K % 32 == 0


def check_w4_operands(what: str, x: torch.Tensor, K: int, g: int,
                      operands, g_multiple: int = W4_G_MULTIPLE) -> None:
    """Raise ``ValueError`` unless the kernels of the W4A16 family can take
    these tensors: x bf16 on a CUDA device, :func:`w4_tileable`, and every ``(name, tensor, shape, dtype)`` of
    ``operands`` contiguous on x's device with exactly that shape and
    dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: needs x bf16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input")
    if not w4_tileable(K, g, g_multiple):
        raise ValueError(f"{what}: K={K} group_size={g} (needs K % 32 == 0, "
                         f"K % g == 0 and g % {g_multiple} == 0)")
    for name, t, shape, dtype in operands:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {tuple(shape)} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{x.device}")


def _entry():
    fn = _build.load("w4a16_matmul").w4a16_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def w4a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """y = x @ dequant(qweight).T for x (..., K), qweight (O, K//8) int32,
    scales (O, K//g) fp32 → (..., O) in x.dtype.

    CUDA: x bf16, every tensor contiguous, K % 32 == 0, K % g == 0, g % 16
    == 0; any O (the ragged edge is masked in the kernel).  Anything else
    raises."""
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, qweight, scales, group_size)
    K = x.shape[-1]
    O = qweight.shape[0]
    g = group_size
    check_w4_operands("w4a16_matmul", x, K, g,
                      (("qweight", qweight, (O, K // PLANES), torch.int32),
                       ("scales", scales, (O, K // max(g, 1)),
                        torch.float32)))
    if not x.is_contiguous():
        raise ValueError("w4a16_matmul: x must be contiguous")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                   y.data_ptr(), M, K, O, g, stream)
    _build.check(err, "w4a16_matmul")
    w4a16_matmul.launches += 1
    return y.reshape(*x.shape[:-1], O)


_build.counted(w4a16_matmul)


def w4a16_matmul_grouped_plain(x: torch.Tensor, qweight: torch.Tensor,
                               scales: torch.Tensor,
                               group_size: int = 128) -> torch.Tensor:
    """Plain version mirroring ``w4a16_matmul_grouped_ref``: the ungrouped
    plain product per expert, stacked."""
    return torch.stack([w4a16_matmul_plain(x[e], qweight[e], scales[e],
                                           group_size)
                        for e in range(qweight.shape[0])])


def _grouped_entry():
    fn = _build.load("w4a16_matmul_grouped").w4a16_matmul_grouped
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def w4a16_matmul_grouped(x: torch.Tensor, qweight: torch.Tensor,
                         scales: torch.Tensor,
                         group_size: int = 128) -> torch.Tensor:
    """Grouped (MoE) product, one launch for all experts: y[e] = x[e] @
    dequant(qweight[e]).T for x (E, C, K), qweight (E, O, K//8) int32,
    scales (E, O, K//g) fp32 → (E, C, O) in x.dtype.

    CUDA: x bf16; qweight and scales contiguous; every x[e] a contiguous
    (C, K) slab at any expert stride that keeps 16-byte alignment: the
    contiguous one, 0 (``h.expand(E, C, K)``: every expert reads the same
    rows, nothing is copied) or a slice of a taller buffer; any C >= 1 and
    any O (ragged edges are masked in the kernel); K % 32 == 0, K % g == 0,
    g % 16 == 0.  Anything else raises."""
    if x.device.type == "cpu":
        return w4a16_matmul_grouped_plain(x, qweight, scales, group_size)
    if x.ndim != 3 or qweight.ndim != 3:
        raise ValueError(f"w4a16_matmul_grouped: x {tuple(x.shape)} qweight "
                         f"{tuple(qweight.shape)} must be 3-D")
    E, C, K = x.shape
    O = qweight.shape[1]
    g = group_size
    check_w4_operands(
        "w4a16_matmul_grouped", x, K, g,
        (("qweight", qweight, (E, O, K // PLANES), torch.int32),
         ("scales", scales, (E, O, K // max(g, 1)), torch.float32)))
    if (x.stride(2) != 1 or (C > 1 and x.stride(1) != K) or x.stride(0) < 0
            or x.stride(0) % 8 or x.data_ptr() % 16):
        raise ValueError(f"w4a16_matmul_grouped: x strides {x.stride()} "
                         f"(needs contiguous (C, K) slabs, 16-byte aligned, "
                         f"at an expert stride that is a multiple of 8)")
    y = torch.empty((E, C, O), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _grouped_entry()(x.data_ptr(), qweight.data_ptr(),
                           scales.data_ptr(), y.data_ptr(), E, x.stride(0),
                           C, K, O, g, stream)
    _build.check(err, "w4a16_matmul_grouped")
    w4a16_matmul_grouped.launches += 1
    return y


_build.counted(w4a16_matmul_grouped)
