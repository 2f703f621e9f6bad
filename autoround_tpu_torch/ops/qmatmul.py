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
raises) and runs :func:`w4a16_matmul_plain` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["PLANES", "pack_w4", "unpack_w4", "w4a16_matmul",
           "w4a16_matmul_plain"]

PLANES = 8  # int4 codes per int32 word


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

    CUDA: x bf16, every tensor contiguous, K % g == 0, g % 32 == 0; any O
    (the ragged edge is masked in the kernel).  Anything else raises."""
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, qweight, scales, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"w4a16_matmul: unsupported device {x.device}")
    K = x.shape[-1]
    O, Kw = qweight.shape
    g = group_size
    if Kw * PLANES != K or g <= 0 or g % 32 or K % g \
            or tuple(scales.shape) != (O, K // g):
        raise ValueError(f"w4a16_matmul: x {tuple(x.shape)} qweight "
                         f"{tuple(qweight.shape)} scales {tuple(scales.shape)}"
                         f" group_size {g}")
    if (x.dtype != torch.bfloat16 or qweight.dtype != torch.int32
            or scales.dtype != torch.float32):
        raise ValueError("w4a16_matmul: needs x bf16, qweight int32, "
                         "scales fp32")
    for name, t in (("x", x), ("qweight", qweight), ("scales", scales)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"w4a16_matmul: {name} must be contiguous on "
                             f"{x.device}")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if M == 0:
        raise ValueError("w4a16_matmul: empty input")
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                   y.data_ptr(), M, K, O, g, stream)
    _build.check(err, "w4a16_matmul")
    w4a16_matmul.launches += 1
    return y.reshape(*x.shape[:-1], O)


w4a16_matmul.launches = 0
