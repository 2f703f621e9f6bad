"""INT8-QK (SageAttention-style) prefill attention (counterpart of
``autoround_tpu/ops/sage_attention.py``).

q (B, H, S, D), k/v (B, Hkv, T, D); query head h reads kv head h // (H /
Hkv).  The mean key of each (batch, kv head) over all T keys (those the
causal mask hides included) is subtracted from k in fp32, which leaves the
softmax unchanged; q and the smoothed k are quantized per token to int8
with max-abs scales ``max(amax, 1e-8) / 127`` (round half to even); the
int32 QKᵀ is dequantized by the rank-1 product of the two scale vectors
and 1/√D; the bottom-right causal mask (``col <= row + T - S``) sets
-0.7·FLT_MAX; softmax in fp32; P is cast to v's dtype and P·V accumulates
in fp32; the result is in q's dtype.

``sage_attention`` launches ``csrc/sage_attention.cu`` on a CUDA tensor (or
raises) and runs :func:`sage_attention_plain`, which mirrors
``sage_attention_ref``, on a CPU tensor.  As in the JAX package the op is
forward-only and nothing in the engine routes to it: it is available as an
alternative to the bf16 flash forward.

The two division forms.  ``sage_attention_ref`` divides by the constants
127 and √D.  Called eagerly it divides; inside the jitted
``sage_attention`` (which off the TPU runs that reference) XLA multiplies by
their fp32 reciprocals.  ``recip`` picks the form; the kernel uses the
jitted one.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..dtypes.fp8 import div_const
from . import _build
from .flash_attention import _check_tensors, _mask_causal

__all__ = ["sage_attention", "sage_attention_plain", "int8_rows",
           "key_mean"]


def int8_rows(x: torch.Tensor, recip: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) max-abs int8 quantization → (codes int8, scales
    fp32 with a trailing 1), as ``_int8_rows``: s = max(amax, 1e-8) / 127,
    codes = round-half-even(x / s) (a true division by s in both forms)."""
    xf = x.float()
    s = div_const(xf.abs().amax(-1, keepdim=True).clamp_min(1e-8), 127.0,
                  recip)
    return torch.round(xf / s).to(torch.int8), s


def key_mean(k: torch.Tensor) -> torch.Tensor:
    """The per-(batch, head) mean key of k (B, Hkv, T, D) over T → (B, Hkv,
    D) fp32: one reduction that reads k in its own dtype and sums in fp32.
    (Its order, and so its last bit, differs from XLA's.)"""
    return k.mean(dim=2, dtype=torch.float32)


def sage_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, recip: bool = False,
                         k_mean: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version mirroring ``sage_attention_ref`` (GQA by repeating the
    kv heads, as the jitted op does before calling it); ``recip`` as the
    module says.  ``k_mean`` (B, Hkv, D) fp32, as the kernel takes it,
    defaults to :func:`key_mean`.  A causal row with no visible key (T < S)
    gets the uniform softmax of the reference."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    if k_mean is None:
        k_mean = key_mean(k)
    qi, qs = int8_rows(q, recip)
    ki, ks = int8_rows(k.float() - k_mean[:, :, None], recip)
    if rep > 1:
        ki = ki.repeat_interleave(rep, dim=1)
        ks = ks.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    # int32 products of int8 codes are exact in fp32 (|sum| < 2^24 for
    # D <= 1024), and float64 sums them exactly on every device
    s = torch.einsum("bhsd,bhtd->bhst", qi.double(), ki.double()).float()
    s = div_const(s * qs * ks.transpose(-1, -2), math.sqrt(D), recip)
    if causal:
        s = _mask_causal(s)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _entry(name: str, n_ptr: int, n_int: int, has_float: bool = False):
    fn = getattr(_build.load("sage_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * has_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _quantize_keys(k: torch.Tensor, k_mean: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's pre-pass on a CUDA k (B, Hkv, T, D) bf16 and its mean
    key (B, Hkv, D) fp32: int8 codes (B, Hkv, T, D) and fp32 scales (B,
    Hkv, T) of k - k_mean, those of ``int8_rows(k.float() - k_mean[:, :,
    None], recip=True)`` bit for bit.  Shapes as :func:`sage_attention`
    checks them."""
    B, Hkv, T, D = k.shape
    ki = torch.empty((B, Hkv, T, D), dtype=torch.int8, device=k.device)
    ks = torch.empty((B, Hkv, T), dtype=torch.float32, device=k.device)
    stream = torch.cuda.current_stream(k.device).cuda_stream
    err = _entry("sage_quantize_keys", 4, 4)(
        k.data_ptr(), k_mean.data_ptr(), ki.data_ptr(), ks.data_ptr(), B,
        Hkv, T, D, stream)
    _build.check(err, "sage_attention (key pre-pass)")
    return ki, ks


def sage_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """INT8-QK attention: q (B, H, S, D), k/v (B, Hkv, T, D) → (B, H, S, D)
    in q.dtype.  Forward only.

    CUDA: bf16, contiguous, D in {128, 256}, S and T multiples of 64,
    H % Hkv == 0 and, when causal, T >= S (the kernel would give a row
    with no visible key 0 where the reference gives the uniform softmax);
    anything else raises.  The mean key is one torch reduction; a pre-pass
    kernel quantizes the smoothed keys once, the attention kernel its q
    tiles.  CPU: the plain version in the kernel's (and the jitted JAX
    op's) reciprocal form."""
    if q.device.type == "cpu":
        return sage_attention_plain(q, k, v, causal, recip=True)
    if q.device.type != "cuda":
        raise ValueError(f"sage_attention: unsupported device {q.device}")
    B, H, S, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"sage_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    Hkv, T = k.shape[1], k.shape[2]
    _check_tensors("sage_attention", q.device, torch.bfloat16, q=q, k=k, v=v)
    if (D not in (128, 256) or S % 64 or T % 64 or H % Hkv
            or (causal and T < S)):
        raise ValueError(f"sage_attention: kernel takes D in (128, 256), "
                         f"S, T % 64 == 0, H % Hkv == 0, T >= S if causal; "
                         f"got D={D} S={S} T={T} H={H} Hkv={Hkv}")
    ki, ks = _quantize_keys(k, key_mean(k).contiguous())
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("sage_attention_fwd", 5, 7, True)(
        q.data_ptr(), ki.data_ptr(), ks.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, H, Hkv, S, T, D, int(causal), 1.0 / math.sqrt(D),
        stream)
    _build.check(err, "sage_attention")
    sage_attention.launches += 1
    return out


_build.counted(sage_attention)
