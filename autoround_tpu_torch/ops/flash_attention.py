"""Flash attention forward (counterpart of ``autoround_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v, causal)`` returns ``(out, lse)``: on a CUDA
tensor it launches the hand-written kernel ``csrc/flash_attention.cu``
(or raises), on a CPU tensor it runs :func:`flash_attention_plain`, the
plain PyTorch version that mirrors ``flash_attention_ref``.  The lse is
(B, H, S) fp32 — the backward of a later slice consumes it.

The causal mask is anchored bottom-right: query row i sees key column j
iff ``j <= i + (T - S)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain"]

_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,H,S,D), k/v (B,Hkv,T,D) → (out (B,H,S,D) in q.dtype,
    lse (B,H,S) fp32).  Scores and softmax in fp32; the probabilities are
    cast to v.dtype before P·V, as ``flash_attention_ref`` does."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril(T - S)
        s = torch.where(mask, s, torch.full_like(s, _MASK_VALUE))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,H,S,D), k/v (B,Hkv,T,D) → (out, lse).

    CUDA: bf16, contiguous, D in {128, 256}, S and T multiples of 64,
    H % Hkv == 0 and, when causal, T >= S; anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, S, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    Hkv, T = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"bf16 tensor on {q.device}")
    if (D not in (128, 256) or S % 64 or T % 64 or H % Hkv
            or (causal and T < S)):
        raise ValueError(f"flash_attention: kernel takes D in (128, 256), "
                         f"S, T % 64 == 0, H % Hkv == 0, T >= S if causal; "
                         f"got D={D} S={S} T={T} H={H} Hkv={Hkv}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr(), B, H, Hkv, S, T, D, int(causal),
                   1.0 / math.sqrt(D), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
