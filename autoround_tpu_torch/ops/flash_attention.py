"""Flash attention, forward and backward (counterpart of
``autoround_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v, causal)`` returns ``(out, lse)`` and is
differentiable in q, k and v.  On CUDA tensors it is a
``torch.autograd.Function`` around three hand-written kernels: the forward
(``csrc/flash_attention.cu``) and the two backward passes dQ and dK/dV
(``csrc/flash_attention_bwd.cu``), which recompute the probabilities from
the saved (B, H, S) fp32 lse; a CUDA tensor launches them or raises.  On
CPU tensors it runs :func:`flash_attention_plain`, the plain PyTorch
version that mirrors ``flash_attention_ref``, under ordinary autograd.
:func:`flash_attention_bwd_plain` is the plain version of the backward
kernels, step by step with their roundings; the tests and the card-side
comparison use it, the CUDA path never does.

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

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_plain"]

_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _mask_causal(s: torch.Tensor) -> torch.Tensor:
    """Scores (..., S, T) with the keys right of the bottom-right diagonal
    set to the mask value."""
    S, T = s.shape[-2:]
    mask = torch.ones((S, T), dtype=torch.bool, device=s.device).tril(T - S)
    return torch.where(mask, s, torch.full_like(s, _MASK_VALUE))


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
        s = _mask_causal(s)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the two backward kernels → (dq, dk, dv) in the
    inputs' dtypes.  P = exp(S − lse) recomputed in fp32, δ = rowsum(dO∘O),
    dS = P∘(dO·Vᵀ − δ)·scale; P and dS are cast to the working dtype before
    the products that consume them, the sums are fp32, and dK/dV are summed
    over each KV head's group of query heads in fp32 before the cast."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    kr = k.repeat_interleave(rep, dim=1) if rep > 1 else k
    vr = v.repeat_interleave(rep, dim=1) if rep > 1 else v
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kr.float()) * scale
    if causal:
        s = _mask_causal(s)
    p = torch.exp(s - lse[..., None])
    delta = (out.float() * do.float()).sum(-1)
    dp = torch.einsum("bhsd,bhtd->bhst", do.float(), vr.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kr.float())
    dkh = torch.einsum("bhst,bhsd->bhtd", ds, q.float())
    dvh = torch.einsum("bhst,bhsd->bhtd", p.to(do.dtype).float(), do.float())
    dk = dkh.reshape(B, Hkv, rep, T, D).sum(2)
    dv = dvh.reshape(B, Hkv, rep, T, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _entry(lib: str, name: str, n_ptr: int):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(what: str, q, k, v, causal: bool):
    """Raise unless the kernels take these tensors; → (B, H, Hkv, S, T, D)."""
    B, H, S, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    Hkv, T = k.shape[1], k.shape[2]
    _check_tensors(what, q.device, torch.bfloat16, q=q, k=k, v=v)
    if (D not in (128, 256) or S % 64 or T % 64 or H % Hkv
            or (causal and T < S)):
        raise ValueError(f"{what}: kernel takes D in (128, 256), "
                         f"S, T % 64 == 0, H % Hkv == 0, T >= S if causal; "
                         f"got D={D} S={S} T={T} H={H} Hkv={Hkv}")
    return B, H, Hkv, S, T, D


def _check_tensors(what: str, device, dtype, **tensors):
    for name, t in tensors.items():
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dtype} tensor on {device}")


def _flash_fwd_cuda(q, k, v, causal: bool):
    B, H, Hkv, S, T, D = _check_qkv("flash_attention", q, k, v, causal)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("flash_attention", "flash_attention_fwd", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Hkv, S, T, D, int(causal), 1.0 / math.sqrt(D),
        stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def _check_bwd(what: str, q, k, v, do, lse, delta, causal: bool):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {q.device}")
    dims = _check_qkv(what, q, k, v, causal)
    B, H, _, S, _, _ = dims
    if do.shape != q.shape or lse.shape != (B, H, S) \
            or delta.shape != (B, H, S):
        raise ValueError(f"{what}: shapes do {tuple(do.shape)} lse "
                         f"{tuple(lse.shape)} delta {tuple(delta.shape)}")
    _check_tensors(what, q.device, torch.bfloat16, do=do)
    _check_tensors(what, q.device, torch.float32, lse=lse, delta=delta)
    return dims


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True
                           ) -> torch.Tensor:
    """dQ (B,H,S,D) bf16 from the dQ kernel.  q, do (B,H,S,D), k/v
    (B,Hkv,T,D) bf16 contiguous on the card, lse and delta (B,H,S) fp32;
    the shapes the forward takes, anything else raises."""
    B, H, Hkv, S, T, D = _check_bwd("flash_attention_bwd_dq", q, k, v, do,
                                    lse, delta, causal)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("flash_attention_bwd", "flash_attention_bwd_dq", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Hkv, S, T, D,
        int(causal), 1.0 / math.sqrt(D), stream)
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B,Hkv,T,D) bf16 and already summed over each KV
    head's group of query heads, from the dK/dV kernel.  Inputs as
    :func:`flash_attention_bwd_dq`."""
    B, H, Hkv, S, T, D = _check_bwd("flash_attention_bwd_dkv", q, k, v, do,
                                    lse, delta, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("flash_attention_bwd", "flash_attention_bwd_dkv", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
        Hkv, S, T, D, int(causal), 1.0 / math.sqrt(D), stream)
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` on the card: δ = rowsum(dO∘O) in
    fp32 with torch ops (as the JAX package leaves it to XLA), then the dQ
    and the dK/dV kernel.  Raises on what the kernels do not take."""
    # out.float() * do.float(), summed: the product in place (do is cast
    # exactly), one fp32 copy fewer
    delta = out.float().mul_(do).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel forward saving (q, k, v, out, lse); kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_fwd_cuda(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # the caller's dO is usually a transposed view
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,H,S,D), k/v (B,Hkv,T,D) → (out, lse); differentiable in q, k,
    v (lse is not).

    CUDA: bf16, contiguous, D in {128, 256}, S and T multiples of 64,
    H % Hkv == 0 and, when causal, T >= S; anything else raises."""
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal)
        return out, lse.detach()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, causal)


# launches of the forward, the dQ and the dK/dV kernel, and calls of the
# backward pair
flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd.launches = 0
