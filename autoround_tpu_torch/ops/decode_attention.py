"""Single-token attention over an int8 KV cache (counterpart of
``autoround_tpu/ops/decode_attention.py``).

``decode_attention`` launches ``csrc/decode_attention.cu`` on a CUDA
tensor (or raises) and runs :func:`decode_attention_plain`, which mirrors
``decode_attention_ref``, on a CPU tensor.  The K scale folds into the
score scale and the V scale into the output; ``pos`` is the index of the
current token per sequence (columns ``<= pos`` attend), ``window`` keeps
``idx > pos - window``, ``chunk`` keeps ``idx >= (pos // chunk) * chunk``,
and ``sinks`` (nh,) add one logit per head to the softmax denominator.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

__all__ = ["decode_attention", "decode_attention_plain"]

_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _pos_vector(pos, B: int, device) -> torch.Tensor:
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return p.expand(B).contiguous()


def decode_attention_plain(q, k_cache, v_cache, pos, k_scale, v_scale,
                           sm_scale: float, softcap: float = 0.0,
                           window: Optional[int] = None,
                           sinks: Optional[torch.Tensor] = None,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """Dequantize + masked softmax attention.

    q (B, nh, hd); k/v_cache (B, T, n_kv, hd) int8 (or any dtype); pos (B,)
    or scalar; k/v_scale (n_kv,) fp32; sinks (nh,) or None.  Returns
    (B, nh, hd) in q.dtype.  (Argument order as ``decode_attention_ref``.)
    """
    B, nh, hd = q.shape
    T, nkv = k_cache.shape[1], k_cache.shape[2]
    rep = nh // nkv
    pos = _pos_vector(pos, B, q.device).long()
    kf = k_cache.float() * k_scale.float().reshape(1, 1, nkv, 1)
    vf = v_cache.float() * v_scale.float().reshape(1, 1, nkv, 1)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    s = torch.einsum("bnh,btnh->bnt", q.float(), kf) * sm_scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    idx = torch.arange(T, device=q.device)[None, None, :]
    p_ = pos[:, None, None]
    valid = idx <= p_
    if window is not None:
        valid = valid & (idx > p_ - window)
    if chunk is not None:
        valid = valid & (idx >= torch.div(p_, chunk, rounding_mode="floor")
                         * chunk)
    s = torch.where(valid, s, torch.full_like(s, _MASK_VALUE))
    if sinks is not None:
        sc = sinks.float().reshape(1, nh, 1).expand(B, nh, 1)
        p = torch.softmax(torch.cat([s, sc], dim=-1), dim=-1)[..., :-1]
    else:
        p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnt,btnh->bnh", p, vf)
    return out.to(q.dtype)


def _entry():
    fn = _build.load("decode_attention").decode_attention_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, pos, k_scale, v_scale,
                     sm_scale: float, softcap: float = 0.0,
                     window: Optional[int] = None,
                     chunk: Optional[int] = None,
                     sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused single-token attention over an int8 KV cache.

    q (B, nh, hd); k/v_cache (B, T, n_kv, hd) int8; pos (B,) int32 or a
    scalar; k/v_scale (n_kv,) fp32; sinks (nh,) fp32 or None.

    CUDA: q bf16, hd == 128, nh / n_kv in {1, 2, 4, 8}, contiguous
    tensors; window and chunk positive when given.  Anything else raises.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, k_scale,
                                      v_scale, sm_scale, softcap, window,
                                      sinks, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, nh, hd = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    T, nkv = k_cache.shape[1], k_cache.shape[2]
    if hd != 128 or nh % nkv or nh // nkv not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention: kernel takes hd == 128 and "
                         f"G in (1, 2, 4, 8); got hd={hd} nh={nh} nkv={nkv}")
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.int8 \
            or v_cache.dtype != torch.int8:
        raise ValueError("decode_attention: needs q bf16 and int8 caches")
    if (window is not None and window <= 0) or (chunk is not None
                                                and chunk <= 0):
        raise ValueError("decode_attention: window / chunk must be > 0")
    k_scale = k_scale.reshape(-1)
    v_scale = v_scale.reshape(-1)
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("k_scale", k_scale), ("v_scale", v_scale)]
    if sinks is not None:
        if sinks.dtype != torch.float32 or sinks.numel() != nh:
            raise ValueError("decode_attention: sinks must be fp32 (nh,)")
        tensors.append(("sinks", sinks))
    for name, t in tensors:
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"on {q.device}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
            or k_scale.numel() != nkv or v_scale.numel() != nkv:
        raise ValueError("decode_attention: k/v_scale must be fp32 (n_kv,)")
    pos_v = _pos_vector(pos, B, q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   pos_v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                   None if sinks is None else sinks.data_ptr(),
                   out.data_ptr(), B, T, nh, nkv, hd, float(sm_scale),
                   float(softcap or 0.0), int(window or 0), int(chunk or 0),
                   stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
