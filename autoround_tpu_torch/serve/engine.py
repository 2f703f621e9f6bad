"""Quantized serving engine: packed weights + KV cache + decode loop
(counterpart of ``autoround_tpu/serve/engine.py``; the Llama and Mixtral
families, every kind of the JAX engine — ``w4a16``, ``w4a16_asym``,
``w4a8``, ``w8a8``, ``w8a16``, ``w2a16``, ``fp8``, ``mxfp4_g32`` and
``mxfp4_g16`` — and ``kv_quant`` None, ``"int8"`` or ``"fp8"``).  The float kinds and
W2A16 serve weight-only with bf16 activations, as the JAX engine does: the
act fields of their schemes shape calibration and tuning only.  The Llama
family's flags (Qwen2.5's q/k/v biases, qk-norm, Gemma's norm offset,
sandwich norms, GeGLU, embedding scale and softcaps, sliding windows and
local rope) ride the one block of ``_block_with_cache``, as in the JAX
engine.

Packed weights stay resident on the card and every packed projection
runs its kind's kernel (``ops/qmatmul``, ``ops/qmatmul_ext``,
``ops/qmatmul_int8``); q/k/v and gate/up are fused along O so one launch
serves each group.  The ``w4a16`` and ``w4a8`` kernels read the same
packed words, so the two opt-in modes that put a W4A16 result on the int8
kernel (``serve_a8`` at packing time, ``prefill_a8`` for prompt passes
only) hold no second copy of the weights.  The experts of
a MoE block are stacked per projection and run the grouped kernel, one
launch for all experts (``_stack_experts``); a block whose experts cannot
all stack serves them one by one through the ungrouped kernel.  Expert
routing is dense-then-mask unless ``moe_capacity_factor > 0`` asks for
capacity dispatch.  Prefill attention takes the flash
kernel where the routing gate passes; every decode step with the int8
cache attends through the int8-KV decode kernel (``ops/decode_attention``).
The fp8 cache (e4m3 storage, per-head scales as for int8) has no kernel, as
in the JAX engine: a step dequantizes the layer's cache and runs the plain
masked attention.

A decode step carries its position as a (B,) int32 tensor on the device,
one entry per slot, and reads no host value that changes from step to
step.  ``generate_scan`` (the JAX engine's on-device ``lax.scan`` loop)
uses that: on the card it runs the first decode step eagerly, captures the
second as a CUDA graph over static buffers (token, positions, cache,
sampler state, output columns) and replays it for the rest; the graph is
kept per (batch, kv_quant, sampling, prefill_a8) and replayed by later
calls.  A failed capture or replay raises; there is no eager fallback.  A
CPU engine runs the same static-buffer step eagerly.

Unlike the JAX package, the cache is updated in place: ``decode_step``
returns the same buffers it was given, with one more token written.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .._device import resolve_device
from ..models import llama, mixtral
from ..ops._build import COUNTED
from ..ops.decode_attention import check_decode_shape, decode_attention
from ..ops.qmatmul import (PLANES, W4_G_MULTIPLE, pack_w4, w4_tileable,
                           w4a16_matmul, w4a16_matmul_grouped)
from ..ops.qmatmul_ext import (fp8_matmul, mxfp4_matmul, pack_w2,
                               w2a16_matmul, w4a16_asym_matmul, w8a16_matmul)
from ..ops.qmatmul_int8 import w4a8_matmul, w8a8_matmul
from ..quantize.orchestrator import QuantizeResult
from ..utils.logger import logger
from ..utils.pytree import set_by_path, tree_map
from .sampling import SamplingParams, sample_token

__all__ = ["KVCache", "QuantizedLlama"]


class KVCache(NamedTuple):
    """KV cache; optionally int8 or fp8 (e4m3) storage with per-(layer,
    head) static scales calibrated at prefill."""

    k: torch.Tensor  # (L, B, T, n_kv, hd) — cfg dtype, or int8 / fp8 storage
    v: torch.Tensor
    length: int      # tokens filled so far (for the cache-full check)
    k_scale: Optional[torch.Tensor] = None  # (L, 1, 1, n_kv, 1) when quantized
    v_scale: Optional[torch.Tensor] = None
    # (B,) int32 on the device: the position each slot's next token takes
    # (zeros from ``_init_cache``, the prompt length after the prefill)
    pos: Optional[torch.Tensor] = None


_KV_QMAX = {"int8": 127.0, "fp8": 448.0}
_KV_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _check_kv_quant(kv_quant: Optional[str]) -> None:
    if kv_quant not in (None, "int8", "fp8"):
        raise NotImplementedError(
            f"kv_quant={kv_quant!r} is not ported (None, 'int8' or 'fp8')")


def _init_cache(cfg: llama.LlamaConfig, batch: int, max_seq: int,
                n_layers: int, kv_quant: Optional[str], device) -> KVCache:
    """An empty cache (with scale buffers when quantized).  On the card an
    int8 cache is decoded by the decode kernel alone, so a head shape it
    does not take raises here, before the prompt pass, naming the shape."""
    if kv_quant == "int8" and torch.device(device).type == "cuda":
        check_decode_shape(cfg.hd, cfg.num_heads, cfg.num_kv_heads)
    shape = (n_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd)
    store = _KV_DTYPE.get(kv_quant, cfg.dtype)
    ks = vs = None
    if kv_quant is not None:
        ks = torch.ones((n_layers, 1, 1, cfg.num_kv_heads, 1), device=device)
        vs = torch.ones_like(ks)
    return KVCache(k=torch.zeros(shape, dtype=store, device=device),
                   v=torch.zeros(shape, dtype=store, device=device),
                   length=0, k_scale=ks, v_scale=vs,
                   pos=torch.zeros((batch,), dtype=torch.int32,
                                   device=device))


def _kv_quantize(x: torch.Tensor, scale: torch.Tensor,
                 kv_quant: str) -> torch.Tensor:
    """x (..., n_kv, hd) → int8 or e4m3 storage with a per-head scale:
    x / scale clipped to ±qmax, then rounded to int8 or cast to e4m3
    (round to nearest even, as the JAX engine's cast)."""
    qmax = _KV_QMAX[kv_quant]
    y = torch.clamp(x.float() / scale, -qmax, qmax)
    if kv_quant == "int8":
        return torch.round(y).to(torch.int8)
    return y.to(torch.float8_e4m3fn)


def _kv_dequantize(x: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (x.float() * scale).to(dtype)


_FUSE_GROUPS = (("qkv", ("q_proj", "k_proj", "v_proj")),
                ("gate_up", ("gate_proj", "up_proj")))


def _fuse_packed(packed: Dict[str, Tuple[torch.Tensor, ...]],
                 cfg: llama.LlamaConfig, kinds: Dict[str, str]):
    """Concatenate q/k/v and gate/up packed weights along O so one kernel
    launch replaces three / two (the shared activation is read once).
    Every payload component (qweight, scales[, zps]) concatenates: all
    kinds lay their first axis out as output channels.  Only groups whose
    members share one kernel kind and one group count fuse.  Members of a
    fused group are dropped (the weights are held once).  Returns
    (packed', splits, kinds') with ``splits`` the static table of member
    widths per fused entry."""
    kinds = dict(kinds)
    out = dict(packed)
    splits: Dict[str, Tuple[int, ...]] = {}
    for bi in range(cfg.num_layers):
        for fused_name, members in _FUSE_GROUPS:
            keys = [f"blocks.{bi}.{m}" for m in members]
            if not all(k in packed for k in keys):
                continue
            entries = [packed[k] for k in keys]
            if (len({kinds[k] for k in keys}) != 1
                    or len({len(e) for e in entries}) != 1
                    or len({tuple(e[1].shape[1:]) for e in entries}) != 1):
                continue   # another kernel or group count: no shared call
            key = f"blocks.{bi}.{fused_name}"
            out[key] = tuple(torch.cat([e[c] for e in entries], dim=0)
                             for c in range(len(entries[0])))
            splits[key] = tuple(int(e[0].shape[0]) for e in entries)
            kinds[key] = kinds[keys[0]]
            for k in keys:
                del out[k]
                del kinds[k]
    return out, splits, kinds


_EXPERT_TRIPLE = ("w1", "w2", "w3")


def _stack_experts(packed, kinds, cfg):
    """Stack per-expert packed ``w4a16`` entries into one grouped payload
    per (block, projection): ``blocks.i.experts_stack.<w>`` → (qweight
    (E, O, K/8), scales (E, O, K/g)), kind ``w4a16_grouped``.  The MoE path
    then runs one grouped kernel launch per projection instead of E
    launches.  Per-expert entries of a stacked projection are removed (the
    weights are held once).

    Stacking is atomic per block: either all of w1 / w2 / w3 stack or none
    does, because ``_moe_mlp`` takes the grouped route only with the full
    triple and the per-expert route needs every per-expert entry.  A
    projection stacks when every one of the E experts packed as ``w4a16``
    with identical shapes."""
    E = getattr(cfg, "num_experts", 0)
    if not E:
        return packed, kinds
    out, kinds = dict(packed), dict(kinds)
    n_stacked = 0
    for bi in range(cfg.num_layers):
        def stackable(wname):
            keys = [f"blocks.{bi}.experts.{e}.{wname}" for e in range(E)]
            if not all(kinds.get(k) == "w4a16" for k in keys):
                return None
            shapes = {tuple(t.shape for t in packed[k]) for k in keys}
            return keys if len(shapes) == 1 else None

        plan = {w: stackable(w) for w in _EXPERT_TRIPLE}
        if any(v is None for v in plan.values()):
            if any(v is not None for v in plan.values()):
                logger.warning(
                    "serving engine: block %d expert MLP only partially "
                    "stackable (%s): serving all its experts one by one",
                    bi, {w: ("ok" if v else "no") for w, v in plan.items()})
            continue
        for wname, keys in plan.items():
            skey = f"blocks.{bi}.experts_stack.{wname}"
            out[skey] = tuple(torch.stack([packed[k][c] for k in keys])
                              for c in range(2))
            kinds[skey] = "w4a16_grouped"
            for k in keys:
                del out[k]
                del kinds[k]
            n_stacked += 1
    if n_stacked:
        logger.info("serving engine: %d expert groups stacked for the "
                    "grouped MoE kernel", n_stacked)
    return out, kinds


def _serving_kind(s) -> Optional[str]:
    """Map a quantization scheme to a packed serving-kernel kind, as the
    JAX engine's ``_serving_kind`` does: ``w4a16`` (sym int codes of at
    most 4 bits: 3- and small-group 2-bit codes fit the int4 layout),
    ``w4a16_asym`` (the same with a per-group zero point), ``w4a8`` (sym
    int4, g >= 128, with sym int8 activations: quantized per token on the
    fly), ``w8a8`` (per-channel sym int8 with sym int8 activations),
    ``w8a16`` (any other sym int8), ``w2a16`` (sym int2, g >= 128; smaller
    groups ride ``w4a16``), ``fp8`` (e4m3 per channel or per tensor),
    ``mxfp4_g32`` / ``mxfp4_g16`` (MXFP4 / NVFP4: E2M1 codes, 32- or
    16-wide group scales), or None when the scheme has no packed path and
    serves its dense qdq weights."""
    act_int8 = s.act_bits == 8 and s.act_data_type == "int" and s.act_sym
    g = s.group_size if isinstance(s.group_size, int) else 0
    kind = None
    if s.data_type == "int" and s.bits == 4 and g >= 16:
        kind = ("w4a16_asym" if not s.sym
                else "w4a8" if act_int8 and g >= 128 else "w4a16")
    elif (s.super_bits and s.bits <= 4 and g >= 16
          and s.data_type == "int_dq"):
        kind = "w4a16" if s.sym else "w4a16_asym"
    elif s.data_type == "int" and s.bits == 3 and g >= 16:
        kind = "w4a16" if s.sym else "w4a16_asym"
    elif s.data_type == "int" and s.bits == 2 and g >= 16:
        kind = ("w4a16_asym" if not s.sym
                else "w2a16" if g >= 128 else "w4a16")
    elif s.data_type == "int" and s.bits == 8 and s.sym:
        kind = "w8a8" if g <= 0 and act_int8 else "w8a16"
    elif s.data_type == "fp8" and g <= 0 and not isinstance(s.group_size,
                                                            tuple):
        kind = "fp8"
    elif s.data_type in ("mx_fp", "nv_fp") and s.bits == 4 and g in (16, 32):
        kind = f"mxfp4_g{g}"
    return kind


def w4_codes_from_qdq(qdq: torch.Tensor, scale: torch.Tensor,
                      group_size: int) -> torch.Tensor:
    """Exact int4 codes of a sym full-range qdq: clip(rint(qdq / scale) +
    8, 0, 15) in fp32, the JAX engine's recovery (``engine.py:390-396``).
    Exact for bits <= 4 even from a bf16 qdq (|code - 8| <= 8)."""
    K = qdq.shape[1]
    srep = scale.float().repeat_interleave(group_size, dim=1)[:, :K]
    return torch.clamp(torch.round(qdq.float() / srep) + 8, 0, 15).to(
        torch.int32)


def w4_asym_codes_from_qdq(qdq: torch.Tensor, scale: torch.Tensor,
                           zp: torch.Tensor, group_size: int) -> torch.Tensor:
    """Int4 codes of an asym qdq: clip(rint(qdq / scale + zp), 0, 15) in
    fp32 with |scale| < 1e-12 replaced by 1e-12, the JAX engine's recovery
    (``engine.py:406-414``).  ``zp`` may be fractional."""
    K = qdq.shape[1]
    srep = scale.float().repeat_interleave(group_size, dim=1)[:, :K]
    zrep = zp.float().repeat_interleave(group_size, dim=1)[:, :K]
    srep = torch.where(srep.abs() < 1e-12, torch.full_like(srep, 1e-12),
                       srep)
    return torch.clamp(torch.round(qdq.float() / srep + zrep), 0, 15).to(
        torch.int32)


# sequence length from which ``prefill_a8`` sends a W4A16 projection to the
# int8 kernel (the JAX engine's threshold)
_A8_PROMPT_SEQ = 256


def w8_codes_from_qdq(qdq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Int8 codes of a sym qdq: clip(rint(qdq / scale), -128, 127) in fp32
    with |scale| < 1e-12 replaced by 1e-12, the JAX engine's recovery
    (``engine.py:425-441``).  ``scale`` is (O, columns), each column one
    group of K / columns input columns (one column: per channel)."""
    K = qdq.shape[1]
    srep = scale.float().repeat_interleave(K // scale.shape[1], dim=1)
    srep = torch.where(srep.abs() < 1e-12, torch.full_like(srep, 1e-12),
                       srep)
    return torch.clamp(torch.round(qdq.float() / srep), -128, 127).to(
        torch.int8)


_E2M1_MIDPOINTS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)
_E2M1_ROWS = 4096


def e2m1_codes_from_qdq(qdq: torch.Tensor, scale: torch.Tensor,
                        group_size: int) -> torch.Tensor:
    """E2M1 codes of an MXFP4 / NVFP4 qdq: the nearest of the 16 values to
    qdq / scale (|scale| < 1e-12 replaced by 1e-12), as the JAX engine's
    ``_encode_e2m1`` picks it, the first table entry on a tie (so -0.0 and
    any value nearest to zero take code 0, and an exact midpoint the smaller
    magnitude).  Counting midpoints below |v| does it without the table's
    (O, K, 16) distances.  Encoded _E2M1_ROWS rows at a time into int32
    codes, so the fp32 temporaries span one slice, not the whole matrix (an
    lm_head's 525 M weights would need 2 GB for each)."""
    O, K = qdq.shape
    mids = torch.tensor(_E2M1_MIDPOINTS, device=qdq.device)
    codes = torch.empty((O, K), dtype=torch.int32, device=qdq.device)
    for r0 in range(0, O, _E2M1_ROWS):
        rows = slice(r0, r0 + _E2M1_ROWS)
        srep = scale[rows].float().repeat_interleave(group_size, dim=1)[:, :K]
        srep = torch.where(srep.abs() < 1e-12, torch.full_like(srep, 1e-12),
                           srep)
        v = qdq[rows].float() / srep
        mag = torch.bucketize(v.abs(), mids, out_int32=True)  # mids < |v|
        codes[rows] = mag + 8 * ((v < 0) & (mag > 0))
    return codes


def w2_codes_from_qdq(qdq: torch.Tensor, scale: torch.Tensor,
                      group_size: int) -> torch.Tensor:
    """2-bit codes of a sym full-range qdq: clip(rint(qdq / scale) + 2, 0,
    3) in fp32 with |scale| < 1e-12 replaced by 1e-12, the JAX engine's
    recovery."""
    K = qdq.shape[1]
    srep = scale.float().repeat_interleave(group_size, dim=1)[:, :K]
    srep = torch.where(srep.abs() < 1e-12, torch.full_like(srep, 1e-12),
                       srep)
    return torch.clamp(torch.round(qdq.float() / srep) + 2, 0, 3).to(
        torch.int32)


def fp8_from_qdq(qdq: torch.Tensor, scale: torch.Tensor):
    """e4m3 bytes and (O,) scales of an FP8 qdq: qdq / s cast to
    float8_e4m3fn (round to nearest even, as the JAX engine's cast), with
    |s| < 1e-12 replaced by 1e-12; a per-tensor scale is repeated per
    row."""
    O = qdq.shape[0]
    sc = scale.float().reshape(-1)
    sc = sc.expand(O) if sc.numel() == 1 else sc.reshape(O, -1)[:, 0]
    sc = torch.where(sc.abs() < 1e-12, torch.full_like(sc, 1e-12), sc)
    return ((qdq.float() / sc[:, None]).to(torch.float8_e4m3fn),
            sc.contiguous())


def _packed_matmul(x: torch.Tensor, entry, kind: str,
                   a8_prompt: bool = False) -> torch.Tensor:
    """One packed projection through its kind's kernel; the group size
    follows from shapes.  With ``a8_prompt`` a ``w4a16`` entry of group
    size 128 runs the W4A8 kernel on the same words when the sequence is
    at least 256 long; the mode keys on the sequence length, not the token
    count, so a decode step stays exact A16 at any batch."""
    qw, scales = entry[0], entry[1]
    x = x.contiguous()
    if kind == "fp8":
        return fp8_matmul(x, qw, scales)
    if kind.startswith("mxfp4_g"):
        return mxfp4_matmul(x, qw, scales, int(kind[len("mxfp4_g"):]))
    if kind == "w2a16":
        return w2a16_matmul(x, qw, scales,
                            (qw.shape[1] * 16) // scales.shape[1])
    if kind == "w8a8":
        return w8a8_matmul(x, qw, scales)
    if kind == "w8a16":
        ncols = scales.shape[1]
        return w8a16_matmul(x, qw, scales,
                            0 if ncols == 1 else qw.shape[1] // ncols)
    group_size = (qw.shape[1] * PLANES) // scales.shape[1]
    if kind == "w4a16_asym":
        return w4a16_asym_matmul(x, qw, scales, entry[2], group_size)
    seq = x.shape[-2] if x.ndim >= 3 else x.numel() // x.shape[-1]
    if kind == "w4a8" or (a8_prompt and kind == "w4a16" and group_size == 128
                          and seq >= _A8_PROMPT_SEQ):
        return w4a8_matmul(x, qw, scales, group_size)
    return w4a16_matmul(x, qw, scales, group_size)


def _make_linear_fn(packed, kinds, block_idx: int, a8_prompt: bool = False):
    """The block's linear interceptor: packed layers go to their kernel,
    the rest to a dense product.  ``lf.grouped(wname, x_slabs)`` runs the
    block's stacked experts on (E, C, K) slabs; ``lf.grouped_names`` says
    which projections are stacked."""
    def lf(name, x, w, b=None):
        key = f"blocks.{block_idx}.{name}"
        entry = packed.get(key)
        y = (_packed_matmul(x, entry, kinds[key], a8_prompt)
             if entry is not None else torch.einsum("...i,oi->...o", x, w))
        return y if b is None else y + b

    prefix = f"blocks.{block_idx}.experts_stack."

    def grouped(wname, x_slabs):
        qw, sc = packed[prefix + wname]
        g = (qw.shape[2] * PLANES) // sc.shape[2]
        return w4a16_matmul_grouped(x_slabs, qw, sc, g)

    lf.grouped = grouped
    lf.grouped_names = frozenset(k[len(prefix):] for k in packed
                                 if k.startswith(prefix))
    return lf


def _fused_call(packed, kinds, splits, block_idx: int, fused_name: str, x,
                a8_prompt: bool = False):
    """Member outputs of a fused projection group, or None."""
    key = f"blocks.{block_idx}.{fused_name}"
    entry = packed.get(key)
    if entry is None:
        return None
    y = _packed_matmul(x, entry, kinds[key], a8_prompt)
    return list(torch.split(y, splits[key], dim=-1))


def _final_fwd_packed(params, packed, kinds, x, cfg):
    """Final norm + lm_head, through the packed kernel when the head was
    quantized (at 128K vocab the head is the largest weight of a step)."""
    entry = packed.get("lm_head")
    if entry is None:
        return llama.final_fwd(params, x, cfg)
    h = llama.rms_norm(x, params["norm"], cfg.rms_eps, cfg.norm_offset)
    return llama._final_softcap(_packed_matmul(h, entry, kinds["lm_head"]),
                                cfg)


def _block_with_cache(weights, x, cos, sin, cfg, kv, pos, lf, packed, kinds,
                      block_idx, splits, moe_capacity_factor: float = 0.0,
                      a8_prompt: bool = False):
    """Decoder block returning (out, k_new, v_new), the JAX engine's
    ``_block_with_cache`` (``engine.py:1179-1385``) for the Llama and
    Mixtral families: q/k/v biases after the fused qkv product, qk-norm,
    sandwich norms, the MLP's activation, and on a sliding layer the
    window (the sliding mask at prefill, the decode kernel's ``window`` or
    the dense cache's mask at decode).  A block that holds ``experts``
    runs the Mixtral routed MLP through ``lf``.

    ``kv`` None: prompt pass (causal attention over the prompt; ``pos``
    None).  At decode ``pos`` is the (B,) int32 position vector on the
    device: slot b writes its token at ``pos[b]`` and attends over [0,
    pos[b]] (the JAX engine's per-slot form, ``engine.py:1266-1269``,
    ``:1299-1313``; a scalar position there is the case of equal entries).
    ``kv = ("int8_cache", k_all, v_all, k_scale, v_scale)``: decode over
    the int8 cache — the new token is quantized and written in place, then
    the decode kernel attends.
    ``kv = (k_all, v_all)``: decode over a dense cache (plain math); the
    token is written unquantized (cast to the cache's dtype), which for
    the fp8 cache's dequantized copy is the JAX engine's order."""
    B, S, H = x.shape
    hd = cfg.hd
    off = cfg.norm_offset
    h = llama.rms_norm(x, weights["input_layernorm"], cfg.rms_eps, off)
    fused = _fused_call(packed, kinds, splits, block_idx, "qkv", h,
                        a8_prompt)
    if fused is not None:
        q, k, v = fused
        if weights.get("q_bias") is not None:
            q = q + weights["q_bias"]
            k = k + weights["k_bias"]
            v = v + weights["v_bias"]
    else:
        q = lf("q_proj", h, weights["q_proj"], weights.get("q_bias"))
        k = lf("k_proj", h, weights["k_proj"], weights.get("k_bias"))
        v = lf("v_proj", h, weights["v_proj"], weights.get("v_bias"))
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = llama.rms_norm(q, weights["q_norm"], cfg.rms_eps, off)
        k = llama.rms_norm(k, weights["k_norm"], cfg.rms_eps, off)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)

    # a Python constant per layer: a captured step bakes in no tensor
    window = (cfg.sliding_window if llama.layer_is_sliding(cfg, block_idx)
              else None)
    if kv is None:
        mask = (llama.sliding_mask(cfg, S, x.device)
                if window is not None and S > window else None)
        attn = llama.attention(q, k, v, mask, cfg)
    elif isinstance(kv[0], str):               # the "int8_cache" tuple
        _, k_all, v_all, ks, vs = kv           # int8 (B, T, n_kv, hd)
        slots = torch.arange(B, device=x.device)
        k_all[slots, pos] = _kv_quantize(k[:, 0], ks[0], "int8")
        v_all[slots, pos] = _kv_quantize(v[:, 0], vs[0], "int8")
        sm = 1.0 / (cfg.attn_scale if cfg.attn_scale is not None
                    else math.sqrt(hd))
        attn = decode_attention(q[:, 0].contiguous(), k_all, v_all, pos,
                                ks.reshape(-1), vs.reshape(-1), sm,
                                softcap=cfg.attn_logit_softcap or 0.0,
                                window=window)[:, None]
    else:
        k_all, v_all = kv                      # (B, T, n_kv, hd)
        slots = torch.arange(B, device=x.device)
        k_all[slots, pos] = k[:, 0].to(k_all.dtype)
        v_all[slots, pos] = v[:, 0].to(v_all.dtype)
        idx = torch.arange(k_all.shape[1], device=x.device)
        valid = idx[None, :] <= pos[:, None]
        if window is not None:
            valid = valid & (idx[None, :] > pos[:, None] - window)
        bias = torch.where(valid, 0.0, -1e30)[:, None, None, :]
        attn = llama.attention(q, k_all, v_all, bias, cfg)
    attn_out = lf("o_proj", attn.reshape(B, S, -1), weights["o_proj"],
                  weights.get("o_bias"))
    x, h = llama._post_attention(weights, x, attn_out, cfg)
    if "experts" in weights:
        mlp_out = mixtral._moe_mlp(weights, h, cfg, lf,
                                   capacity_factor=moe_capacity_factor)
    else:
        act = llama._act(cfg.hidden_act)
        fused_gu = _fused_call(packed, kinds, splits, block_idx, "gate_up",
                               h, a8_prompt)
        if fused_gu is not None:
            gate, up = act(fused_gu[0]), fused_gu[1]
        else:
            gate = act(lf("gate_proj", h, weights["gate_proj"]))
            up = lf("up_proj", h, weights["up_proj"])
        mlp_out = lf("down_proj", gate * up, weights["down_proj"])
    return llama._residual_mlp(weights, x, mlp_out, cfg), k, v


def _prefill_core(params, packed, kinds, splits, input_ids, *, cfg, max_seq,
                  kv_quant, moe_capacity_factor, a8_prompt=False,
                  cache: Optional[KVCache] = None):
    """Prompt pass: fill the cache (int8 / fp8: per-(layer, head) scales
    calibrated on the prompt as max(amax over (B, S, hd), 1e-6) / qmax) and
    return the last position's logits.  ``a8_prompt`` reaches the blocks'
    projections only: the lm_head stays exact, as in the JAX engine.
    ``cache`` (the static buffers of ``generate_scan``) is filled in place,
    its ``pos`` included; by default a new one is made."""
    B, S = input_ids.shape
    if S > max_seq:
        raise ValueError(f"prompt length {S} exceeds max_seq {max_seq}")
    if cache is None:
        cache = _init_cache(cfg, B, max_seq, cfg.num_layers, kv_quant,
                            input_ids.device)
    x = llama.embed_fwd(params, input_ids, cfg)
    tables = llama.dual_rope_tables(cfg, S, device=x.device)
    k_scales, v_scales = [], []
    for i in range(cfg.num_layers):
        cos, sin = tables[llama.layer_is_sliding(cfg, i)]
        x, k_new, v_new = _block_with_cache(
            params["blocks"][i], x, cos, sin, cfg, None, None,
            _make_linear_fn(packed, kinds, i, a8_prompt), packed, kinds, i,
            splits, moe_capacity_factor, a8_prompt)
        if kv_quant is not None:
            qmax = _KV_QMAX[kv_quant]
            ks = torch.clamp(k_new.float().abs().amax(dim=(0, 1, 3),
                                                      keepdim=True),
                             min=1e-6) / qmax          # (1, 1, n_kv, 1)
            vs = torch.clamp(v_new.float().abs().amax(dim=(0, 1, 3),
                                                      keepdim=True),
                             min=1e-6) / qmax
            k_scales.append(ks)
            v_scales.append(vs)
            k_new = _kv_quantize(k_new, ks, kv_quant)
            v_new = _kv_quantize(v_new, vs, kv_quant)
        cache.k[i, :, :S] = k_new.to(cache.k.dtype)
        cache.v[i, :, :S] = v_new.to(cache.v.dtype)
    if kv_quant is not None:
        cache.k_scale.copy_(torch.stack(k_scales))
        cache.v_scale.copy_(torch.stack(v_scales))
    cache.pos.fill_(S)
    cache = cache._replace(length=S)
    logits = _final_fwd_packed(params, packed, kinds, x[:, -1:], cfg)
    return logits[:, 0], cache


def _decode_core(params, packed, kinds, splits, token, k, v, pos, *, cfg,
                 kv_quant, moe_capacity_factor, k_scale=None, v_scale=None):
    """One decode step for the whole batch, slot b at position ``pos[b]``
    (``pos`` (B,) int32 on the device); returns the logits (B, V).  The
    cache ``k``, ``v`` (L, B, T, n_kv, hd), with its scales when
    quantized, is written in place.  Nothing here reads a host value that
    changes between steps, so a CUDA graph can capture the step.

    The fp8 cache is dequantized layer by layer into ``cfg.dtype`` and
    attended by the plain masked attention, with the step's own K/V written
    unquantized into that copy; they are quantized only when stored (the
    JAX engine's ``_decode_core``).  The int8 cache's step attends to its
    quantized token, through the decode kernel."""
    x = llama.embed_fwd(params, token[:, None], cfg)
    # both table pairs from the device positions: (B, 1, rd), a row a slot
    tables = [(c[:, None], s[:, None])
              for c, s in llama.dual_rope_tables(cfg, 1, positions=pos)]
    slots = torch.arange(x.shape[0], device=x.device)
    for i in range(cfg.num_layers):
        cos, sin = tables[llama.layer_is_sliding(cfg, i)]
        if kv_quant is None:
            kv = (k[i], v[i])
        elif kv_quant == "int8":
            kv = ("int8_cache", k[i], v[i], k_scale[i], v_scale[i])
        else:
            kv = (_kv_dequantize(k[i], k_scale[i], cfg.dtype),
                  _kv_dequantize(v[i], v_scale[i], cfg.dtype))
        x, k_new, v_new = _block_with_cache(
            params["blocks"][i], x, cos, sin, cfg, kv, pos,
            _make_linear_fn(packed, kinds, i), packed, kinds, i, splits,
            moe_capacity_factor)
        if kv_quant == "fp8":
            k[i][slots, pos] = _kv_quantize(k_new[:, 0], k_scale[i][0], "fp8")
            v[i][slots, pos] = _kv_quantize(v_new[:, 0], v_scale[i][0], "fp8")
    logits = _final_fwd_packed(params, packed, kinds, x, cfg)
    return logits[:, 0]


class _StepReplay:
    """A step on static buffers, run ``n`` times by :meth:`run`.

    On the card the first run's first step is eager: it loads every kernel
    library and runs every first-call set-up (shared-memory attributes)
    before capture.  The next step is captured as a CUDA graph on a side
    stream and every later step replays it; each launch counter moves by
    its increase over the capture times the replays (a wrapper's count is
    Python, so only the capture ran it).  ``generator`` (a sampler's) is
    registered with the graph, so each replay advances it as an eager step
    does.  A failed capture or replay raises.  On the CPU every step runs
    eagerly.  ``capture_ms`` is the host time of the capture alone (the
    graph's instantiation included)."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.generator = generator
        self.graph = None
        self.deltas: Tuple[Tuple[Any, int], ...] = ()
        self.capture_ms = 0.0

    def run(self, n: int) -> None:
        if self.device.type != "cuda":
            for _ in range(n):
                self.fn()
            return
        if n > 0 and self.graph is None:
            self._capture()                 # one eager step, then capture
            n -= 1
        for _ in range(n):
            self.graph.replay()
        for fn, d in self.deltas:
            fn.launches += d * n

    def _capture(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        counters = list(COUNTED)
        with torch.cuda.stream(side):
            self.fn()
            before = [c.launches for c in counters]
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=side):
                self.fn()
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        main.wait_stream(side)
        self.deltas = tuple((c, c.launches - b)
                            for c, b in zip(counters, before)
                            if c.launches != b)
        for c, b in zip(counters, before):
            c.launches = b
        self.graph = graph


@dataclass(eq=False)
class _ScanState:
    """The static buffers of ``generate_scan`` for one batch size."""

    cache: KVCache       # its ``pos``: the position the next token takes
    tok: torch.Tensor    # (B,) int32: the token the next step embeds
    step: torch.Tensor   # (1,) int64: the column of ``out`` it fills
    out: torch.Tensor    # (B, max_seq) int32: the generated tokens


@dataclass(eq=False)
class QuantizedLlama:
    """Serving-side model: packed quantized layers + dense residue.

    Build with :meth:`from_quantize_result`, :meth:`from_pretrained` (an
    ``autoround`` export) or :meth:`from_gptq` / :meth:`from_awq` and run
    :meth:`prefill` /
    :meth:`decode_step` / :meth:`generate`, or :meth:`generate_scan` (the
    decode loop as a replayed CUDA graph)."""

    cfg: llama.LlamaConfig
    params: Dict[str, Any]                 # non-packed leaves
    # name -> (qweight, scales) or, for w4a16_asym, (qweight, scales, zps);
    # qweight is packed int4 words (E2M1 codes for mxfp4), packed int2 words
    # (w2a16), int8 codes (w8a8, w8a16) or e4m3 bytes (fp8); the w8a8 and
    # fp8 scales are (O,), all others (O, columns)
    packed: Dict[str, Tuple[torch.Tensor, ...]]
    max_seq: int = 2048
    kv_quant: Optional[str] = None         # None | "int8" | "fp8"
    fused_splits: Optional[Dict[str, Tuple[int, ...]]] = None
    device: Optional[torch.device] = None
    # kernel kind per packed entry: "w4a16" | "w4a16_asym" | "w4a16_grouped"
    # | "w4a8" | "w8a8" | "w8a16" | "w2a16" | "fp8" | "mxfp4_g16" |
    # "mxfp4_g32" (None: every entry is w4a16)
    packed_kinds: Optional[Dict[str, str]] = None
    # opt-in: prompt passes run the W4A16 projections of the blocks on the
    # int8 kernel with per-token int8 activations; decode stays exact A16.
    # Changes prompt numerics.
    prefill_a8: bool = False
    # MoE routing: 0 = dense-then-mask (exact; every expert runs every
    # token); > 0 = capacity dispatch, each expert runs C = ceil(N * top_k
    # / E * factor) tokens and slots beyond C drop
    moe_capacity_factor: float = 0.0
    # generate_scan's static buffers per batch size, and its steps per
    # (batch, kv_quant, sampling, prefill_a8); not copied by
    # dataclasses.replace, so a changed engine captures its own
    _scan_states: Dict[int, _ScanState] = field(
        init=False, repr=False, default_factory=dict)
    _scan_steps: Dict[Tuple, _StepReplay] = field(
        init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        _check_kv_quant(self.kv_quant)
        if self.packed_kinds is None:
            self.packed_kinds = {k: "w4a16" for k in self.packed}

    @property
    def captures(self) -> int:
        """CUDA graphs this engine has captured (0 on the CPU)."""
        return sum(s.graph is not None for s in self._scan_steps.values())

    @classmethod
    def from_quantize_result(cls, result: QuantizeResult,
                             cfg: llama.LlamaConfig, max_seq: int = 2048,
                             kv_quant: Optional[str] = None,
                             device=None, moe_capacity_factor: float = 0.0,
                             serve_a8: bool = False) -> "QuantizedLlama":
        """Derive the codes from each layer's qdq, scale and zero point
        (exactly the JAX engine's codes and e4m3 bytes), pack them in the
        port's layout, stack the experts of MoE blocks and fuse q/k/v and
        gate/up.  Layers whose scheme has no packed path or whose shapes the
        kernel cannot take serve their dense qdq weights (as in the JAX
        engine).

        ``serve_a8=True`` (opt-in) serves W4A16 layers of group size 128
        through the W4A8 kernel with per-token int8 activations: it changes
        serving numerics.  The JAX engine's further shape gates (O and K
        multiples of 256, K % (16 g) for w2a16, K % 1024 for mxfp4) are its
        TPU tiles'; the kernels here need K % 32 == 0, K % g == 0 and
        g % 32 == 0 (w4a16 and w4a16_asym: g % 16 == 0; mxfp4: g in {16,
        32}; per channel: g = K) and take any O."""
        _check_kv_quant(kv_quant)
        dev = resolve_device(device)
        params = dict(result.params)
        params["blocks"] = list(result.params["blocks"])
        packed: Dict[str, Tuple[torch.Tensor, ...]] = {}
        kinds: Dict[str, str] = {}
        dense = 0
        for name, ql in result.layers.items():
            s = ql.scheme
            kind = _serving_kind(s)
            O, K = ql.qdq.shape
            g = s.group_size if isinstance(s.group_size, int) else 0
            if serve_a8 and kind == "w4a16" and g == 128:
                kind = "w4a8"
            if kind in ("w8a8", "w8a16", "fp8") and g <= 0:
                tileable = K % 32 == 0                # per channel
            else:
                # a 4-bit group that is not a multiple of 16 (24, 40, ...)
                # serves dense (ROADMAP C)
                tileable = w4_tileable(K, g, W4_G_MULTIPLE if kind in (
                    "w4a16", "w4a16_asym", "mxfp4_g16", "mxfp4_g32")
                    else 32)
            if (kind is None or not tileable
                    or (kind == "w4a16_asym" and ql.zp is None)):
                dense += 1
                continue
            scale = ql.scale.to(device=dev, dtype=torch.float32).contiguous()
            if kind == "w4a16_asym":
                zp = ql.zp.to(device=dev, dtype=torch.float32).contiguous()
                packed[name] = (pack_w4(w4_asym_codes_from_qdq(
                    ql.qdq.to(dev), scale, zp, g)), scale, zp)
            elif kind == "w8a16":
                scale = scale.reshape(O, -1)
                packed[name] = (w8_codes_from_qdq(ql.qdq.to(dev), scale),
                                scale)
            elif kind == "w8a8":
                # one signed scale per output channel, (O,)
                sc = scale.reshape(O, -1)[:, :1]
                sc = torch.where(sc.abs() < 1e-12,
                                 torch.full_like(sc, 1e-12), sc)
                packed[name] = (w8_codes_from_qdq(ql.qdq.to(dev), sc),
                                sc[:, 0].contiguous())
            elif kind == "fp8":
                packed[name] = fp8_from_qdq(ql.qdq.to(dev), scale)
            elif kind == "w2a16":
                packed[name] = (pack_w2(w2_codes_from_qdq(
                    ql.qdq.to(dev), scale, g)), scale)
            elif kind in ("mxfp4_g16", "mxfp4_g32"):
                # the scale holds the MX power of two, or NVFP4's e4m3
                # group scale over the global scale
                scale = scale.reshape(O, -1)
                packed[name] = (pack_w4(e2m1_codes_from_qdq(
                    ql.qdq.to(dev), scale, g)), scale)
            else:
                packed[name] = (pack_w4(w4_codes_from_qdq(
                    ql.qdq.to(dev), scale, g)), scale)
            kinds[name] = kind
            # drop the dense copy (dotted paths reach MoE expert leaves)
            parts = name.split(".", 2)
            if parts[0] == "blocks":
                bi = int(parts[1])
                params["blocks"][bi] = set_by_path(params["blocks"][bi],
                                                   parts[2], None)
            elif name == "lm_head" and params.get("lm_head") is not None:
                params["lm_head"] = None
        if dense:
            logger.warning("serving engine: %d quantized layer(s) serve as "
                           "dense qdq weights (no packed kernel)", dense)
        params = tree_map(lambda t: t.to(dev), params)
        packed, kinds = _stack_experts(packed, kinds, cfg)
        fused, splits, kinds = _fuse_packed(packed, cfg, kinds)
        return cls(cfg=cfg, params=params, packed=fused, max_seq=max_seq,
                   kv_quant=kv_quant, fused_splits=splits, device=dev,
                   packed_kinds=kinds,
                   moe_capacity_factor=moe_capacity_factor)

    @classmethod
    def from_pretrained(cls, path: str, max_seq: int = 2048,
                        kv_quant: Optional[str] = None, device=None,
                        moe_capacity_factor: float = 0.0
                        ) -> "QuantizedLlama":
        """Load an ``autoround``-format export directory (the port's or
        the JAX package's: the files are the same) onto ``device``.

        ``cfg`` comes from ``quantization_config.json``'s ``model_config``
        and its dtype from ``embed_tokens``.  Each layer's words are
        unpacked on the device (``export.packing.unpack_quantized_torch``,
        ``unpack_quantized``'s twin); an int4 sym layer
        whose shape the W4A16 kernel takes (``w4_tileable``) packs in the
        port's layout and keeps no dense leaf, every other layer serves
        dense as ``(codes - zp) * scale`` in the model dtype.  The JAX
        engine packs only g >= 128 with K % (8 g) == 0 (its TPU tiles), so
        a g = 32 export packs here and serves dense there (ROADMAP C).  A
        ``fake`` export's qdq leaves load as they are, dense."""
        import json
        import os

        from ..export import _unflatten_params
        from ..export.packing import unpack_quantized_torch
        from ..utils.convert import config_from_jax
        from ..utils.safetensors_io import DTYPE_CODES, SafeOpen
        from .gptq_loader import _dense

        _check_kv_quant(kv_quant)
        dev = resolve_device(device)
        with open(os.path.join(path, "quantization_config.json")) as f:
            qcfg = json.load(f)
        cfg = config_from_jax(qcfg["model_config"])
        packed: Dict[str, Tuple[torch.Tensor, ...]] = {}
        kinds: Dict[str, str] = {}
        with SafeOpen(os.path.join(path, "model.safetensors"),
                       device=dev) as f:
            keys = set(f.keys())
            if "embed_tokens" in keys:
                cfg = dataclasses.replace(
                    cfg, dtype=DTYPE_CODES[f.dtype_code("embed_tokens")])
            flat = {k: f.get_tensor(k) for k in f.keys()
                    if not k.endswith((".qweight", ".qzeros", ".scales"))}
            for name, meta in qcfg["layers"].items():
                if f"{name}.qweight" not in keys:
                    continue          # a qdq leaf (fake format) is in flat
                payload = {s: f.get_tensor(f"{name}.{s}")
                           for s in ("qweight", "qzeros", "scales")}
                bits, g = meta["bits"], meta["group_size"]
                O = payload["qweight"].shape[1]
                I = payload["qweight"].shape[0] * 32 // bits
                codes, scales, zp = unpack_quantized_torch(payload, bits, O,
                                                           I)
                del payload
                if (meta["data_type"] == "int" and bits == 4 and meta["sym"]
                        and isinstance(g, int) and w4_tileable(I, g)):
                    packed[name] = (pack_w4(codes), scales)
                    kinds[name] = "w4a16"
                    flat[name] = None
                else:
                    gi = g if isinstance(g, int) and g > 0 else I
                    flat[name] = _dense(codes, scales, zp,
                                        torch.arange(I, device=dev) // gi,
                                        cfg.dtype)
        params = _unflatten_params(flat)
        logger.info("from_pretrained: %d packed layers, %d total quantized",
                    len(packed), len(qcfg["layers"]))
        packed, kinds = _stack_experts(packed, kinds, cfg)
        fused, splits, kinds = _fuse_packed(packed, cfg, kinds)
        return cls(cfg=cfg, params=params, packed=fused, max_seq=max_seq,
                   kv_quant=kv_quant, fused_splits=splits, device=dev,
                   packed_kinds=kinds,
                   moe_capacity_factor=moe_capacity_factor)

    @classmethod
    def from_gptq(cls, path: str, max_seq: int = 2048,
                  kv_quant: Optional[str] = None, device=None,
                  moe_capacity_factor: float = 0.0) -> "QuantizedLlama":
        """Load an HF-layout GPTQ or AWQ checkpoint (the CUDA ecosystem's
        formats) onto ``device``; the layout is read from its
        ``quantization_config`` (``serve/gptq_loader.py``)."""
        from .gptq_loader import load_quantized_checkpoint

        _check_kv_quant(kv_quant)
        dev = resolve_device(device)
        params, cfg, packed, kinds = load_quantized_checkpoint(path,
                                                               device=dev)
        fused, splits, kinds = _fuse_packed(packed, cfg, kinds)
        return cls(cfg=cfg, params=params, packed=fused, max_seq=max_seq,
                   kv_quant=kv_quant, fused_splits=splits, device=dev,
                   packed_kinds=kinds,
                   moe_capacity_factor=moe_capacity_factor)

    # AWQ checkpoints take the same loader, which reads the layout
    from_awq = from_gptq

    def _prefill(self, ids: torch.Tensor, cache: Optional[KVCache] = None
                 ) -> Tuple[torch.Tensor, KVCache]:
        return _prefill_core(self.params, self.packed, self.packed_kinds,
                             self.fused_splits, ids, cfg=self.cfg,
                             max_seq=self.max_seq, kv_quant=self.kv_quant,
                             moe_capacity_factor=self.moe_capacity_factor,
                             a8_prompt=self.prefill_a8, cache=cache)

    @torch.no_grad()
    def prefill(self, input_ids) -> Tuple[torch.Tensor, KVCache]:
        """Run the prompt (B, S), return (logits of the last position
        (B, V), cache)."""
        return self._prefill(torch.as_tensor(input_ids,
                                             device=self.device).long())

    def _decode(self, token: torch.Tensor, cache: KVCache) -> torch.Tensor:
        return _decode_core(self.params, self.packed, self.packed_kinds,
                            self.fused_splits, token, cache.k, cache.v,
                            cache.pos, cfg=self.cfg, kv_quant=self.kv_quant,
                            moe_capacity_factor=self.moe_capacity_factor,
                            k_scale=cache.k_scale, v_scale=cache.v_scale)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: KVCache
                    ) -> Tuple[torch.Tensor, KVCache]:
        """One token for the whole batch: token (B,) → (logits (B, V),
        cache).  The cache buffers are updated in place; each slot takes
        its position from ``cache.pos``."""
        T = cache.k.shape[2]
        if cache.length >= T:
            raise ValueError(f"KV cache full ({T} positions)")
        logits = self._decode(token.to(self.device), cache)
        return logits, cache._replace(length=cache.length + 1,
                                      pos=cache.pos + 1)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 sampling: Optional[SamplingParams] = None) -> torch.Tensor:
        """Greedy by default, temperature/top-k/top-p with a generator
        seeded from ``sampling.seed`` otherwise.  Returns (B,
        max_new_tokens) int32 token ids."""
        gen = None
        if sampling is not None and not sampling.is_greedy:
            gen = torch.Generator(device=self.device).manual_seed(
                sampling.seed)
        logits, cache = self.prefill(input_ids)
        tok = sample_token(logits, gen, sampling)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self.decode_step(tok, cache)
            tok = sample_token(logits, gen, sampling)
            out.append(tok)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def generate_scan(self, input_ids, max_new_tokens: int = 32,
                      sampling: Optional[SamplingParams] = None
                      ) -> torch.Tensor:
        """:meth:`generate` with the decode loop on the device (the JAX
        engine's ``generate_scan``, ``engine.py:851-886``): the same
        tokens, from the same kernels in the same order.

        The prompt pass runs eagerly (with ``prefill_a8``, on the int8
        kernel) into a cache this engine keeps for the batch size.  On the
        card the first decode step of the first call runs eagerly, the
        next is captured as a CUDA graph and the rest replay it, one replay
        a token, with one synchronisation at the end; a later call with the
        same (batch, kv_quant, sampling, prefill_a8) replays the same graph
        (``captures`` unchanged).  The sampler's generator, reseeded from
        ``sampling.seed`` each call, advances under replay as in
        ``generate``.  Returns (B, max_new_tokens) int32 token ids."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        B, S = ids.shape
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        if S + max_new_tokens - 1 > self.max_seq:
            raise ValueError(
                f"prompt length {S} + max_new_tokens {max_new_tokens} - 1 "
                f"exceeds max_seq {self.max_seq}")
        st = self._scan_states.get(B)
        if st is None:
            st = _ScanState(
                cache=_init_cache(self.cfg, B, self.max_seq,
                                  self.cfg.num_layers, self.kv_quant,
                                  self.device),
                tok=torch.zeros((B,), dtype=torch.int32, device=self.device),
                step=torch.zeros((1,), dtype=torch.int64, device=self.device),
                out=torch.zeros((B, self.max_seq), dtype=torch.int32,
                                device=self.device))
            self._scan_states[B] = st
        greedy = sampling is None or sampling.is_greedy
        how = None if greedy else (sampling.temperature, sampling.top_k,
                                   sampling.top_p)
        key = (B, self.kv_quant, how, self.prefill_a8)
        step = self._scan_steps.get(key)
        if step is None:
            gen = None if greedy else torch.Generator(device=self.device)

            def one_step():
                logits = self._decode(st.tok, st.cache)
                tok = sample_token(logits, gen, sampling)
                st.tok.copy_(tok)
                st.out.index_copy_(1, st.step, tok[:, None])
                st.cache.pos.add_(1)
                st.step.add_(1)

            step = self._scan_steps[key] = _StepReplay(one_step, self.device,
                                                       gen)
        if step.generator is not None:
            step.generator.manual_seed(sampling.seed)
        logits, _ = self._prefill(ids, cache=st.cache)
        tok = sample_token(logits, step.generator, sampling)
        st.tok.copy_(tok)
        st.out[:, 0] = tok
        st.step.fill_(1)
        step.run(max_new_tokens - 1)
        out = st.out[:, :max_new_tokens].clone()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out
