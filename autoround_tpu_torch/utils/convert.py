"""Carry weights and configs from the JAX package into the port.

``params_from_jax`` takes the JAX parameter tree with its leaves already
converted to numpy arrays (``jax.tree.map(np.asarray, params)``) and
``config_from_jax`` the JAX ``LlamaConfig``'s or ``MixtralConfig``'s fields
as a dict
(``dataclasses.asdict(cfg)``), so this module needs neither JAX nor the
JAX package: both sides then compute on the same weights.
``tune_params_from_jax`` carries a tuned state the same way, and
``quantize_result_to_numpy`` goes the other way: a port result as the numpy
tree the JAX package's results can be compared with.
``packed_from_jax`` turns one packed payload of the JAX serving engine
(numpy) into the port's, for every kind of the JAX engine but the stacked
experts.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .._device import resolve_device
from ..models.llama import UNSUPPORTED_FIELDS, LlamaConfig
from ..models.mixtral import MixtralConfig
from ..ops.qmatmul import pack_w4
from ..ops.qmatmul_ext import pack_w2

__all__ = ["params_from_jax", "config_from_jax", "tune_params_from_jax",
           "quantize_result_to_numpy", "unpack_w4_bytes", "unpack_planes",
           "packed_from_jax"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _torch_dtype(dt) -> torch.dtype:
    name = np.dtype(dt).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported parameter dtype {dt!r}")
    return _DTYPES[name]


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Any, cfg: LlamaConfig, device=None) -> Any:
    """Numpy parameter tree (dicts / lists of arrays, as the JAX package
    lays it out) → the same tree of tensors on ``device``, in ``cfg``'s
    dtype for floating leaves."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        if node is None:
            return None
        t = _leaf(node, dev)
        return t.to(cfg.dtype) if t.is_floating_point() else t

    return rec(tree)


# the ROADMAP item each unported config flag waits for
_UNPORTED_ITEM = {"chunked_attention": "A11, models/llama4.py",
                  "online_r4": "A12, transforms/hadamard.py"}


def config_from_jax(fields: Mapping[str, Any]) -> LlamaConfig:
    """JAX config fields → the port's config: a ``MixtralConfig`` when the
    fields hold ``num_experts``, else a ``LlamaConfig``; ``layer_types``
    and ``rope_llama3`` come back as tuples.  Raises
    ``NotImplementedError`` for a config that sets a flag the port does
    not implement (Llama4's chunked attention, online R4)."""
    cls = MixtralConfig if "num_experts" in fields else LlamaConfig
    known = cls.__dataclass_fields__
    for name, off in UNSUPPORTED_FIELDS.items():
        if fields.get(name, off) != off:
            raise NotImplementedError(
                f"{cls.__name__}.{name}={fields[name]!r} is not ported yet "
                f"(ROADMAP {_UNPORTED_ITEM[name]})")
    kw: Dict[str, Any] = {k: v for k, v in fields.items()
                          if k in known and k != "dtype"}
    for name in ("rope_llama3", "layer_types"):
        if kw.get(name) is not None:
            kw[name] = tuple(kw[name])
    if "dtype" in fields:
        kw["dtype"] = _torch_dtype(fields["dtype"])
    return cls(**kw)


def tune_params_from_jax(tree: Mapping[str, Mapping[str, Any]],
                         device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Numpy tuning state ``{layer: {v, min_scale, max_scale}}`` → the
    same tree of fp32 tensors on ``device``."""
    dev = resolve_device(device)
    return {name: {k: _leaf(a, dev).float() for k, a in layer.items()}
            for name, layer in tree.items()}


def quantize_result_to_numpy(result) -> Dict[str, Any]:
    """A port ``QuantizeResult`` as numpy: ``{"params": tree, "layers":
    {name: {qdq, scale, zp, act_scale}}, "loss_traces": {...}}``, floats
    widened to fp32 (exact from bf16)."""
    def arr(t):
        if t is None:
            return None
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def rec(node):
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return arr(node)

    return {"params": rec(result.params),
            "layers": {n: {"qdq": arr(q.qdq), "scale": arr(q.scale),
                           "zp": arr(q.zp), "act_scale": arr(q.act_scale),
                           "act_global_scale": arr(q.act_global_scale)}
                       for n, q in result.layers.items()},
            "loss_traces": dict(result.loss_traces)}


def unpack_w4_bytes(packed: np.ndarray) -> np.ndarray:
    """The JAX package's W4A8 byte pairs (O, K // 2) int8 → (O, K) int32
    codes in [0, 15]: in each tile of 2 x 128 columns, byte column c holds
    the first group's code in its low nibble and the second group's code
    XOR 8 in its high nibble."""
    O, Kb = packed.shape
    g = 128
    b = np.asarray(packed).astype(np.int32) & 0xFF
    lo = b & 0xF
    hi = ((b >> 4) & 0xF) ^ 8
    c = np.stack([lo.reshape(O, Kb // g, g), hi.reshape(O, Kb // g, g)],
                 axis=2)
    return c.reshape(O, 2 * Kb)


def unpack_planes(words: np.ndarray, bits: int,
                  group_size: int) -> np.ndarray:
    """The JAX package's bit-plane words (O, K * bits // 32) int32 → (O, K)
    int32 codes: in K-tile t of width (32 // bits) * g, column ``t * (32 //
    bits) * g + j * g + i`` sits in field j (of ``bits`` bits) of word ``t *
    g + i`` (``pack_w4_planes`` for 4 bits, ``pack_w2_planes`` for 2)."""
    planes = 32 // bits
    O, Kw = words.shape
    g = group_size
    w = np.asarray(words).astype(np.uint32).reshape(O, Kw // g, 1, g)
    shifts = (np.arange(planes, dtype=np.uint32) * bits)[None, None, :, None]
    codes = (w >> shifts) & ((1 << bits) - 1)
    return codes.reshape(O, Kw * planes).astype(np.int32)


def packed_from_jax(entry, kind: str, device=None):
    """One packed payload of the JAX engine (a tuple of numpy arrays) →
    the port's, on ``device``: ``w4a8`` byte pairs and the nibble planes of
    ``w4a16``, ``w4a16_asym`` and ``mxfp4`` become the packed words of
    ``pack_w4``, the ``w2a16`` planes those of ``pack_w2``; the int8 codes and the scales of ``w8a8`` and
    ``w8a16`` and the e4m3 bytes and scales of ``fp8`` cross as they are.
    The ``mxfp4_g*`` scales lose the JAX engine's lane padding, by the g of
    the kind (two paddings can give one column count: K = 2048 holds 128
    columns at g = 16 exact and at g = 32 padded)."""
    dev = resolve_device(device)
    if kind == "w4a8":
        codes = torch.from_numpy(unpack_w4_bytes(entry[0])).to(dev)
        return (pack_w4(codes), _leaf(entry[1], dev).float())
    if kind in ("w8a8", "w8a16"):
        return (_leaf(entry[0], dev).to(torch.int8),
                _leaf(entry[1], dev).float())
    if kind == "fp8":
        raw = np.array(entry[0]).view(np.uint8)    # a writable copy
        return (torch.from_numpy(raw).to(dev).view(torch.float8_e4m3fn),
                _leaf(entry[1], dev).float())
    if kind.startswith("mxfp4_g"):
        g = int(kind[len("mxfp4_g"):])
        codes = unpack_planes(entry[0], 4, 128)
        K = codes.shape[1]
        return (pack_w4(torch.from_numpy(codes).to(dev)),
                _leaf(np.asarray(entry[1])[:, :K // g], dev).float()
                .contiguous())
    if kind == "w2a16":
        scales = np.asarray(entry[1])
        K = entry[0].shape[1] * 16
        codes = unpack_planes(entry[0], 2, K // scales.shape[1])
        return (pack_w2(torch.from_numpy(codes).to(dev)),
                _leaf(scales, dev).float())
    if kind in ("w4a16", "w4a16_asym"):
        scales = np.asarray(entry[1])
        K = entry[0].shape[1] * 8
        codes = unpack_planes(entry[0], 4, K // scales.shape[1])
        return (pack_w4(torch.from_numpy(codes).to(dev)),
                _leaf(scales, dev).float()) + tuple(
                    _leaf(e, dev).float() for e in entry[2:])
    raise ValueError(f"unknown packed kind {kind!r}")
