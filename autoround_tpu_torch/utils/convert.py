"""Carry weights and configs from the JAX package into the port.

``params_from_jax`` takes the JAX parameter tree with its leaves already
converted to numpy arrays (``jax.tree.map(np.asarray, params)``) and
``config_from_jax`` the JAX ``LlamaConfig``'s fields as a dict
(``dataclasses.asdict(cfg)``), so this module needs neither JAX nor the
JAX package: both sides then compute on the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .._device import resolve_device
from ..models.llama import UNSUPPORTED_FIELDS, LlamaConfig

__all__ = ["params_from_jax", "config_from_jax"]

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


def config_from_jax(fields: Mapping[str, Any]) -> LlamaConfig:
    """JAX ``LlamaConfig`` fields → the port's ``LlamaConfig``.  Raises
    ``NotImplementedError`` for a config that sets a flag this slice does
    not port (sliding windows, local rope, chunked attention, online R4)."""
    for name, off in UNSUPPORTED_FIELDS.items():
        if name in fields and fields[name] != off:
            raise NotImplementedError(
                f"LlamaConfig.{name}={fields[name]!r} is not ported yet")
    known = LlamaConfig.__dataclass_fields__
    kw: Dict[str, Any] = {k: v for k, v in fields.items()
                          if k in known and k != "dtype"}
    if kw.get("rope_llama3") is not None:
        kw["rope_llama3"] = tuple(kw["rope_llama3"])
    if "dtype" in fields:
        kw["dtype"] = _torch_dtype(fields["dtype"])
    return LlamaConfig(**kw)
