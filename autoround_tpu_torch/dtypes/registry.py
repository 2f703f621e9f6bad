"""Fake-quant function registry (counterpart of
``autoround_tpu/dtypes/registry.py``), limited to the int entries in the
``tuned``, ``rtn`` and ``opt_rtn`` modes.  The other data types come with
later slices of the port.

Every registered function has the uniform signature::

    fn(w, *, bits, group_size, v=None, min_scale=None, max_scale=None,
       **extras) -> QdqResult
"""

from __future__ import annotations

from typing import Callable, Dict

from . import intq

__all__ = ["QUANT_FUNCS", "get_quant_func"]

QUANT_FUNCS: Dict[str, Callable] = {
    "int_sym": lambda w, bits, group_size, **kw: intq.qdq_int_sym(
        w, bits, group_size,
        v=kw.get("v"), min_scale=kw.get("min_scale"),
        max_scale=kw.get("max_scale"),
        clip_lo=kw.get("clip_lo", 0.0), clip_hi=kw.get("clip_hi", 1.0)),
    "int_asym": lambda w, bits, group_size, **kw: intq.qdq_int_asym(
        w, bits, group_size,
        v=kw.get("v"), min_scale=kw.get("min_scale"),
        max_scale=kw.get("max_scale"),
        clip_lo=kw.get("clip_lo", 0.0), clip_hi=kw.get("clip_hi", 1.0)),
    "rtn_int_sym": lambda w, bits, group_size, **kw: intq.rtn_int_sym(
        w, bits, group_size),
    "rtn_int_asym": lambda w, bits, group_size, **kw: intq.rtn_int_asym(
        w, bits, group_size),
    "opt_rtn_int_sym": lambda w, bits, group_size, **kw: intq.opt_rtn_int_sym(
        w, bits, group_size, imatrix=kw.get("imatrix")),
}


def get_quant_func(data_type: str, bits: int, sym: bool, mode: str = "tuned"):
    """Resolve (data_type, bits, sym, mode) → qdq callable, in the JAX
    package's probe order: exact mode-prefixed name first, then
    sym-suffixed, then bits-suffixed, then the tuned entry."""
    prefix = "" if mode == "tuned" else mode + "_"
    suffix = "_sym" if sym else "_asym"
    for name in (
        prefix + data_type + suffix,
        prefix + data_type + str(bits) + suffix,
        prefix + data_type,
        prefix + data_type + str(bits),
        data_type + suffix,
        data_type,
    ):
        if name in QUANT_FUNCS:
            return QUANT_FUNCS[name]
    raise KeyError(
        f"No quant func for data_type={data_type!r} bits={bits} sym={sym} "
        f"mode={mode!r}; this slice of the port registers "
        f"{sorted(QUANT_FUNCS)}")
