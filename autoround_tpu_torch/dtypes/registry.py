"""Fake-quant function registry (counterpart of
``autoround_tpu/dtypes/registry.py``): the int, GGUF double-quant
(``int_dq``), MX, NVFP4, fp4_v2, FP8, W4FP8 and float-zero-point entries
in the ``tuned``, ``rtn`` and ``opt_rtn`` modes, under the JAX package's
names.  :func:`register_dtype` adds one.

Every registered function has the uniform signature::

    fn(w, *, bits, group_size, v=None, min_scale=None, max_scale=None,
       **extras) -> QdqResult

``recip=True`` among the extras asks the float types to divide by their
constants as the JAX package's jitted tuning loss does (``fp8.div_const``).
"""

from __future__ import annotations

from typing import Callable, Dict

from . import extra, fp8, gguf, intq, mxfp, nvfp

__all__ = ["QUANT_FUNCS", "register_dtype", "get_quant_func"]

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


def _reg(name: str, fn: Callable) -> None:
    QUANT_FUNCS[name] = fn


def register_dtype(name: str):
    """Decorator: register ``fn`` under ``name``."""
    def deco(fn):
        QUANT_FUNCS[name] = fn
        return fn
    return deco


# --- mx ---
_MX_NAMES = ("mx_fp4", "mx_fp6_e2m3", "mx_fp6_e3m2", "mx_fp8", "mx_fp8_e5m2",
             "mx_int2", "mx_int4", "mx_int8")
_MX_FP_BY_BITS = {4: "mx_fp4", 6: "mx_fp6_e2m3", 8: "mx_fp8"}


def _mx(name, default_rounding, tuned=True):
    def fn(w, bits, group_size, **kw):
        dt = name(bits) if callable(name) else name
        return mxfp.qdq_mx(
            w, data_type=dt, group_size=group_size,
            v=kw.get("v") if tuned else None,
            max_scale=kw.get("max_scale") if tuned else None,
            rounding=kw.get("rounding", default_rounding),
            divisor=kw.get("divisor"), recip=kw.get("recip", False))
    return fn


def _opt_mx(name):
    def fn(w, bits, group_size, **kw):
        dt = name(bits) if callable(name) else name
        return mxfp.opt_rtn_mx(w, data_type=dt, group_size=group_size,
                               imatrix=kw.get("imatrix"))
    return fn


for _name in _MX_NAMES:
    _reg(_name, _mx(_name, "floor"))
    _reg("rtn_" + _name, _mx(_name, "rceil"))
    _reg("opt_rtn_" + _name, _opt_mx(_name))
# generic names resolved by bits: "mx_fp" + bits, "mx_int" + bits
_reg("mx_fp", _mx(_MX_FP_BY_BITS.__getitem__, "floor"))
_reg("rtn_mx_fp", _mx(_MX_FP_BY_BITS.__getitem__, "rceil", tuned=False))
_reg("opt_rtn_mx_fp", _opt_mx(_MX_FP_BY_BITS.__getitem__))
_reg("opt_rtn_mx_int", _opt_mx(lambda b: f"mx_int{b}"))


def _mx_int(tuned):
    def fn(w, bits, group_size, **kw):
        return mxfp.qdq_mx(
            w, data_type=f"mx_int{bits}", group_size=group_size,
            v=kw.get("v") if tuned else None,
            max_scale=kw.get("max_scale") if tuned else None,
            rounding="floor")
    return fn


_reg("mx_int", _mx_int(True))
_reg("rtn_mx_int", _mx_int(False))

# --- nvfp ---
_reg("nv_fp", lambda w, bits, group_size, **kw: nvfp.qdq_nvfp4(
    w, group_size=group_size, v=kw.get("v"), max_scale=kw.get("max_scale"),
    global_scale=kw.get("global_scale"), recip=kw.get("recip", False)))
_reg("nv_fp4", QUANT_FUNCS["nv_fp"])
_reg("nv_fp4_with_static_gs", QUANT_FUNCS["nv_fp"])
_reg("rtn_nv_fp", lambda w, bits, group_size, **kw: nvfp.rtn_nvfp4(
    w, group_size=group_size, global_scale=kw.get("global_scale"),
    recip=kw.get("recip", False)))
_reg("rtn_nv_fp4", QUANT_FUNCS["rtn_nv_fp"])


# fp4_v2: E2M1 elements with unsigned E5M3 group scales
def _fp4_v2(tuned, use_global_scale):
    def fn(w, bits, group_size, **kw):
        return nvfp.qdq_fp4_v2(
            w, group_size=group_size, v=kw.get("v") if tuned else None,
            max_scale=kw.get("max_scale") if tuned else None,
            global_scale=kw.get("global_scale"),
            use_global_scale=use_global_scale)
    return fn


_reg("fp4_v2", _fp4_v2(True, False))
_reg("rtn_fp4_v2", _fp4_v2(False, False))
_reg("fp4_v2_with_global_scale", _fp4_v2(True, True))
_reg("rtn_fp4_v2_with_global_scale", _fp4_v2(False, True))

# --- fp8 ---
_reg("fp8", lambda w, bits, group_size, **kw: (
    fp8.qdq_fp8_block(w, block=group_size, recip=kw.get("recip", False))
    if isinstance(group_size, tuple)
    else fp8.qdq_fp8_sym(w, group_size=group_size,
                         max_scale=kw.get("max_scale"), scale=kw.get("scale"),
                         recip=kw.get("recip", False))))
_reg("fp8_sym", QUANT_FUNCS["fp8"])
_reg("rtn_fp8", QUANT_FUNCS["fp8"])
_reg("fp8_e5m2", lambda w, bits, group_size, **kw: fp8.qdq_fp8_sym(
    w, group_size=group_size, fp8_format="e5m2",
    recip=kw.get("recip", False)))
_reg("block_fp8", lambda w, bits, group_size, **kw: fp8.qdq_fp8_block(
    w, block=group_size if isinstance(group_size, tuple) else (128, 128),
    recip=kw.get("recip", False)))


# --- gguf double-quant (k-quants) ---
def _dq_kw(kw):
    """The keywords the JAX package's double-quant entries pass on (a
    frozen grid among the extras is not one of them), and ``recip``."""
    return {k: v for k, v in kw.items()
            if k in ("v", "min_scale", "max_scale", "super_bits",
                     "super_group_size", "imatrix", "clip_lo", "clip_hi",
                     "recip")
            and v is not None}


_reg("int_sym_dq", lambda w, bits, group_size, **kw: gguf.qdq_int_dq_sym(
    w, bits, group_size, **_dq_kw(kw)))
_reg("int_asym_dq", lambda w, bits, group_size, **kw: gguf.qdq_int_dq_asym(
    w, bits, group_size, **_dq_kw(kw)))
_reg("rtn_int_sym_dq", lambda w, bits, group_size, **kw: gguf.rtn_int_dq_sym(
    w, bits, group_size, **_dq_kw(kw)))
_reg("rtn_int_asym_dq", lambda w, bits, group_size, **kw: gguf.rtn_int_dq_asym(
    w, bits, group_size, **_dq_kw(kw)))
_reg("opt_rtn_int_sym_dq", QUANT_FUNCS["rtn_int_sym_dq"])
_reg("opt_rtn_int_asym_dq", QUANT_FUNCS["rtn_int_asym_dq"])
# aliases for the resolver's "{data_type}_{sym}" probe of data_type "int_dq"
_reg("int_dq_sym", QUANT_FUNCS["int_sym_dq"])
_reg("int_dq_asym", QUANT_FUNCS["int_asym_dq"])
_reg("rtn_int_dq_sym", QUANT_FUNCS["rtn_int_sym_dq"])
_reg("rtn_int_dq_asym", QUANT_FUNCS["rtn_int_asym_dq"])
_reg("opt_rtn_int_dq_sym", QUANT_FUNCS["rtn_int_sym_dq"])
_reg("opt_rtn_int_dq_asym", QUANT_FUNCS["rtn_int_asym_dq"])

# --- w4fp8 and the float zero point ---
_reg("w4fp8", lambda w, bits, group_size, **kw: extra.qdq_w4fp8(
    w, bits, group_size, v=kw.get("v"), min_scale=kw.get("min_scale"),
    max_scale=kw.get("max_scale"), recip=kw.get("recip", False)))
_reg("rtn_w4fp8", lambda w, bits, group_size, **kw: extra.qdq_w4fp8(
    w, bits, group_size, recip=kw.get("recip", False)))
_reg("int_asym_float_zp", lambda w, bits, group_size, **kw:
     extra.qdq_int_asym_float_zp(
         w, bits, group_size, v=kw.get("v"), min_scale=kw.get("min_scale"),
         max_scale=kw.get("max_scale"), clip_lo=kw.get("clip_lo", 0.0),
         clip_hi=kw.get("clip_hi", 1.0), recip=kw.get("recip", False)))
_reg("rtn_int_asym_float_zp", lambda w, bits, group_size, **kw:
     extra.qdq_int_asym_float_zp(w, bits, group_size,
                                 recip=kw.get("recip", False)))


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
        f"mode={mode!r}; the port registers {sorted(QUANT_FUNCS)}")
