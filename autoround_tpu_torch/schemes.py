"""Quantization scheme system.

Own copy of ``autoround_tpu/schemes.py`` (pure Python, no JAX): the port
never imports the JAX package.  A scheme is a frozen, hashable description
of *how* a tensor family is quantized: weight bits / group size / symmetry
/ data type plus the activation-side equivalents and the double-quant
("super") fields used by GGUF k-quants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

__all__ = [
    "QuantizationScheme",
    "PRESET_SCHEMES",
    "parse_scheme",
    "is_mx_fp",
    "is_nv_fp",
    "is_fp8",
    "is_gguf",
    "is_int",
    "is_float",
]

GroupSize = Union[int, Tuple[int, int]]


@dataclass(frozen=True)
class QuantizationScheme:
    """Frozen description of a quantization recipe.

    Mirrors the field surface of the reference dataclass
    (``auto_round/schemes.py:197``): weight-side ``bits/group_size/sym/
    data_type``, activation-side ``act_*``, and GGUF double-quant
    ``super_bits/super_group_size``.

    group_size semantics (same as reference):
      * ``-1``  → per-output-channel (one group = whole input dim)
      * ``0``   → per-tensor
      * ``n>0`` → groups of ``n`` along the input-channel axis
      * ``(r, c)`` tuple → 2-D blocks (block-wise FP8, e.g. (128, 128))
    """

    # Weight side
    bits: int = 16
    group_size: GroupSize = 128
    sym: bool = True
    data_type: str = "int"
    # Activation side
    act_bits: int = 16
    act_group_size: Optional[GroupSize] = None
    act_sym: Optional[bool] = None
    act_data_type: Optional[str] = None
    act_dynamic: bool = True
    # GGUF double-quant (super-block) fields
    super_bits: Optional[int] = None
    super_group_size: Optional[int] = None

    def with_overrides(self, **kw) -> "QuantizationScheme":
        """Return a copy with the given non-None fields replaced."""
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(self, **kw)

    # -- classification helpers (reference: schemes.py dtype classifiers) --
    @property
    def is_weight_quantized(self) -> bool:
        return self.bits < 16

    @property
    def is_act_quantized(self) -> bool:
        return self.act_bits < 16

    def effective_act(self) -> "QuantizationScheme":
        """Resolve activation-side defaults from the weight side.

        Matches the inherit rule of the reference
        (``schemes.py:425`` ``_override_scheme_with_user_specify``): any act_*
        field left ``None`` inherits the weight-side setting.
        """
        return dataclasses.replace(
            self,
            act_group_size=(
                self.act_group_size if self.act_group_size is not None else self.group_size
            ),
            act_sym=self.act_sym if self.act_sym is not None else self.sym,
            act_data_type=(
                self.act_data_type if self.act_data_type is not None else self.data_type
            ),
        )

    def key(self) -> str:
        """Stable string key (used in layer-config plans and export configs)."""
        parts = [f"w{self.bits}", f"g{self.group_size}", "sym" if self.sym else "asym",
                 self.data_type]
        if self.is_act_quantized:
            parts.append(f"a{self.act_bits}")
        return "_".join(str(p) for p in parts)


def is_mx_fp(data_type: str) -> bool:
    return data_type.startswith("mx_fp") or data_type.startswith("mx_int")


def is_nv_fp(data_type: str) -> bool:
    return data_type.startswith("nv_fp")


def is_fp8(data_type: str) -> bool:
    return "fp8" in data_type and not is_mx_fp(data_type) and not is_nv_fp(data_type)


def is_gguf(data_type: str) -> bool:
    return data_type.endswith("_dq") or data_type.startswith("gguf")


def is_int(data_type: str) -> bool:
    return data_type == "int" or data_type.startswith("int")


def is_float(data_type: str) -> bool:
    return not is_int(data_type)


def _s(**kw) -> QuantizationScheme:
    return QuantizationScheme(**kw)


# Preset table.  Names/surfaces track the reference presets
# (``auto_round/schemes.py:538-816``); the definitions below are written from
# the format specs (OCP MX spec, NVFP4, FP8-E4M3), not copied.
PRESET_SCHEMES = {
    # --- weight-only int ---
    "W2A16": _s(bits=2, group_size=128, sym=True, data_type="int"),
    "W2A16G64": _s(bits=2, group_size=64, sym=True, data_type="int"),
    "W3A16": _s(bits=3, group_size=128, sym=True, data_type="int"),
    "W4A16": _s(bits=4, group_size=128, sym=True, data_type="int"),
    "W4A16G32": _s(bits=4, group_size=32, sym=True, data_type="int"),
    "W8A16": _s(bits=8, group_size=128, sym=True, data_type="int"),
    # --- int weight + act ---
    "W4A8": _s(bits=4, group_size=128, sym=True, data_type="int",
               act_bits=8, act_group_size=0, act_sym=True, act_data_type="int"),
    "W8A8": _s(bits=8, group_size=-1, sym=True, data_type="int",
               act_bits=8, act_group_size=0, act_sym=True, act_data_type="int"),
    # --- microscaling (OCP MX): group of 32, shared pow-2 (E8M0) scale ---
    "MXFP4": _s(bits=4, group_size=32, sym=True, data_type="mx_fp",
                act_bits=4, act_group_size=32, act_sym=True, act_data_type="mx_fp"),
    "MXFP6": _s(bits=6, group_size=32, sym=True, data_type="mx_fp",
                act_bits=6, act_group_size=32, act_sym=True, act_data_type="mx_fp"),
    "MXFP8": _s(bits=8, group_size=32, sym=True, data_type="mx_fp",
                act_bits=8, act_group_size=32, act_sym=True, act_data_type="mx_fp"),
    "MXINT4": _s(bits=4, group_size=32, sym=True, data_type="mx_int",
                 act_bits=16),
    "MXINT8": _s(bits=8, group_size=32, sym=True, data_type="mx_int",
                 act_bits=16),
    # --- NVFP4: group of 16, FP8-E4M3 group scales x FP32 global scale ---
    "NVFP4": _s(bits=4, group_size=16, sym=True, data_type="nv_fp",
                act_bits=4, act_group_size=16, act_sym=True,
                act_data_type="nv_fp4_with_static_gs"),
    # --- FP8 ---
    "FP8_STATIC": _s(bits=8, group_size=-1, sym=True, data_type="fp8",
                     act_bits=8, act_group_size=0, act_sym=True,
                     act_data_type="fp8", act_dynamic=False),
    "FP8_BLOCK": _s(bits=8, group_size=(128, 128), sym=True, data_type="fp8",
                    act_bits=8, act_group_size=128, act_sym=True,
                    act_data_type="fp8"),
    # --- GGUF k-quants (double-quant / super-block) ---
    "GGUF:Q2_K_S": _s(bits=2, group_size=16, sym=False, data_type="int_dq",
                      super_bits=4, super_group_size=16),
    "GGUF:Q3_K_S": _s(bits=3, group_size=16, sym=True, data_type="int_dq",
                      super_bits=6, super_group_size=16),
    "GGUF:Q4_K_S": _s(bits=4, group_size=32, sym=False, data_type="int_dq",
                      super_bits=6, super_group_size=8),
    "GGUF:Q4_K_M": _s(bits=4, group_size=32, sym=False, data_type="int_dq",
                      super_bits=6, super_group_size=8),
    "GGUF:Q5_K_S": _s(bits=5, group_size=32, sym=False, data_type="int_dq",
                      super_bits=6, super_group_size=8),
    "GGUF:Q6_K": _s(bits=6, group_size=16, sym=True, data_type="int_dq",
                    super_bits=8, super_group_size=16),
    "GGUF:Q4_0": _s(bits=4, group_size=32, sym=True, data_type="int"),
    "GGUF:Q4_1": _s(bits=4, group_size=32, sym=False, data_type="int"),
    "GGUF:Q8_0": _s(bits=8, group_size=32, sym=True, data_type="int"),
    # --- passthrough ---
    "BF16": _s(bits=16, group_size=0, data_type="bf16"),
}


def parse_scheme(scheme: Union[str, dict, QuantizationScheme],
                 **overrides) -> QuantizationScheme:
    """Resolve a user-facing scheme spec into a ``QuantizationScheme``.

    Accepts a preset name (case-insensitive), a dict of fields, or an
    existing scheme; ``overrides`` (bits=, group_size=, ...) win over the
    base.  Mirrors ``auto_round/schemes.py:496`` ``parse_scheme``.
    """
    if isinstance(scheme, QuantizationScheme):
        base = scheme
    elif isinstance(scheme, dict):
        base = QuantizationScheme(**scheme)
    elif isinstance(scheme, str):
        name = scheme.strip().upper()
        if name not in PRESET_SCHEMES:
            raise ValueError(
                f"Unknown scheme {scheme!r}; known presets: {sorted(PRESET_SCHEMES)}"
            )
        base = PRESET_SCHEMES[name]
    else:
        raise TypeError(f"Cannot parse scheme from {type(scheme)}")
    return base.with_overrides(**overrides)
