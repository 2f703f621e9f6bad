"""Port parity: schemes and the per-layer plan match the JAX package."""

import dataclasses

import pytest

from autoround_tpu import schemes as jschemes
from autoround_tpu.quantize import layer_config as jlc
from autoround_tpu_torch import schemes as tschemes
from autoround_tpu_torch.quantize import layer_config as tlc


@pytest.mark.parametrize("name", sorted(jschemes.PRESET_SCHEMES))
def test_preset_fields_match(name):
    a = jschemes.parse_scheme(name)
    b = tschemes.parse_scheme(name.lower())
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.key() == b.key()
    assert dataclasses.asdict(a.effective_act()) == dataclasses.asdict(
        b.effective_act())


def test_overrides_dicts_and_errors():
    a = jschemes.parse_scheme("W4A16", group_size=32, sym=False)
    b = tschemes.parse_scheme("W4A16", group_size=32, sym=False)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    d = {"bits": 3, "group_size": 64}
    assert dataclasses.asdict(jschemes.parse_scheme(d)) == \
        dataclasses.asdict(tschemes.parse_scheme(d))
    with pytest.raises(ValueError):
        tschemes.parse_scheme("W5A16")
    with pytest.raises(TypeError):
        tschemes.parse_scheme(4)


@pytest.mark.parametrize("dt", ["int", "int_dq", "mx_fp", "mx_int", "nv_fp",
                                "fp8", "gguf_q4", "bf16"])
def test_classifiers_match(dt):
    for fn in ("is_mx_fp", "is_nv_fp", "is_fp8", "is_gguf", "is_int",
               "is_float"):
        assert getattr(jschemes, fn)(dt) == getattr(tschemes, fn)(dt)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(quant_lm_head=True),
    dict(layer_config={"down_proj": "W8A16", "blocks.1.q_proj": {"bits": 2}},
         ignore_layers=["o_proj"]),
    dict(layer_config={r"blocks\.0\..*": "BF16"}, quant_lm_head=True),
])
def test_layer_plan_matches(kw):
    names = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
             "down_proj")
    a = jlc.resolve_layer_schemes(2, names, "W4A16", **kw)
    b = tlc.resolve_layer_schemes(2, names, "W4A16", **kw)
    assert list(a) == list(b)
    for n in a:
        assert dataclasses.asdict(a[n]) == dataclasses.asdict(b[n])


def test_layer_plan_unmatched_pattern_raises():
    with pytest.raises(ValueError):
        tlc.resolve_layer_schemes(1, ("q_proj",), "W4A16",
                                  layer_config={"nope": "W8A16"})
