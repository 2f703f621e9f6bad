"""``utils.convert.config_from_jax`` against every config class of the JAX
package: each class, by its name and as an export's ``model_config`` (no
class name, tuples as JSON lists, no dtype, as the JAX export writes it),
rebuilds the port class of the same name with every field carried, or
raises ``NotImplementedError`` naming its ROADMAP item (A14 for the VLM,
omni and diffusion classes).  Two subclasses add no field to their base,
so their exports come back as the base, which serves them the same:
GLM-4.6-Lite (a ``DeepseekConfig``) and Qwen3.5-MoE (a
``Qwen3NextConfig``).  No field is dropped: one the chosen class lacks
raises.
"""

import dataclasses
import json

import pytest
import torch

from autoround_tpu.models import deepseek_vl as jdvl
from autoround_tpu.models import mllama as jml
from autoround_tpu.models import registry as jreg
from autoround_tpu_torch.models.registry import ALL_PRESETS
from autoround_tpu_torch.utils.convert import config_from_jax
from _port_threads import one_torch_thread  # noqa: F401

# one preset of each JAX config class (DeepSeek-VL's and Mllama's presets
# are outside the JAX ALL_PRESETS)
_FIRST = {}
for _name, _cfg in list(jreg.ALL_PRESETS.items()) + list(
        jdvl.CONFIG_PRESETS.items()) + list(jml.CONFIG_PRESETS.items()):
    _FIRST.setdefault(type(_cfg).__name__, (_name, _cfg))
PORTED = {type(c).__name__ for c in ALL_PRESETS.values()}
A14 = {"LlavaConfig", "MllamaConfig", "Mistral3Config", "Gemma3VLConfig",
       "Qwen2VLConfig", "Qwen25VLConfig", "Qwen25OmniConfig",
       "Qwen3OmniConfig", "Qwen3VLMoeConfig", "Glm4vMoeConfig",
       "DeepseekVLConfig", "DiTConfig", "MMDiTConfig"}
# subclasses without a field of their own: an export rebuilds their base
EXPORT_AS = {"GlmMoeLiteConfig": "DeepseekConfig",
             "Qwen35MoeConfig": "Qwen3NextConfig"}
# JAX fields the port converts (the dtype) rather than compares
OFF = ("dtype",)


def test_every_class_is_ported_or_a14():
    assert set(_FIRST) == PORTED | A14 and not PORTED & A14
    assert {"Ernie45Config", "LongcatConfig", "Step35Config"} <= PORTED


def _export_fields(cfg):
    """The model_config the JAX export writes (``__dict__`` less dtype),
    through JSON."""
    return json.loads(json.dumps({
        k: (v if not hasattr(v, "dtype") else str(v))
        for k, v in cfg.__dict__.items() if k != "dtype"}))


@pytest.mark.parametrize("how", ["named", "export"])
@pytest.mark.parametrize("cls", sorted(_FIRST))
def test_config_from_jax_rebuilds_or_refuses(cls, how):
    name, jcfg = _FIRST[cls]
    if how == "named":
        fields, want = dataclasses.asdict(jcfg), cls
        args = (fields, cls)
    else:
        fields, want = _export_fields(jcfg), EXPORT_AS.get(cls, cls)
        args = (fields,)
    if cls in A14:
        with pytest.raises(NotImplementedError, match="ROADMAP A14"):
            config_from_jax(*args)
        return
    tcfg = config_from_jax(*args)
    assert type(tcfg).__name__ == want
    for f in dataclasses.fields(jcfg):
        if f.name not in OFF:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    if how == "named" and name in ALL_PRESETS:
        assert tcfg == ALL_PRESETS[name]


def test_no_field_is_dropped():
    """A field the chosen class lacks raises, where it used to be dropped:
    ``swiglu_limit`` on a Llama export no longer makes a GPT-OSS config,
    and a field no family has raises by name."""
    fields = _export_fields(jreg.ALL_PRESETS["tiny"])
    with pytest.raises(NotImplementedError, match="swiglu_limit"):
        config_from_jax(dict(fields, swiglu_limit=7.0))
    with pytest.raises(NotImplementedError, match="unknown_width"):
        config_from_jax(dict(fields, unknown_width=3), "LlamaConfig")
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        config_from_jax(dict(fields, patch_size=16))
    with pytest.raises(NotImplementedError, match="SomeVLConfig"):
        config_from_jax(fields, "SomeVLConfig")
    # online R4's fields are taken, on or off
    assert config_from_jax(dict(fields, r4_block=64)) == \
        dataclasses.replace(ALL_PRESETS["tiny"], dtype=torch.bfloat16,
                            r4_block=64)
