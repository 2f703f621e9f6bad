"""The port's HF checkpoint loader and writer (``utils/hf_loader.py``)
against the JAX package's: ``config_from_hf`` field by field over one HF
config per family, checkpoints written by either side read by the other
with equal leaves (exact), the port's files byte-equal to the JAX
package's for the same weights, Phi-3's fused projections split, Mixtral
and Qwen2-MoE round trips, tied embeddings, and the unported
``model_type``s and FP8 sources raising by their ROADMAP item.  (The
DeepSeek family's round trips are in ``tests/test_torch_deepseek.py``.)
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.models import llama as jl
from autoround_tpu.models import mixtral as jm
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from autoround_tpu_torch.utils.safetensors_io import save_file
from _port_threads import one_torch_thread  # noqa: F401

_BASE = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rope_theta=1e4, rms_norm_eps=1e-5)

HF_CONFIGS = {
    "llama": dict(_BASE, model_type="llama"),
    "llama3.1-rope": dict(_BASE, model_type="llama", rope_theta=5e5,
                          rope_scaling={"rope_type": "llama3",
                                        "factor": 8.0,
                                        "low_freq_factor": 1.0,
                                        "high_freq_factor": 4.0,
                                        "original_max_position_embeddings":
                                            8192}),
    "mistral": dict(_BASE, model_type="mistral", num_key_value_heads=1),
    "qwen2": dict(_BASE, model_type="qwen2", rope_theta=1e6),
    "qwen3": dict(_BASE, model_type="qwen3", head_dim=32,
                  tie_word_embeddings=True, rms_norm_eps=1e-6),
    "gemma2": dict(_BASE, model_type="gemma2", head_dim=16,
                   hidden_activation="gelu_pytorch_tanh",
                   query_pre_attn_scalar=256, sliding_window=4096,
                   attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0),
    "gemma3_text": dict(_BASE, model_type="gemma3_text", head_dim=16,
                        num_hidden_layers=3, hidden_activation=
                        "gelu_pytorch_tanh", query_pre_attn_scalar=16,
                        sliding_window=8, rope_local_base_freq=1e4,
                        rope_scaling={"rope_type": "linear", "factor": 8.0},
                        layer_types=["sliding_attention",
                                     "sliding_attention", "full_attention"]),
    "phi3": dict(_BASE, model_type="phi3", tie_word_embeddings=False),
    "mixtral": dict(_BASE, model_type="mixtral", num_local_experts=4,
                    num_experts_per_tok=2),
    "qwen2_moe": dict(_BASE, model_type="qwen2_moe", num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=96,
                      shared_expert_intermediate_size=128,
                      norm_topk_prob=False),
    "qwen3_moe": dict(_BASE, model_type="qwen3_moe", num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=96,
                      head_dim=32),
    # DeepSeek-V2-Lite's published fields, yarn rope scaling included
    "deepseek_v2": dict(_BASE, model_type="deepseek_v2",
                        num_key_value_heads=4, q_lora_rank=None,
                        kv_lora_rank=32, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16,
                        n_routed_experts=8, num_experts_per_tok=6,
                        moe_intermediate_size=48, n_shared_experts=2,
                        first_k_dense_replace=1, routed_scaling_factor=1.0,
                        topk_method="greedy", norm_topk_prob=False,
                        rms_norm_eps=1e-6,
                        rope_scaling={"type": "yarn", "factor": 40,
                                      "beta_fast": 32, "beta_slow": 1,
                                      "mscale": 0.707,
                                      "mscale_all_dim": 0.707,
                                      "original_max_position_embeddings":
                                          4096}),
    "deepseek_v3": dict(_BASE, model_type="deepseek_v3",
                        num_key_value_heads=4, q_lora_rank=48,
                        kv_lora_rank=32, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16,
                        n_routed_experts=16, num_experts_per_tok=4,
                        moe_intermediate_size=32, n_shared_experts=1,
                        first_k_dense_replace=2, routed_scaling_factor=2.5,
                        n_group=4, topk_group=2, topk_method="noaux_tc",
                        scoring_func="sigmoid", norm_topk_prob=True,
                        rope_interleave=True),
    "glm4_moe_lite": dict(_BASE, model_type="glm4_moe_lite",
                          num_key_value_heads=4, q_lora_rank=48,
                          kv_lora_rank=32, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16,
                          n_routed_experts=8, num_experts_per_tok=2,
                          moe_intermediate_size=32, n_shared_experts=1,
                          first_k_dense_replace=1,
                          routed_scaling_factor=1.8, n_group=1,
                          topk_group=1, norm_topk_prob=True),
    "gpt_oss": dict(_BASE, model_type="gpt_oss", head_dim=16,
                    intermediate_size=64, sliding_window=8,
                    num_local_experts=4, num_experts_per_tok=2,
                    rope_theta=150000.0,
                    rope_scaling={"rope_type": "yarn", "factor": 32.0,
                                  "beta_fast": 32.0, "beta_slow": 1.0,
                                  "truncate": False,
                                  "original_max_position_embeddings": 4096}),
    "llama4_text": dict(_BASE, model_type="llama4_text", head_dim=16,
                        intermediate_size_mlp=256, num_local_experts=4,
                        num_experts_per_tok=1, interleave_moe_layer_step=2,
                        no_rope_layers=[1, 0], attention_chunk_size=8,
                        layer_types=["chunked_attention", "full_attention"],
                        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                      "low_freq_factor": 1.0,
                                      "high_freq_factor": 4.0,
                                      "original_max_position_embeddings":
                                          8192}),
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_equals_jax(name):
    j = jh.config_from_hf(HF_CONFIGS[name], jnp.float32)
    t = th.config_from_hf(HF_CONFIGS[name], torch.float32)
    assert type(t).__name__ == type(j).__name__
    for f in dataclasses.fields(t):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.float32


# ported since these cases were written (Qwen3-Next / 3.5, GLM-4.5, GLM-5
# DSA, MiniMax, Step-3.5's config): their cases now hold what the loader
# does with the same base config
_NOW_PORTED = ("qwen3_next", "qwen3_5_moe", "qwen3_5", "glm4_moe",
               "glm_moe_dsa", "minimax", "step3p5")


@pytest.mark.parametrize("model_type", _NOW_PORTED)
def test_unported_model_types_raise(model_type):
    if model_type in ("glm4_moe", "glm_moe_dsa", "step3p5"):
        # the JAX loader's config, field by field
        hf = dict(_BASE, model_type=model_type)
        t = th.config_from_hf(hf, torch.float32)
        j = jh.config_from_hf(hf, jnp.float32)
        assert type(t).__name__ == type(j).__name__ == {
            "glm4_moe": "Glm4MoeConfig", "glm_moe_dsa": "GlmMoeDsaConfig",
            "step3p5": "Step35Config"}[model_type]
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        return
    # a hybrid config needs its layer kinds; with them it builds the
    # JAX loader's config
    with pytest.raises(ValueError, match="layer_types"):
        th.config_from_hf(dict(_BASE, model_type=model_type))
    hf = dict(_BASE, model_type=model_type, num_experts=4,
              layer_types=["linear_attention", "full_attention"])
    t = th.config_from_hf(hf, torch.float32)
    j = jh.config_from_hf(hf, jnp.float32)
    assert type(t).__name__ == type(j).__name__ == (
        "Qwen3NextConfig" if model_type == "qwen3_next"
        else "MiniMaxConfig" if model_type == "minimax"
        else "Qwen35MoeConfig")
    for f in dataclasses.fields(t):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("marker", ["weight_scale_inv", "f8_weight"])
def test_fp8_source_raises(tmp_path, marker):
    """An FP8-source checkpoint loads as the JAX loader loads it (the
    refusal this test held went with the FP8 read): an F8 weight is
    dequantized by its ``weight_scale_inv`` grid, a scale beside a weight
    that is not F8 is dropped and the weight kept as stored; the trees are
    equal leaf for leaf in fp32."""
    gen = torch.Generator().manual_seed(0)
    tensors = {"model.embed_tokens.weight": torch.zeros(64, 64)}
    w = torch.randn(64, 64, generator=gen)
    key = "model.layers.0.self_attn.q_proj.weight"
    if marker == "f8_weight":
        tensors[key] = w.to(torch.float8_e4m3fn)
        tensors[key + "_scale_inv"] = torch.tensor([[0.5]])
    else:
        tensors[key] = w
        tensors[key + "_scale_inv"] = torch.ones(1, 1) * 3.0
    for n in ("k_proj", "v_proj", "o_proj"):
        tensors[f"model.layers.0.self_attn.{n}.weight"] = torch.randn(
            64, 64, generator=gen)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(
        dict(HF_CONFIGS["llama"], num_hidden_layers=1)))
    tp, _ = th.load_hf_checkpoint(str(tmp_path), torch.float32, device="cpu")
    jp, _ = jh.load_hf_checkpoint(str(tmp_path), jnp.float32)
    assert sorted(tp["blocks"][0]) == sorted(jp["blocks"][0])
    for k, v in jp["blocks"][0].items():
        np.testing.assert_array_equal(tp["blocks"][0][k].numpy(),
                                      np.asarray(v), err_msg=k)
    want = (w.to(torch.float8_e4m3fn).float() * 0.5 if marker == "f8_weight"
            else w)
    assert torch.equal(tp["blocks"][0]["q_proj"], want)


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        th.load_hf_checkpoint("/nonexistent")


# ---------------------------------------------------------------- round trips

def _jax_params(cfg, seed):
    """JAX params with every leaf in the config's dtype (the JAX init
    leaves down_proj in fp32 under a bf16 config) and every 1-D leaf moved
    off its initial value."""
    mod = jm if isinstance(cfg, jm.MixtralConfig) else jl
    p = mod.init_params(cfg, jax.random.PRNGKey(seed))
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 4096))

    def fix(a):
        a = a.astype(cfg.dtype)
        if a.ndim == 1:
            a = a + 0.1 * jax.random.normal(next(keys), a.shape, cfg.dtype)
        return a
    return jax.tree.map(fix, p)


def _same_tree(t_tree, j_tree):
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree), (sorted(t_tree), sorted(j_tree))
        for k in j_tree:
            _same_tree(t_tree[k], j_tree[k])
    elif isinstance(j_tree, (list, tuple)):
        assert len(t_tree) == len(j_tree)
        for a, b in zip(t_tree, j_tree):
            _same_tree(a, b)
    else:
        np.testing.assert_array_equal(
            t_tree.float().numpy(), np.asarray(j_tree).astype(np.float32))


FAMILIES = {
    "llama-bf16": dataclasses.replace(jl.CONFIG_PRESETS["tiny"],
                                      dtype=jnp.bfloat16),
    "qwen-bias": jl.CONFIG_PRESETS["tiny-qwen"],
    "tied": jl.LlamaConfig(vocab_size=64, hidden_size=32,
                           intermediate_size=64, num_layers=1, num_heads=2,
                           num_kv_heads=1, tie_embeddings=True,
                           dtype=jnp.float32),
    "mixtral": jm.MixtralConfig(vocab_size=64, hidden_size=64,
                                intermediate_size=96, num_layers=2,
                                num_heads=4, num_kv_heads=2, num_experts=4,
                                top_k=2, rope_theta=1e4, dtype=jnp.float32),
    "qwen2_moe": jm.MixtralConfig(vocab_size=64, hidden_size=64,
                                  intermediate_size=96, num_layers=2,
                                  num_heads=4, num_kv_heads=2,
                                  num_experts=4, top_k=2, attn_bias=True,
                                  shared_expert_intermediate=128,
                                  shared_expert_gate=True,
                                  norm_topk_prob=False, rope_theta=1e4,
                                  dtype=jnp.float32),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_round_trips_and_bytes(tmp_path, family):
    """JAX save → port load and port save → JAX load give equal leaves,
    and the port's files equal the JAX package's byte for byte."""
    jcfg = FAMILIES[family]
    jp = _jax_params(jcfg, 3)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jh.save_hf_checkpoint(jp, jcfg, str(tmp_path / "j"))
    th.save_hf_checkpoint(tp, tcfg, str(tmp_path / "t"))
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
    loaded, lcfg = th.load_hf_checkpoint(str(tmp_path / "j"), tcfg.dtype,
                                         device="cpu")
    jloaded, jlcfg = jh.load_hf_checkpoint(str(tmp_path / "t"), jcfg.dtype)
    _same_tree(loaded, jloaded)
    _same_tree(loaded, jp)
    assert type(lcfg).__name__ == type(jlcfg).__name__
    for f in dataclasses.fields(lcfg):
        if f.name != "dtype":
            assert getattr(lcfg, f.name) == getattr(jlcfg, f.name), f.name
    if jcfg.tie_embeddings:
        assert lcfg.tie_embeddings and "lm_head" not in loaded


def test_round_trip_logits(tmp_path):
    """A loaded Qwen2-MoE runs the port's forward to the JAX forward's
    logits on the JAX weights (fp32; ~1e-6, held to 1e-5)."""
    from autoround_tpu_torch.models import mixtral as tm
    jcfg = FAMILIES["qwen2_moe"]
    jp = _jax_params(jcfg, 4)
    jh.save_hf_checkpoint(jp, jcfg, str(tmp_path / "q"))
    tp, tcfg = th.load_hf_checkpoint(str(tmp_path / "q"), torch.float32,
                                     device="cpu")
    assert tcfg.shared_expert_intermediate == 128
    assert tcfg.norm_topk_prob is False
    ids = np.random.default_rng(0).integers(0, 64, (2, 8))
    want = np.asarray(jm.model_fwd(jp, jnp.asarray(ids), jcfg), np.float32)
    got = tm.model_fwd(tp, torch.as_tensor(ids), tcfg).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_phi3_fused_split(tmp_path):
    """Phi-3's fused qkv_proj / gate_up_proj split into the port's leaves,
    equal to the JAX loader's."""
    jcfg = jl.LlamaConfig(vocab_size=64, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          num_kv_heads=2, rope_theta=1e4, dtype=jnp.float32)
    jp = _jax_params(jcfg, 6)
    a = lambda x: np.asarray(x)  # noqa: E731
    tensors = {"model.embed_tokens.weight": a(jp["embed_tokens"]),
               "model.norm.weight": a(jp["norm"]),
               "lm_head.weight": a(jp["lm_head"])}
    for li, b in enumerate(jp["blocks"]):
        p = f"model.layers.{li}."
        tensors[p + "self_attn.qkv_proj.weight"] = np.concatenate(
            [a(b["q_proj"]), a(b["k_proj"]), a(b["v_proj"])])
        tensors[p + "self_attn.o_proj.weight"] = a(b["o_proj"])
        tensors[p + "mlp.gate_up_proj.weight"] = np.concatenate(
            [a(b["gate_proj"]), a(b["up_proj"])])
        tensors[p + "mlp.down_proj.weight"] = a(b["down_proj"])
        tensors[p + "input_layernorm.weight"] = a(b["input_layernorm"])
        tensors[p + "post_attention_layernorm.weight"] = a(
            b["post_attention_layernorm"])
    save_file(tensors, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS["phi3"]))
    tp, _ = th.load_hf_checkpoint(str(tmp_path), torch.float32, device="cpu")
    jp2, _ = jh.load_hf_checkpoint(str(tmp_path), jnp.float32)
    _same_tree(tp, jp2)
    _same_tree(tp, jp)


def test_missing_attention_weights_raise(tmp_path):
    save_file({"model.embed_tokens.weight": torch.zeros(64, 64)},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS["llama"]))
    with pytest.raises(ValueError, match="missing attention"):
        th.load_hf_checkpoint(str(tmp_path), device="cpu")
