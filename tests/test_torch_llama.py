"""Port parity: the Llama model functions against the JAX package, with
the weights carried across by ``utils.convert.params_from_jax``.

Tolerance: fp32 weights and activations on both sides; matmul and
softmax reduction orders differ, so logits agree to ~1e-6 of their O(1)
magnitude.  atol = rtol = 1e-4 leaves margin for the 2-layer chains."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.models import llama as jl
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.ops.flash_attention import flash_attention
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax

TOL = 1e-4


def _pair(jcfg, seed=0):
    jp = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jp, tcfg, tp


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               rtol=tol, atol=tol)


_TINY = jl.CONFIG_PRESETS["tiny"]
_CONFIGS = {
    "tiny": _TINY,
    "llama3.1-rope": dataclasses.replace(_TINY,
                                         rope_llama3=(8.0, 1.0, 4.0, 64)),
    # llama3.2-style: tied embeddings, head_dim != hidden / heads
    "tied-hd32": dataclasses.replace(_TINY, tie_embeddings=True,
                                     head_dim=32),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_model_fwd_logits_match(name):
    jcfg = _CONFIGS[name]
    jp, tcfg, tp = _pair(jcfg)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16))
    want = jl.model_fwd(jp, jnp.asarray(ids), jcfg)
    got = tl.model_fwd(tp, torch.from_numpy(ids), tcfg)
    _close(want, got)


def test_block_fwd_flash_gate_matches():
    """hd 128, S = 512: the port routes through the flash kernel's plain
    version (the routing gate passes), JAX through its plain math."""
    jcfg = jl.LlamaConfig(vocab_size=64, hidden_size=256,
                          intermediate_size=256, num_layers=1, num_heads=2,
                          num_kv_heads=1, head_dim=128, rope_theta=1e4,
                          dtype=jnp.float32)
    jp, tcfg, tp = _pair(jcfg, seed=2)
    x = np.random.default_rng(2).standard_normal((1, 512, 256)).astype(
        np.float32)
    jc, js = jl.rope_tables(jcfg, 512)
    tc, ts = tl.rope_tables(tcfg, 512)
    _close(jc, tc, 1e-6)
    _close(js, ts, 1e-6)
    q = torch.zeros(1, 512, 2, 128)
    assert tl._flash_eligible(q, q[:, :, :1], None)
    want = jl.block_fwd(jp["blocks"][0], jnp.asarray(x), jc, js, jcfg)
    got = tl.block_fwd(tp["blocks"][0], torch.from_numpy(x), tc, ts, tcfg)
    _close(want, got)


def test_rms_norm_and_rope_parts():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    g = rng.standard_normal((16,)).astype(np.float32)
    _close(jl.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6),
           tl.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6),
           1e-6)
    jcfg = _CONFIGS["llama3.1-rope"]
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    pos = np.array([3, 7, 100], np.int32)
    jc, js = jl.rope_tables(jcfg, 3, positions=jnp.asarray(pos))
    tc, ts = tl.rope_tables(tcfg, 3, positions=torch.from_numpy(pos))
    _close(jl.apply_rope(jnp.asarray(x), jc, js),
           tl.apply_rope(torch.from_numpy(x), tc, ts), 1e-6)


@pytest.mark.parametrize("name", ["tiny-qwen", "tiny-qwen3", "tiny-gemma2",
                                  "tiny-gemma3"])
def test_config_from_jax_rejects_unported_flags(name):
    with pytest.raises(NotImplementedError):
        config_from_jax(dataclasses.asdict(jl.CONFIG_PRESETS[name]))


@pytest.mark.parametrize("name", ["tiny", "llama3.2-1b", "llama3-8b"])
def test_config_from_jax_llama_presets(name):
    cfg = config_from_jax(dataclasses.asdict(jl.CONFIG_PRESETS[name]))
    assert cfg == tl.CONFIG_PRESETS[name]


def test_init_params_seeded_and_shaped():
    cfg = tl.CONFIG_PRESETS["tiny"]
    a = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jl.init_params(_TINY, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), jp) == \
        jax.tree.map(lambda t: tuple(t.shape), a,
                     is_leaf=lambda t: isinstance(t, torch.Tensor))
    torch.testing.assert_close(a["blocks"][1]["down_proj"],
                               b["blocks"][1]["down_proj"], rtol=0, atol=0)


def test_no_flash_launch_on_cpu():
    before = flash_attention.launches
    cfg = tl.CONFIG_PRESETS["tiny"]
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tl.model_fwd(p, torch.zeros((1, 8), dtype=torch.long), cfg)
    assert flash_attention.launches == before
