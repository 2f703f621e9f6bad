"""Port parity for the Llama-family flags (Qwen2.5 biases, Qwen3 qk-norm,
Gemma2 / Gemma3 norms, GeGLU, softcaps, sliding windows, dual rope):
the model, the quantize loop and export against the JAX package, on the
tiny presets ``tiny-qwen``, ``tiny-qwen3``, ``tiny-gemma2`` and
``tiny-gemma3`` with the weights carried across by
``utils.convert.params_from_jax``.  Every bias and norm gain is moved off
its initial value (0 or 1) first, so each one counts.

Tolerances (fp32 throughout):
  * logits and rope tables: the same fp32 operations summed in other
    orders; logits agree to ~1e-6 of their O(1) size, 1e-4 (``TOL``)
    leaves margin; rope tables to 1e-6;
  * RTN: qdq and scales exact (the same IEEE operations on the weights);
  * SignRound loss traces: the first loss of each block within 1e-3
    (later blocks start from chains through tuned blocks); sign-SGD turns
    last-bit differences (a softcap's division, which XLA makes a product
    by the reciprocal under jit, GeGLU's tanh) into other updates, so there
    is no bitwise target: measured at most 2.0e-6 relative at any step
    (tiny-qwen; 0.8e-6 to 1.0e-6 for the others), held to ``TRACE_RTOL``
    = 6e-6 at every step and at the best loss;
  * export of an RTN result: files byte-identical.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.export import save_quantized as j_save
from autoround_tpu.models import llama as jl
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401

PRESETS = ("tiny-qwen", "tiny-qwen3", "tiny-gemma2", "tiny-gemma3")
TOL = 1e-4
FIRST_LOSS_RTOL = 1e-3
TRACE_RTOL = 6e-6
SEQ = 16


def perturbed_params(jcfg, seed=0):
    """JAX ``init_params`` as numpy, with every 1-D leaf (norm gains, q/k
    norms, biases) moved off its initial value by N(0, 0.1)."""
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def move(a):
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(a.dtype)

    tree["norm"] = move(tree["norm"])
    for b in tree["blocks"]:
        for k, a in b.items():
            if a.ndim == 1:
                b[k] = move(a)
    return tree


def family_pair(jcfg, seed=0):
    """(JAX params, port config, port params) of one config."""
    tree = perturbed_params(jcfg, seed)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    return (jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, "cpu"))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               rtol=tol, atol=tol)


_GEMMA3 = jl.CONFIG_PRESETS["tiny-gemma3"]
_CONFIGS = {name: jl.CONFIG_PRESETS[name] for name in PRESETS}
# Gemma2 with a window the prompt passes (even layers slide)
_CONFIGS["tiny-gemma2-window8"] = dataclasses.replace(
    jl.CONFIG_PRESETS["tiny-gemma2"], sliding_window=8)
# partial rotary on both table pairs: global 0.5, local 0.25 of hd
_CONFIGS["tiny-gemma3-partial"] = dataclasses.replace(
    _GEMMA3, partial_rotary_factor=0.5, partial_rotary_factor_local=0.25)


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(name):
        if name not in built:
            built[name] = family_pair(_CONFIGS[name])
        return built[name]
    return get


def test_params_leaves_and_perturbation(pairs):
    """The port's ``init_params`` lays out the JAX package's leaves, and
    the carried-over gains and biases are off their initial values."""
    for name in PRESETS:
        jcfg = _CONFIGS[name]
        jp, tcfg, tp = pairs(name)
        ti = tl.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        shapes = jax.tree.map(lambda t: tuple(t.shape), jp)
        assert shapes == jax.tree.map(
            lambda t: tuple(t.shape), ti,
            is_leaf=lambda t: isinstance(t, torch.Tensor)), name
        b0 = ti["blocks"][0]
        gain0 = 1.0 - jcfg.norm_offset
        assert torch.all(b0["input_layernorm"] == gain0)
        if jcfg.attn_bias:
            assert torch.all(b0["q_bias"] == 0)
            assert tp["blocks"][0]["q_bias"].abs().max() > 0.05
        if jcfg.qk_norm:
            assert torch.all(b0["q_norm"] == 1)
        if jcfg.sandwich_norms:
            assert torch.all(b0["post_feedforward_layernorm"] == gain0)
        assert (tp["blocks"][0]["input_layernorm"] - gain0).abs().max() > 0.05


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_model_fwd_logits_match(pairs, name):
    """Logits at S = 16: past the window of tiny-gemma3 (8) and of the
    Gemma2 variant, so the sliding mask and both rope pairs are live."""
    jcfg = _CONFIGS[name]
    jp, tcfg, tp = pairs(name)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, SEQ))
    want = jl.model_fwd(jp, jnp.asarray(ids), jcfg)
    got = tl.model_fwd(tp, torch.from_numpy(ids), tcfg)
    _close(want, got)
    if jcfg.final_logit_softcap:
        assert got.abs().max() < jcfg.final_logit_softcap


def test_sliding_layers_and_mask():
    g3 = tl.CONFIG_PRESETS["tiny-gemma3"]
    assert [tl.layer_is_sliding(g3, i) for i in range(3)] == \
        [jl.layer_is_sliding(_GEMMA3, i) for i in range(3)] == \
        [True, True, False]
    g2 = config_from_jax(dataclasses.asdict(_CONFIGS["tiny-gemma2-window8"]))
    assert [tl.layer_is_sliding(g2, i) for i in range(2)] == [True, False]
    assert not tl.layer_is_sliding(tl.CONFIG_PRESETS["tiny-qwen"], 0)
    np.testing.assert_array_equal(
        np.asarray(jl.sliding_mask(_GEMMA3, SEQ)),
        tl.sliding_mask(g3, SEQ).numpy())


@pytest.mark.parametrize("name", ["tiny-qwen", "tiny-qwen3", "tiny-gemma2",
                                  "tiny-gemma3", "qwen2.5-7b", "qwen3-4b",
                                  "gemma2-2b", "gemma3-12b"])
def test_registry_routes_the_presets(name):
    from autoround_tpu_torch.models.registry import ALL_PRESETS, get_model_fns
    cfg = ALL_PRESETS[name]
    assert cfg is tl.CONFIG_PRESETS[name]
    assert get_model_fns(cfg).block_fwd is tl.block_fwd


_ROPE = {
    "gemma3": _GEMMA3,                         # local theta, linear x8
    "partial": _CONFIGS["tiny-gemma3-partial"],
    "linear-only": dataclasses.replace(jl.CONFIG_PRESETS["tiny"],
                                       rope_scaling_factor=4.0),
}


@pytest.mark.parametrize("name", sorted(_ROPE))
@pytest.mark.parametrize("local", [False, True])
def test_rope_tables_match(name, local):
    """Global (linear-scaled), local (its own base, unscaled) and partial
    tables at arbitrary positions, and apply_rope on them (rd < hd rotates
    the leading rd dims only).  Built local after global and global after
    local: a cached frequency vector must not serve the other pair."""
    jcfg = _ROPE[name]
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    pos = np.array([0, 5, 17, 300], np.int32)
    tl.rope_tables(tcfg, 4, positions=torch.from_numpy(pos),
                   local=not local)
    jc, js = jl.rope_tables(jcfg, 4, positions=jnp.asarray(pos), local=local)
    tc, ts = tl.rope_tables(tcfg, 4, positions=torch.from_numpy(pos),
                            local=local)
    assert tuple(tc.shape) == tuple(jc.shape)
    _close(jc, tc, 1e-6)
    _close(js, ts, 1e-6)
    x = np.random.default_rng(4).standard_normal(
        (1, 4, 2, jcfg.hd)).astype(np.float32)
    _close(jl.apply_rope(jnp.asarray(x), jc, js),
           tl.apply_rope(torch.from_numpy(x), tc, ts), 1e-6)
    (gc, _), (lc, _) = tl.dual_rope_tables(tcfg, 4,
                                           torch.from_numpy(pos))
    assert (gc is lc) == (not jcfg.rope_local_theta)


def _both(name, **kw):
    jp, tcfg, tp = family_pair(_CONFIGS[name])
    jcfg = _CONFIGS[name]
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, SEQ))
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(ids))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jres, ar.quantize(ids), ar


@pytest.fixture(scope="module")
def rtn():
    built = {}

    def get(name):
        if name not in built:
            built[name] = _both(name, scheme="W4A16G32", iters=0,
                                quant_lm_head=True)
        return built[name]
    return get


@pytest.mark.parametrize("name", PRESETS)
def test_rtn_codes_equal(rtn, name):
    jres, tres, _ = rtn(name)
    assert sorted(jres.layers) == sorted(tres.layers)
    assert len(tres.layers) == 7 * _CONFIGS[name].num_layers + 1
    for n, jq in jres.layers.items():
        np.testing.assert_array_equal(np.asarray(jq.qdq),
                                      tres.layers[n].qdq.numpy(), err_msg=n)
        np.testing.assert_array_equal(np.asarray(jq.scale),
                                      tres.layers[n].scale.numpy(),
                                      err_msg=n)
    # the unquantized leaves (biases, gains) pass through unchanged
    b = tres.params["blocks"][0]
    jb = jres.params["blocks"][0]
    for k in ("input_layernorm", "q_bias", "q_norm",
              "pre_feedforward_layernorm"):
        if k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), b[k].numpy())


@pytest.mark.parametrize("name", PRESETS)
def test_signround_loss_traces_close(name):
    """SignRound, 4 iterations a block and on the lm_head; tiny-gemma3's
    calibration (16 tokens) is longer than its window (8), so the sliding
    mask is inside the tuning loss and the FP reference of layers 0-1."""
    jres, tres, _ = _both(name, scheme="W4A16G32", iters=4, batch_size=4,
                          seed=0)
    assert sorted(jres.loss_traces) == sorted(tres.loss_traces)
    assert len(tres.loss_traces) == _CONFIGS[name].num_layers
    for bi, jt in jres.loss_traces.items():
        tt = tres.loss_traces[bi]
        assert tt.shape == jt.shape and np.isfinite(tt).all()
        np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
        np.testing.assert_allclose(tt, jt, rtol=TRACE_RTOL)
        np.testing.assert_allclose(tt.min(), jt.min(), rtol=TRACE_RTOL)


def test_tuning_reference_uses_the_window(monkeypatch):
    """Each block's FP reference in the quantize loop runs a sliding
    layer with the local tables and, past the window, the sliding mask (a
    reference without the mask is another target: the outputs differ), and
    a global layer with neither."""
    jcfg = _GEMMA3
    _, tcfg, tp = family_pair(jcfg)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, SEQ)))
    x = tl.embed_fwd(tp, ids, tcfg)
    _, (cl, sl) = tl.dual_rope_tables(tcfg, SEQ)
    full = tl.block_fwd(tp["blocks"][0], x, cl, sl, tcfg)
    windowed = tl.block_fwd(tp["blocks"][0], x, cl, sl, tcfg,
                            mask=tl.sliding_mask(tcfg, SEQ))
    assert (full - windowed).abs().max() > 1e-3
    from types import SimpleNamespace

    from autoround_tpu_torch.quantize import orchestrator
    seen = []

    def spy(w, xb, cos, sin, cfg, mask=None, linear_fn=None):
        seen.append((torch.equal(cos, cl), mask is not None))
        return tl.block_fwd(w, xb, cos, sin, cfg, mask=mask,
                            linear_fn=linear_fn)
    fns = vars(orchestrator.get_model_fns(tcfg))
    monkeypatch.setattr(orchestrator, "get_model_fns",
                        lambda cfg: SimpleNamespace(**{**fns,
                                                       "block_fwd": spy}))
    AutoRound((tp, tcfg), scheme="W4A16G32", iters=0,
              device="cpu").quantize(ids.numpy())
    # one FP reference a block: sliding, sliding, global
    assert seen == [(True, True), (True, True), (False, False)]


@pytest.mark.parametrize("name", ["tiny-gemma3", "tiny-qwen"])
@pytest.mark.parametrize("fmt", ["fake", "autoround"])
def test_export_bytes_equal_the_jax_package(rtn, tmp_path, name, fmt):
    """``quantization_config.json``'s model_config (layer_types a JSON
    list) and the tensors equal the JAX package's byte for byte."""
    jres, _, ar = rtn(name)
    jd = j_save(jres, _CONFIGS[name], str(tmp_path / "j"), fmt)
    td = ar.save_quantized(str(tmp_path / "t"), fmt)
    for f in ("model.safetensors", "quantization_config.json"):
        assert filecmp.cmp(os.path.join(jd, f), os.path.join(td, f),
                           shallow=False), f
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
