"""Serving parity for Qwen3-Next and Qwen3.5-MoE: the hybrid cache (K / V
of the full layers, conv tails and fp32 recurrent states of the DeltaNet
layers), the prompt pass and the recurrent decode steps, ``generate_scan``
(a second call with new prompts starts from its own state), the fused
q(+gate) / k / v and a dense layer's gate / up, the stacked experts and
capacity dispatch, ``kv_quant``'s warning, ``from_pretrained`` and a
Qwen3.5 directory with fused expert stacks, against the JAX engine on the
same RTN results (``tests/test_torch_qwen3next.py``'s pairs).

Tolerances (fp32, CPU):
  * engine logits and caches against the JAX engine: 1e-4 (the port packs
    every projection at g = 32 and runs the fused q / k / v and the
    stacked experts; the JAX engine serves the same qdq weights dense);
  * the engine against ``model_fwd`` on the qdq weights: 1e-4;
  * tokens: equal;
  * ``from_pretrained`` against the in-memory engine: 1e-2 (fp16 scales in
    the files).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu import envs as jenvs
from autoround_tpu.models import qwen3next as jq
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.utils import hf_loader as jh
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.models import qwen3next as tq
from autoround_tpu_torch.serve.batching import ContinuousBatchingEngine
from autoround_tpu_torch.serve.engine import HybridCache
from autoround_tpu_torch.utils import hf_loader as th
from autoround_tpu_torch.utils.convert import params_from_jax
from test_torch_qwen3next import (IDS, NAMES, make_pair, port_config,
                                  write_hf)
from _port_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-4
FP16_SCALE_TOL = 1e-2
MAX_SEQ = 32


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _rtn(pair):
    jcfg, jp, tcfg, tp = pair
    kw = dict(scheme="W4A16G32", iters=0, quant_lm_head=True)
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(IDS))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jres, ar.quantize(IDS), ar


@pytest.fixture(scope="module")
def rtn():
    return {n: _rtn(make_pair(n)) for n in NAMES}


def _engines(name, rtn, **kw):
    """(JAX engine, port engine) over the RTN results of ``name``."""
    jres, tres, _ = rtn[name]
    return (JQuantizedLlama.from_quantize_result(jres, make_pair(name)[0],
                                                 max_seq=MAX_SEQ),
            QuantizedLlama.from_quantize_result(tres, make_pair(name)[2],
                                                max_seq=MAX_SEQ,
                                                device="cpu", **kw))


def test_engine_packs_stacks_and_fuses(rtn):
    """Every block's experts stack for row 5; the full layer's q(+gate) /
    k / v fuse into one entry split 2·nh·hd / nkv·hd / nkv·hd; the DeltaNet
    projections pack but ``in_proj_ba``, which serves dense; no packed
    layer keeps a dense leaf."""
    _, te = _engines("tiny-qwen3next", rtn)
    cfg = te.cfg
    stacked = sorted(k for k in te.packed if "experts_stack" in k)
    assert stacked == [f"blocks.{b}.experts_stack.{w}" for b in range(4)
                       for w in ("w1", "w2", "w3")]
    assert not any(".experts." in k for k in te.packed)
    assert te.fused_splits == {"blocks.3.qkv": (2 * 4 * 16, 2 * 16, 2 * 16)}
    assert {"blocks.0.in_proj_qkvz", "blocks.0.out_proj", "blocks.3.o_proj",
            "blocks.1.shared_expert.w2", "lm_head"} <= set(te.packed)
    b0, b3 = te.params["blocks"][0], te.params["blocks"][3]
    assert b0["in_proj_qkvz"] is None and b0["in_proj_ba"] is not None
    assert b3["q_proj"] is None and b3["k_proj"] is None
    assert b0["A_log"].dtype == torch.float32
    _, cache = te.prefill(IDS[:2, :12])
    assert isinstance(cache, HybridCache) and cache.length == 12
    assert cache.k.shape == (1, 2, MAX_SEQ, cfg.num_kv_heads, cfg.hd)
    assert cache.conv.shape == (3, 2, cfg.linear_conv_kernel_dim - 1, 128)
    assert cache.state.shape == (3, 2, 4, 16, 16)
    assert cache.state.dtype == torch.float32 and cache.conv.dtype == \
        cfg.dtype
    assert cache.pos.tolist() == [12, 12]


@pytest.mark.parametrize("S", [12, 2])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_the_jax_engine(name, S, rtn):
    """The prompt pass (its logits and every cache buffer) and three
    recurrent decode steps against the JAX engine; the last step also
    against ``model_fwd`` of the extended sequence on the qdq weights (the
    JAX test's form).  S = 2 < K - 1: the conv tail is left-padded."""
    je, te = _engines(name, rtn)
    p = np.random.default_rng(2).integers(0, 256, (2, S))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    _close(jc.k[:, :, :S], tc.k[:, :, :S], LOGIT_TOL)
    _close(jc.conv, tc.conv, LOGIT_TOL)
    _close(jc.state, tc.state, LOGIT_TOL)
    seq = p
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(3):
        jlog, jc = je.decode_step(jnp.asarray(tok), jc)
        tlog, tc = te.decode_step(torch.from_numpy(tok), tc)
        _close(jlog, tlog, LOGIT_TOL)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    _close(jc.conv, tc.conv, LOGIT_TOL)
    _close(jc.state, tc.state, LOGIT_TOL)
    assert tc.pos.tolist() == [S + 3] * 2
    want = tq.model_fwd(rtn[name][1].params, torch.from_numpy(seq),
                        make_pair(name)[2])[:, -1]
    torch.testing.assert_close(tlog, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_generate_scan_equals_generate_and_jax(name, rtn):
    """Two calls with new prompts of other lengths: the second starts from
    its own prompt's conv tails and states, not the first call's last
    step's."""
    je, te = _engines(name, rtn)
    rng = np.random.default_rng(3)
    for S in (10, 5):
        p = rng.integers(0, 256, (2, S))
        want = np.asarray(je.generate_scan(jnp.asarray(p), max_new_tokens=6))
        np.testing.assert_array_equal(te.generate_scan(p, max_new_tokens=6)
                                      .numpy(), want)
        np.testing.assert_array_equal(te.generate(p, max_new_tokens=6),
                                      want)


def test_kv_quant_has_no_effect_on_the_hybrid_cache(rtn, caplog):
    """``kv_quant="int8"`` warns once and serves the dense hybrid cache,
    as the JAX engine's hybrid cores take no ``kv_quant``."""
    _, te = _engines("tiny-qwen3next", rtn)
    with caplog.at_level(logging.WARNING, logger="autoround_tpu"):
        _, tq8 = _engines("tiny-qwen3next", rtn, kv_quant="int8")
    assert tq8.kv_quant is None
    assert "kv_quant='int8' has no effect" in caplog.text
    p = IDS[:2, :12]
    l8, c8 = tq8.prefill(p)
    l0, c0 = te.prefill(p)
    assert c8.k.dtype == torch.float32 and c8.k_scale is None
    torch.testing.assert_close(l8, l0, rtol=0, atol=0)


def test_capacity_dispatch_in_the_engine(rtn, monkeypatch):
    """``moe_capacity_factor = E / k`` (nothing drops) against the JAX
    engine reading the same factor from its environment."""
    cfg = make_pair("tiny-qwen3next")[0]
    full = cfg.num_experts / cfg.top_k
    monkeypatch.setattr(jenvs, "AR_MOE_CAPACITY_FACTOR", full)
    je, te = _engines("tiny-qwen3next", rtn, moe_capacity_factor=full)
    p = np.random.default_rng(5).integers(0, 256, (2, 12))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    _close(je.decode_step(jnp.asarray(tok), jc)[0],
           te.decode_step(torch.from_numpy(tok), tc)[0], LOGIT_TOL)


def test_mlp_only_layer_serves_its_fused_gate_up():
    """An ``mlp_only_layers`` block (dense MLP): its gate / up fuse into one
    packed entry, which the hybrid block takes; against the JAX engine."""
    jcfg = dataclasses.replace(jq.CONFIG_PRESETS["tiny-qwen3next"],
                               mlp_only_layers=(1, 3))
    tree = jax.tree.map(np.asarray, jq.init_params(jcfg,
                                                   jax.random.PRNGKey(4)))
    tcfg = port_config(jcfg)
    kw = dict(scheme="W4A16G32", iters=0)
    jres = JAutoRound((jax.tree.map(jnp.asarray, tree), jcfg),
                      **kw).quantize(jnp.asarray(IDS))
    tres = AutoRound((params_from_jax(tree, tcfg, "cpu"), tcfg),
                     device="cpu", **kw).quantize(IDS)
    je = JQuantizedLlama.from_quantize_result(jres, jcfg, max_seq=MAX_SEQ)
    te = QuantizedLlama.from_quantize_result(tres, tcfg, max_seq=MAX_SEQ,
                                             device="cpu")
    assert {"blocks.1.gate_up", "blocks.3.gate_up", "blocks.3.qkv"} <= set(
        te.packed)
    assert not any(k.startswith("blocks.1.experts") for k in te.packed)
    p = np.random.default_rng(6).integers(0, 256, (2, 12))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    _close(je.decode_step(jnp.asarray(tok), jc)[0],
           te.decode_step(torch.from_numpy(tok), tc)[0], LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_batcher_refuses_the_hybrid(name, rtn):
    _, te = _engines(name, rtn)
    with pytest.raises(NotImplementedError,
                       match="per-slot conv/recurrent state"):
        ContinuousBatchingEngine(te, max_batch=2, max_seq=MAX_SEQ)


def test_from_pretrained_of_a_qwen3next_export(rtn, tmp_path):
    out = rtn["tiny-qwen3next"][2].save_quantized(str(tmp_path / "e"),
                                                  "autoround")
    le = QuantizedLlama.from_pretrained(out, max_seq=MAX_SEQ, device="cpu")
    _, te = _engines("tiny-qwen3next", rtn)
    assert type(le.cfg) is tq.Qwen3NextConfig
    assert le.cfg == make_pair("tiny-qwen3next")[2]
    assert sorted(le.packed) == sorted(te.packed)
    assert le.params["blocks"][0]["dt_bias"].dtype == torch.float32
    p = np.random.default_rng(7).integers(0, 256, (2, 12))
    llog, lc = le.prefill(p)
    tlog, tc = te.prefill(p)
    torch.testing.assert_close(llog, tlog, rtol=FP16_SCALE_TOL,
                               atol=FP16_SCALE_TOL)
    tok = tlog.argmax(-1).to(torch.int32)
    torch.testing.assert_close(le.decode_step(tok, lc)[0],
                               te.decode_step(tok, tc)[0],
                               rtol=FP16_SCALE_TOL, atol=FP16_SCALE_TOL)


def test_qwen35_fused_directory_quantizes_and_serves_like_jax(tmp_path):
    """The JAX test's path: a ``qwen3_5_moe`` directory (fused stacks, an
    ``mtp.*`` tensor) → RTN W4A16 → the engine → ``generate``; tokens equal
    the JAX engine's, logits within 1e-4."""
    jcfg, jp = make_pair("tiny-qwen35moe")[:2]
    path = write_hf(jax.tree.map(np.asarray, jp), jcfg, str(tmp_path / "m"),
                    "qwen3_5_moe", fused=True)
    tparams, tcfg = th.load_hf_checkpoint(path, torch.float32, device="cpu")
    jparams, jcfg2 = jh.load_hf_checkpoint(path, jnp.float32)
    assert type(tcfg) is tq.Qwen35MoeConfig
    kw = dict(scheme="W4A16G32", iters=0)
    jres = JAutoRound((jparams, jcfg2), **kw).quantize(jnp.asarray(IDS[:4]))
    tres = AutoRound((tparams, tcfg), device="cpu", **kw).quantize(IDS[:4])
    assert "blocks.0.experts.0.w1" in tres.layers
    je = JQuantizedLlama.from_quantize_result(jres, jcfg2, max_seq=MAX_SEQ)
    te = QuantizedLlama.from_quantize_result(tres, tcfg, max_seq=MAX_SEQ,
                                             device="cpu")
    p = IDS[:2, :8]
    _close(je.prefill(jnp.asarray(p))[0], te.prefill(p)[0], LOGIT_TOL)
    want = np.asarray(je.generate(jnp.asarray(p), max_new_tokens=4))
    np.testing.assert_array_equal(te.generate(p, max_new_tokens=4).numpy(),
                                  want)
