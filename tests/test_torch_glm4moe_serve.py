"""Port parity for serving GLM-4.5 (``serve/engine.py``'s GQA path with the
DeepSeek router, ``serve/batching.py``): the fused q/k/v with its biases
added after the fused product, the dense block 0's fused gate / up, the
routed experts stacked for the grouped kernel, the prompt pass and decode
over a dense, int8 and fp8 K / V cache against the JAX engine,
``generate_scan`` against ``generate``, the continuous batcher, capacity
dispatch and ``from_pretrained`` of a GLM-4.5 export, on ``tiny-glm4moe``
and its G = 12 variant (the weights of ``tests/test_torch_glm4moe.py``'s
``make_pair``, RTN W4A16 g32 with the lm_head in both packages).

At G = 12 the int8 cache's step runs ``decode_attention_plain`` here (the
CPU tensor's plain version of the hand-written kernel) and
``decode_attention_ref`` in the JAX engine (its op gives G > 8 to the
reference); at G = 2 the JAX engine's Pallas kernel runs in interpret
mode.  The port packs every projection at g = 32, where the JAX engine's
TPU tiles take none of these shapes and serve the same qdq weights dense:
the products agree to fp32 summation order.

Tolerances (fp32, CPU):
  * logits: 1e-4 (of O(1) logits);
  * dense cache contents: 1e-5; int8 / fp8 codes: at least 99.9% equal,
    the rest one step apart (a value within rounding of a code boundary);
    scales rtol 1e-6;
  * tokens: equal;
  * ``from_pretrained`` against the in-memory engine: 1e-2 (the files
    store fp16 scales, as ``tests/test_torch_from_pretrained.py`` holds
    it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu import envs as jenvs
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.batching import ContinuousBatchingEngine as JCB
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.models import glm4moe as tg
from autoround_tpu_torch.serve.batching import ContinuousBatchingEngine
from test_torch_deepseek_serve import _codes_close
from test_torch_glm4moe import NAMES, make_pair
from _port_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
SCALE_RTOL = 1e-6
FP16_SCALE_TOL = 1e-2
MAX_SEQ = 32


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def served():
    ids = np.random.default_rng(1).integers(0, 256, (4, 16))
    out = {}
    for name in NAMES:
        jcfg, jp, tcfg, tp = make_pair(name)
        kw = dict(scheme="W4A16G32", iters=0, quant_lm_head=True)
        jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(ids))
        tres = AutoRound((tp, tcfg), device="cpu", **kw).quantize(ids)
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres)
    return out


# one JAX engine per result and cache kind, shared by the tests that read
# it (each compiles its prefill / decode once); a keyword (a capacity run,
# which the JAX engine reads from its environment as it traces) builds anew
_JAX_ENGINES = {}


def _jax_engine(jres, jcfg, kv_quant, fresh):
    if fresh:
        return JQuantizedLlama.from_quantize_result(
            jres, jcfg, max_seq=MAX_SEQ, kv_quant=kv_quant)
    key = (id(jres), kv_quant)
    hit = _JAX_ENGINES.get(key)
    if hit is None or hit[0] is not jres:
        eng = JQuantizedLlama.from_quantize_result(
            jres, jcfg, max_seq=MAX_SEQ, kv_quant=kv_quant)
        hit = _JAX_ENGINES[key] = (jres, eng)
    return hit[1]


def _engines(s, kv_quant=None, **kw):
    return (_jax_engine(s["jres"], s["jcfg"], kv_quant, bool(kw)),
            QuantizedLlama.from_quantize_result(
                s["tres"], s["tcfg"], max_seq=MAX_SEQ, kv_quant=kv_quant,
                device="cpu", **kw))


def test_engine_layout(served):
    s = served["tiny-glm4moe-g12"]
    cfg = s["tcfg"]
    _, te = _engines(s, "int8")
    qd, kvd = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    for bi in range(cfg.num_layers):
        assert te.fused_splits[f"blocks.{bi}.qkv"] == (qd, kvd, kvd)
        # the biases stay dense leaves, added after the fused product
        assert te.params["blocks"][bi]["q_bias"] is not None
    assert te.fused_splits["blocks.0.gate_up"] == (cfg.intermediate_size,) * 2
    stacked = sorted(k for k in te.packed if "experts_stack" in k)
    assert stacked == [f"blocks.{b}.experts_stack.{w}" for b in (1, 2)
                       for w in ("down_proj", "gate_proj", "up_proj")]
    assert not any(".experts." in k for k in te.packed)
    assert "blocks.1.shared_experts.up_proj" in te.packed
    assert "blocks.1.gate_up" not in te.fused_splits   # shared: not fused
    logits, cache = te.prefill(np.arange(16).reshape(2, 8))
    assert cache.k.shape == (cfg.num_layers, 2, MAX_SEQ, 1, cfg.hd)
    assert cache.k.dtype == torch.int8
    assert logits.shape == (2, cfg.vocab_size)


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_the_jax_engine(name, kv_quant, served):
    je, te = _engines(served[name], kv_quant)
    p = np.random.default_rng(2).integers(0, 256, (2, 8))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    if kv_quant is None:
        _close(jc.k[:, :, :8], tc.k[:, :, :8], CACHE_TOL)
        _close(jc.v[:, :, :8], tc.v[:, :, :8], CACHE_TOL)
    else:
        for a, b in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=SCALE_RTOL)
        _codes_close(jc.k[:, :, :8], tc.k[:, :, :8])
        _codes_close(jc.v[:, :, :8], tc.v[:, :, :8])
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(3):
        jlog, jc = je.decode_step(jnp.asarray(tok), jc)
        tlog, tc = te.decode_step(torch.from_numpy(tok), tc)
        _close(jlog, tlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    if kv_quant is None:
        _close(jc.k[:, :, 8:11], tc.k[:, :, 8:11], CACHE_TOL)
    else:
        _codes_close(jc.k[:, :, 8:11], tc.k[:, :, 8:11])
        _codes_close(jc.v[:, :, 8:11], tc.v[:, :, 8:11])
    assert int(jc.length) == tc.length == 11


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_generate_scan_equals_generate_and_jax(name, kv_quant, served):
    je, te = _engines(served[name], kv_quant)
    p = np.random.default_rng(3).integers(0, 256, (2, 5))
    want = np.asarray(je.generate_scan(jnp.asarray(p), max_new_tokens=6))
    got = te.generate_scan(p, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(te.generate(p, max_new_tokens=6).numpy(),
                                  want)
    np.testing.assert_array_equal(te.generate_scan(p, max_new_tokens=6),
                                  got)


@pytest.mark.parametrize("name", NAMES)
def test_batcher_slots_equal_single_requests(name, served):
    """Two requests in a 4-slot batcher, a third joining late, give
    ``generate``'s tokens alone and the JAX batcher's."""
    s = served[name]
    je, te = _engines(s)
    te.max_seq = je.max_seq = 64
    cb = ContinuousBatchingEngine(te, max_batch=4, max_seq=64,
                                  prompt_buckets=(8, 16))
    assert cb.cache.k.shape == (s["tcfg"].num_layers, 4, 64,
                                s["tcfg"].num_kv_heads, s["tcfg"].hd)
    jcb = JCB(je, max_batch=4, max_seq=64, prompt_buckets=(8, 16))
    prompts = [[3, 5, 7], [11, 2, 9, 4, 1]]
    rids = [cb.submit(p, max_new_tokens=5) for p in prompts]
    jrids = [jcb.submit(p, max_new_tokens=5) for p in prompts]
    late = None
    steps = 0
    while cb.pending():
        cb.step()
        jcb.step()
        steps += 1
        if steps == 2:
            late = (cb.submit([7, 7, 1, 2], max_new_tokens=4),
                    jcb.submit([7, 7, 1, 2], max_new_tokens=4))
    while jcb.pending():
        jcb.step()
    for p, rid, jrid in zip(prompts + [[7, 7, 1, 2]], rids + [late[0]],
                            jrids + [late[1]]):
        n = len(cb.result(rid))
        want = te.generate(torch.tensor([p]), max_new_tokens=n)[0].tolist()
        assert cb.result(rid) == want
        assert cb.result(rid) == list(map(int, jcb.result(jrid)))


def test_capacity_dispatch_in_the_engine(served, monkeypatch):
    """``moe_capacity_factor = E / k``: nothing drops, the default route's
    logits; the JAX engine takes the factor from its environment."""
    s = served["tiny-glm4moe-g12"]
    full = s["tcfg"].n_routed_experts / s["tcfg"].num_experts_per_tok
    _, base = _engines(s, "int8")
    monkeypatch.setattr(jenvs, "AR_MOE_CAPACITY_FACTOR", full)
    je, te = _engines(s, "int8", moe_capacity_factor=full)
    p = np.random.default_rng(5).integers(0, 256, (2, 8))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    blog, _ = base.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    torch.testing.assert_close(tlog, blog, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jlog2, _ = je.decode_step(jnp.asarray(tok), jc)
    tlog2, _ = te.decode_step(torch.from_numpy(tok), tc)
    _close(jlog2, tlog2, LOGIT_TOL)


def test_from_pretrained_of_a_glm4moe_export(served, tmp_path):
    s = served["tiny-glm4moe-g12"]
    ar = AutoRound.__new__(AutoRound)      # save what the fixture made
    ar.result, ar.model_cfg, ar.tokenizer = s["tres"], s["tcfg"], None
    out = ar.save_quantized(str(tmp_path / "e"), "autoround")
    le = QuantizedLlama.from_pretrained(out, max_seq=MAX_SEQ, device="cpu",
                                        kv_quant="int8")
    _, te = _engines(s, "int8")
    assert type(le.cfg) is tg.Glm4MoeConfig
    assert le.cfg == dataclasses.replace(s["tcfg"], dtype=torch.float32)
    assert sorted(le.packed) == sorted(te.packed)
    assert le.fused_splits == te.fused_splits
    p = np.random.default_rng(6).integers(0, 256, (2, 8))
    llog, lc = le.prefill(p)
    tlog, tc = te.prefill(p)
    torch.testing.assert_close(llog, tlog, rtol=FP16_SCALE_TOL,
                               atol=FP16_SCALE_TOL)
    tok = tlog.argmax(-1).to(torch.int32)
    torch.testing.assert_close(le.decode_step(tok, lc)[0],
                               te.decode_step(tok, tc)[0],
                               rtol=FP16_SCALE_TOL, atol=FP16_SCALE_TOL)
