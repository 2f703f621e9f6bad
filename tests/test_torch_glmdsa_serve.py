"""Port parity for serving GLM-5 DSA: the MLA engine over the compressed
latent cache with dense attention (not the lightning indexer's subset),
its warning, the prompt pass and absorbed decode with bf16-dtype (fp32
here) and int8 latents against the JAX engine, ``generate_scan`` against
``generate``, the continuous batcher against the JAX batcher and
``from_pretrained`` of a GLM-5 export, on the weights of
``tests/test_torch_glmdsa.py``'s ``make_pair`` (RTN W4A16 g32 with the
lm_head in both packages).  The indexer's ``q_proj`` / ``k_proj`` pack like
any layer and are never read, as the JAX engine keeps them.

Tolerances (fp32, CPU): logits 1e-4; latent cache 1e-5; int8 latent codes
at least 99.9% equal and the rest one step apart, scales rtol 1e-6;
tokens equal; ``from_pretrained`` against the in-memory engine 1e-2 (fp16
scales in the files).
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.batching import ContinuousBatchingEngine as JCB
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.models import deepseek as td
from autoround_tpu_torch.models import glmdsa as tdsa
from autoround_tpu_torch.serve.batching import ContinuousBatchingEngine
from test_torch_deepseek_serve import _codes_close
from test_torch_glmdsa import make_pair
from _port_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
SCALE_RTOL = 1e-6
FP16_SCALE_TOL = 1e-2
MAX_SEQ = 32
NAME = "tiny-glmdsa-shared"


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def served():
    ids = np.random.default_rng(1).integers(0, 256, (4, 16))
    jcfg, jp, tcfg, tp = make_pair(NAME)
    kw = dict(scheme="W4A16G32", iters=0, quant_lm_head=True)
    jres = JAutoRound((jp, jcfg), **kw).quantize(jnp.asarray(ids))
    tres = AutoRound((tp, tcfg), device="cpu", **kw).quantize(ids)
    return dict(jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres)


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


def _engines(s, kv_quant=None):
    return (_jax_engine(s["jres"], s["jcfg"], kv_quant, False),
            QuantizedLlama.from_quantize_result(
                s["tres"], s["tcfg"], max_seq=MAX_SEQ, kv_quant=kv_quant,
                device="cpu"))


def test_engine_warns_dense_mla_and_keeps_the_indexer(served, caplog):
    with caplog.at_level(logging.WARNING, logger="autoround_tpu"):
        _, te = _engines(served)
    assert any("DENSE MLA" in r.message and "top-8" in r.message
               for r in caplog.records)
    cfg = served["tcfg"]
    assert te.fused_splits == {}
    for bi in range(cfg.num_layers):
        assert f"blocks.{bi}.indexer.q_proj" in te.packed
        assert te.params["blocks"][bi]["indexer"]["weights_proj"] is not None
    logits, cache = te.prefill(np.arange(16).reshape(2, 8))
    assert cache.k.shape == (cfg.num_layers, 2, MAX_SEQ, 1, cfg.kv_lora_rank)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_prefill_and_decode_match_the_jax_engine(kv_quant, served):
    je, te = _engines(served, kv_quant)
    p = np.random.default_rng(2).integers(0, 256, (2, 12))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    if kv_quant is None:
        _close(jc.k[:, :, :12], tc.k[:, :, :12], CACHE_TOL)
    else:
        np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale),
                                   rtol=SCALE_RTOL)
        _codes_close(jc.k[:, :, :12], tc.k[:, :, :12])
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(2):
        jlog, jc = je.decode_step(jnp.asarray(tok), jc)
        tlog, tc = te.decode_step(torch.from_numpy(tok), tc)
        _close(jlog, tlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


def test_generate_scan_equals_generate_and_jax(served):
    je, te = _engines(served, "int8")
    p = np.random.default_rng(3).integers(0, 256, (2, 5))
    want = np.asarray(je.generate_scan(jnp.asarray(p), max_new_tokens=6))
    got = te.generate_scan(p, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(te.generate(p, max_new_tokens=6).numpy(),
                                  want)


def test_batcher_slots_equal_single_requests(served):
    je, te = _engines(served)
    te.max_seq = je.max_seq = 64
    cb = ContinuousBatchingEngine(te, max_batch=4, max_seq=64,
                                  prompt_buckets=(8, 16))
    jcb = JCB(je, max_batch=4, max_seq=64, prompt_buckets=(8, 16))
    prompts = [[3, 5, 7], [11, 2, 9, 4, 1]]
    rids = [cb.submit(p, max_new_tokens=5) for p in prompts]
    jrids = [jcb.submit(p, max_new_tokens=5) for p in prompts]
    while cb.pending():
        cb.step()
        jcb.step()
    while jcb.pending():
        jcb.step()
    for p, rid, jrid in zip(prompts, rids, jrids):
        want = te.generate(torch.tensor([p]), max_new_tokens=5)[0].tolist()
        assert cb.result(rid) == want
        assert cb.result(rid) == list(map(int, jcb.result(jrid)))


def test_from_pretrained_of_a_glmdsa_export(served, tmp_path):
    ar = AutoRound.__new__(AutoRound)      # save what the fixture made
    ar.result, ar.model_cfg, ar.tokenizer = (served["tres"], served["tcfg"],
                                             None)
    out = ar.save_quantized(str(tmp_path / "e"), "autoround")
    le = QuantizedLlama.from_pretrained(out, max_seq=MAX_SEQ, device="cpu",
                                        kv_quant="int8")
    _, te = _engines(served, "int8")
    assert type(le.cfg) is tdsa.GlmMoeDsaConfig and td.is_mla(le.cfg)
    assert le.cfg == dataclasses.replace(served["tcfg"], dtype=torch.float32)
    assert sorted(le.packed) == sorted(te.packed)
    p = np.random.default_rng(6).integers(0, 256, (2, 8))
    llog, lc = le.prefill(p)
    tlog, tc = te.prefill(p)
    torch.testing.assert_close(llog, tlog, rtol=FP16_SCALE_TOL,
                               atol=FP16_SCALE_TOL)
