"""Port parity for the Llama-family flags in serving: the packed engine
(prefill, decode with the dense and the int8 KV cache, greedy ``generate``
and ``generate_scan``) and the continuous batcher, against the JAX package
on ``tiny-qwen``, ``tiny-qwen3``, ``tiny-gemma2`` with an 8-token window
and ``tiny-gemma3`` (window 8, local rope on its sliding layers), their
biases and gains moved off their initial values
(``test_torch_families.perturbed_params``).

RTN W4A16 g32 with the lm_head quantized: the port packs every projection
(hidden 64 and intermediate 128 tile at g = 32) and fuses q/k/v, so the
biases add after the fused product; the JAX engine serves the same qdq
weights dense (its TPU tiles need K % 1024).  Prompts of 12 tokens and 6
decode steps run past the window at prefill (the sliding mask) and at
every decode step (the decode kernel's ``window`` on the int8 cache, the
per-slot mask on the dense one).

Tolerances (fp32 throughout, as in ``tests/test_torch_engine.py``):
  * logits: the packed product's plain version sums the same fp32 products
    as the dense qdq weights in another order; 1e-4 (``LOGIT_TOL``) with
    the dense cache, 1e-3 (``INT8_LOGIT_TOL``) with the int8 cache, where
    a code may differ by one at a .5 boundary;
  * greedy tokens: equal to the JAX engine's up to the first step whose
    JAX top-2 logit gap is below ``GAP_TOL`` (either choice is within the
    logit tolerance there); ``generate_scan`` equals ``generate`` exactly,
    and the batcher equals ``generate`` exactly (the same ops on each
    slot's data).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.batching import \
    ContinuousBatchingEngine as JContinuousBatchingEngine
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.serve import ContinuousBatchingEngine
from test_torch_batching import SCHEDULE, _run_schedule
from test_torch_families import family_pair

LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
GAP_TOL = 1e-3
PROMPT, N_NEW, MAX_SEQ = 12, 6, 32

CONFIGS = {
    "tiny-qwen": jl.CONFIG_PRESETS["tiny-qwen"],
    "tiny-qwen3": jl.CONFIG_PRESETS["tiny-qwen3"],
    "tiny-gemma2-window8": dataclasses.replace(
        jl.CONFIG_PRESETS["tiny-gemma2"], sliding_window=8),
    "tiny-gemma3": jl.CONFIG_PRESETS["tiny-gemma3"],
}


@pytest.fixture(scope="module")
def served():
    """name → (JAX config, JAX result, port config, port result)."""
    built = {}

    def get(name):
        if name not in built:
            jcfg = CONFIGS[name]
            jp, tcfg, tp = family_pair(jcfg, seed=1)
            calib = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                                      (2, 16))
            kw = dict(scheme="W4A16G32", iters=0, quant_lm_head=True)
            built[name] = (
                jcfg, JAutoRound((jp, jcfg), **kw).quantize(
                    jnp.asarray(calib)),
                tcfg, AutoRound((tp, tcfg), device="cpu", **kw).quantize(
                    calib))
        return built[name]
    return get


@pytest.fixture(scope="module")
def engines(served):
    """(name, kv_quant) → (JAX engine, port engine, JAX greedy run: tokens
    (B, N_NEW), each step's logits and least top-2 gap)."""
    built = {}

    def get(name, kv_quant):
        key = (name, kv_quant)
        if key not in built:
            jcfg, jres, tcfg, tres = served(name)
            je = JQuantizedLlama.from_quantize_result(
                jres, jcfg, max_seq=MAX_SEQ, kv_quant=kv_quant)
            te = QuantizedLlama.from_quantize_result(
                tres, tcfg, max_seq=MAX_SEQ, kv_quant=kv_quant, device="cpu")
            prompts = np.random.default_rng(8).integers(
                0, jcfg.vocab_size, (2, PROMPT))
            logits, cache = je.prefill(jnp.asarray(prompts))
            toks, lgs, gaps = [], [], []
            for step in range(N_NEW):
                lg = np.asarray(logits, np.float32)
                top2 = np.sort(lg, axis=-1)[:, -2:]
                gaps.append((top2[:, 1] - top2[:, 0]).min())
                lgs.append(lg)
                toks.append(lg.argmax(-1).astype(np.int32))
                if step < N_NEW - 1:
                    logits, cache = je.decode_step(jnp.asarray(toks[-1]),
                                                   cache)
            built[key] = (je, te, dict(prompts=prompts, logits=lgs,
                                       toks=np.stack(toks, 1), gaps=gaps))
        return built[key]
    return get


CASES = [(n, kv) for n in CONFIGS for kv in (None, "int8")]


@pytest.mark.parametrize("name,kv_quant", CASES)
def test_prefill_and_decode_logits_match(engines, name, kv_quant):
    """Prefill logits and the logits of every decode step (fed the JAX
    engine's greedy tokens), past the window; the packed q/k/v fuse, so
    the biases add after the fused product."""
    je, te, run = engines(name, kv_quant)
    assert "blocks.0.qkv" in te.packed and "lm_head" in te.packed
    tol = LOGIT_TOL if kv_quant is None else INT8_LOGIT_TOL
    logits, cache = te.prefill(run["prompts"])
    for step in range(N_NEW):
        np.testing.assert_allclose(run["logits"][step], logits.numpy(),
                                   rtol=tol, atol=tol, err_msg=str(step))
        if step < N_NEW - 1:
            logits, cache = te.decode_step(
                torch.from_numpy(run["toks"][:, step]), cache)
    assert cache.length == PROMPT + N_NEW - 1
    if CONFIGS[name].final_logit_softcap:
        assert logits.abs().max() < CONFIGS[name].final_logit_softcap


@pytest.mark.parametrize("name,kv_quant", CASES)
def test_greedy_tokens_and_generate_scan(engines, name, kv_quant):
    je, te, run = engines(name, kv_quant)
    got = te.generate(run["prompts"], max_new_tokens=N_NEW)
    first_close = next((i for i, g in enumerate(run["gaps"]) if g < GAP_TOL),
                       N_NEW)
    assert first_close >= 1, run["gaps"]
    np.testing.assert_array_equal(run["toks"][:, :first_close],
                                  got.numpy()[:, :first_close])
    scan = te.generate_scan(run["prompts"], max_new_tokens=N_NEW)
    assert torch.equal(scan, got)


@pytest.mark.parametrize("name", ["tiny-qwen3", "tiny-gemma2-window8"])
def test_quirky_arch_matches_plain_generate(engines, name):
    """``tests/test_batching.py::TestBatchingModelQuirks``: the batcher
    inherits every flag from the shared block (a request alone in the
    batch gives ``generate``'s tokens)."""
    _, te, _ = engines(name, None)
    prompt = [3, 5, 7, 11, 2]
    eng = ContinuousBatchingEngine(te, max_batch=2, max_seq=64,
                                   prompt_buckets=(8, 16))
    rid = eng.submit(prompt, max_new_tokens=8)
    while eng.pending():
        eng.step()
    want = te.generate(np.asarray([prompt]), max_new_tokens=8)[0]
    assert eng.result(rid) == want.tolist()


def test_gemma3_schedule_matches_jax_batcher(engines):
    """tiny-gemma3 through the interleaved schedule of
    ``tests/test_torch_batching.py`` (an 11-token prompt in the 16 bucket:
    the window bites at prefill and decode) on both batchers."""
    je, te, _ = engines("tiny-gemma3", None)
    kw = dict(max_batch=2, max_seq=64, prompt_buckets=(8, 16))
    want, _ = _run_schedule(JContinuousBatchingEngine(je, **kw))
    got, _ = _run_schedule(ContinuousBatchingEngine(te, **kw))
    for (_, prompt, n), w, g in zip(SCHEDULE, want, got):
        assert len(g) == n
        logits, cache = je.prefill(jnp.asarray([prompt]))
        gaps = []
        for step in range(n):
            lg = np.sort(np.asarray(logits, np.float32)[0])
            gaps.append(lg[-1] - lg[-2])
            if step < n - 1:
                logits, cache = je.decode_step(
                    jnp.asarray([w[step]], jnp.int32), cache)
        first_close = next((i for i, gap in enumerate(gaps)
                            if gap < GAP_TOL), n)
        assert first_close >= 1, gaps
        assert g[:first_close] == w[:first_close]
