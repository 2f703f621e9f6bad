"""Continuous batching in the port (``autoround_tpu_torch/serve/batching``),
mirroring ``tests/test_batching.py`` and held against the JAX batcher.

The four tests of ``TestContinuousBatching`` run on the port's own tiny
W4A16 engine: a batcher's greedy tokens equal ``generate``'s exactly, and
requests are independent of what else shares the batch (fp32 on the CPU;
the same ops on each slot's data).  One interleaved schedule runs through
the port's batcher and the JAX batcher on the same weights: equal greedy
tokens, up to the first step whose JAX top-2 logit gap is below
``GAP_TOL`` (there either choice is within the logit tolerance); the
prompt pass and first decode step of a request in the batch against the
same prompt alone through ``prefill`` / ``decode_step``, within
``LOGIT_TOL`` (the padded bucket and the shared batch change only the
order of fp32 sums).

``TestBatchingModelQuirks`` of the JAX suite (``tiny-qwen3``,
``tiny-gemma2``) and tiny-gemma3 against the JAX batcher are in
``tests/test_torch_families_serve.py``, with the Llama-family flags.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.batching import \
    ContinuousBatchingEngine as JContinuousBatchingEngine
from autoround_tpu_torch import AutoRound, QuantizedLlama, SamplingParams
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.serve import ContinuousBatchingEngine, Request
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-4
GAP_TOL = 1e-3


@pytest.fixture(scope="module")
def model():
    cfg = tl.CONFIG_PRESETS["tiny"]
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
    res = AutoRound((params, cfg), scheme="W4A16", iters=0,
                    device="cpu").quantize(ids)
    return QuantizedLlama.from_quantize_result(res, cfg, max_seq=64,
                                               device="cpu"), cfg


def _drain(eng):
    while eng.pending():
        eng.step()


class TestContinuousBatching:
    def test_single_request_matches_plain_generate(self, model):
        qm, cfg = model
        eng = ContinuousBatchingEngine(qm, max_batch=4, max_seq=64,
                                       prompt_buckets=(8, 16))
        prompt = [3, 5, 7, 11]
        rid = eng.submit(prompt, max_new_tokens=6)
        _drain(eng)
        want = qm.generate(np.asarray([prompt]), max_new_tokens=6)[0]
        assert eng.result(rid) == want.tolist()

    def test_interleaved_requests_independent(self, model):
        qm, cfg = model
        p1, p2 = [1, 2, 3], [9, 8, 7, 6, 5]
        solo = {}
        for p in (p1, p2):
            e = ContinuousBatchingEngine(qm, max_batch=4, max_seq=64,
                                         prompt_buckets=(8, 16))
            rid = e.submit(p, max_new_tokens=5)
            _drain(e)
            solo[tuple(p)] = e.result(rid)
        eng = ContinuousBatchingEngine(qm, max_batch=4, max_seq=64,
                                       prompt_buckets=(8, 16))
        r1 = eng.submit(p1, max_new_tokens=5)
        r2 = eng.submit(p2, max_new_tokens=5)
        _drain(eng)
        assert eng.result(r1) == solo[tuple(p1)]
        assert eng.result(r2) == solo[tuple(p2)]

    def test_slot_reuse_after_finish(self, model):
        qm, cfg = model
        eng = ContinuousBatchingEngine(qm, max_batch=2, max_seq=64,
                                       prompt_buckets=(8,))
        a = eng.submit([1, 2], max_new_tokens=2)
        b = eng.submit([3, 4], max_new_tokens=8)
        with pytest.raises(RuntimeError):
            eng.submit([5], max_new_tokens=2)  # batch full
        while len(eng.result(a)) < 2:
            eng.step()
        # a finished → slot free → new request joins while b still runs
        c = eng.submit([5, 6], max_new_tokens=3)
        _drain(eng)
        assert len(eng.result(b)) == 8
        assert len(eng.result(c)) == 3

    def test_late_join_does_not_change_running_request(self, model):
        qm, cfg = model
        eng = ContinuousBatchingEngine(qm, max_batch=4, max_seq=64,
                                       prompt_buckets=(8,))
        r1 = eng.submit([2, 4, 6], max_new_tokens=8)
        for _ in range(3):
            eng.step()
        partial = list(eng.result(r1))
        eng.submit([7, 7, 7], max_new_tokens=4)  # joins mid-flight
        _drain(eng)
        assert eng.result(r1)[: len(partial)] == partial
        solo = ContinuousBatchingEngine(qm, max_batch=4, max_seq=64,
                                        prompt_buckets=(8,))
        rs = solo.submit([2, 4, 6], max_new_tokens=8)
        _drain(solo)
        assert eng.result(r1) == solo.result(rs)


def test_eos_and_sampling(model):
    """EOS ends a request early and frees its slot; a sampled batcher is
    deterministic in its seed."""
    qm, cfg = model
    eng = ContinuousBatchingEngine(qm, max_batch=2, max_seq=64,
                                   prompt_buckets=(8,))
    rid = eng.submit([3, 1, 4], max_new_tokens=6)
    _drain(eng)
    first = eng.result(rid)
    eos = first[2]
    eng = ContinuousBatchingEngine(qm, max_batch=2, max_seq=64,
                                   prompt_buckets=(8,), eos_token=eos)
    rid = eng.submit([3, 1, 4], max_new_tokens=6)
    _drain(eng)
    stop = first.index(eos) + 1
    assert eng.result(rid) == first[:stop] and eng._free == [1, 0]
    sp = SamplingParams(temperature=1.0, top_k=20, seed=11)
    runs = []
    for _ in range(2):
        e = ContinuousBatchingEngine(qm, max_batch=2, max_seq=64,
                                     prompt_buckets=(8,), sampling=sp)
        r = [e.submit([3, 1, 4], 6), e.submit([2, 7], 5)]
        _drain(e)
        runs.append([e.result(i) for i in r])
    assert runs[0] == runs[1]
    assert [len(t) for t in runs[0]] == [6, 5]


def test_refusals(model):
    qm, cfg = model
    eng = ContinuousBatchingEngine(qm, max_batch=2, max_seq=16,
                                   prompt_buckets=(8,))
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit(list(range(9)), max_new_tokens=2)      # no bucket
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit([1, 2, 3], max_new_tokens=14)          # past max_seq
    assert isinstance(eng._requests[1], Request)

    class Qwen3NextConfig(tl.LlamaConfig):
        pass

    odd = dataclasses.replace(
        qm, cfg=Qwen3NextConfig(**dataclasses.asdict(cfg)))
    with pytest.raises(NotImplementedError, match="A item 5"):
        ContinuousBatchingEngine(odd, max_batch=2, max_seq=16)


@pytest.fixture(scope="module")
def jax_pair():
    jcfg = jl.LlamaConfig(vocab_size=256, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=4,
                          num_kv_heads=2, head_dim=64, rope_theta=1e4,
                          dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(5))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    calib = np.random.default_rng(5).integers(0, 256, (2, 32))
    jres = JAutoRound((jp, jcfg), scheme="W4A16", iters=0).quantize(
        jnp.asarray(calib))
    tres = AutoRound((tp, tcfg), scheme="W4A16", iters=0,
                     device="cpu").quantize(calib)
    return (JQuantizedLlama.from_quantize_result(jres, jcfg, max_seq=64),
            QuantizedLlama.from_quantize_result(tres, tcfg, max_seq=64,
                                                device="cpu"))


# (step at which a request joins, prompt, new tokens): the second joins
# after two steps of the first, the third after the first has finished
SCHEDULE = [(0, [5, 17, 33, 2, 9], 6), (2, [40, 41, 42, 43, 44, 45, 46, 47,
                                            48, 49, 50], 8),
            (7, [7, 7, 3], 5)]


def _run_schedule(eng, logits_of=None):
    """Drive SCHEDULE; returns the results in order (and, with
    ``logits_of``, that request's prompt-pass and first decode logits)."""
    rids, seen = [], []
    for t in range(40):
        for join, prompt, n in SCHEDULE:
            if join == t:
                rids.append(eng.submit(prompt, max_new_tokens=n))
                if logits_of == len(rids) - 1:
                    slot = eng._requests[rids[-1]].slot
                    seen.append(eng.last_logits[slot].clone())
        if not eng.pending() and len(rids) == len(SCHEDULE):
            break
        eng.step()
        if logits_of is not None and len(seen) == 1:
            seen.append(eng.last_logits[slot].clone())
    return [eng.result(r) for r in rids], seen


def test_interleaved_schedule_matches_jax_batcher(jax_pair):
    je, te = jax_pair
    kw = dict(max_batch=2, max_seq=64, prompt_buckets=(8, 16))
    want, _ = _run_schedule(JContinuousBatchingEngine(je, **kw))
    got, _ = _run_schedule(ContinuousBatchingEngine(te, **kw))
    for (_, prompt, n), w, g in zip(SCHEDULE, want, got):
        assert len(g) == n
        # the JAX engine's greedy loop on the prompt alone gives the gaps
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


def test_batched_logits_match_a_request_alone(jax_pair):
    """The second request of SCHEDULE joins a running batch: its prompt
    pass (bucket 16, padded) and its first decode step (beside another
    slot) against the same prompt alone through prefill / decode_step."""
    _, te = jax_pair
    _, seen = _run_schedule(ContinuousBatchingEngine(
        te, max_batch=2, max_seq=64, prompt_buckets=(8, 16)), logits_of=1)
    prompt = SCHEDULE[1][1]
    logits, cache = te.prefill(np.asarray([prompt]))
    np.testing.assert_allclose(seen[0].numpy(), logits[0].numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    tok = logits.argmax(-1).to(torch.int32)
    logits, _ = te.decode_step(tok, cache)
    np.testing.assert_allclose(seen[1].numpy(), logits[0].numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
