"""Port parity for serving the DeepSeek family (``serve/engine.py``'s MLA
path, ``serve/batching.py``'s MLA slots): the compressed latent cache
(bf16 / int8 / fp8), prompt pass and absorbed decode against the JAX
engine, ``generate_scan`` against ``generate``, per-slot positions, the
continuous batcher, capacity dispatch and ``from_pretrained`` of a DeepSeek
export, on ``tiny-deepseek``, ``tiny-deepseek-v2`` and ``tiny-glmlite``
(the weights of ``tests/test_torch_deepseek.py``'s ``make_pair``, RTN
W4A16 g32 with the lm_head in both packages).

The port packs every projection but ``kv_b_proj`` at g = 32 (the routed
experts stacked for the grouped kernel's plain version), where the JAX
engine's TPU tiles take none of these shapes and serve the same qdq
weights dense: the products agree to fp32 summation order.

Tolerances (fp32, CPU):
  * logits: 1e-4 (of O(1) logits; measured ~1e-6);
  * bf16-dtype cache (fp32 here) contents: 1e-5;
  * int8 / fp8 latent codes: at least 99.9% equal and the rest one step
    apart (a latent within rounding of a code boundary: the latents agree
    to fp32 order); scales rtol 1e-6;
  * tokens: equal;
  * ``from_pretrained`` against the in-memory engine: the files store fp16
    scales, which move each weight by up to 2^-11 of itself (measured
    1.2e-4 on the logits); held to 1e-2, as
    ``tests/test_torch_from_pretrained.py`` holds it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu import envs as jenvs
from autoround_tpu.models import deepseek as jd
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.batching import ContinuousBatchingEngine as JCB
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.models import deepseek as td
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.serve.batching import ContinuousBatchingEngine
from test_torch_deepseek import NAMES, make_pair
from _port_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
CODES_EQUAL_MIN = 0.999
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


def _codes_close(j, t):
    """Latent codes (int8, or e4m3 compared as their values)."""
    a = np.asarray(j.astype(jnp.float32) if j.dtype != jnp.int8 else j,
                   np.float32)
    b = t.float().numpy() if t.dtype != torch.int8 else t.numpy().astype(
        np.float32)
    same = a == b
    assert same.mean() >= CODES_EQUAL_MIN, same.mean()
    if t.dtype == torch.int8:
        assert np.abs(a - b).max() <= 1
    else:                       # one e4m3 step: at most 1/8 of the value
        assert (np.abs(a - b) <= np.abs(a) / 8 + 1e-30).all()


@pytest.mark.parametrize("name", NAMES)
def test_engine_layout_and_latent_cache_shapes(name, served):
    s = served[name]
    cfg = s["tcfg"]
    for kv_quant, dt in ((None, torch.float32), ("int8", torch.int8),
                         ("fp8", torch.float8_e4m3fn)):
        _, te = _engines(s, kv_quant)
        assert te.fused_splits == {}                   # nothing fuses
        assert not any(k.endswith((".qkv", ".gate_up")) for k in te.packed)
        assert not any("kv_b_proj" in k for k in te.packed)
        for bi in range(cfg.num_layers):
            # kv_b_proj serves from its qdq leaf
            assert torch.equal(te.params["blocks"][bi]["kv_b_proj"],
                               s["tres"].layers[f"blocks.{bi}.kv_b_proj"].qdq)
        stacked = sorted(k for k in te.packed if "experts_stack" in k)
        assert stacked == [f"blocks.{b}.experts_stack.{w}" for b in (1, 2)
                           for w in ("down_proj", "gate_proj", "up_proj")]
        assert not any(".experts." in k for k in te.packed)
        assert "blocks.0.gate_proj" in te.packed and "lm_head" in te.packed
        assert "blocks.1.shared_experts.up_proj" in te.packed
        logits, cache = te.prefill(np.arange(16).reshape(2, 8))
        L = cfg.num_layers
        assert cache.k.shape == (L, 2, MAX_SEQ, 1, cfg.kv_lora_rank)
        assert cache.v.shape == (L, 2, MAX_SEQ, 1, cfg.qk_rope_head_dim)
        assert cache.k.dtype == cache.v.dtype == dt
        if kv_quant:
            assert cache.k_scale.shape == cache.v_scale.shape == (
                L, 1, 1, 1, 1)
        assert cache.length == 8 and cache.pos.tolist() == [8, 8]
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
    for step in range(2):
        jlog, jc = je.decode_step(jnp.asarray(tok), jc)
        tlog, tc = te.decode_step(torch.from_numpy(tok), tc)
        _close(jlog, tlog, LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    # the two decode tokens' latents, written at positions 8 and 9
    if kv_quant is None:
        _close(jc.k[:, :, 8:10], tc.k[:, :, 8:10], CACHE_TOL)
    else:
        _codes_close(jc.k[:, :, 8:10], tc.k[:, :, 8:10])
        _codes_close(jc.v[:, :, 8:10], tc.v[:, :, 8:10])
    assert int(jc.length) == tc.length == 10


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
    # a second call reuses the static buffers
    np.testing.assert_array_equal(te.generate_scan(p, max_new_tokens=6),
                                  got)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_block_with_cache_per_slot_positions(quant, served):
    """One decode token per slot at its own position, against the JAX
    block's per-slot form; a 0-d position equals equal entries."""
    cfg, jcfg = served["tiny-deepseek"]["tcfg"], served["tiny-deepseek"][
        "jcfg"]
    _, jp, _, tp = make_pair("tiny-deepseek")
    rng = np.random.default_rng(4)
    B, T = 3, 12
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    ckv = rng.standard_normal((B, T, 1, r)).astype(np.float32)
    kr = rng.standard_normal((B, T, 1, dr)).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.hidden_size)).astype(np.float32)
    pos = np.array([3, 11, 0], np.int32)
    jc, js = jd.rope_tables(jcfg, 1, positions=jnp.asarray(pos))
    tc, ts = td.rope_tables(cfg, 1, positions=torch.from_numpy(pos))
    if quant is None:
        jkv = (jnp.asarray(ckv), jnp.asarray(kr))
        tkv = (torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy()))
    else:
        dt, jdt, qmax = ((torch.int8, jnp.int8, 127.0) if quant == "int8"
                         else (torch.float8_e4m3fn, jnp.float8_e4m3fn,
                               448.0))
        cs, rs = np.float32(0.02), np.float32(0.03)
        cq = np.clip(ckv / cs * 20, -qmax, qmax)
        rq = np.clip(kr / rs * 20, -qmax, qmax)
        if quant == "int8":
            cq, rq = np.round(cq), np.round(rq)
        jcq, jrq = jnp.asarray(cq).astype(jdt), jnp.asarray(rq).astype(jdt)
        jkv = (quant, jcq, jrq, jnp.asarray(cs), jnp.asarray(rs))
        tkv = (quant, torch.from_numpy(cq).to(dt), torch.from_numpy(rq).to(dt),
               torch.tensor(cs), torch.tensor(rs))
    blk_j, blk_t = jp["blocks"][1], tp["blocks"][1]
    jo, jckv, jkr = jd.block_with_cache(blk_j, jnp.asarray(x), jc[:, None],
                                        js[:, None], jcfg, jkv,
                                        jnp.asarray(pos),
                                        jd.llama._plain_linear)
    to, tckv, tkr = td.block_with_cache(blk_t, torch.from_numpy(x),
                                        tc[:, None], ts[:, None], cfg, tkv,
                                        torch.from_numpy(pos),
                                        tl._plain_linear)
    _close(jo, to, LOGIT_TOL)
    _close(jckv, tckv, CACHE_TOL)
    _close(jkr, tkr, CACHE_TOL)
    # the token's latents were written in place at each slot's position
    buf = tkv[-4] if quant else tkv[0]
    if quant is None:
        for b in range(B):
            _close(jckv[b], buf[b, pos[b]], CACHE_TOL)
    # a 0-d position is every slot's
    p0 = torch.tensor(5, dtype=torch.int32)
    c0, s0 = td.rope_tables(cfg, 1, positions=p0.expand(B))
    tkv2 = tuple(t.clone() if isinstance(t, torch.Tensor) else t
                 for t in tkv)
    tkv3 = tuple(t.clone() if isinstance(t, torch.Tensor) else t
                 for t in tkv)
    a = td.block_with_cache(blk_t, torch.from_numpy(x), c0[:, None],
                            s0[:, None], cfg, tkv2, p0, tl._plain_linear)[0]
    b = td.block_with_cache(blk_t, torch.from_numpy(x), c0[:, None],
                            s0[:, None], cfg, tkv3, p0.expand(B).clone(),
                            tl._plain_linear)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_batcher_slots_equal_single_requests(name, served):
    """The JAX ``TestMlaContinuousBatching`` case: two requests in a 4-slot
    batcher give ``generate``'s tokens alone, and the JAX batcher's."""
    s = served[name]
    je, te = _engines(s)
    te.max_seq = je.max_seq = 64
    cb = ContinuousBatchingEngine(te, max_batch=4, max_seq=64,
                                  prompt_buckets=(8, 16))
    assert cb.cache.k.shape == (s["tcfg"].num_layers, 4, 64, 1,
                                s["tcfg"].kv_lora_rank)
    assert cb.cache.v.shape[-1] == s["tcfg"].qk_rope_head_dim
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
        if steps == 2:       # a late join beside the running requests
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
    s = served["tiny-deepseek"]
    full = s["tcfg"].n_routed_experts / s["tcfg"].num_experts_per_tok
    _, base = _engines(s)
    monkeypatch.setattr(jenvs, "AR_MOE_CAPACITY_FACTOR", full)
    je, te = _engines(s, moe_capacity_factor=full)
    p = np.random.default_rng(5).integers(0, 256, (2, 8))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    blog, bc = base.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    torch.testing.assert_close(tlog, blog, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jlog2, _ = je.decode_step(jnp.asarray(tok), jc)
    tlog2, _ = te.decode_step(torch.from_numpy(tok), tc)
    _close(jlog2, tlog2, LOGIT_TOL)


def test_from_pretrained_of_a_deepseek_export(served, tmp_path):
    s = served["tiny-deepseek"]
    ar = AutoRound.__new__(AutoRound)      # save what the fixture made
    ar.result, ar.model_cfg, ar.tokenizer = s["tres"], s["tcfg"], None
    out = ar.save_quantized(str(tmp_path / "e"), "autoround")
    le = QuantizedLlama.from_pretrained(out, max_seq=MAX_SEQ, device="cpu",
                                        kv_quant="int8")
    _, te = _engines(s, "int8")
    assert type(le.cfg) is td.DeepseekConfig
    assert le.cfg == dataclasses.replace(s["tcfg"], dtype=torch.float32)
    assert sorted(le.packed) == sorted(te.packed)
    assert not any("kv_b_proj" in k for k in le.packed)
    # the files store fp16 scales: words equal, scales rounded
    for k, (qw, sc) in te.packed.items():
        assert torch.equal(le.packed[k][0], qw), k
        assert torch.equal(le.packed[k][1], sc.half().float()), k
    for bi in range(s["tcfg"].num_layers):
        a = le.params["blocks"][bi]["kv_b_proj"]
        b = te.params["blocks"][bi]["kv_b_proj"]
        assert (a - b).abs().max() <= 2.0 ** -11 * b.abs().max()
    p = np.random.default_rng(6).integers(0, 256, (2, 8))
    llog, lc = le.prefill(p)
    tlog, tc = te.prefill(p)
    torch.testing.assert_close(llog, tlog, rtol=FP16_SCALE_TOL,
                               atol=FP16_SCALE_TOL)
    tok = tlog.argmax(-1).to(torch.int32)
    torch.testing.assert_close(le.decode_step(tok, lc)[0],
                               te.decode_step(tok, tc)[0],
                               rtol=FP16_SCALE_TOL, atol=FP16_SCALE_TOL)
    assert os.path.exists(os.path.join(out, "quantization_config.json"))
