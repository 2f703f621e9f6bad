"""Serving parity for MiniMax: the hybrid cache (K / V of the full layers,
the zero-width tails and the fp32 lightning states of the linear ones), the
prompt pass and the recurrent decode steps, ``generate_scan`` (a second
call with new prompts starts from its own state), per-slot positions, the
fused q / k / v of the full layers, the stacked experts and capacity
dispatch, ``kv_quant``'s warning, the batcher's refusal and
``from_pretrained``, against the JAX engine on the same RTN results
(``tests/test_torch_minimax.py``'s pairs).

Tolerances (fp32, CPU):
  * engine logits and caches against the JAX engine: 1e-4 (the port packs
    every projection at g = 32 and runs the fused q / k / v and the
    stacked experts; the JAX engine serves the same qdq weights dense);
  * the engine against ``model_fwd`` on the qdq weights: 1e-4;
  * per-slot positions against each slot alone: 1e-5;
  * tokens: equal;
  * ``from_pretrained`` against the in-memory engine: 1e-2 (fp16 scales in
    the files).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu import envs as jenvs
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models import minimax as tm
from autoround_tpu_torch.serve.batching import ContinuousBatchingEngine
from autoround_tpu_torch.serve.engine import (HybridCache, _fuser,
                                              _make_linear_fn)
from test_torch_minimax import IDS, PUBLISHED, make_pair
from _port_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-4
SLOT_TOL = 1e-5
FP16_SCALE_TOL = 1e-2
MAX_SEQ = 32
KINDS = (None, PUBLISHED)


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
    return {k: _rtn(make_pair(k)) for k in KINDS}


def _engines(kind, rtn, **kw):
    """(JAX engine, port engine) over the RTN results of ``kind``."""
    jres, tres, _ = rtn[kind]
    return (JQuantizedLlama.from_quantize_result(jres, make_pair(kind)[0],
                                                 max_seq=MAX_SEQ),
            QuantizedLlama.from_quantize_result(tres, make_pair(kind)[2],
                                                max_seq=MAX_SEQ,
                                                device="cpu", **kw))


def test_engine_packs_stacks_and_fuses(rtn):
    """Every block's experts stack for row 5; the full layers' q / k / v
    fuse into one entry split nh·hd / nkv·hd / nkv·hd; the lightning
    projections pack; no packed layer keeps a dense leaf; the cache's
    tails are zero-width, its states fp32 (nh, hd, hd)."""
    _, te = _engines(None, rtn)
    cfg = te.cfg
    stacked = sorted(k for k in te.packed if "experts_stack" in k)
    assert stacked == [f"blocks.{b}.experts_stack.{w}" for b in range(4)
                       for w in ("w1", "w2", "w3")]
    assert not any(".experts." in k for k in te.packed)
    split = (4 * 16, 2 * 16, 2 * 16)
    assert te.fused_splits == {"blocks.1.qkv": split, "blocks.3.qkv": split}
    assert {"blocks.0.qkv_proj", "blocks.0.out_proj", "blocks.0.output_gate",
            "blocks.1.o_proj", "lm_head"} <= set(te.packed)
    assert set(te.packed_kinds.values()) == {"w4a16", "w4a16_grouped"}
    b0, b1 = te.params["blocks"][0], te.params["blocks"][1]
    assert b0["qkv_proj"] is None and b0["output_gate"] is None
    assert b1["q_proj"] is None and b1["k_proj"] is None
    assert b0["slope_rate"].dtype == b0["attn_norm"].dtype == torch.float32
    _, cache = te.prefill(IDS[:2, :12])
    assert isinstance(cache, HybridCache) and cache.length == 12
    assert cache.k.shape == (2, 2, MAX_SEQ, cfg.num_kv_heads, cfg.hd)
    assert cache.conv.shape == (2, 2, 0, 0) and cache.conv.dtype == cfg.dtype
    assert cache.state.shape == (2, 2, 4, 16, 16)
    assert cache.state.dtype == torch.float32
    assert cache.pos.tolist() == [12, 12]


@pytest.mark.parametrize("S", [12, 5])
@pytest.mark.parametrize("kind", KINDS, ids=["alternating", "published"])
def test_prefill_and_decode_match_the_jax_engine(kind, S, rtn):
    """The prompt pass (its logits and every cache buffer) and three
    recurrent decode steps against the JAX engine; the last step also
    against ``model_fwd`` of the extended sequence on the qdq weights.
    S = 12 runs a chunk and a remainder, S = 5 a short chunk alone."""
    je, te = _engines(kind, rtn)
    p = np.random.default_rng(2).integers(0, 256, (2, S))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    _close(jc.k[:, :, :S], tc.k[:, :, :S], LOGIT_TOL)
    _close(jc.state, tc.state, LOGIT_TOL)
    assert np.asarray(jc.conv).shape == tuple(tc.conv.shape)
    seq = p
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(3):
        jlog, jc = je.decode_step(jnp.asarray(tok), jc)
        tlog, tc = te.decode_step(torch.from_numpy(tok), tc)
        _close(jlog, tlog, LOGIT_TOL)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    _close(jc.state, tc.state, LOGIT_TOL)
    _close(jc.k[:, :, :S + 3], tc.k[:, :, :S + 3], LOGIT_TOL)
    assert tc.pos.tolist() == [S + 3] * 2
    want = tm.model_fwd(rtn[kind][1].params, torch.from_numpy(seq),
                        make_pair(kind)[2])[:, -1]
    torch.testing.assert_close(tlog, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("kind", KINDS, ids=["alternating", "published"])
def test_generate_scan_equals_generate_and_jax(kind, rtn):
    """Two calls with new prompts of other lengths: the second starts from
    its own prompt's states, not the first call's last step's."""
    je, te = _engines(kind, rtn)
    rng = np.random.default_rng(3)
    for S in (10, 5):
        p = rng.integers(0, 256, (2, S))
        want = np.asarray(je.generate_scan(jnp.asarray(p), max_new_tokens=6))
        np.testing.assert_array_equal(te.generate_scan(p, max_new_tokens=6)
                                      .numpy(), want)
        np.testing.assert_array_equal(te.generate(p, max_new_tokens=6),
                                      want)


def test_per_slot_positions(rtn):
    """A decode step with slots at positions 7 and 11 (the full layer
    writes each slot's token at its own position and masks past it; the
    lightning state is per slot): each slot's output equals a step of that
    slot alone, and the tokens land where ``pos`` says."""
    _, te = _engines(None, rtn)
    cfg = te.cfg
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, (1, S)) for S in (7, 11)]
    caches = [te.prefill(p)[1] for p in prompts]
    tok = torch.tensor([3, 200], dtype=torch.int32)
    alone = [te.decode_step(tok[i:i + 1], c)[0] for i, c in
             enumerate(caches)]
    caches = [te.prefill(p)[1] for p in prompts]
    both = HybridCache(
        k=torch.cat([c.k for c in caches], dim=1),
        v=torch.cat([c.v for c in caches], dim=1),
        conv=torch.cat([c.conv for c in caches], dim=1),
        state=torch.cat([c.state for c in caches], dim=1),
        length=11, pos=torch.tensor([7, 11], dtype=torch.int32))
    logits, out = te.decode_step(tok, both)
    for i in range(2):
        torch.testing.assert_close(logits[i:i + 1], alone[i], rtol=SLOT_TOL,
                                   atol=SLOT_TOL)
    assert out.pos.tolist() == [8, 12]
    # the full layer's new keys sit at each slot's own position
    for i, S in enumerate((7, 11)):
        assert out.k[0, i, S].abs().sum() > 0
        assert out.k[0, i, S + 1:].abs().sum() == 0
    # the serving block at the same positions, dense against fused q/k/v
    x = torch.from_numpy(rng.standard_normal((2, 1, cfg.hidden_size))
                         .astype(np.float32))
    cos, sin = tl.rope_tables(cfg, 1, positions=both.pos)
    cos, sin = cos[:, None], sin[:, None]
    kv = [t.clone() for t in (both.k[1], both.v[1])]
    y_fused, _ = tm.block_with_cache(
        te.params["blocks"][3], x, cos, sin, cfg, ("full", *kv), both.pos,
        _make_linear_fn(te.packed, te.packed_kinds, 3),
        _fuser(te.packed, te.packed_kinds, te.fused_splits, 3))
    qdq = rtn[None][1].params["blocks"][3]
    kv = [t.clone() for t in (both.k[1], both.v[1])]
    y_dense, _ = tm.block_with_cache(qdq, x, cos, sin, cfg, ("full", *kv),
                                     both.pos, tl._plain_linear)
    torch.testing.assert_close(y_fused, y_dense, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_kv_quant_has_no_effect_on_the_hybrid_cache(rtn, caplog):
    """``kv_quant="int8"`` warns once and serves the dense hybrid cache,
    as the JAX engine's hybrid cores take no ``kv_quant``."""
    _, te = _engines(None, rtn)
    with caplog.at_level(logging.WARNING, logger="autoround_tpu"):
        _, t8 = _engines(None, rtn, kv_quant="int8")
    assert t8.kv_quant is None
    assert "kv_quant='int8' has no effect" in caplog.text
    p = IDS[:2, :12]
    l8, c8 = t8.prefill(p)
    l0, _ = te.prefill(p)
    assert c8.k.dtype == torch.float32 and c8.k_scale is None
    torch.testing.assert_close(l8, l0, rtol=0, atol=0)


def test_capacity_dispatch_in_the_engine(rtn, monkeypatch):
    """``moe_capacity_factor = E / k`` (nothing drops) against the JAX
    engine reading the same factor from its environment."""
    cfg = make_pair()[0]
    full = cfg.num_experts / cfg.top_k
    monkeypatch.setattr(jenvs, "AR_MOE_CAPACITY_FACTOR", full)
    je, te = _engines(None, rtn, moe_capacity_factor=full)
    p = np.random.default_rng(5).integers(0, 256, (2, 12))
    jlog, jc = je.prefill(jnp.asarray(p))
    tlog, tc = te.prefill(p)
    _close(jlog, tlog, LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    _close(je.decode_step(jnp.asarray(tok), jc)[0],
           te.decode_step(torch.from_numpy(tok), tc)[0], LOGIT_TOL)


def test_batcher_refuses_the_hybrid(rtn):
    _, te = _engines(None, rtn)
    with pytest.raises(NotImplementedError,
                       match="MiniMaxConfig needs per-slot conv/recurrent"):
        ContinuousBatchingEngine(te, max_batch=2, max_seq=MAX_SEQ)


def test_from_pretrained_of_a_minimax_export(rtn, tmp_path):
    out = rtn[None][2].save_quantized(str(tmp_path / "e"), "autoround")
    le = QuantizedLlama.from_pretrained(out, max_seq=MAX_SEQ, device="cpu")
    _, te = _engines(None, rtn)
    assert type(le.cfg) is tm.MiniMaxConfig and le.cfg == make_pair()[2]
    assert sorted(le.packed) == sorted(te.packed)
    b0 = le.params["blocks"][0]
    assert b0["slope_rate"].dtype == torch.float32
    torch.testing.assert_close(b0["slope_rate"],
                               te.params["blocks"][0]["slope_rate"], rtol=0,
                               atol=0)
    p = np.random.default_rng(7).integers(0, 256, (2, 12))
    llog, lc = le.prefill(p)
    tlog, tc = te.prefill(p)
    torch.testing.assert_close(llog, tlog, rtol=FP16_SCALE_TOL,
                               atol=FP16_SCALE_TOL)
    tok = tlog.argmax(-1).to(torch.int32)
    torch.testing.assert_close(le.decode_step(tok, lc)[0],
                               te.decode_step(tok, tc)[0],
                               rtol=FP16_SCALE_TOL, atol=FP16_SCALE_TOL)
