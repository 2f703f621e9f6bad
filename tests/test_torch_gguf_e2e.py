"""Port parity of GGUF quantization end to end (``AutoRound(scheme=
"GGUF:...")``: the cascade plan, the token embedding quantized up front
and the quantized chain re-cached from it, RTN and SignRound with
``enable_alg_ext`` / ``use_imatrix``, the layers' double-quant payloads,
the fake export) and of W4FP8 / the float zero point, against the JAX
package; and the packed engine on a GGUF result.

``tiny`` widened to hidden 256 / MLP 256 (the k-quants' 256-wide
super-blocks need it; at 64 every layer falls back to Q8_0; MLP 256
rather than 512 leaves the JAX side two weight shapes to compile its
searches for instead of four, and every layer still takes a k-quant),
one KV head, fp32, CPU.  Tolerances:
  * RTN without an imatrix: every qdq, scale, zero point and payload
    tensor bit-equal, fake export byte-equal;
  * RTN with ``use_imatrix``: the imatrix (a mean of squared block inputs,
    which differ in their last bits between the packages) within 1e-5
    relative (measured 1.4e-6), so at least 99.8% of each layer's codes
    equal;
  * SignRound: loss traces within 5e-6 relative at every step, as the
    other slices hold them (``lr`` 0.01: at the default 1 / iters a step
    moves a rounding offset so far that one gradient entry cancelling to
    rounding noise parts the traces, as queue C records for W4A16 too).
    ``NOISE_FLIP`` names the steps that leave the band.
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
from autoround_tpu.models.registry import ALL_PRESETS as JPRESETS
from autoround_tpu.models.registry import get_model_fns as j_model_fns
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.export import codes_from_qdq, save_quantized
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.models.registry import get_model_fns
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401

WIDE = dict(hidden_size=256, intermediate_size=256, num_kv_heads=1)
TRACE_RTOL = 5e-6
CODES_EQUAL_MIN = 0.998
IDS = np.random.default_rng(1).integers(0, 256, (8, 32))
# Q4_K_M with the head: block 1 from step 1 (measured 1.6e-5, then 1.0e-4
# and 1.7e-4; block 0 stays within 1.9e-7); held to 1e-2.  Block 1's tuned
# q_proj parts from JAX's in 0.06% of its codes: rounding offsets whose
# gradient is rounding noise, which sign-SGD steps the other way (queue
# C's "seen, not a fault"; at MLP 512 block 0 left the band from step 2
# and block 1 from step 0, held to the same 1e-2)
NOISE_FLIP = {("GGUF:Q4_K_M", 1): (1, 1e-2)}


def _pair(preset, **over):
    jcfg = dataclasses.replace(JPRESETS[preset], **over)
    jp = j_model_fns(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu")


@pytest.fixture(scope="module")
def wide():
    return _pair("tiny", **WIDE)


def _both(pair, ids=IDS, **kw):
    jcfg, jp, tcfg, tp = pair
    jar = JAutoRound((jp, jcfg), **kw)
    jres = jar.quantize(jnp.asarray(ids))
    ar = AutoRound((tp, tcfg), device="cpu", **kw)
    return jar, jres, ar, ar.quantize(ids)


def _codes(ql, jax_side):
    f = (lambda a: np.asarray(a, np.float32)) if jax_side else \
        (lambda t: t.float().numpy())
    zp = None if ql.zp is None else f(ql.zp)
    return codes_from_qdq(f(ql.qdq), f(ql.scale), zp, ql.scheme.bits,
                          ql.scheme.group_size)


def _same_plan(jar, ar):
    assert {k: v.key() for k, v in ar.layer_schemes.items()} == \
        {k: v.key() for k, v in jar.layer_schemes.items()}


@pytest.fixture(scope="module")
def rtn_q4km(wide):
    return _both(wide, scheme="GGUF:Q4_K_M", iters=0, quant_lm_head=True)


def test_rtn_bit_equal_with_payloads(rtn_q4km):
    """Q4_K_M RTN: the plan (Q6_K head and embedding, Q4_K elsewhere at
    two blocks), every layer and its double-quant payload bit-equal, the
    embedding's qdq in the result's params."""
    jar, jres, ar, tres = rtn_q4km
    _same_plan(jar, ar)
    assert ar.layer_schemes["embed_tokens"].key() == "w6_g16_sym_int_dq"
    assert ar.layer_schemes["lm_head"].key() == "w6_g16_sym_int_dq"
    assert list(tres.layers) == list(jres.layers)
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        for a, b in ((jq.qdq, tq.qdq), (jq.scale, tq.scale),
                     (jq.zp, tq.zp)):
            if a is None:
                assert b is None, name
            else:
                np.testing.assert_array_equal(
                    b.float().numpy(), np.asarray(a, np.float32),
                    err_msg=name)
        assert sorted(tq.extras) == sorted(jq.extras), name
        for k, v in jq.extras.items():
            if isinstance(v, (bool, int)):
                assert tq.extras[k] == v
            else:
                np.testing.assert_array_equal(tq.extras[k].numpy(),
                                              np.asarray(v), err_msg=k)
    assert torch.equal(tres.params["embed_tokens"],
                       tres.layers["embed_tokens"].qdq)


def test_fake_export_bytes_equal_jax(rtn_q4km, tmp_path):
    jar, jres, ar, tres = rtn_q4km
    jd, td = tmp_path / "jax", tmp_path / "port"
    j_save(jres, jar.model_cfg, str(jd), format="fake")
    save_quantized(tres, ar.model_cfg, str(td), format="fake")
    for f in sorted(os.listdir(jd)):
        assert filecmp.cmp(jd / f, td / f, shallow=False), f
    # packed export of a double-quant layer refuses, as in JAX
    with pytest.raises(NotImplementedError, match="int_dq"):
        save_quantized(tres, ar.model_cfg, str(tmp_path / "p"),
                       format="autoround")


def test_rtn_imatrix_codes_like_jax(wide):
    jar, jres, ar, tres = _both(wide, scheme="GGUF:Q4_K_M", iters=0,
                                use_imatrix=True)
    _same_plan(jar, ar)
    assert sorted(tres.imatrices) == sorted(jres.imatrices)
    for k, v in jres.imatrices.items():
        np.testing.assert_allclose(tres.imatrices[k], v, rtol=1e-5,
                                   atol=1e-12)
    for name, jq in jres.layers.items():
        same = np.mean(_codes(tres.layers[name], False) == _codes(jq, True))
        assert same >= CODES_EQUAL_MIN, (name, same)


@pytest.mark.parametrize("scheme,kw", [
    # asym Q4_K with the sym Q6_K head (and embedding) tuned
    ("GGUF:Q4_K_M", dict(quant_lm_head=True)),
    ("GGUF:Q2_K_S", dict(enable_alg_ext=True, use_imatrix=True)),
])
def test_signround_traces_like_jax(wide, scheme, kw):
    """The tuned block losses step for step; block 0's first loss reads
    the chain re-cached from the quantized embedding on both sides."""
    jar, jres, ar, tres = _both(wide, scheme=scheme, iters=4, batch_size=4,
                                lr=0.01, seed=0, **kw)
    _same_plan(jar, ar)
    assert sorted(tres.loss_traces) == sorted(jres.loss_traces) == [0, 1]
    for bi, jt in jres.loss_traces.items():
        tt, jt = tres.loss_traces[bi], np.asarray(jt)
        step, band = NOISE_FLIP.get((scheme, bi), (len(jt), 0.0))
        np.testing.assert_allclose(tt[:step], jt[:step], rtol=TRACE_RTOL)
        np.testing.assert_allclose(tt[step:], jt[step:], rtol=band)
    flipped = any(k[0] == scheme for k in NOISE_FLIP)
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        same = np.mean(_codes(tq, False) == _codes(jq, True))
        assert same >= (0.9 if flipped else CODES_EQUAL_MIN), (name, same)
        assert (tq.extras is None) == (jq.extras is None), name
    if kw.get("use_imatrix"):
        assert sorted(tres.imatrices) == sorted(jres.imatrices)
    # the quantized chain starts from the qdq embedding, the FP chain from
    # the FP one: the first loss is the embedding's damage through block 0
    tcfg, tp = ar.model_cfg, ar.params
    emb = tres.layers["embed_tokens"].qdq
    assert not torch.equal(emb, tp["embed_tokens"])


@pytest.mark.parametrize("scheme", [
    dict(bits=4, group_size=32, sym=True, data_type="w4fp8"),
    dict(bits=4, group_size=32, sym=False, data_type="int_asym_float_zp"),
])
def test_w4fp8_and_float_zp_quantize_like_jax(scheme, tmp_path):
    pair = _pair("tiny")
    jar, jres, ar, tres = _both(pair, scheme=scheme, iters=0,
                                quant_lm_head=True)
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(tres.layers[name].qdq.numpy(),
                                      np.asarray(jq.qdq), err_msg=name)
    j_save(jres, jar.model_cfg, str(tmp_path / "j"), format="fake")
    save_quantized(tres, ar.model_cfg, str(tmp_path / "t"), format="fake")
    for f in sorted(os.listdir(tmp_path / "j")):
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f
    # tuned: a few steps run through the registry's tuned entries
    res = AutoRound((pair[3], pair[2]), scheme=scheme, iters=2,
                    batch_size=4, device="cpu").quantize(IDS[:4])
    assert all(np.isfinite(t).all() for t in res.loss_traces.values())


def test_q2k_mixed_on_moe_and_the_packed_engine():
    """GGUF:Q2_K_MIXED on ``tiny-moe`` widened: the routed experts Q2_K,
    the rest Q4_K_S, lm_head and embedding Q8_0, codes bit-equal to JAX's
    RTN; the engine packs each kind its scheme maps to (Q2_K / Q4_K asym
    through row 9 with the fractional zero point, the Q8_0 head through
    row 11 at g32) and its logits follow the qdq model's."""
    pair = _pair("tiny-moe", **WIDE)
    jar, jres, ar, tres = _both(pair, scheme="GGUF:Q2_K_MIXED", iters=0)
    _same_plan(jar, ar)
    plan = ar.layer_schemes
    assert plan["blocks.0.experts.0.w1"].key() == "w2_g16_asym_int_dq"
    assert plan["blocks.0.q_proj"].key() == "w4_g32_asym_int_dq"
    assert plan["lm_head"].key() == plan["embed_tokens"].key() == \
        "w8_g32_sym_int"
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(tres.layers[name].qdq.numpy(),
                                      np.asarray(jq.qdq), err_msg=name)
    eng = QuantizedLlama.from_quantize_result(tres, ar.model_cfg,
                                              max_seq=48, device="cpu")
    kinds = set(eng.packed_kinds.values())
    assert {"w4a16_asym", "w8a16"} <= kinds
    assert eng.packed_kinds["lm_head"] == "w8a16"
    prompts = torch.as_tensor(IDS[:2, :12])
    logits, _ = eng.prefill(prompts)
    fns = get_model_fns(ar.model_cfg)
    with torch.no_grad():
        want = fns.model_fwd(tres.params, prompts, ar.model_cfg)[:, -1]
    np.testing.assert_allclose(logits.float().numpy(), want.float().numpy(),
                               rtol=2e-3, atol=2e-3)


def test_q3k_sym_codes_serve_through_w4a16(wide):
    """Q3_K (sym, signed 3-bit codes, g16, a negative d̂ allowed) packs as
    ``w4a16``, the head too (no ``_M`` upgrade); prefill follows the qdq
    model."""
    jcfg, jp, tcfg, tp = wide
    tres = AutoRound((tp, tcfg), scheme="GGUF:Q3_K_S", iters=0,
                     quant_lm_head=True, device="cpu").quantize(IDS)
    eng = QuantizedLlama.from_quantize_result(tres, tcfg, max_seq=48,
                                              device="cpu")
    assert eng.packed_kinds["blocks.0.qkv"] == "w4a16"
    assert eng.packed_kinds["lm_head"] == "w4a16"   # Q3_K: no upgrade
    prompts = torch.as_tensor(IDS[:2, :12])
    logits, _ = eng.prefill(prompts)
    with torch.no_grad():
        want = tl.model_fwd(tres.params, prompts, tcfg)[:, -1]
    np.testing.assert_allclose(logits.float().numpy(), want.float().numpy(),
                               rtol=2e-3, atol=2e-3)
