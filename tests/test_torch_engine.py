"""Port parity for the slice end to end: RTN quantize → pack → prefill /
decode / greedy generate, against the JAX package on the same weights.

The config is packable (K % 1024 == 0 for g = 128) and the calibration
and prompt length is 512 with head_dim 128, so the port's flash routing
gate and the engine's packing and fusion all engage (their plain versions
run here, on CPU tensors).

Tolerances (fp32 throughout):
  * qdq, scales and int4 codes: exact (same IEEE operations);
  * logits: both sides sum the same fp32 products in different orders, so
    they agree to ~1e-6 of their O(1) magnitude; 1e-4 leaves margin;
  * int8 KV cache: the scales agree to a few fp32 ulps (rtol 1e-6); a
    cache code may differ by one where the fp32 value lies within rounding
    noise of a .5 boundary — at most 1 in 10^4 entries, never by more;
  * int8 decode logits: those rare one-code differences move the logits
    by ~1e-5; atol 1e-3 leaves margin;
  * fp8 (e4m3) KV cache: the scales as for int8 (rtol 1e-6); x / scale is
    the same IEEE division of values that agree to ~1e-6, so an e4m3 code
    differs only where that value lies within rounding noise of a
    midpoint between two codes, and then by one step (or +0 against -0):
    compared as bit patterns, at most 1 in 10^4 entries differ; the decode
    token's entries may also move further near 0, where e4m3 is finer
    than the step's own differences, while their values stay within 1e-4
    of the calibrated amax; the decode logits are held to the int8
    tolerance;
  * greedy tokens: equal, up to the first step whose JAX top-2 logit gap
    is below 1e-3 (where either choice is within the logit tolerance).
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.ops.qmatmul import unpack_w4_planes
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu_torch import AutoRound, QuantizedLlama, SamplingParams
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.ops.qmatmul import unpack_w4
from autoround_tpu_torch.serve.sampling import sample_token
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax

REPO = Path(__file__).resolve().parent.parent
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
GAP_TOL = 1e-3
SEQ = 512
MAX_SEQ = SEQ + 8


@pytest.fixture(scope="module")
def pair():
    jcfg = jl.LlamaConfig(vocab_size=256, hidden_size=1024,
                          intermediate_size=1024, num_layers=2, num_heads=8,
                          num_kv_heads=2, head_dim=128, rope_theta=1e4,
                          dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 256, (2, SEQ))
    prompts = rng.integers(0, 256, (2, SEQ))
    jres = JAutoRound((jp, jcfg), scheme="W4A16", iters=0,
                      quant_lm_head=True).quantize(jnp.asarray(calib))
    tres = AutoRound((tp, tcfg), scheme="W4A16", iters=0, quant_lm_head=True,
                     device="cpu").quantize(calib)
    return dict(jcfg=jcfg, tcfg=tcfg, jres=jres, tres=tres, prompts=prompts)


@pytest.fixture(scope="module")
def engines(pair):
    """kv_quant → (JAX engine, port engine), each built once."""
    built = {}

    def get(kv_quant):
        if kv_quant not in built:
            built[kv_quant] = (
                JQuantizedLlama.from_quantize_result(
                    pair["jres"], pair["jcfg"], max_seq=MAX_SEQ,
                    kv_quant=kv_quant),
                QuantizedLlama.from_quantize_result(
                    pair["tres"], pair["tcfg"], max_seq=MAX_SEQ,
                    kv_quant=kv_quant, device="cpu"))
        return built[kv_quant]
    return get


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               rtol=tol, atol=tol)


def test_rtn_qdq_and_scales_identical(pair):
    jl_, tl_ = pair["jres"].layers, pair["tres"].layers
    assert sorted(jl_) == sorted(tl_) and "lm_head" in tl_
    assert len(tl_) == 2 * 7 + 1
    for name in jl_:
        np.testing.assert_array_equal(np.asarray(jl_[name].qdq),
                                      tl_[name].qdq.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(jl_[name].scale),
                                      tl_[name].scale.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(pair["jres"].params["lm_head"]),
                                  pair["tres"].params["lm_head"].numpy())


def test_engine_codes_identical(engines):
    je, te = engines(None)
    keys = [f"blocks.{i}.{n}" for i in range(2)
            for n in ("qkv", "o_proj", "gate_up", "down_proj")] + ["lm_head"]
    assert sorted(te.packed) == sorted(keys)
    assert te.fused_splits["blocks.0.qkv"] == (1024, 256, 256)
    for k in keys:
        jqw, jsc = je.packed[k]
        tqw, tsc = te.packed[k]
        np.testing.assert_array_equal(np.asarray(unpack_w4_planes(jqw, 128)),
                                      unpack_w4(tqw).numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(jsc), tsc.numpy(), err_msg=k)
    # packed layers carry no dense copy
    assert te.params["lm_head"] is None
    assert te.params["blocks"][0]["q_proj"] is None


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_prefill_and_decode_logits_match(pair, engines, kv_quant):
    je, te = engines(kv_quant)
    prompts = pair["prompts"]
    jlog, jc = je.prefill(jnp.asarray(prompts))
    tlog, tc = te.prefill(prompts)
    _close(jlog, tlog, LOGIT_TOL)
    assert tc.length == SEQ and int(jc.length) == SEQ
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jlog2, jc2 = je.decode_step(jnp.asarray(tok), jc)
    tlog2, tc2 = te.decode_step(torch.from_numpy(tok), tc)
    _close(jlog2, tlog2, LOGIT_TOL if kv_quant is None else INT8_LOGIT_TOL)
    assert tc2.length == SEQ + 1
    if kv_quant == "int8":
        assert tc2.k.dtype == torch.int8
        for a, b in ((jc2.k_scale, tc2.k_scale), (jc2.v_scale, tc2.v_scale)):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6)
        for a, b in ((jc2.k, tc2.k), (jc2.v, tc2.v)):
            a = np.asarray(a).astype(np.int32)[:, :, :SEQ + 1]
            b = b.numpy().astype(np.int32)[:, :, :SEQ + 1]
            assert np.abs(a - b).max() <= 1
            assert (a != b).sum() <= a.size // 10_000
    if kv_quant == "fp8":
        assert tc2.k.dtype == torch.float8_e4m3fn
        for a, b in ((jc2.k_scale, tc2.k_scale), (jc2.v_scale, tc2.v_scale)):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6)
        for a, b in ((jc2.k, tc2.k), (jc2.v, tc2.v)):
            # e4m3 bit patterns (sign bit 7, magnitude bits 0-6): a code
            # that differs is +0 against -0 (x / scale within rounding noise
            # of 0) or a neighbour of the same sign (magnitudes one apart).
            # The decode token's entries come from activations that carry
            # the step's own differences (~1e-5 of a head's amax); near 0
            # e4m3 codes are finer than that, so there a code may also move
            # further while its value stays within 1e-4 of the calibrated
            # amax (qmax in scaled units; measured 1.8e-5)
            ab = np.asarray(a)[:, :, :SEQ + 1]
            bb = b[:, :, :SEQ + 1]
            near = np.zeros(ab.shape, bool)
            near[:, :, SEQ] = np.abs(ab[:, :, SEQ].astype(np.float32)
                                     - bb[:, :, SEQ].float().numpy()
                                     ) <= 1e-4 * 448.0
            ab = ab.view(np.uint8).astype(np.int32)
            bb = bb.view(torch.uint8).numpy().astype(np.int32)
            diff = ab != bb
            zeros = ((ab & 127) == 0) & ((bb & 127) == 0)
            step = (ab >> 7 == bb >> 7) & (np.abs(ab - bb) == 1)
            assert (zeros | step | near)[diff].all()
            assert diff.sum() <= ab.size // 10_000


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_greedy_tokens_match(pair, engines, kv_quant):
    je, te = engines(kv_quant)
    prompts = pair["prompts"]
    n_new = 6
    # JAX greedy loop, recording each step's top-2 logit gap
    logits, cache = je.prefill(jnp.asarray(prompts))
    toks, gaps = [], []
    for step in range(n_new):
        lg = np.asarray(logits, np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append((top2[:, 1] - top2[:, 0]).min())
        toks.append(lg.argmax(-1).astype(np.int32))
        if step < n_new - 1:
            logits, cache = je.decode_step(jnp.asarray(toks[-1]), cache)
    want = np.stack(toks, axis=1)
    got = te.generate(prompts, max_new_tokens=n_new).numpy()
    assert got.shape == (2, n_new) and got.dtype == np.int32
    first_close = next((i for i, g in enumerate(gaps) if g < GAP_TOL), n_new)
    assert first_close >= 1, gaps   # these seeds give gaps >= 6e-3
    np.testing.assert_array_equal(want[:, :first_close],
                                  got[:, :first_close])


def test_sampling_modes():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=gen)
    greedy = sample_token(logits, None, None)
    np.testing.assert_array_equal(greedy.numpy(),
                                  logits.argmax(-1).numpy())
    assert greedy.dtype == torch.int32
    top1 = sample_token(logits, torch.Generator().manual_seed(1),
                        SamplingParams(temperature=1.0, top_k=1))
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    nucleus = sample_token(logits, torch.Generator().manual_seed(1),
                           SamplingParams(temperature=0.7, top_p=1e-6))
    np.testing.assert_array_equal(nucleus.numpy(), greedy.numpy())
    sp = SamplingParams(temperature=1.0, top_k=10, top_p=0.9, seed=3)
    a = sample_token(logits, torch.Generator().manual_seed(3), sp)
    b = sample_token(logits, torch.Generator().manual_seed(3), sp)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    kept = torch.topk(logits, 10).indices
    assert all(int(t) in kept[i].tolist() for i, t in enumerate(a))


def test_unpackable_layers_serve_dense_and_other_kinds_raise():
    """hidden 64 < g = 128: those W4A16 layers serve their dense qdq (as
    in the JAX engine); down_proj (K = 128) packs, since the port's layout
    needs only K % g == 0.  A W8A16 result serves through its own kind (g =
    128 > K = 64: those layers dense too, down_proj packed); so does a
    W2A16 g128 result through the ``w2a16`` kind."""
    cfg = tl.CONFIG_PRESETS["tiny"]
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    res = AutoRound((p, cfg), iters=0, device="cpu").quantize(ids)
    eng = QuantizedLlama.from_quantize_result(res, cfg, max_seq=16,
                                              device="cpu")
    assert sorted(eng.packed) == ["blocks.0.down_proj", "blocks.1.down_proj"]
    assert eng.params["blocks"][0]["q_proj"] is not None
    logits, cache = eng.prefill(ids[:1])
    assert torch.isfinite(logits).all() and cache.length == 8
    res8 = AutoRound((p, cfg), scheme="W8A16", iters=0,
                     device="cpu").quantize(ids)
    eng8 = QuantizedLlama.from_quantize_result(res8, cfg, max_seq=16,
                                               device="cpu")
    assert sorted(eng8.packed) == ["blocks.0.down_proj", "blocks.1.down_proj"]
    assert set(eng8.packed_kinds.values()) == {"w8a16"}
    assert eng8.packed["blocks.0.down_proj"][0].dtype == torch.int8
    logits8, _ = eng8.prefill(ids[:1])
    dense8 = tl.model_fwd(res8.params, torch.as_tensor(ids[:1]), cfg)[:, -1]
    np.testing.assert_allclose(logits8.numpy(), dense8.numpy(), rtol=1e-4,
                               atol=1e-4)
    res2 = AutoRound((p, cfg), scheme="W2A16", iters=0,
                     device="cpu").quantize(ids)
    eng2 = QuantizedLlama.from_quantize_result(res2, cfg, max_seq=16,
                                               device="cpu")
    assert sorted(eng2.packed) == ["blocks.0.down_proj", "blocks.1.down_proj"]
    assert set(eng2.packed_kinds.values()) == {"w2a16"}
    logits2, _ = eng2.prefill(ids[:1])
    dense2 = tl.model_fwd(res2.params, torch.as_tensor(ids[:1]), cfg)[:, -1]
    np.testing.assert_allclose(logits2.numpy(), dense2.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_iters_positive_not_ported():
    """iters > 0 (SignRound) is ported; each of its options that is not
    raises when quantize runs, naming its ROADMAP item."""
    cfg = tl.CONFIG_PRESETS["tiny"]
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = np.zeros((2, 8), np.int64)
    assert AutoRound((p, cfg), iters=1, device="cpu").quantize(
        ids).loss_traces[0].shape == (1,)
    for kw, item in ((dict(optimizer="adam"), "A3"),
                     (dict(enable_alg_ext=True), "A3"),
                     (dict(nblocks=2), "A5"),
                     (dict(enable_awq=True), "A12")):
        with pytest.raises(NotImplementedError, match=item):
            AutoRound((p, cfg), iters=2, device="cpu", **kw).quantize(ids)


def test_device_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    cfg = tl.CONFIG_PRESETS["tiny"]
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        AutoRound((p, cfg), iters=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_params(cfg, torch.Generator().manual_seed(0))
    res = AutoRound((p, cfg), iters=0, device="cpu").quantize(
        np.zeros((1, 8), np.int64))
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantizedLlama.from_quantize_result(res, cfg, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"norm": np.ones(4, np.float32)}, cfg)


_IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|autoround_tpu)(\.|\s|,|$)"
    r"|from\s+(jax|autoround_tpu)(\.|\s))", re.M)


def test_import_isolation():
    code = ("import sys, autoround_tpu_torch, autoround_tpu_torch.utils."
            "convert\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'autoround_tpu' or "
            "m.startswith('autoround_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    files = list((REPO / "autoround_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        assert not _IMPORT_RE.search(text), f


# ---------------------------------------------- head shapes of the int8 decode
#
# The int8-KV decode kernel takes hd in (64, 128, 256) and any G = nh / n_kv
# from 1 to 8.  On the CPU the engine runs the kernel's plain version; these
# configs hold the engine at the head shapes the kernel gained (llama3.2-1b's
# hd 64 with G = 4, tied embeddings; G = 7 as in qwen2.5-7b) against the JAX
# engine, with the int8 cache, at the tolerances above.

DECODE_SHAPES = {"llama3.2-1b_hd64_G4": dict(num_heads=8, num_kv_heads=2,
                                             tie_embeddings=True),
                 "hd64_G7": dict(num_heads=14, num_kv_heads=2)}


@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
def test_int8_decode_head_shapes_match_jax(shape):
    jcfg = jl.LlamaConfig(vocab_size=128, hidden_size=256,
                          intermediate_size=512, num_layers=2, head_dim=64,
                          rope_theta=1e4, dtype=jnp.float32,
                          **DECODE_SHAPES[shape])
    jp = jl.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(1)
    calib = rng.integers(0, 128, (2, 16))
    prompts = rng.integers(0, 128, (2, 16))
    jres = JAutoRound((jp, jcfg), scheme="W4A16", iters=0,
                      quant_lm_head=True).quantize(jnp.asarray(calib))
    tres = AutoRound((tp, tcfg), scheme="W4A16", iters=0, quant_lm_head=True,
                     device="cpu").quantize(calib)
    je = JQuantizedLlama.from_quantize_result(jres, jcfg, max_seq=32,
                                              kv_quant="int8")
    te = QuantizedLlama.from_quantize_result(tres, tcfg, max_seq=32,
                                             kv_quant="int8", device="cpu")
    n_new = 6
    logits, cache = je.prefill(jnp.asarray(prompts))
    tlog, tcache = te.prefill(prompts)
    _close(logits, tlog, LOGIT_TOL)
    toks, gaps = [], []
    for step in range(n_new):
        lg = np.asarray(logits, np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append((top2[:, 1] - top2[:, 0]).min())
        toks.append(lg.argmax(-1).astype(np.int32))
        if step < n_new - 1:
            logits, cache = je.decode_step(jnp.asarray(toks[-1]), cache)
            tlog, tcache = te.decode_step(torch.from_numpy(toks[-1]), tcache)
            _close(logits, tlog, INT8_LOGIT_TOL)
    assert tcache.k.dtype == torch.int8 and tcache.k.shape[-1] == 64
    want = np.stack(toks, axis=1)
    got = te.generate(prompts, max_new_tokens=n_new).numpy()
    first_close = next((i for i, g in enumerate(gaps) if g < GAP_TOL), n_new)
    assert first_close >= 1, gaps
    np.testing.assert_array_equal(want[:, :first_close],
                                  got[:, :first_close])


@pytest.mark.parametrize("hd,nh,nkv", [(96, 8, 2), (128, 32, 2), (64, 6, 4),
                                       (32, 4, 4)])
def test_decode_gate_names_the_shape(hd, nh, nkv):
    """hd 96 / 32, G = 16 and a G that is not whole raise by name, both in
    the gate and where the engine builds an int8 cache on the card (before
    any tensor is made, so no card is needed to see it)."""
    from autoround_tpu_torch.ops.decode_attention import check_decode_shape
    from autoround_tpu_torch.serve.engine import _init_cache

    with pytest.raises(ValueError, match=f"head_dim={hd} num_heads={nh} "
                                         f"num_kv_heads={nkv}"):
        check_decode_shape(hd, nh, nkv)
    cfg = dataclasses.replace(tl.CONFIG_PRESETS["tiny"], head_dim=hd,
                              num_heads=nh, num_kv_heads=nkv)
    with pytest.raises(ValueError, match=f"head_dim={hd}"):
        _init_cache(cfg, 1, 16, cfg.num_layers, "int8", "cuda")


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", range(1, 9))
def test_decode_gate_takes_every_kernel_shape(hd, G):
    from autoround_tpu_torch.ops.decode_attention import check_decode_shape

    check_decode_shape(hd, 2 * G, 2)


@pytest.mark.parametrize("hd", [64, 96, 128, 256, 384, 512])
def test_flash_gate_is_the_jax_gate(hd):
    """The port routes where the JAX model does (hd % 128 == 0); a head
    dim the kernel does not take reaches ``flash_attention`` and raises
    there by name instead of running plain attention on the card."""
    from autoround_tpu_torch.ops.flash_attention import _check_qkv

    q = torch.zeros(1, 512, 2, hd)
    assert tl._flash_eligible(q, q, None) == (hd % 128 == 0)
    qb = torch.zeros(1, 2, 512, hd, dtype=torch.bfloat16)
    if hd in (128, 256):
        _check_qkv("flash_attention", qb, qb, qb, True)
    else:
        with pytest.raises(ValueError, match=f"D={hd}"):
            _check_qkv("flash_attention", qb, qb, qb, True)