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


@pytest.mark.parametrize("kv_quant", [None, "int8"])
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


@pytest.mark.parametrize("kv_quant", [None, "int8"])
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
    needs only K % g == 0.  A W8A16 result needs a kernel not ported yet."""
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
    with pytest.raises(NotImplementedError, match="w8a16"):
        QuantizedLlama.from_quantize_result(res8, cfg, max_seq=16,
                                            device="cpu")


def test_iters_positive_not_ported():
    cfg = tl.CONFIG_PRESETS["tiny"]
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="A3"):
        AutoRound((p, cfg), iters=10, device="cpu")


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
