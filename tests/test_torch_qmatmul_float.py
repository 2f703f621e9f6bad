"""Port parity for the float and 2-bit serving kinds (``fp8``, ``mxfp4_g32``,
``mxfp4_g16``, ``w2a16``): the plain versions of ``fp8_matmul``,
``mxfp4_matmul`` and ``w2a16_matmul`` against the JAX package's ``*_ref``
functions, the packing helpers, ``packed_from_jax``, and a Llama quantized
with FP8_STATIC, MXFP4, NVFP4 and W2A16 served through those kinds against
the JAX engine.

The CUDA kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against the plain versions there);
here each wrapper is called on CPU tensors, which is exactly when it takes
its plain version.  Inputs are made with numpy from a seed and handed to
both packages; packed words are built from the same codes in each
package's own layout.

Tolerances (fp32 on the CPU unless stated):
  * the products: both sides dequantize with the same fp32 operations and
    sum K products in different orders: 1e-4 of an O(1) output at K <= 2048;
  * bf16 activations: both round the dequantized weight and the output to
    bf16; equal up to one bf16 ulp of the output (rtol 2^-7);
  * engine codes, e4m3 bytes and scales: exact;
  * logits: 1e-4 (as ``tests/test_torch_engine.py``); greedy tokens equal up
    to the first step whose JAX top-2 gap is below 1e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.ops import qmatmul_ext as jext
from autoround_tpu.ops.qmatmul import pack_w4_planes
from autoround_tpu.schemes import parse_scheme as j_parse
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu.serve.engine import _encode_e2m1
from autoround_tpu.serve.engine import _serving_kind as j_kind
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.ops.qmatmul import pack_w4, unpack_w4
from autoround_tpu_torch.ops.qmatmul_ext import (
    decode_e2m1, fp8_matmul, fp8_matmul_plain, mxfp4_matmul, pack_w2,
    unpack_w2, w2a16_matmul)
from autoround_tpu_torch.schemes import parse_scheme
from autoround_tpu_torch.serve.engine import (_serving_kind,
                                              e2m1_codes_from_qdq,
                                              fp8_from_qdq, w2_codes_from_qdq)
from autoround_tpu_torch.utils.convert import (config_from_jax,
                                               packed_from_jax,
                                               params_from_jax, unpack_planes)

PROD_TOL = 1e-4
BF16_RTOL = 2.0 ** -7
LOGIT_TOL = 1e-4
GAP_TOL = 1e-3


def _bf16_close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=BF16_RTOL)


# ------------------------------------------------------------ plain products

@pytest.mark.parametrize("g", [128, 256])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_w2a16_plain_matches_ref(lead, g):
    rng = np.random.default_rng(g + len(lead))
    O, K = 96, 16 * g
    codes = rng.integers(0, 4, (O, K)).astype(np.int32)
    scales = rng.uniform(-0.02, 0.02, (O, K // g)).astype(np.float32)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    jqw = jext.pack_w2_planes(jnp.asarray(codes), g)
    want = jext.w2a16_matmul_ref(jnp.asarray(x), jqw, jnp.asarray(scales), g)
    tqw, tsc = packed_from_jax((np.asarray(jqw), scales), "w2a16", "cpu")
    assert torch.equal(tqw, pack_w2(torch.from_numpy(codes)))
    got = w2a16_matmul(torch.from_numpy(x), tqw, tsc, g)
    assert got.shape == (*lead, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PROD_TOL,
                               atol=PROD_TOL)
    xb = jnp.asarray(x, jnp.bfloat16)
    _bf16_close(w2a16_matmul(torch.from_numpy(x).bfloat16(), tqw, tsc, g),
                jext.w2a16_matmul_ref(xb, jqw, jnp.asarray(scales), g))


def _e4m3(rng, O, K):
    w = np.clip(rng.standard_normal((O, K)) * 60, -448, 448)
    w[0, :4] = (0.0, 2.0 ** -9, -448.0, 3 * 2.0 ** -9)   # zero, subnormals
    return w.astype(ml_dtypes.float8_e4m3fn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_fp8_plain_matches_ref(lead, dtype):
    rng = np.random.default_rng(len(lead))
    O, K = 96, 1024
    wf8 = _e4m3(rng, O, K)
    scales = rng.uniform(1e-4, 0.01, (O,)).astype(np.float32)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    want = jext.fp8_matmul_ref(jnp.asarray(x, dtype), jnp.asarray(wf8),
                               jnp.asarray(scales))
    twf, tsc = packed_from_jax((wf8, scales), "fp8", "cpu")
    assert twf.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(twf.view(torch.uint8).numpy(),
                                  wf8.view(np.uint8))
    got = fp8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), twf, tsc)
    assert got.shape == (*lead, O)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=PROD_TOL, atol=PROD_TOL)
    else:
        _bf16_close(got, want)


def test_decode_e2m1_equals_the_jax_package():
    codes = np.arange(16, dtype=np.int32)
    got = decode_e2m1(torch.from_numpy(codes)).numpy()
    want = np.asarray(jext.decode_e2m1(jnp.asarray(codes)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [32, 16])
def test_mxfp4_plain_matches_ref(g, dtype):
    rng = np.random.default_rng(g)
    O, K = 96, 2048
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    if g == 32:   # MX: powers of two
        scales = np.exp2(rng.integers(-10, -3, (O, K // g))).astype(np.float32)
    else:         # NVFP4: e4m3 values over a global scale
        scales = rng.uniform(1e-4, 0.01, (O, K // g)).astype(np.float32)
    x = rng.standard_normal((4, K)).astype(np.float32)
    jqw = pack_w4_planes(jnp.asarray(codes), 128)
    want = jext.mxfp4_matmul_ref(jnp.asarray(x, dtype), jqw,
                                 jnp.asarray(scales), g)
    # the JAX engine's lane-padded scale layout crosses to the exact one
    pad = jext.mx_scale_cols(K, g) - K // g
    tqw, tsc = packed_from_jax(
        (np.asarray(jqw), np.pad(scales, ((0, 0), (0, pad)))),
        f"mxfp4_g{g}", "cpu")
    assert torch.equal(unpack_w4(tqw), torch.from_numpy(codes))
    np.testing.assert_array_equal(tsc.numpy(), scales)
    got = mxfp4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tqw,
                       tsc, g)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=PROD_TOL, atol=PROD_TOL)
    else:
        _bf16_close(got, want)


def test_unpack_planes_is_the_jax_unpack():
    rng = np.random.default_rng(3)
    c4 = rng.integers(0, 16, (8, 2048)).astype(np.int32)
    c2 = rng.integers(0, 4, (8, 4096)).astype(np.int32)
    np.testing.assert_array_equal(
        unpack_planes(np.asarray(pack_w4_planes(jnp.asarray(c4), 128)), 4,
                      128), c4)
    np.testing.assert_array_equal(
        unpack_planes(np.asarray(jext.pack_w2_planes(jnp.asarray(c2), 256)),
                      2, 256), c2)
    assert torch.equal(unpack_w2(pack_w2(torch.from_numpy(c2))),
                       torch.from_numpy(c2))
    # the JAX engine's w4a16 / w4a16_asym planes cross to pack_w4's words
    sc = np.ones((8, 2048 // 128), np.float32)
    jqw = np.asarray(pack_w4_planes(jnp.asarray(c4), 128))
    qw, tsc = packed_from_jax((jqw, sc), "w4a16", "cpu")
    assert torch.equal(qw, pack_w4(torch.from_numpy(c4)))
    qw, tsc, tzp = packed_from_jax((jqw, sc, 7 * sc), "w4a16_asym", "cpu")
    assert torch.equal(qw, pack_w4(torch.from_numpy(c4)))
    assert bool((tzp == 7).all()) and tzp.dtype == torch.float32


# --------------------------------------------------------- packing helpers

def test_e2m1_codes_equal_the_jax_encoder():
    """Grid values of both signs, -0.0, values off the grid and exact
    midpoints (ties) against ``_encode_e2m1``."""
    rng = np.random.default_rng(5)
    grid = np.array([0, .5, 1, 1.5, 2, 3, 4, 6], np.float32)
    v = np.concatenate([
        grid, -grid, [-0.0, 0.25, -0.25, 0.75, -5.0, 5.0, 2.5, -3.5, 7.0,
                      -9.0, 0.1, -0.1],
        rng.uniform(-7, 7, 200)]).astype(np.float32)
    want = _encode_e2m1(v[None, :])[0]
    scale = np.ones((1, 1), np.float32)
    got = e2m1_codes_from_qdq(torch.from_numpy(v[None, :]),
                              torch.from_numpy(scale), v.size).numpy()[0]
    np.testing.assert_array_equal(got, want)
    assert got[grid.size + 0] == 0 and got[2 * grid.size] == 0   # -0.0


def test_e2m1_codes_in_row_slices_equal_the_jax_encoder(monkeypatch):
    """The encoder works a slice of rows at a time (an lm_head's fp32
    temporaries); with slices of 3 rows over 10 (a short tail) and group
    scales of 16 columns, including ones below 1e-12, the codes are those
    of ``_encode_e2m1`` on the scale-divided values."""
    from autoround_tpu_torch.serve import engine as teng

    rng = np.random.default_rng(8)
    O, K, g = 10, 64, 16
    scale = rng.uniform(0.001, 0.01, (O, K // g)).astype(np.float32)
    scale[0, 0], scale[4, 2] = 1e-13, 0.0
    srep = np.repeat(scale, g, 1)
    qdq = (rng.uniform(-7, 7, (O, K)) * srep).astype(np.float32)
    monkeypatch.setattr(teng, "_E2M1_ROWS", 3)
    got = e2m1_codes_from_qdq(torch.from_numpy(qdq),
                              torch.from_numpy(scale), g).numpy()
    guard = np.where(np.abs(srep) < 1e-12, 1e-12, srep).astype(np.float32)
    np.testing.assert_array_equal(got, _encode_e2m1(qdq / guard))


def test_w2_codes_and_fp8_bytes_with_tiny_scales():
    rng = np.random.default_rng(6)
    O, K, g = 8, 256, 128
    codes = rng.integers(0, 4, (O, K)).astype(np.int32)
    scales = rng.uniform(-0.02, 0.02, (O, K // g)).astype(np.float32)
    scales[0, 0], scales[1, 1] = 1e-13, 0.0
    srep = np.repeat(scales, g, 1)
    qdq = ((codes - 2) * srep).astype(np.float32)
    got = w2_codes_from_qdq(torch.from_numpy(qdq), torch.from_numpy(scales),
                            g).numpy()
    guard = np.where(np.abs(srep) < 1e-12, 1e-12, srep)
    np.testing.assert_array_equal(
        got, np.clip(np.rint(qdq / guard) + 2, 0, 3).astype(np.int32))
    live = np.abs(srep) >= 1e-12
    np.testing.assert_array_equal(got[live], codes[live])

    wf8 = _e4m3(rng, O, K).astype(np.float32)
    sc = rng.uniform(1e-4, 0.01, (O, 1)).astype(np.float32)
    sc[2, 0] = 1e-14
    qdq = (wf8 * sc).astype(np.float32)
    tw, ts = fp8_from_qdq(torch.from_numpy(qdq), torch.from_numpy(sc))
    guard = np.where(np.abs(sc[:, 0]) < 1e-12, 1e-12, sc[:, 0])
    want = np.asarray(jnp.asarray(qdq / guard[:, None]).astype(
        jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(tw.view(torch.uint8).numpy(), want)
    np.testing.assert_array_equal(ts.numpy(), guard)
    # a per-tensor scale is repeated per row
    tw1, ts1 = fp8_from_qdq(torch.from_numpy(qdq),
                            torch.tensor([0.01], dtype=torch.float32))
    assert ts1.shape == (O,) and bool((ts1 == 0.01).all())


def test_serving_kinds_equal_the_jax_engine():
    """``tests/test_serve_ext.py``'s kind table, and small-group and
    per-tensor variants."""
    for name, kw in (("W4A16", {}), ("W2A16", {}), ("W8A16", {}),
                     ("W8A8", {}), ("W4A8", {}), ("FP8_STATIC", {}),
                     ("MXFP4", {}), ("NVFP4", {}), ("W2A16", dict(
                         group_size=64)), ("FP8_STATIC", dict(group_size=0)),
                     ("FP8_BLOCK", {}), ("MXFP8", {}), ("W2A16", dict(
                         group_size=256))):
        want = j_kind(j_parse(name, **kw))
        assert _serving_kind(parse_scheme(name, **kw)) == want, (name, kw)


# ------------------------------------------------------------------ engine

@functools.lru_cache(maxsize=None)
def _float_model(hidden):
    jcfg = jl.LlamaConfig(vocab_size=128, hidden_size=hidden,
                          intermediate_size=hidden, num_layers=1,
                          num_heads=4, num_kv_heads=2, rope_theta=1e4,
                          dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp,
                calib=rng.integers(0, 128, (4, 16)),
                prompts=rng.integers(0, 128, (2, 12)))


ENGINE_CASES = [("FP8_STATIC", "fp8"), ("MXFP4", "mxfp4_g32"),
                ("NVFP4", "mxfp4_g16"), ("W2A16", "w2a16")]


@pytest.fixture(scope="module", params=ENGINE_CASES, ids=[c[0] for c in
                                                          ENGINE_CASES])
def engine_pair(request):
    scheme, kind = request.param
    # the smallest width at which the JAX engine packs the kind: K % 2048
    # for W2's 16 planes, K % 1024 for the E2M1 planes (FP8: any K)
    m = _float_model(2048 if scheme == "W2A16" else 1024)
    jres = JAutoRound((m["jp"], m["jcfg"]), scheme=scheme, iters=0,
                      quant_lm_head=True).quantize(jnp.asarray(m["calib"]))
    tres = AutoRound((m["tp"], m["tcfg"]), scheme=scheme, iters=0,
                     quant_lm_head=True, device="cpu").quantize(m["calib"])
    je = JQuantizedLlama.from_quantize_result(jres, m["jcfg"], max_seq=32)
    te = QuantizedLlama.from_quantize_result(tres, m["tcfg"], max_seq=32,
                                             device="cpu")
    return dict(kind=kind, jres=jres, tres=tres, je=je, te=te,
                prompts=m["prompts"])


def test_engine_payloads_equal_the_jax_engine(engine_pair):
    """Codes, e4m3 bytes and scales of every packed entry (the JAX engine's
    payload through ``packed_from_jax`` equals the port's own packing)."""
    je, te, kind = engine_pair["je"], engine_pair["te"], engine_pair["kind"]
    keys = ["blocks.0.qkv", "blocks.0.o_proj", "blocks.0.gate_up",
            "blocks.0.down_proj"]
    want_keys = keys + (["lm_head"] if "lm_head" in je.packed else [])
    assert sorted(te.packed) == sorted(want_keys)
    assert set(te.packed_kinds.values()) == {kind}
    for k in want_keys:
        assert je.packed_kinds[k] == kind, k
        jent = tuple(np.asarray(t) for t in je.packed[k])
        conv = packed_from_jax(jent, kind, "cpu")
        for a, b in zip(conv, te.packed[k]):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype == torch.float8_e4m3fn:
                a, b = a.view(torch.uint8), b.view(torch.uint8)
            assert torch.equal(a, b), k
    assert te.params["blocks"][0]["down_proj"] is None


def test_engine_logits_and_greedy_tokens(engine_pair):
    je, te, prompts = (engine_pair[k] for k in ("je", "te", "prompts"))
    n_new = 4
    logits, cache = je.prefill(jnp.asarray(prompts))
    tlog, tcache = te.prefill(prompts)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(logits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    toks, gaps = [], []
    for step in range(n_new):
        lg = np.asarray(logits, np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append((top2[:, 1] - top2[:, 0]).min())
        toks.append(lg.argmax(-1).astype(np.int32))
        if step < n_new - 1:
            logits, cache = je.decode_step(jnp.asarray(toks[-1]), cache)
            tlog, tcache = te.decode_step(torch.from_numpy(toks[-1]), tcache)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(logits),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
    want = np.stack(toks, axis=1)
    got = te.generate(prompts, max_new_tokens=n_new).numpy()
    first_close = next((i for i, g in enumerate(gaps) if g < GAP_TOL), n_new)
    assert first_close >= 1, gaps
    np.testing.assert_array_equal(want[:, :first_close],
                                  got[:, :first_close])


def test_fuse_keeps_kinds_of_one_g_together():
    """q/k/v of one float kind fuse (fp8's 1-D scales included); members of
    the two MX group sizes do not."""
    from autoround_tpu_torch.serve.engine import _fuse_packed

    cfg = dataclasses.replace(
        config_from_jax(dataclasses.asdict(jl.CONFIG_PRESETS["tiny"])),
        num_layers=2)
    packed, kinds = {}, {}
    for name, O in (("q_proj", 8), ("k_proj", 4), ("v_proj", 4)):
        packed[f"blocks.0.{name}"] = (
            torch.zeros((O, 64), dtype=torch.float8_e4m3fn), torch.ones(O))
        kinds[f"blocks.0.{name}"] = "fp8"
        g = 16 if name == "v_proj" else 32
        packed[f"blocks.1.{name}"] = (torch.zeros((O, 8), dtype=torch.int32),
                                      torch.ones((O, 64 // g)))
        kinds[f"blocks.1.{name}"] = f"mxfp4_g{g}"
    fused, splits, fkinds = _fuse_packed(packed, cfg, kinds)
    assert fkinds["blocks.0.qkv"] == "fp8" and splits["blocks.0.qkv"] == (
        8, 4, 4)
    assert fused["blocks.0.qkv"][0].dtype == torch.float8_e4m3fn
    assert fused["blocks.0.qkv"][1].shape == (16,)
    assert "blocks.1.qkv" not in fused and "blocks.1.v_proj" in fused
