"""Port parity for the int8 kinds: ``quantize_rows`` and the plain versions
of ``w8a8_matmul``, ``w4a8_matmul`` and ``w8a16_matmul`` against the JAX
package's ``*_ref`` functions (what its wrappers take off the TPU), and a
Llama quantized with ``W4A8``, ``W8A8`` and ``W8A16`` served against the JAX
engine, with the two opt-in modes that put a W4A16 result on the int8
kernel (``serve_a8``, ``prefill_a8``).

The CUDA kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against the plain versions there);
here the wrappers are called on CPU tensors, which is exactly when they
take their plain versions.  Inputs are made with numpy from a seed and
handed to both packages.

Tolerances (fp32 on the CPU unless stated):
  * ``quantize_rows``: codes and scales bit-equal (the JAX function is
    jitted, and XLA compiles its ``amax / 127.0`` to a product with
    fp32(1 / 127); the port does the same);
  * ``w8a8``: both sides do the exact integer product and the same two
    fp32 multiplications: rtol 1e-5 (K = 14336 included: an fp32 product of
    the codes would be inexact there);
  * ``w4a8``: the JAX ref sums K fp32 products at once, the port per group
    of exact integers: rtol 1e-4, atol 1e-4 (the JAX test's own);
  * ``w8a16``: the same fp32 dequantization, K products summed in another
    order: 1e-4; bf16: equal up to one bf16 ulp of the output (2^-7);
  * engine codes and scales: exact;
  * ``W8A16`` logits: 1e-4 (as ``tests/test_torch_engine.py``);
  * ``W4A8`` / ``W8A8`` projections: every packed call of the JAX engine's
    prefill, replayed in the port on the very input the JAX engine gave it,
    agrees to 1e-5 of the output's largest value (the codes are then equal,
    only fp32 summation order differs);
  * ``W4A8`` / ``W8A8`` logits: free-running, the per-token quantizer
    rounds, and a last-bit difference in an activation that lies on a
    rounding boundary moves that code by one (1 / 127 of the row's amax).
    One such flip changes its projection's output by about 7e-4, which
    flips more codes in every later quantizer, until the two forwards
    carry unrelated rounding noise: over 16 prompts max |Δ| / max |JAX| was
    either below 4e-7 (no flip) or between 0.010 and 0.013, against 0.014
    to 0.020 between A8 and exact-A16 serving.  Measured here: W4A8 6e-7
    at prefill (held at 1e-5) and 0.0119 at the decode step after it, W8A8
    0.0124 and 0.0097, ``prefill_a8`` 0.0064; limit 0.04, about 3x.  So
    the logits alone cannot tell an engine that skipped the activation
    quantizer; the replayed projections and the floor on the distance from
    the dense qdq model do;
  * greedy tokens: equal up to the first step whose JAX top-2 gap is below
    the logit tolerance of the kind, and at least the first token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.ops import qmatmul_ext as jext
from autoround_tpu.ops import qmatmul_int8 as jint8
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.ops.qmatmul import pack_w4, unpack_w4
from autoround_tpu_torch.ops.qmatmul_ext import (w8a16_matmul,
                                                 w8a16_matmul_plain)
from autoround_tpu_torch.ops.qmatmul_int8 import (quantize_rows,
                                                  w4a8_matmul,
                                                  w4a8_matmul_plain,
                                                  w8a8_matmul,
                                                  w8a8_matmul_plain)
from autoround_tpu_torch.serve import engine as tengine
from autoround_tpu_torch.utils.convert import (config_from_jax,
                                               packed_from_jax,
                                               params_from_jax,
                                               unpack_w4_bytes)

LOGIT_TOL = 1e-4
A8_LOGIT_REL = 0.04
A8_NO_FLIP_REL = 1e-5
A8_CALL_REL = 1e-5


# ----------------------------------------------------------- quantize_rows

def _rows(rng, M, K):
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] = 0.0                                   # scale floor 1e-8
    x[1] = rng.integers(-127, 128, K)            # amax 127: integers
    x[1, :2] = (127.0, -127.0)
    x[2] = rng.integers(-126, 126, K) + 0.5      # ties: round half to even
    x[2, 0] = 127.0
    x[3] *= 1e-6
    x[4] *= 1e4
    return x


@pytest.mark.parametrize("shape", [(8, 512), (3, 5, 1024), (64, 4096)])
def test_quantize_rows_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    x = _rows(rng, int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    ji, js = jint8.quantize_rows(jnp.asarray(x))
    ti, ts = quantize_rows(torch.from_numpy(x))
    assert ti.dtype == torch.int8 and ts.dtype == torch.float32
    assert ti.shape == shape and ts.shape == shape[:-1]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    flat = ti.reshape(-1, shape[-1]).numpy()
    assert not flat[0].any() and ts.reshape(-1)[0] == np.float32(1e-8)
    assert flat[1, 0] == 127 and flat[1, 1] == -127 and np.abs(flat).max() == 127


def test_quantize_rows_bf16_input():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((16, 256)).astype(np.float32)
    ji, js = jint8.quantize_rows(jnp.asarray(x, jnp.bfloat16))
    ti, ts = quantize_rows(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------------------- w8a8

@pytest.mark.parametrize("lead,O,K", [((4,), 256, 512), ((2, 3), 96, 1024),
                                      ((5,), 64, 14336)])
def test_w8a8_plain_matches_ref(lead, O, K):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    # codes that keep every product positive: the sum reaches K * 127 * 127
    wi = rng.integers(-128, 128, (O, K)).astype(np.int8)
    wi[0] = 127
    x[..., 0, :] = np.abs(x[..., 0, :]) + 3.0
    ws = rng.uniform(-0.02, 0.02, (O,)).astype(np.float32)
    want = jint8.w8a8_matmul_ref(jnp.asarray(x), jnp.asarray(wi),
                                 jnp.asarray(ws))
    got = w8a8_matmul(torch.from_numpy(x), torch.from_numpy(wi),
                      torch.from_numpy(ws))
    assert got.shape == (*lead, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-30)


def test_w8a8_plain_integer_part_is_exact():
    """K = 14336 at full code range: the int32 sum of row 0 is beyond 2^24,
    where an fp32 product of the codes would round."""
    K, O = 14336, 8
    x = np.full((1, K), 2.0, np.float32)
    x[0, ::2] = 1.0 + 1.0 / 127                  # codes 127 and 64
    wi = np.full((O, K), 127, np.int8)
    wi[:, 1] = 126
    ws = np.ones((O,), np.float32)
    xi, xs = quantize_rows(torch.from_numpy(x))
    acc = (xi.numpy().astype(np.int64) @ wi.astype(np.int64).T)
    assert acc.max() > 2 ** 24 and acc.max() % 2 == 1
    got = w8a8_matmul_plain(torch.from_numpy(x), torch.from_numpy(wi),
                            torch.from_numpy(ws))
    want = acc.astype(np.float32) * xs.numpy()[:, None] * ws[None, :]
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------- w4a8

@pytest.mark.parametrize("g", [128, 256])
@pytest.mark.parametrize("lead", [(4,), (2, 3)])
def test_w4a8_plain_matches_ref(lead, g):
    rng = np.random.default_rng(g + len(lead))
    O, K = 256, 1024
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    scales = rng.uniform(0.01, 0.02, (O, K // g)).astype(np.float32)
    scales[::3] *= -1.0
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    jqw = jint8.pack_w4_bytes(jnp.asarray(codes))
    want = jint8.w4a8_matmul_ref(jnp.asarray(x), jqw, jnp.asarray(scales), g)
    tqw, tsc = packed_from_jax((np.asarray(jqw), scales), "w4a8", "cpu")
    np.testing.assert_array_equal(unpack_w4(tqw).numpy(), codes)
    got = w4a8_matmul(torch.from_numpy(x), tqw, tsc, g)
    assert got.shape == (*lead, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_w4a8_converter_and_explicit_math():
    rng = np.random.default_rng(7)
    O, K, g = 32, 512, 128
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    packed = np.asarray(jint8.pack_w4_bytes(jnp.asarray(codes)))
    np.testing.assert_array_equal(unpack_w4_bytes(packed), codes)
    np.testing.assert_array_equal(
        unpack_w4_bytes(packed), np.asarray(jint8.unpack_w4_bytes(packed)))
    scales = rng.uniform(0.01, 0.02, (O, K // g)).astype(np.float32)
    x = rng.standard_normal((3, K)).astype(np.float32)
    xi, xs = quantize_rows(torch.from_numpy(x))
    w = (codes - 8) * np.repeat(scales, g, axis=1)
    want = (xi.numpy().astype(np.float32) @ w.T) * xs.numpy()[:, None]
    got = w4a8_matmul_plain(torch.from_numpy(x),
                            pack_w4(torch.from_numpy(codes)),
                            torch.from_numpy(scales), g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown packed kind"):
        packed_from_jax((packed, scales), "int3", "cpu")


# ------------------------------------------------------------------ w8a16

@pytest.mark.parametrize("g", [128, 256, 0])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_w8a16_plain_matches_ref(lead, g):
    rng = np.random.default_rng(g + len(lead))
    O, K = 96, 1024
    wi = rng.integers(-128, 128, (O, K)).astype(np.int8)
    scales = rng.uniform(-0.02, 0.02, (O, K // g if g else 1)).astype(
        np.float32)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    want = jext.w8a16_matmul_ref(jnp.asarray(x), jnp.asarray(wi),
                                 jnp.asarray(scales), g)
    twi, tsc = packed_from_jax((wi, scales), "w8a16", "cpu")
    got = w8a16_matmul(torch.from_numpy(x), twi, tsc, g)
    assert got.shape == (*lead, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("g", [128, 0])
def test_w8a16_plain_bf16_rounding(g):
    rng = np.random.default_rng(1)
    O, K = 64, 1024
    wi = rng.integers(-128, 128, (O, K)).astype(np.int8)
    scales = rng.uniform(0.001, 0.002, (O, K // g if g else 1)).astype(
        np.float32)
    x = rng.standard_normal((4, K)).astype(np.float32)
    want = jext.w8a16_matmul_ref(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(wi), jnp.asarray(scales), g)
    got = w8a16_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(wi), torch.from_numpy(scales),
                             g)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


# ----------------------------------------------------------------- engine

KINDS = {"W4A8": "w4a8", "W8A8": "w8a8", "W8A16": "w8a16"}


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig(vocab_size=256, hidden_size=1024,
                          intermediate_size=1024, num_layers=2, num_heads=8,
                          num_kv_heads=2, head_dim=128, rope_theta=1e4,
                          dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp,
                calib=rng.integers(0, 256, (4, 16)),
                prompts=rng.integers(0, 256, (2, 12)))


@pytest.fixture(scope="module")
def served(model):
    """scheme → (JAX result, port result, JAX engine, port engine)."""
    built = {}

    def get(scheme):
        if scheme not in built:
            jres = JAutoRound((model["jp"], model["jcfg"]), scheme=scheme,
                              iters=0, quant_lm_head=True).quantize(
                                  jnp.asarray(model["calib"]))
            tres = AutoRound((model["tp"], model["tcfg"]), scheme=scheme,
                             iters=0, quant_lm_head=True,
                             device="cpu").quantize(model["calib"])
            built[scheme] = (
                jres, tres,
                JQuantizedLlama.from_quantize_result(jres, model["jcfg"],
                                                     max_seq=32),
                QuantizedLlama.from_quantize_result(tres, model["tcfg"],
                                                    max_seq=32, device="cpu"))
        return built[scheme]
    return get


KEYS = [f"blocks.{i}.{n}" for i in range(2)
        for n in ("qkv", "o_proj", "gate_up", "down_proj")] + ["lm_head"]


@pytest.mark.parametrize("scheme", ["W4A8", "W8A8", "W8A16"])
def test_engine_kinds_codes_and_scales(served, scheme):
    jres, tres, je, te = served(scheme)
    kind = KINDS[scheme]
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(np.asarray(jq.qdq),
                                      tres.layers[name].qdq.numpy())
        np.testing.assert_array_equal(np.asarray(jq.scale),
                                      tres.layers[name].scale.numpy())
    assert sorted(te.packed) == sorted(KEYS)
    assert set(te.packed_kinds.values()) == {kind}
    # the JAX engine keeps the members of a fused group beside it; both
    # engines tag every entry, fused ones included, with the scheme's kind
    assert all(je.packed_kinds[k] == kind for k in KEYS)
    assert set(je.packed_kinds.values()) == {kind}
    for k in KEYS:
        tqw, tsc = packed_from_jax(tuple(np.asarray(t) for t in je.packed[k]),
                                   kind, "cpu")
        qw, sc = te.packed[k]
        assert qw.dtype == tqw.dtype and sc.shape == tsc.shape, k
        np.testing.assert_array_equal(qw.numpy(), tqw.numpy(), err_msg=k)
        np.testing.assert_array_equal(sc.numpy(), tsc.numpy(), err_msg=k)
    if kind == "w8a8":
        assert te.packed["blocks.0.qkv"][1].shape == (1024 + 256 + 256,)
        assert te.packed["lm_head"][0].dtype == torch.int8
    if kind == "w8a16":
        assert te.packed["blocks.0.qkv"][1].shape == (1536, 1024 // 128)
    assert te.fused_splits["blocks.0.qkv"] == (1024, 256, 256)
    assert te.params["lm_head"] is None
    assert te.params["blocks"][1]["down_proj"] is None


def _compare_logits(scheme, jlog, tlog, limit=A8_LOGIT_REL):
    jlog = np.asarray(jlog, np.float32)
    if scheme == "W8A16":
        np.testing.assert_allclose(tlog.numpy(), jlog, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        return LOGIT_TOL * 10
    rel = np.abs(tlog.numpy() - jlog).max() / np.abs(jlog).max()
    assert rel < limit, rel
    return A8_LOGIT_REL * float(np.abs(jlog).max())


@pytest.mark.parametrize("scheme", ["W4A8", "W8A8"])
def test_engine_projections_on_the_jax_engines_inputs(model, served,
                                                      monkeypatch, scheme):
    """Every int8 projection the JAX engine runs in a prefill, replayed in
    the port on the same input: activation quantizer, integer product and
    epilogue agree call by call.  (The JAX engine runs a fused group's
    members one by one; the port's fused entry holds them side by side.)"""
    import autoround_tpu.serve.engine as jengine
    _, _, je, te = served(scheme)
    kind = KINDS[scheme]
    name = kind + "_matmul"
    seen = []
    real = getattr(jengine, name)

    def spy(x, *rest):
        y = real(x, *rest)
        jax.debug.callback(
            lambda a, b: seen.append((np.array(a), np.array(b))), x, y,
            ordered=True)
        return y
    monkeypatch.setattr(jengine, name, spy)
    # another max_seq: a fresh trace, so that the spy is in it
    je = dataclasses.replace(je, max_seq=40)
    jax.block_until_ready(je.prefill(jnp.asarray(model["prompts"])))
    jax.effects_barrier()
    per_block = [("qkv", 0, 1024), ("qkv", 1024, 1280), ("qkv", 1280, 1536),
                 ("o_proj", 0, 1024), ("gate_up", 0, 1024),
                 ("gate_up", 1024, 2048), ("down_proj", 0, 1024)]
    calls = [(f"blocks.{i}.{n}", lo, hi) for i in range(2)
             for n, lo, hi in per_block] + [("lm_head", 0, 256)]
    assert len(seen) == len(calls)
    for (key, lo, hi), (x, y) in zip(calls, seen):
        got = tengine._packed_matmul(torch.from_numpy(x), te.packed[key],
                                     kind).numpy()[..., lo:hi]
        assert got.shape == y.shape, key
        assert np.abs(got - y).max() < A8_CALL_REL * np.abs(y).max(), key


@pytest.mark.parametrize("scheme", ["W4A8", "W8A8", "W8A16"])
def test_engine_logits_and_greedy_tokens(model, served, scheme):
    _, _, je, te = served(scheme)
    prompts = model["prompts"]
    n_new = 5
    logits, cache = je.prefill(jnp.asarray(prompts))
    tlog, tcache = te.prefill(prompts)
    # the W4A8 prefill of these prompts meets no rounding boundary
    gap_tol = _compare_logits(
        scheme, logits, tlog,
        A8_NO_FLIP_REL if scheme == "W4A8" else A8_LOGIT_REL)
    toks, gaps = [], []
    for step in range(n_new):
        lg = np.asarray(logits, np.float32)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append((top2[:, 1] - top2[:, 0]).min())
        toks.append(lg.argmax(-1).astype(np.int32))
        if step < n_new - 1:
            logits, cache = je.decode_step(jnp.asarray(toks[-1]), cache)
            if step == 0:
                tlog, tcache = te.decode_step(torch.from_numpy(toks[-1]),
                                              tcache)
                _compare_logits(scheme, logits, tlog)
    want = np.stack(toks, axis=1)
    got = te.generate(prompts, max_new_tokens=n_new).numpy()
    assert got.shape == want.shape
    first_close = next((i for i, g in enumerate(gaps) if g < gap_tol), n_new)
    assert first_close >= 1, gaps
    np.testing.assert_array_equal(want[:, :first_close],
                                  got[:, :first_close])


@pytest.mark.parametrize("scheme", ["W4A8", "W8A8"])
def test_engine_tracks_the_qdq_model(model, served, scheme):
    """Packed serving with dynamic int8 activations stays near the dense
    qdq model (the JAX test's measure and limit), and not on it: the
    activation quantizer leaves its noise (measured 0.0156 and 0.0137; an
    engine that served these weights on exact activations gives 1e-6)."""
    from autoround_tpu_torch.models import llama as tl
    _, tres, _, te = served(scheme)
    ids = torch.as_tensor(model["prompts"])
    logits, _ = te.prefill(ids)
    ref = tl.model_fwd(tres.params, ids, model["tcfg"])[:, -1]
    rms = float(((logits - ref) ** 2).mean().sqrt() / (ref ** 2).mean().sqrt())
    assert 0.005 < rms < 0.05, rms


def test_serve_a8_repacks_nothing(model, served):
    """``serve_a8``: the W4A16 result's layers take the ``w4a8`` kind on
    the very words the exact engine holds; the logits stay within the JAX
    test's measure of exact-A16 serving, and agree with the JAX engine's
    ``serve_a8`` within the A8 tolerance."""
    jres, tres, _, exact = served("W4A16")
    a8 = QuantizedLlama.from_quantize_result(tres, model["tcfg"], max_seq=32,
                                             device="cpu", serve_a8=True)
    assert set(a8.packed_kinds.values()) == {"w4a8"}
    assert set(exact.packed_kinds.values()) == {"w4a16"}
    for k, (qw, sc) in exact.packed.items():
        assert torch.equal(a8.packed[k][0], qw) and torch.equal(
            a8.packed[k][1], sc)
    ja8 = JQuantizedLlama.from_quantize_result(jres, model["jcfg"],
                                               max_seq=32, serve_a8=True)
    assert set(ja8.packed_kinds.values()) == {"w4a8"}
    le, _ = exact.prefill(model["prompts"])
    la, _ = a8.prefill(model["prompts"])
    denom = max(1e-6, float(le.abs().max()))
    assert float((le - la).abs().max()) / denom < 0.06
    jla, _ = ja8.prefill(jnp.asarray(model["prompts"]))
    _compare_logits("W4A8", jla, la)


def test_serve_a8_leaves_other_group_sizes_exact(model):
    res = AutoRound((model["tp"], model["tcfg"]), scheme="W4A16G32", iters=0,
                    device="cpu").quantize(model["calib"])
    eng = QuantizedLlama.from_quantize_result(res, model["tcfg"], max_seq=32,
                                              device="cpu", serve_a8=True)
    assert set(eng.packed_kinds.values()) == {"w4a16"}


def test_prefill_a8_keys_on_the_sequence_length(model, served, monkeypatch):
    """``prefill_a8``: a prompt of 256 tokens runs the blocks' projections
    on the W4A8 kernel and the lm_head exact; a shorter prompt and every
    decode step stay exact A16.  Logits against the JAX engine in the same
    mode within the A8 tolerance."""
    jres, _, je, exact = served("W4A16")
    eng = dataclasses.replace(exact, prefill_a8=True)
    calls = {"w4a8": 0, "w4a16": 0}
    a8_fn, a16_fn = tengine.w4a8_matmul, tengine.w4a16_matmul

    def spy(kind, fn):
        def run(*a):
            calls[kind] += 1
            return fn(*a)
        return run
    monkeypatch.setattr(tengine, "w4a8_matmul", spy("w4a8", a8_fn))
    monkeypatch.setattr(tengine, "w4a16_matmul", spy("w4a16", a16_fn))

    short, _ = eng.prefill(model["prompts"])
    assert calls == {"w4a8": 0, "w4a16": 2 * 4 + 1}
    assert torch.equal(short, exact.prefill(model["prompts"])[0])

    rng = np.random.default_rng(3)
    long_ids = rng.integers(0, 256, (1, 256))
    eng = dataclasses.replace(eng, max_seq=264)
    calls.update(w4a8=0, w4a16=0)
    la, cache = eng.prefill(long_ids)
    assert calls == {"w4a8": 2 * 4, "w4a16": 1}
    calls.update(w4a8=0, w4a16=0)
    tok = la.argmax(-1).to(torch.int32)
    step, _ = eng.decode_step(tok, cache)
    assert calls == {"w4a8": 0, "w4a16": 2 * 4 + 1}
    assert torch.isfinite(step).all()

    ja8 = dataclasses.replace(je, max_seq=264, prefill_a8=True)
    jla, _ = ja8.prefill(jnp.asarray(long_ids))
    _compare_logits("W4A8", jla, la)
    le, _ = dataclasses.replace(exact, max_seq=264).prefill(long_ids)
    denom = max(1e-6, float(le.abs().max()))
    assert float((le - la).abs().max()) / denom < 0.06


def test_moe_experts_of_an_a8_kind_stay_unstacked():
    """A Mixtral quantized with W4A8: the experts pack as ``w4a8`` and, as
    in the JAX engine, only ``w4a16`` experts stack for the grouped kernel:
    these serve one by one."""
    from autoround_tpu_torch.models import mixtral
    cfg = dataclasses.replace(mixtral.CONFIG_PRESETS["tiny-moe"],
                              hidden_size=128, intermediate_size=128,
                              num_heads=2, num_kv_heads=1, head_dim=64)
    p = mixtral.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    res = AutoRound((p, cfg), scheme="W4A8", iters=0,
                    device="cpu").quantize(ids)
    eng = QuantizedLlama.from_quantize_result(res, cfg, max_seq=16,
                                              device="cpu")
    assert set(eng.packed_kinds.values()) == {"w4a8"}
    assert not any("experts_stack" in k for k in eng.packed)
    assert any(".experts.0.w1" in k for k in eng.packed)
    logits, cache = eng.prefill(ids[:1])
    assert torch.isfinite(logits).all() and cache.length == 8
