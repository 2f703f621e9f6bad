"""Port parity for the asym W4A16 kind: the plain version of
``w4a16_asym_matmul`` against the JAX package's ``w4a16_asym_matmul_ref``,
and a Llama quantized with an int4 asym scheme served through the
``w4a16_asym`` kind against the JAX engine.

The CUDA kernel runs only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the plain version there); here
the wrapper is called on CPU tensors, which is exactly when it takes its
plain version.  Inputs are made with numpy from a seed and handed to both
packages; the packed words are built from the same codes in each package's
own layout.

Tolerances (fp32 on the CPU unless stated):
  * the product: both sides dequantize ``(code - zp) * scale`` with the same
    fp32 operations and sum K products in different orders: 1e-4 of an O(1)
    output for K = 2048;
  * bf16 activations: both round the dequantized weight and the output to
    bf16; equal up to one bf16 ulp of the output (rtol 2^-7);
  * engine codes, scales and zero points: exact;
  * logits: 1e-4 (as ``tests/test_torch_engine.py``); greedy tokens equal up
    to the first step whose JAX top-2 gap is below 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.ops.qmatmul import pack_w4_planes, unpack_w4_planes
from autoround_tpu.ops.qmatmul_ext import w4a16_asym_matmul_ref
from autoround_tpu.serve import QuantizedLlama as JQuantizedLlama
from autoround_tpu_torch import AutoRound, QuantizedLlama
from autoround_tpu_torch.ops.qmatmul import pack_w4, unpack_w4
from autoround_tpu_torch.ops.qmatmul_ext import (w4a16_asym_matmul,
                                                 w4a16_asym_matmul_plain)
from autoround_tpu_torch.schemes import QuantizationScheme
from autoround_tpu_torch.serve.engine import (_fuse_packed, _serving_kind,
                                              w4_asym_codes_from_qdq)
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax

LOGIT_TOL = 1e-4
GAP_TOL = 1e-3
ASYM = dict(bits=4, group_size=128, sym=False, data_type="int")


def _operands(rng, O, K, g, zp_kind):
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    scales = rng.uniform(0.005, 0.02, (O, K // g)).astype(np.float32)
    if zp_kind == "integral":
        zps = rng.integers(0, 16, (O, K // g)).astype(np.float32)
    else:
        zps = rng.uniform(0.0, 15.0, (O, K // g)).astype(np.float32)
    return codes, scales, zps


@pytest.mark.parametrize("zp_kind", ["integral", "fractional"])
@pytest.mark.parametrize("g", [128, 256])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_asym_plain_matches_ref(lead, g, zp_kind):
    rng = np.random.default_rng(g + len(lead))
    O, K = 96, 2048
    codes, scales, zps = _operands(rng, O, K, g, zp_kind)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    want = w4a16_asym_matmul_ref(
        jnp.asarray(x), pack_w4_planes(jnp.asarray(codes), g),
        jnp.asarray(scales), jnp.asarray(zps), g)
    got = w4a16_asym_matmul(torch.from_numpy(x),
                            pack_w4(torch.from_numpy(codes)),
                            torch.from_numpy(scales), torch.from_numpy(zps), g)
    assert got.shape == (*lead, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("zp_kind", ["integral", "fractional"])
def test_asym_plain_bf16_rounding(zp_kind):
    rng = np.random.default_rng(1)
    O, K, g = 64, 1024, 128
    codes, scales, zps = _operands(rng, O, K, g, zp_kind)
    x = rng.standard_normal((4, K)).astype(np.float32)
    want = w4a16_asym_matmul_ref(
        jnp.asarray(x, jnp.bfloat16), pack_w4_planes(jnp.asarray(codes), g),
        jnp.asarray(scales), jnp.asarray(zps), g)
    got = w4a16_asym_matmul_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        pack_w4(torch.from_numpy(codes)), torch.from_numpy(scales),
        torch.from_numpy(zps), g)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


def test_asym_with_zero_point_eight_is_the_sym_product():
    """zp = 8 everywhere: the asym product is the sym one, bit for bit."""
    from autoround_tpu_torch.ops.qmatmul import w4a16_matmul_plain
    rng = np.random.default_rng(2)
    O, K, g = 32, 512, 128
    codes, scales, _ = _operands(rng, O, K, g, "integral")
    x = torch.from_numpy(rng.standard_normal((5, K)).astype(np.float32))
    qw = pack_w4(torch.from_numpy(codes))
    s = torch.from_numpy(scales)
    assert torch.equal(
        w4a16_asym_matmul_plain(x, qw, s, torch.full_like(s, 8.0), g),
        w4a16_matmul_plain(x, qw, s, g))


@pytest.mark.parametrize("zp_kind", ["integral", "fractional"])
def test_asym_codes_recovered_from_qdq(zp_kind):
    """``(code - zp) * scale`` → the codes back, a fractional zero point and
    a scale below 1e-12 included (the JAX engine's guard: such a group's
    scale counts as 1e-12 in the division)."""
    rng = np.random.default_rng(3)
    O, K, g = 16, 512, 128
    codes, scales, zps = _operands(rng, O, K, g, zp_kind)
    scales[0, 0] = 1e-13
    scales[1, 1] = 0.0
    srep, zrep = np.repeat(scales, g, 1), np.repeat(zps, g, 1)
    qdq = ((codes.astype(np.float32) - zrep) * srep).astype(np.float32)
    got = w4_asym_codes_from_qdq(torch.from_numpy(qdq),
                                 torch.from_numpy(scales),
                                 torch.from_numpy(zps), g).numpy()
    guard = np.where(np.abs(srep) < 1e-12, 1e-12, srep)
    want = np.clip(np.rint(qdq / guard + zrep), 0, 15).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    live = np.abs(srep) >= 1e-12
    np.testing.assert_array_equal(got[live], codes[live])


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def asym_pair():
    jcfg = jl.LlamaConfig(vocab_size=128, hidden_size=1024,
                          intermediate_size=1024, num_layers=2, num_heads=8,
                          num_kv_heads=2, head_dim=128, rope_theta=1e4,
                          dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 128, (2, 16))
    prompts = rng.integers(0, 128, (2, 16))
    jres = JAutoRound((jp, jcfg), scheme=dict(ASYM), iters=0,
                      quant_lm_head=True).quantize(jnp.asarray(calib))
    tres = AutoRound((tp, tcfg), scheme=dict(ASYM), iters=0,
                     quant_lm_head=True, device="cpu").quantize(calib)
    je = JQuantizedLlama.from_quantize_result(jres, jcfg, max_seq=32)
    te = QuantizedLlama.from_quantize_result(tres, tcfg, max_seq=32,
                                             device="cpu")
    return dict(jres=jres, tres=tres, je=je, te=te, prompts=prompts)


def test_asym_engine_codes_scales_and_zero_points(asym_pair):
    je, te = asym_pair["je"], asym_pair["te"]
    keys = [f"blocks.{i}.{n}" for i in range(2)
            for n in ("qkv", "o_proj", "gate_up", "down_proj")] + ["lm_head"]
    assert sorted(te.packed) == sorted(keys)
    assert set(te.packed_kinds.values()) == {"w4a16_asym"}
    assert sorted(te.packed_kinds) == sorted(keys)
    for k in keys:
        assert je.packed_kinds[k] == "w4a16_asym"
        jqw, jsc, jzp = je.packed[k]
        tqw, tsc, tzp = te.packed[k]
        np.testing.assert_array_equal(np.asarray(unpack_w4_planes(jqw, 128)),
                                      unpack_w4(tqw).numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(jsc), tsc.numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(jzp), tzp.numpy(), err_msg=k)
        assert tzp.dtype == torch.float32
    assert te.params["lm_head"] is None
    assert te.params["blocks"][1]["down_proj"] is None


def test_asym_engine_logits_and_greedy_tokens(asym_pair):
    je, te, prompts = (asym_pair[k] for k in ("je", "te", "prompts"))
    n_new = 5
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


def test_serving_kind_table():
    """The JAX engine's mapping: every kind of it is ported (the int8, the
    2-bit and the float kinds among them)."""
    from autoround_tpu.schemes import QuantizationScheme as JScheme
    from autoround_tpu.serve.engine import _serving_kind as j_kind
    ported = ("w4a16", "w4a16_asym", "w4a8", "w8a8", "w8a16", "w2a16", "fp8",
              "mxfp4_g16", "mxfp4_g32", None)
    seen = set()
    for kw in (dict(bits=4, group_size=128, sym=True),
               dict(bits=4, group_size=32, sym=False),
               dict(bits=3, group_size=64, sym=True),
               dict(bits=3, group_size=64, sym=False),
               dict(bits=2, group_size=64, sym=True),
               dict(bits=2, group_size=64, sym=False),
               dict(bits=4, group_size=8, sym=True),
               dict(bits=2, group_size=128, sym=True),
               dict(bits=8, group_size=128, sym=True),
               dict(bits=8, group_size=-1, sym=True, act_bits=8),
               dict(bits=4, group_size=128, sym=True, act_bits=8),
               dict(bits=8, group_size=-1, sym=True, act_bits=8,
                    act_group_size=0, act_sym=True, act_data_type="int"),
               dict(bits=4, group_size=128, sym=True, act_bits=8,
                    act_group_size=0, act_sym=True, act_data_type="int"),
               dict(bits=4, group_size=64, sym=True, act_bits=8,
                    act_group_size=0, act_sym=True, act_data_type="int"),
               dict(bits=8, group_size=-1, data_type="fp8"),
               dict(bits=4, group_size=32, data_type="mx_fp"),
               dict(bits=4, group_size=16, data_type="nv_fp")):
        want = j_kind(JScheme(**kw))
        seen.add(want)
        assert want in ported, kw
        assert _serving_kind(QuantizationScheme(**kw)) == want, kw
    assert {"w4a8", "w8a8", "w8a16", "w2a16", "fp8", "mxfp4_g32",
            "mxfp4_g16"} <= seen


def test_fuse_refuses_members_of_different_kinds():
    """A q/k/v group whose members are of two kinds (or of two arities)
    keeps its members; one whose members agree fuses all three payload
    components."""
    cfg = dataclasses.replace(
        config_from_jax(dataclasses.asdict(jl.CONFIG_PRESETS["tiny"])),
        num_layers=2)

    def entry(O, asym):
        e = (torch.zeros((O, 16), dtype=torch.int32), torch.ones((O, 1)))
        return e + (torch.full((O, 1), 7.0),) if asym else e

    packed, kinds = {}, {}
    for bi, asym_k in ((0, False), (1, True)):
        for name, O in (("q_proj", 8), ("k_proj", 4), ("v_proj", 4)):
            asym = True if name != "k_proj" else asym_k
            packed[f"blocks.{bi}.{name}"] = entry(O, asym)
            kinds[f"blocks.{bi}.{name}"] = "w4a16_asym" if asym else "w4a16"
    fused, splits, fkinds = _fuse_packed(packed, cfg, kinds)
    assert "blocks.0.qkv" not in fused and "blocks.0.k_proj" in fused
    assert fkinds["blocks.0.k_proj"] == "w4a16"
    assert splits == {"blocks.1.qkv": (8, 4, 4)}
    assert fkinds["blocks.1.qkv"] == "w4a16_asym"
    assert [tuple(t.shape) for t in fused["blocks.1.qkv"]] == [
        (16, 16), (16, 1), (16, 1)]
    assert "blocks.1.q_proj" not in fused and "blocks.1.q_proj" not in fkinds


# ------------------------------------------------- small groups (g % 32 != 0)
#
# The SYM4 / ASYM4 kernel bodies read a second scale (and zero point) half
# way through a 32-column chunk, so the port packs every w4a16 / w4a16_asym
# layer of g % 16 == 0.  The JAX engine packs them where K % 8g == 0; at
# g = 16 that is every layer of this config (K 256 and 512), and the two
# engines pack the same layers with the same codes.  A g that is not a
# multiple of 16 (24) the JAX engine packs and the port serves dense: a
# recorded deviation (ROADMAP C), pinned here.

def _small_group_pair(scheme, hidden, inter, heads):
    jcfg = jl.LlamaConfig(vocab_size=128, hidden_size=hidden,
                          intermediate_size=inter, num_layers=2,
                          num_heads=heads, num_kv_heads=2, head_dim=64,
                          rope_theta=1e4, dtype=jnp.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(2))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(2)
    calib = rng.integers(0, 128, (2, 16))
    prompts = rng.integers(0, 128, (2, 16))
    jres = JAutoRound((jp, jcfg), scheme=dict(scheme), iters=0,
                      quant_lm_head=True).quantize(jnp.asarray(calib))
    tres = AutoRound((tp, tcfg), scheme=dict(scheme), iters=0,
                     quant_lm_head=True, device="cpu").quantize(calib)
    je = JQuantizedLlama.from_quantize_result(jres, jcfg, max_seq=32)
    te = QuantizedLlama.from_quantize_result(tres, tcfg, max_seq=32,
                                             device="cpu")
    return je, te, prompts


def _logits_match(je, te, prompts, n_steps=3):
    jlog, jc = je.prefill(jnp.asarray(prompts))
    tlog, tc = te.prefill(prompts)
    for step in range(n_steps):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        jlog, jc = je.decode_step(jnp.asarray(tok), jc)
        tlog, tc = te.decode_step(torch.from_numpy(tok), tc)


_MEMBERS = {"qkv": ("q_proj", "k_proj", "v_proj"),
            "gate_up": ("gate_proj", "up_proj")}


def _packed_layers(eng):
    """{layer name: its packed entry} with the fused entries split back
    into their members (the JAX engine also keeps the members)."""
    out = {}
    for key, ent in eng.packed.items():
        head, _, last = key.rpartition(".")
        if last not in _MEMBERS:
            out[key] = ent
            continue
        if isinstance(ent[0], torch.Tensor):
            parts = [torch.split(t, list(eng.fused_splits[key]))
                     for t in ent]
            for i, m in enumerate(_MEMBERS[last]):
                out[f"{head}.{m}"] = tuple(p[i] for p in parts)
    return out


@pytest.mark.parametrize("sym", [True, False])
def test_g16_packs_the_layers_the_jax_engine_packs(sym):
    g = 16
    je, te, prompts = _small_group_pair(
        dict(bits=4, group_size=g, sym=sym, data_type="int"), 256, 512, 4)
    kind = "w4a16" if sym else "w4a16_asym"
    jl_, tl_ = _packed_layers(je), _packed_layers(te)
    assert len(jl_) == 2 * 7 + 1 and "lm_head" in jl_
    assert sorted(tl_) == sorted(jl_)
    assert set(te.packed_kinds.values()) == {kind}
    for k in jl_:
        assert je.packed_kinds[k] == kind
        np.testing.assert_array_equal(
            np.asarray(unpack_w4_planes(jl_[k][0], g)),
            unpack_w4(tl_[k][0]).numpy(), err_msg=k)
        for a, b in zip(jl_[k][1:], tl_[k][1:]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=k)
    assert te.params["lm_head"] is None
    _logits_match(je, te, prompts)


def test_g24_serves_dense_where_the_jax_engine_packs():
    je, te, prompts = _small_group_pair(
        dict(bits=4, group_size=24, sym=True, data_type="int"), 384, 768, 6)
    assert len(_packed_layers(je)) == 2 * 7 + 1
    assert te.packed == {}
    assert te.params["blocks"][0]["q_proj"] is not None
    _logits_match(je, te, prompts)
