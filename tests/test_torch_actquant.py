"""Port parity for activation quantization: ``qdq_act``, the stats passes,
the static scales, and ``quantize_model`` with act-quantized schemes
(``iters = 0`` and tuned, static scales with and without act-scale tuning,
``quant_attention``, ``use_imatrix``) against the JAX package.

``tiny`` preset, fp32, CPU.  Inputs are made with numpy from a seed and
handed to both packages.  Tolerances:
  * ``qdq_act`` values: bit-equal with the JAX function under jit, as the
    tuning loss and the quantized chain run it (there XLA turns the
    division by the constant qmax into a product with fp32(1 / qmax), and
    so does the port; outside jit JAX divides, one fp32 ulp away);
    STE gradients: rtol 1e-5 with a floor of 1e-5 of the largest gradient;
  * amax, second moments, static scales, attention scales: rtol 1e-5 (the
    inputs of the later layers of a block went through products summed in
    different orders);
  * RTN (``iters = 0``) qdq and weight scales: exact; static act scales
    rtol 1e-5;
  * tuned runs with activation quantization in the loss: the activations of
    the two packages differ in their last bits, and one that lies on a
    rounding boundary of the int8 grid moves by a whole step (1 / 127 of
    the amax), which moves the loss far more than sign-SGD's last-bit
    noise does without activation quantization (5e-6 there).  Measured
    over these runs (6 steps at the default recipe's lr of 1 / 200): loss
    traces equal to 2e-6, 6e-6, 2e-5, 2.1e-4 and, in the run where a step
    moved, 2.5e-3 relative; every code of every layer equal; tuned static
    act scales equal to 1e-6.  Limits: traces rtol 1e-2 (about 3x the
    worst), codes 99%, act scales rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.algorithms import actquant as jact
from autoround_tpu.models import llama as jl
from autoround_tpu.schemes import QuantizationScheme as JScheme
from autoround_tpu_torch import AutoRound
from autoround_tpu_torch.algorithms import actquant as tact
from autoround_tpu_torch.export import codes_from_qdq
from autoround_tpu_torch.models import llama as tl
from autoround_tpu_torch.schemes import QuantizationScheme
from autoround_tpu_torch.utils.convert import (config_from_jax,
                                               params_from_jax,
                                               quantize_result_to_numpy)
from _port_threads import one_torch_thread  # noqa: F401

JCFG = jl.CONFIG_PRESETS["tiny"]
STAT_RTOL = 1e-5
TRACE_RTOL = 1e-2
CODES_EQUAL_MIN = 0.99
STATIC_A8 = dict(bits=4, group_size=32, sym=True, data_type="int",
                 act_bits=8, act_group_size=0, act_sym=True,
                 act_data_type="int", act_dynamic=False)


def _act_scheme(cls, sym, group_size, bits=8, dynamic=True):
    return cls(bits=4, group_size=32, sym=True, data_type="int",
               act_bits=bits, act_group_size=group_size, act_sym=sym,
               act_data_type="int", act_dynamic=dynamic)


# ---------------------------------------------------------------- qdq_act

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", ["per_tensor", "per_token", "static"])
@pytest.mark.parametrize("sym", [True, False])
def test_qdq_act_values_and_ste_gradients(sym, mode, bits):
    rng = np.random.default_rng(bits + 10 * sym + len(mode))
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 2, 5] = 9.0                 # one outlier sets the per-tensor scale
    r = rng.standard_normal(x.shape).astype(np.float32)
    gs = -1 if mode == "per_token" else 0
    static = np.float32(0.037) if mode == "static" else None
    js = _act_scheme(JScheme, sym, gs, bits, dynamic=static is None)
    ts = _act_scheme(QuantizationScheme, sym, gs, bits,
                     dynamic=static is None)

    @jax.jit
    def jf(xx, ss):
        return jact.qdq_act(xx, js, static_scale=ss)
    want = jf(jnp.asarray(x), None if static is None else jnp.asarray(static))
    tx = torch.from_numpy(x).requires_grad_(True)
    tstat = None if static is None else torch.tensor(
        static, requires_grad=True)
    got = tact.qdq_act(tx, ts, static_scale=tstat)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    if sym and static is None:
        q = got.detach().numpy() / np.abs(x).max() * (2 ** (bits - 1) - 1)
        assert np.abs(q).max() <= 2 ** (bits - 1) - 1 + 1e-3

    jr = jnp.asarray(r)
    if static is not None and sym:
        jgx, jgs = jax.grad(lambda xx, ss: jnp.sum(jf(xx, ss) * jr),
                            argnums=(0, 1))(jnp.asarray(x),
                                            jnp.asarray(static))
        tgx, tgs = torch.autograd.grad((got * torch.from_numpy(r)).sum(),
                                       (tx, tstat))
        np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), rtol=1e-4)
    else:
        jgx = jax.grad(lambda xx: jnp.sum(jf(xx, None if static is None
                                             else jnp.asarray(static)) * jr)
                       )(jnp.asarray(x))
        (tgx,) = torch.autograd.grad((got * torch.from_numpy(r)).sum(), (tx,))
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tgx.numpy(), jgx, rtol=1e-5,
                               atol=1e-5 * np.abs(jgx).max())


FLOAT_ACT = [("mx_fp", 4, 32, True, False), ("mx_fp", 8, 32, True, False),
             ("mx_int", 8, 32, True, False),
             ("nv_fp4_with_static_gs", 4, 16, True, False),
             ("nv_fp4_with_static_gs", 4, 16, True, True),
             ("fp8", 8, 0, True, False), ("fp8", 8, -1, True, False),
             ("fp8", 8, 0, False, True)]


@pytest.mark.parametrize("adt,bits,gs,dynamic,static", FLOAT_ACT,
                         ids=[f"{a}{b}g{g}{'d' if d else 's'}"
                              f"{'-scale' if s else ''}"
                              for a, b, g, d, s in FLOAT_ACT])
def test_float_qdq_act_values_and_ste_gradients(adt, bits, gs, dynamic,
                                                static):
    """The ``mx_``, ``nv_fp`` and ``fp8`` branches against the jitted JAX
    function (as the tuning loss and the quantized chain run it): values
    bit-equal, gradients w.r.t. x rtol 1e-5 with a floor of 1e-5 of the
    largest, w.r.t. a static scale rtol 1e-4 (a sum over every element of x
    in another order, as for the int static scale above; measured 4.4e-5).
    NVFP4 takes a static global scale, fp8 a static scale; without one each
    derives its own from x."""
    rng = np.random.default_rng(bits + len(adt) + 3 * static)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    x[1, 2, 5] = 9.0
    r = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(bits=4, group_size=32, sym=True, data_type="int",
              act_bits=bits, act_group_size=gs, act_sym=True,
              act_data_type=adt, act_dynamic=dynamic)
    js, ts = JScheme(**kw), QuantizationScheme(**kw)
    sv = None
    if static:
        sv = np.float32(2688.0 / 9.0) if adt.startswith("nv") \
            else np.float32(9.0 / 448.0)
    skey = "global_scale" if adt.startswith("nv") else "static_scale"

    def jfn(xx, ss):
        return jnp.sum(jact.qdq_act(xx, js, **{skey: ss}) * jnp.asarray(r))

    want = jax.jit(lambda xx, ss: jact.qdq_act(xx, js, **{skey: ss}))(
        jnp.asarray(x), None if sv is None else jnp.asarray(sv))
    tx = torch.from_numpy(x).requires_grad_(True)
    tss = None if sv is None else torch.tensor(sv, requires_grad=True)
    got = tact.qdq_act(tx, ts, **{skey: tss})
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    argn = (0,) if sv is None else (0, 1)
    jg = jax.jit(jax.grad(jfn, argnums=argn))(
        jnp.asarray(x), None if sv is None else jnp.asarray(sv))
    tg = torch.autograd.grad((got * torch.from_numpy(r)).sum(),
                             (tx,) if sv is None else (tx, tss))
    for i, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5 if i == 0 else 1e-4,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_build_static_act_scales_float_rows():
    """The NVFP4 global scale (448 * 6 / amax) and the static fp8 scale
    (amax / 448), divided as the JAX package divides (eagerly)."""
    amax = {"a": 3.5, "b": 0.0, "c": 7.25, "d": 1e-3}
    kinds = {"a": ("nv_fp4_with_static_gs", 4, True),
             "b": ("fp8", 8, False), "c": ("fp8", 8, True),
             "d": ("fp8", 8, False)}

    def schemes(cls):
        return {n: cls(bits=4, group_size=16, act_bits=b, act_group_size=0,
                       act_sym=True, act_data_type=adt, act_dynamic=dyn)
                for n, (adt, b, dyn) in kinds.items()}
    jst, jgl = jact.build_static_act_scales(
        schemes(JScheme), {n: jnp.asarray(v, jnp.float32)
                           for n, v in amax.items()})
    tst, tgl = tact.build_static_act_scales(
        schemes(QuantizationScheme),
        {n: torch.tensor(v) for n, v in amax.items()})
    assert sorted(tst) == sorted(jst) == ["b", "d"]
    assert sorted(tgl) == sorted(jgl) == ["a"]
    for got, want in ((tst, jst), (tgl, jgl)):
        for n in got:
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_qdq_act_passes_through_and_unported_types_raise():
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    w16 = QuantizationScheme(bits=4, group_size=32)
    assert tact.qdq_act(x, w16) is x
    bf = tact.qdq_act(x.to(torch.bfloat16),
                      _act_scheme(QuantizationScheme, True, 0))
    assert bf.dtype == torch.bfloat16
    # the float activation types are ported: same shape and dtype, values
    # moved onto their grids
    for adt, bits, gs in (("mx_fp", 4, 32), ("nv_fp4_with_static_gs", 4, 16),
                          ("fp8", 8, 0)):
        s = QuantizationScheme(bits=4, group_size=32, act_bits=bits,
                               act_group_size=gs, act_data_type=adt)
        y = tact.qdq_act(x.reshape(1, 2, 8).repeat(1, 1, 4), s)
        assert y.shape == (1, 2, 32) and y.dtype == x.dtype
        assert not torch.equal(y, x.reshape(1, 2, 8).repeat(1, 1, 4))


def test_act_quant_linear_fn_quantizes_only_its_layers():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    names = ("q_proj", "o_proj")
    static = np.float32(0.02)
    jlf = jact.make_act_quant_linear_fn(
        {n: _act_scheme(JScheme, True, 0, dynamic=n == "q_proj")
         for n in names}, {"o_proj": jnp.asarray(static)})
    tlf = tact.make_act_quant_linear_fn(
        {n: _act_scheme(QuantizationScheme, True, 0, dynamic=n == "q_proj")
         for n in names}, {"o_proj": torch.tensor(static)})
    for name in names + ("down_proj",):
        want = np.asarray(jlf(name, jnp.asarray(x), jnp.asarray(w)))
        got = tlf(name, torch.from_numpy(x), torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = torch.einsum("...i,oi->...o", torch.from_numpy(x),
                         torch.from_numpy(w))
    assert torch.equal(tlf("down_proj", torch.from_numpy(x),
                           torch.from_numpy(w)), plain)
    assert not torch.equal(tlf("q_proj", torch.from_numpy(x),
                               torch.from_numpy(w)), plain)


# ------------------------------------------------------------ stats passes

@pytest.fixture(scope="module")
def model():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(JCFG))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ids = np.random.default_rng(1).integers(0, JCFG.vocab_size, (16, 32))
    return dict(jp=jp, tp=tp, tcfg=tcfg, ids=ids)


@pytest.mark.parametrize("kind", ["act", "output", "imatrix"])
def test_stats_passes_equal_on_a_block(model, kind):
    x = np.random.default_rng(3).standard_normal(
        (4, 32, JCFG.hidden_size)).astype(np.float32)
    jcos, jsin = jl.rope_tables(JCFG, 32)
    tcos, tsin = tl.rope_tables(model["tcfg"], 32)
    names = set(tl.LINEAR_KEYS) - {"up_proj"}

    def jfwd(w, xx, lf):
        return jl.block_fwd(w, xx, jcos, jsin, JCFG, linear_fn=lf)

    def tfwd(w, xx, lf):
        return tl.block_fwd(w, xx, tcos, tsin, model["tcfg"], linear_fn=lf)

    jfn = {"act": jact.collect_act_stats, "output": jact.collect_output_stats,
           "imatrix": jact.collect_imatrix}[kind]
    tfn = {"act": tact.collect_act_stats, "output": tact.collect_output_stats,
           "imatrix": tact.collect_imatrix}[kind]
    want = jfn(jfwd, model["jp"]["blocks"][0], jnp.asarray(x), names)
    got = tfn(tfwd, model["tp"]["blocks"][0], torch.from_numpy(x), names)
    assert sorted(got) == sorted(want) == sorted(names)
    for n in names:
        shape = (JCFG.intermediate_size if n == "down_proj"
                 else JCFG.hidden_size,) if kind == "imatrix" else ()
        assert got[n].shape == shape and got[n].dtype == torch.float32
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=STAT_RTOL, err_msg=n)


def test_build_static_act_scales_equal():
    amax = {"a": 3.5, "b": 0.0, "c": 7.25, "d": 1.0}
    kinds = {"a": dict(act_dynamic=False), "b": dict(act_dynamic=False),
             "c": dict(act_dynamic=True),
             "d": dict(act_dynamic=False, act_bits=4)}

    def schemes(cls):
        return {n: cls(bits=4, group_size=32, act_bits=kw.get("act_bits", 8),
                       act_group_size=0, act_sym=True, act_data_type="int",
                       act_dynamic=kw["act_dynamic"])
                for n, kw in kinds.items()}
    jst, jgl = jact.build_static_act_scales(
        schemes(JScheme), {n: jnp.asarray(v, jnp.float32)
                           for n, v in amax.items()})
    tst, tgl = tact.build_static_act_scales(
        schemes(QuantizationScheme),
        {n: torch.tensor(v) for n, v in amax.items()})
    assert sorted(tst) == sorted(jst) == ["a", "b", "d"]
    assert not tgl and not jgl
    for n in tst:
        np.testing.assert_array_equal(tst[n].numpy(), np.asarray(jst[n]))
    assert float(tst["d"]) == pytest.approx(1.0 / 7.0)


# ---------------------------------------------------------- quantize_model

def _both(model, **kw):
    jres = JAutoRound((model["jp"], JCFG), **kw).quantize(
        jnp.asarray(model["ids"]))
    tres = AutoRound((model["tp"], model["tcfg"]), device="cpu",
                     **kw).quantize(model["ids"])
    return jres, tres


def _act_scales_close(jres, tres, static: bool):
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        if not static or name == "lm_head":
            assert jq.act_scale is None and tq.act_scale is None, name
        else:
            assert tq.act_scale.shape == () and float(tq.act_scale) > 0
            np.testing.assert_allclose(tq.act_scale.numpy(),
                                       np.asarray(jq.act_scale),
                                       rtol=STAT_RTOL, err_msg=name)
        assert jq.act_global_scale is None and tq.act_global_scale is None


@pytest.mark.parametrize("scheme,static", [("W4A8", False), ("W8A8", False),
                                           (STATIC_A8, True)])
def test_rtn_with_act_schemes_against_jax(model, scheme, static):
    jres, tres = _both(model, scheme=scheme if isinstance(scheme, str)
                       else dict(scheme), iters=0, quant_lm_head=True)
    assert sorted(jres.layers) == sorted(tres.layers)
    assert len(tres.layers) == JCFG.num_layers * 7 + 1
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(np.asarray(jq.qdq),
                                      tres.layers[name].qdq.numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(jq.scale),
                                      tres.layers[name].scale.numpy(),
                                      err_msg=name)
    _act_scales_close(jres, tres, static)
    out = quantize_result_to_numpy(tres)
    assert (out["layers"]["blocks.0.q_proj"]["act_scale"] is not None) \
        == static


def _compare_tuned(jres, tres):
    assert sorted(jres.loss_traces) == sorted(tres.loss_traces)
    worst = 0.0
    for bi, jt in jres.loss_traces.items():
        tt = tres.loss_traces[bi]
        assert tt.shape == jt.shape and np.isfinite(tt).all()
        worst = max(worst, float(np.abs(tt / jt - 1).max()))
        np.testing.assert_allclose(tt, jt, rtol=TRACE_RTOL)
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        s = jq.scheme
        jc = codes_from_qdq(np.asarray(jq.qdq), np.asarray(jq.scale), None,
                            s.bits, s.group_size)
        tc = codes_from_qdq(tq.qdq.numpy(), tq.scale.numpy(), None, s.bits,
                            s.group_size)
        assert np.mean(jc == tc) >= CODES_EQUAL_MIN, (name, np.mean(jc == tc))
    return worst


@pytest.mark.parametrize("scheme", ["W4A8", STATIC_A8])
def test_tuned_with_act_quant_against_jax(model, scheme):
    """The interceptor is in the tuning loss and on the quantized chain:
    both change the losses (they differ from the weight-only run's)."""
    kw = dict(scheme=scheme if isinstance(scheme, str) else dict(scheme),
              iters=6, batch_size=4, seed=0, lr=5e-3)
    jres, tres = _both(model, **kw)
    _compare_tuned(jres, tres)
    _act_scales_close(jres, tres, static=not isinstance(scheme, str))
    w_only = AutoRound((model["tp"], model["tcfg"]), device="cpu",
                       scheme="W4A16G32" if not isinstance(scheme, str)
                       else "W4A16", iters=6, batch_size=4, seed=0,
                       lr=5e-3).quantize(model["ids"])
    for bi in (0, 1):
        assert abs(w_only.loss_traces[bi][0] - tres.loss_traces[bi][0]) \
            > 1e-3 * w_only.loss_traces[bi][0]


def test_act_scale_tuning_against_jax(model, monkeypatch):
    """Static int8 activations with the shrink factor tuned (the JAX package
    takes the switch from the environment, the port from its config): loss
    traces, codes and the baked static scales."""
    kw = dict(scheme=dict(STATIC_A8), iters=6, batch_size=4, seed=0,
              lr=5e-3)
    monkeypatch.setenv("AR_ENABLE_ACT_MINMAX_TUNING", "1")
    jres = JAutoRound((model["jp"], JCFG), **kw).quantize(
        jnp.asarray(model["ids"]))
    monkeypatch.delenv("AR_ENABLE_ACT_MINMAX_TUNING")
    tres = AutoRound((model["tp"], model["tcfg"]), device="cpu",
                     enable_act_minmax_tuning=True, **kw).quantize(
                         model["ids"])
    _compare_tuned(jres, tres)
    _act_scales_close(jres, tres, static=True)
    fixed = AutoRound((model["tp"], model["tcfg"]), device="cpu",
                      **kw).quantize(model["ids"])
    shrunk = [float(tres.layers[n].act_scale / fixed.layers[n].act_scale)
              for n in tres.layers if n.startswith("blocks.0.")]
    assert all(0.0 < r <= 1.0 for r in shrunk)
    assert any(r < 1.0 for r in shrunk), shrunk


def test_quant_attention_and_imatrix_against_jax(model):
    jres, tres = _both(model, scheme="W4A16G32", iters=0,
                       quant_attention=True, use_imatrix=True)
    assert sorted(tres.attention_scales) == sorted(jres.attention_scales) \
        == list(range(JCFG.num_layers))
    for bi, jsc in jres.attention_scales.items():
        assert sorted(tres.attention_scales[bi]) == ["k_proj", "q_proj",
                                                     "v_proj"]
        for n, v in jsc.items():
            np.testing.assert_allclose(tres.attention_scales[bi][n].numpy(),
                                       np.asarray(v), rtol=STAT_RTOL)
    assert sorted(tres.imatrices) == sorted(jres.imatrices)
    assert len(tres.imatrices) == JCFG.num_layers * 7
    for n, v in jres.imatrices.items():
        assert isinstance(tres.imatrices[n], np.ndarray)
        np.testing.assert_allclose(tres.imatrices[n], v, rtol=STAT_RTOL,
                                   atol=1e-12, err_msg=n)
    plain = AutoRound((model["tp"], model["tcfg"]), device="cpu",
                      scheme="W4A16G32", iters=0).quantize(model["ids"])
    differ = 0
    for name, jq in jres.layers.items():
        tq = tres.layers[name]
        jc = codes_from_qdq(np.asarray(jq.qdq), np.asarray(jq.scale), None,
                            4, 32)
        tc = codes_from_qdq(tq.qdq.numpy(), tq.scale.numpy(), None, 4, 32)
        assert np.mean(jc == tc) >= 0.999, (name, np.mean(jc == tc))
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                   rtol=1e-6, err_msg=name)
        differ += int(not torch.equal(tq.scale, plain.layers[name].scale))
    assert differ > 0      # the imatrix-weighted search moved some scales
