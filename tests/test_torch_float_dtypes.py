"""Port parity for the float data types: FP8 (per tensor, per channel, 2-D
blocks), every MX format and rounding, NVFP4 and fp4_v2, and the
registry's entries for them, against the JAX package; and the port's int,
MX and NVFP4 functions against the reference goldens
(``tests/goldens/reference_qdq.npz``) at ``tests/test_reference_parity.py``'s
tolerances.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
  * qdq values and scales: exact.  The weights are of normal size, so
    every shared exponent lies in [-12, 12], where XLA's ``exp2`` and
    ``log2`` are exact on the CPU; the port builds its powers of two from
    the exponent bits.  Outside that range the JAX package's powers of two
    miss by up to 4.1e-6 relative (one test pins e = -15 and e = 13);
  * values under ``jit``: the JAX tuning loss and activation quantizer run
    jitted, where XLA turns a division by a constant into a product with
    its fp32 reciprocal; the port's ``recip=True`` gives the same bits;
  * STE gradients w.r.t. ``v`` and ``max_scale`` (jitted JAX against the
    port's autograd): rtol 1e-5 with a floor of 1e-5 of the largest
    gradient.  A scale's gradient sums r * (q - w / s) over its group or
    row, terms that cancel to about 1e-3 of their size, and XLA fuses and
    orders them otherwise: measured up to 5.7e-6 of the largest (fp8 per
    channel), 1e-6 or less elsewhere.  The clips of
    ``max_scale`` at its start value 1.0 and of the E2M1 grid at ±6 pass
    half the gradient in both;
  * goldens: rtol 1e-5 / atol 1e-6 (int, MX), rtol 1e-4 / atol 1e-5
    (NVFP4, fp4_v2), as ``tests/test_reference_parity.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.algorithms.rtn import rtn_quantize_layer as j_rtn
from autoround_tpu.dtypes import fp8 as jfp8
from autoround_tpu.dtypes import mxfp as jmx
from autoround_tpu.dtypes import nvfp as jnv
from autoround_tpu.dtypes import registry as jreg
from autoround_tpu.schemes import parse_scheme as j_parse
from autoround_tpu_torch.algorithms.rtn import rtn_quantize_layer as t_rtn
from autoround_tpu_torch.dtypes import fp8 as tfp8
from autoround_tpu_torch.dtypes import intq as tintq
from autoround_tpu_torch.dtypes import mxfp as tmx
from autoround_tpu_torch.dtypes import nvfp as tnv
from autoround_tpu_torch.dtypes import registry as treg
from autoround_tpu_torch.dtypes.ste import pow2
from autoround_tpu_torch.schemes import parse_scheme as t_parse
from _port_threads import one_torch_thread  # noqa: F401

GRAD_RTOL = 1e-5
GRAD_FLOOR = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "reference_qdq.npz")


def _weights(O, I, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((O, I)) * scale).astype(np.float32)
    w[1, :7] = (0.0, -0.0, 1e-9, -1e-9, scale, -scale, 3 * scale)
    return w


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32),
                                  b.detach().float().numpy())


# --------------------------------------------------------- values, scales

FP8_CASES = [("tensor", 0), ("channel", -1), ("block", (128, 128)),
             ("block_ragged", (64, 96))]


@pytest.mark.parametrize("name,gs", FP8_CASES, ids=[c[0] for c in FP8_CASES])
def test_fp8_values_and_scales_exact(name, gs):
    w = _weights(200, 300, seed=1, scale=3.0)
    if isinstance(gs, tuple):
        a = jfp8.qdq_fp8_block(jnp.asarray(w), block=gs)
        b = tfp8.qdq_fp8_block(torch.from_numpy(w), block=gs)
    else:
        a = jfp8.qdq_fp8_sym(jnp.asarray(w), group_size=gs)
        b = tfp8.qdq_fp8_sym(torch.from_numpy(w), group_size=gs)
    _same(a.qdq, b.qdq)
    _same(a.scale, b.scale)
    # static scale and e5m2
    s = np.float32(0.0123)
    _same(jfp8.qdq_fp8_sym(jnp.asarray(w), scale=jnp.asarray(s)).qdq,
          tfp8.qdq_fp8_sym(torch.from_numpy(w), scale=torch.tensor(s)).qdq)
    _same(jfp8.qdq_fp8_sym(jnp.asarray(w), fp8_format="e5m2").qdq,
          tfp8.qdq_fp8_sym(torch.from_numpy(w), fp8_format="e5m2").qdq)


MX_NAMES = ["mx_fp4", "mx_fp6_e2m3", "mx_fp6_e3m2", "mx_fp8", "mx_int2",
            "mx_int4", "mx_int8"]


@pytest.mark.parametrize("rounding", ["floor", "rceil", "rceil_7_25"])
@pytest.mark.parametrize("dt", MX_NAMES)
def test_mx_values_and_scales_exact(dt, rounding):
    # scale 0.5: the shared exponents of mx_fp8 (emax 8) stay >= -12 too
    w = _weights(24, 200, seed=len(dt), scale=0.5 if dt == "mx_fp8" else 0.05)
    a = jmx.qdq_mx(jnp.asarray(w), dt, 32, rounding=rounding)
    b = tmx.qdq_mx(torch.from_numpy(w), dt, 32, rounding=rounding)
    e = np.log2(np.asarray(a.scale))
    assert e.min() >= -12 and e.max() <= 12, (e.min(), e.max())
    _same(a.qdq, b.qdq)
    _same(a.scale, b.scale)


@pytest.mark.parametrize("dt", ["mx_fp4", "mx_fp8"])
def test_mx_qdq_in_slices_of_groups_is_bit_equal(monkeypatch, dt):
    """A weight above the slice size is done a slice of groups at a time
    (an lm_head's fp32 temporaries); the values and scales, and the
    gradients of w, the rounding offset and the clip scale, equal the
    whole-tensor qdq bit for bit, with given uniforms too, and a tail
    slice shorter than the rest."""
    w = torch.from_numpy(_weights(24, 200, seed=3, scale=0.05))
    rng = np.random.default_rng(4)
    groups = 24 * 7                            # 200 columns: 7 groups of 32
    kw = dict(v=torch.from_numpy(rng.uniform(-0.5, 0.5, (24, 200))
                                 .astype(np.float32)),
              max_scale=torch.from_numpy(rng.uniform(0.5, 1.0, groups)
                                         .astype(np.float32)),
              rand=torch.from_numpy(rng.uniform(0, 1, (groups, 32))
                                    .astype(np.float32)))
    dy = torch.from_numpy(rng.standard_normal((24, 200)).astype(np.float32))

    def run(extra):
        leaves = [t.detach().requires_grad_(True)
                  for t in (w, extra.get("v"), extra.get("max_scale"))
                  if t is not None]
        args = dict(extra, **dict(zip(("v", "max_scale"), leaves[1:])))
        r = tmx.qdq_mx(leaves[0], dt, 32, rounding="rceil", **args)
        return r, torch.autograd.grad(r.qdq, leaves, dy, allow_unused=True)

    no_rand = {k: kw[k] for k in ("v", "max_scale")}
    for extra in ({}, no_rand, kw):
        whole, gw = run(extra)
        monkeypatch.setattr(tmx, "_CHUNK_ELEMS", 32 * 10)
        sliced, gs = run(extra)
        monkeypatch.undo()
        assert torch.equal(whole.qdq, sliced.qdq)
        assert torch.equal(whole.scale, sliced.scale)
        if "rand" not in extra:                # uniforms take v's place
            assert all(a is not None for a in gw)
        for a, b in zip(gw, gs):
            assert (a is None and b is None) or torch.equal(a, b)


def test_mx_fp8_e5m2_within_the_exp2_deviation():
    """e5m2 elements (emax 15) put shared exponents below -12 at any normal
    weight size, where the JAX package's exp2 misses the power of two: the
    port's scales are exact powers of two, the JAX package's within 4.1e-6
    relative of them, and the qdq values within the same."""
    w = _weights(8, 128, seed=9)
    a = jmx.qdq_mx(jnp.asarray(w), "mx_fp8_e5m2", 32)
    b = tmx.qdq_mx(torch.from_numpy(w), "mx_fp8_e5m2", 32)
    bs = b.scale.numpy()
    np.testing.assert_array_equal(np.exp2(np.round(np.log2(bs))), bs)
    np.testing.assert_allclose(np.asarray(a.scale), bs, rtol=4.1e-6)
    np.testing.assert_allclose(np.asarray(a.qdq), b.qdq.numpy(), rtol=8.2e-6,
                               atol=0)


@pytest.mark.parametrize("e", [-15, 13])
def test_exp2_deviation_pinned(e):
    """The one known difference, pinned: at a shared exponent of -15 (or
    13) the JAX package's scale is XLA's exp2, off the power of two on the
    CPU by at most 4.1e-6 relative; the port's is 2^e exactly.  Recorded in
    ROADMAP section C."""
    amax = np.float32(2.0 ** (e + 2) * 1.5)       # floor(log2) - 2 = e
    w = np.zeros((1, 32), np.float32)
    w[0, 0] = amax
    a = np.asarray(jmx.qdq_mx(jnp.asarray(w), "mx_fp4", 32).scale)[0, 0]
    b = tmx.qdq_mx(torch.from_numpy(w), "mx_fp4", 32).scale[0, 0].item()
    assert b == 2.0 ** e
    assert a != b and abs(a - b) / b <= 4.1e-6
    assert pow2(torch.tensor([float(e)])).item() == 2.0 ** e


def test_pow2_exact_over_the_e8m0_range():
    e = torch.arange(-149, 128, dtype=torch.float32)
    want = torch.from_numpy(np.ldexp(np.float32(1), np.arange(-149, 128))
                            .astype(np.float32))
    assert torch.equal(pow2(e), want)


@pytest.mark.parametrize("g", [16, 32])
def test_nvfp4_and_fp4_v2_values_and_scales_exact(g):
    w = _weights(24, 160, seed=g)
    a = jnv.qdq_nvfp4(jnp.asarray(w), g)
    b = tnv.qdq_nvfp4(torch.from_numpy(w), g)
    _same(a.qdq, b.qdq)
    _same(a.scale, b.scale)
    gs = np.float32(1234.5)
    _same(jnv.qdq_nvfp4(jnp.asarray(w), g, global_scale=jnp.asarray(gs)).qdq,
          tnv.qdq_nvfp4(torch.from_numpy(w), g,
                        global_scale=torch.tensor(gs)).qdq)
    for use_gs in (False, True):
        a = jnv.qdq_fp4_v2(jnp.asarray(w), g, use_global_scale=use_gs)
        b = tnv.qdq_fp4_v2(torch.from_numpy(w), g, use_global_scale=use_gs)
        _same(a.qdq, b.qdq)
        _same(a.scale, b.scale)


def test_cast_ue5m3_exact():
    rng = np.random.default_rng(4)
    x = np.concatenate([np.exp2(rng.uniform(-20, 17, 3000)),
                        [0.0, 2.0 ** -14, 2.0 ** -17, 114688.0, 1e-9, 3.0]]
                       ).astype(np.float32)
    _same(jnv.cast_ue5m3(jnp.asarray(x)), tnv.cast_ue5m3(torch.from_numpy(x)))


def test_quant_fp_elements_stochastic_and_offsets_exact():
    """The same uniform numbers (and rounding offsets) into both: equal
    elements for every format."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-8, 8, (16, 32)).astype(np.float32)
    u = rng.uniform(0, 1, x.shape).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
    for dt in MX_NAMES:
        fj, ft = jmx.MX_FORMATS[dt], tmx.MX_FORMATS[dt]
        _same(jmx.quant_fp_elements(jnp.asarray(x), fj, rand=jnp.asarray(u)),
              tmx.quant_fp_elements(torch.from_numpy(x), ft,
                                    rand=torch.from_numpy(u)))
        _same(jmx.quant_fp_elements(jnp.asarray(x), fj, v=jnp.asarray(v)),
              tmx.quant_fp_elements(torch.from_numpy(x), ft,
                                    v=torch.from_numpy(v)))
    # through qdq_mx: the generator's numbers, laid out as the groups
    w = _weights(8, 64, seed=2)
    gen = torch.Generator().manual_seed(0)
    r = torch.rand((8 * 2, 32), generator=torch.Generator().manual_seed(0))
    b = tmx.qdq_mx(torch.from_numpy(w), "mx_fp4", 32, generator=gen)
    c = tmx.qdq_mx(torch.from_numpy(w), "mx_fp4", 32, rand=r)
    assert torch.equal(b.qdq, c.qdq)


# ------------------------------------------------------------ registry, RTN

REG_CASES = [("mx_fp", 4, 32), ("mx_fp", 6, 32), ("mx_fp", 8, 32),
             ("mx_int", 4, 32), ("mx_int", 8, 32), ("mx_fp4", 4, 32),
             ("mx_fp6_e3m2", 6, 32), ("mx_int2", 2, 32), ("nv_fp", 4, 16),
             ("nv_fp4_with_static_gs", 4, 16), ("fp4_v2", 4, 32),
             ("fp4_v2_with_global_scale", 4, 16), ("fp8", 8, -1),
             ("fp8", 8, 0), ("fp8", 8, (128, 128)), ("fp8_e5m2", 8, -1),
             ("block_fp8", 8, (128, 128))]


@pytest.mark.parametrize("mode", ["tuned", "rtn", "opt_rtn"])
@pytest.mark.parametrize("dt,bits,g", REG_CASES,
                         ids=[f"{c[0]}{c[1]}g{c[2]}" for c in REG_CASES])
def test_registry_entries_exact(dt, bits, g, mode):
    w = _weights(32, 256, seed=bits,
                 scale=0.5 if dt.startswith("mx") and bits == 8 else 0.05)
    try:
        jf = jreg.get_quant_func(dt, bits, True, mode)
    except KeyError:
        with pytest.raises(KeyError):
            treg.get_quant_func(dt, bits, True, mode)
        return
    tf = treg.get_quant_func(dt, bits, True, mode)
    im = np.random.default_rng(1).uniform(0.1, 2, (256,)).astype(np.float32)
    kw = {} if mode != "opt_rtn" else dict(imatrix=im)
    a = jf(jnp.asarray(w), bits=bits, group_size=g,
           **{k: jnp.asarray(v) for k, v in kw.items()})
    b = tf(torch.from_numpy(w), bits=bits, group_size=g,
           **{k: torch.from_numpy(v) for k, v in kw.items()})
    _same(a.qdq, b.qdq)
    _same(a.scale, b.scale)


@pytest.mark.parametrize("scheme", ["MXFP4", "NVFP4", "FP8_STATIC", "MXFP8",
                                    "MXINT4", "FP8_BLOCK"])
@pytest.mark.parametrize("imatrix", [False, True])
def test_rtn_quantize_layer_exact(scheme, imatrix):
    w = _weights(48, 256, seed=3, scale=0.5 if scheme == "MXFP8" else 0.05)
    im = (np.random.default_rng(2).uniform(0.1, 2, (256,)).astype(np.float32)
          if imatrix else None)
    a = j_rtn(jnp.asarray(w), j_parse(scheme),
              imatrix=None if im is None else jnp.asarray(im))
    b = t_rtn(torch.from_numpy(w), t_parse(scheme),
              imatrix=None if im is None else torch.from_numpy(im))
    _same(a.qdq, b.qdq)
    _same(a.scale, b.scale)


# -------------------------------------------------------- jitted, gradients

def _grad_close(got, want):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    floor = GRAD_FLOOR * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=floor)


GRAD_CASES = [("mx_fp", 4, 32), ("mx_fp", 8, 32), ("mx_fp6_e3m2", 6, 32),
              ("mx_int", 4, 32), ("nv_fp", 4, 16), ("fp4_v2", 4, 32),
              ("fp4_v2_with_global_scale", 4, 16), ("fp8", 8, -1)]


@pytest.mark.parametrize("dt,bits,g", GRAD_CASES,
                         ids=[f"{c[0]}{c[1]}g{c[2]}" for c in GRAD_CASES])
def test_tuned_qdq_and_ste_gradients_equal_jitted_jax(dt, bits, g):
    """The tuning loss's qdq: values under jit (``recip=True``) and the
    gradients w.r.t. ``v`` and ``max_scale``, which start at 0 and at the
    clip bound 1.0, and at values inside the range."""
    rng = np.random.default_rng(bits + g if isinstance(g, int) else 0)
    O, I = 16, 128
    w = _weights(O, I, seed=5, scale=0.5 if bits == 8 and dt != "fp8"
                 else 0.05)
    r = rng.standard_normal((O, I)).astype(np.float32)
    ms_shape = (O, 1 if g == -1 else I // g)
    jf = jreg.get_quant_func(dt, bits, True)
    tf = treg.get_quant_func(dt, bits, True)
    for v0, ms0 in ((0.0, 1.0), (None, None)):
        v = (np.full((O, I), v0, np.float32) if v0 is not None else
             rng.uniform(-0.4, 0.4, (O, I)).astype(np.float32))
        ms = (np.full(ms_shape, ms0, np.float32) if ms0 is not None else
              rng.uniform(0.6, 1.0, ms_shape).astype(np.float32))

        # the weight rides as an argument, as in the tuning loss: a
        # closed-over constant would let XLA fold the global scale
        def jloss(ww, vv, mm):
            q = jf(ww, bits=bits, group_size=g, v=vv, max_scale=mm).qdq
            return jnp.sum(q * r), q

        (_, jq), (gv, gm) = jax.jit(jax.value_and_grad(
            jloss, argnums=(1, 2), has_aux=True))(
                jnp.asarray(w), jnp.asarray(v), jnp.asarray(ms))
        tv = torch.from_numpy(v).requires_grad_(True)
        tm = torch.from_numpy(ms).requires_grad_(True)
        tq = tf(torch.from_numpy(w), bits=bits, group_size=g, v=tv,
                max_scale=tm, recip=True).qdq
        (tq * torch.from_numpy(r)).sum().backward()
        _same(jq, tq)
        if dt != "fp8":                  # fp8 has no rounding offset
            _grad_close(tv.grad, gv)
        _grad_close(tm.grad, gm)
        assert float(np.abs(np.asarray(gm)).max()) > 0


def test_e2m1_grid_bound_passes_half_the_gradient():
    """An element that quantizes to ±6 sits on the clip bound of the grid:
    half its gradient passes, in both packages."""
    x = np.array([[6.0, -6.0, 7.0, 5.9, 1.2]], np.float32)
    fj, ft = jmx.MX_FORMATS["mx_fp4"], tmx.MX_FORMATS["mx_fp4"]
    gj = jax.grad(lambda a: jnp.sum(jmx.quant_fp_elements(a, fj)))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tmx.quant_fp_elements(tx, ft).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(gj))
    assert tx.grad[0, 0].item() == 0.5 and tx.grad[0, 2].item() == 0.0


def test_nvfp4_gradient_of_an_underflowed_group_scale():
    """A group whose e4m3 scale underflows to 0 (a zero group, or one far
    below the static global scale) divides by the 1e-30 floor over the
    global scale.  The JAX package's gradient of that division squares the
    divisor, which overflows, and 0 * inf gives NaN; PyTorch divides twice
    and stays finite.  Recorded in ROADMAP section C; the other groups'
    gradients agree."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32)).astype(np.float32)
    x[0, :16] = 0.0
    x[1, :16] *= 1e-7
    gs = np.float32(2688.0 / 4.0)
    jg = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(jnv.qdq_nvfp4(
        a, 16, global_scale=jnp.asarray(gs)).qdq)))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tnv.qdq_nvfp4(tx, 16, global_scale=torch.tensor(gs),
                  recip=True).qdq.sum().backward()
    assert np.isnan(jg[0, :16]).all() and np.isnan(jg[1, :16]).any()
    assert torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(tx.grad[:, 16:].numpy(), jg[:, 16:],
                               rtol=GRAD_RTOL)


# ----------------------------------------------------------------- goldens

@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDEN)


def _golden_close(got, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("g", [32, 128])
def test_int_goldens(goldens, g, bits, sym):
    w = torch.from_numpy(goldens["input"])
    fn = tintq.qdq_int_sym if sym else tintq.qdq_int_asym
    _golden_close(fn(w, bits, g).qdq,
                  goldens[f"int_{'sym' if sym else 'asym'}_b{bits}_g{g}"],
                  1e-5, 1e-6)


def test_int_sym_tuned_golden(goldens):
    w = torch.from_numpy(goldens["input"])
    v = torch.from_numpy(goldens["tuned_v"]).reshape(w.shape)
    ms = torch.from_numpy(goldens["tuned_ms"])
    _golden_close(tintq.qdq_int_sym(w, 4, 128, v=v, min_scale=ms,
                                    max_scale=ms).qdq,
                  goldens["int_sym_b4_g128_tuned"], 1e-5, 1e-6)


@pytest.mark.parametrize("rounding", ["floor", "rceil"])
@pytest.mark.parametrize("dt", ["mx_fp4", "mx_fp8", "mx_fp6_e2m3",
                                "mx_fp6_e3m2"])
def test_mx_goldens(goldens, dt, rounding):
    w = torch.from_numpy(goldens["input"])
    _golden_close(tmx.qdq_mx(w, dt, 32, rounding=rounding).qdq,
                  goldens[f"mx_{rounding}_{dt}"], 1e-5, 1e-6)


def test_nvfp4_golden(goldens):
    w = torch.from_numpy(goldens["input"])
    _golden_close(tnv.qdq_nvfp4(w, 16).qdq, goldens["nvfp4"], 1e-4, 1e-5)


@pytest.mark.parametrize("use_gs", [False, True])
@pytest.mark.parametrize("g", [16, 32])
def test_fp4_v2_goldens(goldens, g, use_gs):
    w = torch.from_numpy(goldens["input"])
    key = f"fp4_v2_gs_g{g}" if use_gs else f"fp4_v2_g{g}"
    _golden_close(tnv.qdq_fp4_v2(w, g, use_global_scale=use_gs).qdq,
                  goldens[key], 1e-4, 1e-5)
