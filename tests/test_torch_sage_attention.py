"""Port parity for the int8-QK (SageAttention-style) attention: the plain
version of ``sage_attention`` against the JAX package's
``sage_attention_ref`` (called eagerly) and the jitted ``sage_attention``
(which off the TPU runs that reference under jit).

The CUDA kernel runs only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the plain version there); here
the wrapper is called on CPU tensors, which is exactly when it takes its
plain version.  Inputs are made with numpy from a seed and handed to both
packages.

The two division forms: eagerly ``_int8_rows`` divides by 127 and the
reference by √D; under jit XLA multiplies by their fp32 reciprocals.
``recip=False`` / ``True`` follow each.

The mean key is an fp32 sum over T; PyTorch and XLA add in other orders,
so the two means may differ in the last bit, and a smoothed key that lies
within that bit of a rounding boundary then gets another int8 code.  The
parity tests therefore hand the plain version the JAX package's own mean
(``k_mean``, as the kernel takes it); the port's own mean is held to the
JAX mean and, end to end, to a looser limit.

Tolerances (fp32 on the CPU):
  * int8 codes and scales: bit-equal in each form (the same IEEE
    operations);
  * outputs on the JAX mean: 1e-5 of the largest |output|, the int32
    scores, the softmax and P·V summing in other orders (measured up to
    5e-7);
  * the port's mean: within 2 fp32 ulps of the JAX mean (rtol 2.4e-7 of
    the largest |mean|); end to end on it, 5e-3 of the largest |output|,
    the JAX test's own limit for the int8 path: one code flipped by a
    last-bit difference of the mean moves an output by about 5e-4 of the
    largest (measured);
  * bf16 inputs: one bf16 ulp of the largest |output| (rtol 2^-7), both
    sides rounding P and the output to bf16;
  * the JAX test's own two properties at its limits: mean abs error below
    5e-3 against ``flash_attention_ref`` with a +2 key offset that the
    smoothing must absorb, and causality with GQA within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.ops.flash_attention import flash_attention_ref
from autoround_tpu.ops.sage_attention import (_int8_rows, sage_attention,
                                              sage_attention_ref)
from autoround_tpu_torch.ops import sage_attention as ts
from autoround_tpu_torch.ops.sage_attention import (int8_rows,
                                                    sage_attention_plain)

OUT_RTOL = 1e-5
# (B, H, Hkv, S, T, D, causal): GQA 1 / 2 / 4 / 8, T > S, T < S (the
# reference's uniform rows), D of the JAX tests and of the kernel
SHAPES = [(2, 4, 4, 64, 64, 32, True), (1, 4, 2, 16, 16, 8, True),
          (2, 8, 2, 32, 48, 32, False), (1, 4, 1, 64, 96, 128, True),
          (1, 8, 1, 32, 64, 64, False), (1, 2, 2, 48, 32, 64, True)]


def _inputs(seed, B, H, Hkv, S, T, D, offset=2.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, T, D)) + offset).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("form", ["eager", "jit"])
def test_int8_rows_codes_and_scales_bit_equal(form):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 40, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                           # the 1e-8 floor
    x[0, 0, 1] = 1e-9
    fn = _int8_rows if form == "eager" else jax.jit(_int8_rows)
    jc, js = fn(jnp.asarray(x))
    tc, tsc = int8_rows(torch.from_numpy(x), recip=form == "jit")
    assert tc.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js), tsc.numpy())


def test_the_two_division_forms_differ():
    """Each form is pinned: on these rows the eager and the jitted scales
    differ in some last bits, so a test could not pass with one form for
    both."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 40, 64)) * 3).astype(np.float32)
    _, se = int8_rows(torch.from_numpy(x), recip=False)
    _, sj = int8_rows(torch.from_numpy(x), recip=True)
    assert not torch.equal(se, sj)
    np.testing.assert_allclose(se.numpy(), sj.numpy(), rtol=2e-7)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=OUT_RTOL * np.abs(want).max())


def _jax_mean(k, jitted):
    def mean(a):
        return jnp.mean(a, axis=2)
    fn = jax.jit(mean) if jitted else mean
    return torch.from_numpy(np.array(fn(jnp.asarray(k))))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_eager_reference(shape):
    B, H, Hkv, S, T, D, causal = shape
    q, k, v = _inputs(sum(shape[:6]), B, H, Hkv, S, T, D)
    rep = H // Hkv
    want = sage_attention_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
                              jnp.asarray(np.repeat(v, rep, 1)), causal)
    got = sage_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, recip=False,
                               k_mean=_jax_mean(k, False))
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jitted_op(shape):
    B, H, Hkv, S, T, D, causal = shape
    q, k, v = _inputs(sum(shape[:6]) + 1, B, H, Hkv, S, T, D)
    want = sage_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal)
    got = sage_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, recip=True,
                               k_mean=_jax_mean(k, True))
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_own_mean_end_to_end(shape):
    """The port's own mean key: within 2 ulps of JAX's, and the whole op
    within the int8 path's limit of the jitted JAX op."""
    B, H, Hkv, S, T, D, causal = shape
    q, k, v = _inputs(sum(shape[:6]), B, H, Hkv, S, T, D)
    mean = ts.key_mean(torch.from_numpy(k))
    want_mean = _jax_mean(k, True)
    np.testing.assert_allclose(mean.numpy(), want_mean.numpy(), rtol=0,
                               atol=2.4e-7 * want_mean.abs().max().item())
    want = np.asarray(sage_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal))
    got = sage_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, recip=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-3 * np.abs(want).max())


def test_bf16_inputs():
    B, H, Hkv, S, T, D = 1, 4, 2, 64, 64, 128
    q, k, v = _inputs(7, B, H, Hkv, S, T, D)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = sage_attention(jq, jk, jv, True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    k_mean = torch.from_numpy(np.array(jax.jit(
        lambda a: jnp.mean(a.astype(jnp.float32), axis=2))(jk)))
    got = sage_attention_plain(tq, tk, tv, True, recip=True, k_mean=k_mean)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_int8_matches_bf16_closely():
    """The JAX test's property through the port's entry point: mean-smoothed
    per-token int8 QK tracks the fp path, the +2 key offset absorbed."""
    B, H, S, D = 2, 4, 64, 32
    q, k, v = _inputs(0, B, H, H, S, S, D)
    y = ts.sage_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    want = np.asarray(flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), True))
    err = float(np.mean(np.abs(y.numpy() - want)))
    assert err < 5e-3, err


def test_gqa_causality():
    B, H, Hkv, S, D = 1, 4, 2, 16, 8
    q, k, v = _inputs(3, B, H, Hkv, S, S, D, offset=0.0)
    y = ts.sage_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 1:] = 0.0
    v2[:, :, 1:] = 0.0
    y2 = ts.sage_attention(torch.from_numpy(q), torch.from_numpy(k2),
                           torch.from_numpy(v2), causal=True)
    np.testing.assert_allclose(y[:, :, 0].numpy(), y2[:, :, 0].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_on_cpu_matches_the_jitted_op(causal, monkeypatch):
    """On a CPU tensor the entry point runs the plain version in the
    reciprocal form, the kernel's and the jitted JAX op's: bit-equal to
    ``recip=True`` and not to the eager form, and on JAX's mean key within
    1e-5 of the jitted op."""
    q, k, v = _inputs(5, 1, 4, 2, 32, 64, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = ts.sage_attention.launches
    got = ts.sage_attention(tq, tk, tv, causal)
    assert torch.equal(got, sage_attention_plain(tq, tk, tv, causal,
                                                 recip=True))
    assert not torch.equal(got, sage_attention_plain(tq, tk, tv, causal,
                                                     recip=False))
    monkeypatch.setattr(ts, "key_mean", lambda _: _jax_mean(k, True))
    _close(ts.sage_attention(tq, tk, tv, causal),
           sage_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal))
    assert ts.sage_attention.launches == before
