"""Port parity: int qdq / RTN in the port equal the JAX package's exactly.

Both sides compute the same IEEE fp32 operations in the same order
(min/max, one division, round-half-even, clip, multiply), so qdq and
scale must be bit-identical; the comparisons below use equality, no
tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.algorithms.rtn import rtn_quantize_layer as j_rtn
from autoround_tpu.dtypes import intq as jintq
from autoround_tpu.schemes import parse_scheme as j_parse
from autoround_tpu_torch.algorithms.rtn import rtn_quantize_layer as t_rtn
from autoround_tpu_torch.dtypes import intq as tintq
from autoround_tpu_torch.dtypes.registry import get_quant_func
from autoround_tpu_torch.dtypes.ste import round_ste
from autoround_tpu_torch.schemes import parse_scheme as t_parse


def _weights(O, I, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((O, I)).astype(np.float32) * 0.05
    # every other row: all-positive-dominant groups (scale sign flip) and
    # an exactly-zero row (the eps guard)
    w[::2] = np.abs(w[::2]) + 0.01
    w[1] = 0.0
    return w


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32),
                                  b.float().numpy())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("shape,g", [((16, 256), 128), ((12, 200), 128),
                                     ((8, 96), 32), ((6, 130), -1)])
def test_qdq_sym_exact(bits, shape, g):
    w = _weights(*shape, seed=bits)
    a = jintq.qdq_int_sym(jnp.asarray(w), bits, g)
    b = tintq.qdq_int_sym(torch.from_numpy(w), bits, g)
    _same(a.qdq, b.qdq)
    _same(a.scale, b.scale)
    assert b.zp is None
    # the full-range flip made some scales negative
    assert (b.scale < 0).any() and (b.scale > 0).any()


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape,g", [((16, 256), 128), ((12, 200), 128),
                                     ((6, 130), -1)])
def test_qdq_asym_exact(bits, shape, g):
    w = _weights(*shape, seed=10 + bits)
    a = jintq.qdq_int_asym(jnp.asarray(w), bits, g)
    b = tintq.qdq_int_asym(torch.from_numpy(w), bits, g)
    _same(a.qdq, b.qdq)
    _same(a.scale, b.scale)
    _same(a.zp, b.zp)


def test_qdq_sym_tuned_params_exact():
    """v / min_scale / max_scale inputs (the SignRound parameters) give the
    same qdq in both packages."""
    rng = np.random.default_rng(3)
    w = _weights(16, 256, seed=3)
    v = rng.uniform(-0.5, 0.5, w.shape).astype(np.float32)
    mn = rng.uniform(0.5, 1.2, (16 * 2,)).astype(np.float32)
    mx = rng.uniform(0.5, 1.2, (16 * 2,)).astype(np.float32)
    for fn_j, fn_t in ((jintq.qdq_int_sym, tintq.qdq_int_sym),
                       (jintq.qdq_int_asym, tintq.qdq_int_asym)):
        a = fn_j(jnp.asarray(w), 4, 128, v=jnp.asarray(v),
                 min_scale=jnp.asarray(mn), max_scale=jnp.asarray(mx))
        b = fn_t(torch.from_numpy(w), 4, 128, v=torch.from_numpy(v),
                 min_scale=torch.from_numpy(mn),
                 max_scale=torch.from_numpy(mx))
        _same(a.qdq, b.qdq)
        _same(a.scale, b.scale)


@pytest.mark.parametrize("scheme", ["W4A16", "W2A16G64", "W3A16", "W8A16",
                                    "GGUF:Q4_1"])
def test_rtn_layer_exact(scheme):
    w = _weights(24, 512, seed=7)
    a = j_rtn(jnp.asarray(w), j_parse(scheme))
    b = t_rtn(torch.from_numpy(w), t_parse(scheme))
    _same(a.qdq, b.qdq)
    _same(a.scale, b.scale)


def test_rtn_bf16_weights_exact():
    """bf16 weights: compute in fp32, cast the qdq back to bf16 (both
    packages round the same fp32 values half-to-even)."""
    w = _weights(16, 256, seed=9)
    a = j_rtn(jnp.asarray(w).astype(jnp.bfloat16), j_parse("W4A16"))
    b = t_rtn(torch.from_numpy(w).to(torch.bfloat16), t_parse("W4A16"))
    assert b.qdq.dtype == torch.bfloat16
    _same(a.qdq.astype(jnp.float32), b.qdq)
    _same(a.scale, b.scale)


def test_registry_resolution():
    assert get_quant_func("int", 4, True, mode="rtn") is not \
        get_quant_func("int", 4, True)
    with pytest.raises(KeyError):      # GGUF double quant: not ported
        get_quant_func("int_dq", 4, True)
    # an imatrix routes sym int to the opt_rtn entry, asym (none
    # registered) to plain RTN, as in the JAX package
    assert get_quant_func("int", 4, True, mode="opt_rtn") is not \
        get_quant_func("int", 4, True)
    assert get_quant_func("int", 4, False, mode="opt_rtn") is \
        get_quant_func("int", 4, False)
    w = _weights(4, 64, seed=1)
    im = np.linspace(0.1, 2.0, 64).astype(np.float32)
    for scheme in ("GGUF:Q4_0", "GGUF:Q4_1"):      # int g32, sym and asym
        a = j_rtn(jnp.asarray(w), j_parse(scheme), imatrix=jnp.asarray(im))
        b = t_rtn(torch.from_numpy(w), t_parse(scheme),
                  imatrix=torch.from_numpy(im))
        _same(a.qdq, b.qdq)


def test_round_ste_half_even_and_identity_grad():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, 1.2], requires_grad=True)
    y = round_ste(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.rint(x.detach().numpy()))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(5, np.float32))
