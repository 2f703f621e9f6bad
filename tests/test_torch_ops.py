"""Port parity: the plain versions of the three ported kernels against
their JAX counterparts, plus the port's W4 packing.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against these plain versions there); here every wrapper is called
on CPU tensors, which is exactly when it takes its plain version.

Tolerances: both sides compute in fp32 from identical fp32 inputs but
reduce in different orders, so results agree to a few fp32 ulps of the
output magnitude: rtol = atol = 1e-5 unless stated otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.ops.decode_attention import (decode_attention as j_dec,
                                                decode_attention_ref)
from autoround_tpu.ops.flash_attention import flash_attention_ref
from autoround_tpu.ops.qmatmul import (pack_w4_planes, unpack_w4_planes,
                                       w4a16_matmul_ref)
from autoround_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_plain)
from autoround_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)
from autoround_tpu_torch.ops.qmatmul import (pack_w4, unpack_w4, w4a16_matmul,
                                             w4a16_matmul_plain)

_MASK = -0.7 * float(np.finfo(np.float32).max)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.float().numpy() if torch.is_tensor(b)
                               else np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- flash

def _jax_lse(q, k, causal):
    """logsumexp of the masked scaled scores, the reference the kernel's
    lse is held to (flash_attention_ref returns only the output)."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    k = jnp.repeat(k, rep, axis=1)
    s = jnp.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(D)
    if causal:
        T = k.shape[2]
        s = jnp.where(jnp.tril(jnp.ones((S, T), bool), k=T - S), s, _MASK)
    return jax.nn.logsumexp(s, axis=-1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("S,T", [(128, 128), (64, 192)])
def test_flash_plain_matches_ref(S, T, rep, causal):
    rng = np.random.default_rng(S + T + rep)
    Hkv, D = 2, 128
    q = rng.standard_normal((2, Hkv * rep, S, D)).astype(np.float32)
    k = rng.standard_normal((2, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((2, Hkv, T, D)).astype(np.float32)
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal)
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal)
    _close(want, out)
    _close(_jax_lse(jnp.asarray(q), jnp.asarray(k), causal), lse)
    assert lse.shape == (2, Hkv * rep, S) and lse.dtype == torch.float32


def test_flash_bottom_right_offset():
    """S < T: the last query row sees every key, the first sees T - S + 1."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 128)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 5, 128)).astype(
        np.float32))
    v = torch.eye(5, 128).reshape(1, 1, 5, 128)
    out, _ = flash_attention_plain(q, k, v, causal=True)
    assert (out[0, 0, 0, :4] > 0).all() and out[0, 0, 0, 4] == 0
    assert (out[0, 0, 1, :5] > 0).all()


# ---------------------------------------------------------------- w4a16

@pytest.mark.parametrize("g", [128, 256])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_w4a16_plain_matches_ref(g, lead):
    rng = np.random.default_rng(g + len(lead))
    O, K = 96, 2048
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    # signed scales: the full-range flip makes about half negative
    scales = (rng.uniform(0.005, 0.02, (O, K // g))
              * rng.choice([-1.0, 1.0], (O, K // g))).astype(np.float32)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    want = w4a16_matmul_ref(jnp.asarray(x),
                            pack_w4_planes(jnp.asarray(codes), g),
                            jnp.asarray(scales), g)
    got = w4a16_matmul(torch.from_numpy(x), pack_w4(torch.from_numpy(codes)),
                       torch.from_numpy(scales), g)
    assert got.shape == (*lead, O)
    # sums of K=2048 fp32 products, |y| ~ 1: 1e-4 covers the order change
    _close(want, got, 1e-4)


def test_w4a16_plain_bf16_rounding():
    """bf16 activations: both dequantize to bf16, accumulate in fp32 and
    round the output to bf16 — equal up to one bf16 ulp of the output."""
    rng = np.random.default_rng(1)
    O, K, g = 64, 1024, 128
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    scales = rng.uniform(-0.02, 0.02, (O, K // g)).astype(np.float32)
    x = rng.standard_normal((4, K)).astype(np.float32)
    want = w4a16_matmul_ref(jnp.asarray(x, jnp.bfloat16),
                            pack_w4_planes(jnp.asarray(codes), g),
                            jnp.asarray(scales), g)
    got = w4a16_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                             pack_w4(torch.from_numpy(codes)),
                             torch.from_numpy(scales), g)
    assert got.dtype == torch.bfloat16
    a = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(a, got.float().numpy(), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("O,K", [(8, 64), (33, 1024), (130, 4096)])
def test_pack_roundtrip_and_codes_equal_jax(O, K):
    rng = np.random.default_rng(O)
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    words = pack_w4(torch.from_numpy(codes))
    assert words.dtype == torch.int32 and words.shape == (O, K // 8)
    np.testing.assert_array_equal(unpack_w4(words).numpy(), codes)
    if K % 1024 == 0:
        jax_codes = unpack_w4_planes(pack_w4_planes(jnp.asarray(codes), 128),
                                     128)
        np.testing.assert_array_equal(unpack_w4(words).numpy(),
                                      np.asarray(jax_codes))


def test_pack_layout_is_column_major_nibbles():
    codes = torch.arange(16, dtype=torch.int32).reshape(1, 16) % 16
    w = pack_w4(codes)
    assert (w[0, 0].item() & 0xFFFFFFFF) == 0x76543210
    assert (w[0, 1].item() & 0xFFFFFFFF) == 0xFEDCBA98


# ---------------------------------------------------------------- decode

def _dec_inputs(B, T, nkv, G, seed):
    rng = np.random.default_rng(seed)
    nh = nkv * G
    q = rng.standard_normal((B, nh, 128)).astype(np.float32)
    kc = rng.integers(-127, 128, (B, T, nkv, 128)).astype(np.int8)
    vc = rng.integers(-127, 128, (B, T, nkv, 128)).astype(np.int8)
    ks = rng.uniform(0.01, 0.03, (nkv,)).astype(np.float32)
    vs = rng.uniform(0.01, 0.03, (nkv,)).astype(np.float32)
    sinks = rng.standard_normal((nh,)).astype(np.float32)
    return q, kc, vc, ks, vs, sinks


@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("case", ["scalar", "per_slot", "window", "chunk",
                                  "softcap", "sinks"])
def test_decode_plain_matches_ref_and_interpret(G, case):
    B, T, nkv = 3, 256, 2
    q, kc, vc, ks, vs, sinks = _dec_inputs(B, T, nkv, G, seed=G)
    pos = np.array([200], np.int32) if case == "scalar" else \
        np.array([0, 130, 255], np.int32)
    kw = dict(softcap=30.0 if case == "softcap" else 0.0,
              window=100 if case == "window" else None,
              chunk=96 if case == "chunk" else None)
    sm = 1.0 / np.sqrt(128)
    j_args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
              jnp.asarray(np.broadcast_to(pos, (B,))), jnp.asarray(ks),
              jnp.asarray(vs), sm)
    js = jnp.asarray(sinks) if case == "sinks" else None
    ref = decode_attention_ref(*j_args, kw["softcap"], kw["window"], js,
                               chunk=kw["chunk"])
    kern = j_dec(*j_args, sinks=js, interpret=True, **kw)
    ts = torch.from_numpy(sinks) if case == "sinks" else None
    tpos = torch.from_numpy(pos) if case != "scalar" else int(pos[0])
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), tpos, torch.from_numpy(ks),
                           torch.from_numpy(vs), sm, sinks=ts, **kw)
    _close(ref, got)
    # the Pallas kernel in interpret mode, at the JAX tests' own 2e-4
    _close(kern, got, 2e-4)
    plain = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc), tpos,
                                   torch.from_numpy(ks), torch.from_numpy(vs),
                                   sm, kw["softcap"], kw["window"], ts,
                                   chunk=kw["chunk"])
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


# ---------------------------------------------------------------- wrappers

def test_wrappers_never_fall_back_off_cpu():
    """A tensor on neither the CPU nor a CUDA device raises: the plain
    version is taken only for CPU tensors, and no launch is counted."""
    before = (flash_attention.launches, w4a16_matmul.launches,
              decode_attention.launches)
    m = torch.empty((1, 2, 64, 128), device="meta")
    with pytest.raises(ValueError):
        flash_attention(m, m, m)
    with pytest.raises(ValueError):
        w4a16_matmul(torch.empty((2, 1024), device="meta"),
                     torch.empty((8, 128), dtype=torch.int32, device="meta"),
                     torch.empty((8, 8), device="meta"))
    with pytest.raises(ValueError):
        decode_attention(torch.empty((1, 8, 128), device="meta"),
                         torch.empty((1, 16, 2, 128), dtype=torch.int8,
                                     device="meta"),
                         torch.empty((1, 16, 2, 128), dtype=torch.int8,
                                     device="meta"),
                         0, torch.ones(2), torch.ones(2), 0.1)
    assert (flash_attention.launches, w4a16_matmul.launches,
            decode_attention.launches) == before
