"""The int8 GEMV's order of summation, on the CPU.

``csrc/a8_tiles.cuh``'s GEMV (M <= 32) multiplies the int8 codes of the
activations by the weights on tensor cores (``mma.sync.m16n8k32`` s8).  Each
mma takes one aligned 32-column chunk of K, so a W4A8 group (g % 32 == 0)
is complete after g / 32 mmas and its int32 sum is exact.  ``gemv_plan``
may split K over a thread-block cluster of kc blocks (kc in 1, 2, 4, 8, 16,
from host shapes only) in ranges of whole units: a group of g / 32 chunks
for W4A8, one chunk for W8A8.  Rank r takes the units r * upb .. r * upb +
upb - 1 with upb = ceil(units / kc), so the last ranks may hold fewer units
or none.  Inside a rank W4A8 closes each group in order, ``accf = accf +
float(acc_g) * s_g`` (fp32, a separate multiply and add); rank 0 then adds
the ranks' fp32 partial sums in the order 1, 2, ... through distributed
shared memory and multiplies by the row scale xs.  W8A8 adds int32 sums,
exact in any order, and applies ``float(acc) * xs * ws``.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
there); here ``_w4a8_split`` and ``_w8a8_split`` mirror that order in torch
and are held against the JAX package's ``w4a8_matmul_ref`` and
``w8a8_matmul_ref`` on inputs made from a seed with numpy, and against the
port's plain versions, which the card tests hold the kernel to.

Tolerances: against JAX, rtol = atol = 1e-4 for W4A8 (the JAX test's own:
its ref sums all K fp32 products at once) and rtol 1e-5 for W8A8 (the same
exact integers and the same two fp32 multiplications); against the plain
version, W4A8 at kc = 1 and W8A8 at every kc bit for bit, W4A8 at kc > 1
within 1e-5 of a row's RMS (``chip_smoke.W4A8_F32_ROW_TOL``: the
rank-ordered sum moves an output by a few fp32 ulps of the partial sums).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.ops import qmatmul_int8 as jint8
from autoround_tpu_torch.ops.qmatmul import pack_w4, unpack_w4
from autoround_tpu_torch.ops.qmatmul_int8 import (quantize_rows_plain,
                                                  w4a8_matmul_plain,
                                                  w8a8_matmul_plain)
from _port_threads import one_torch_thread  # noqa: F401

CHUNK = 32                   # columns of one mma
F32_ROW_TOL = 1e-5


def _rank_chunks(K, unit, kc):
    """The chunk range [lo, hi) of each of the kc ranks (empty ranks
    included)."""
    units = K // CHUNK // unit
    upb = -(-units // kc)
    n_chunks = K // CHUNK
    return [(min(n_chunks, r * upb * unit),
             min(n_chunks, (r + 1) * upb * unit)) for r in range(kc)]


def _w4a8_split(x, qweight, scales, g, kc):
    """The GEMV's W4A8 sums in torch: per rank, each group's exact integer
    dot (in float64) as fp32 times its scale, added in group order; the
    ranks' fp32 sums added in rank order; times xs.  fp32 (M, O)."""
    K = x.shape[-1]
    xi, xs = quantize_rows_plain(x)
    xd = xi.double()
    wd = (unpack_w4(qweight) - 8).double()
    sc = scales.float()
    total = None
    for lo, hi in _rank_chunks(K, g // CHUNK, kc):
        accf = torch.zeros((x.shape[0], qweight.shape[0]))
        for c0 in range(lo * CHUNK, hi * CHUNK, g):
            part = (xd[:, c0:c0 + g] @ wd[:, c0:c0 + g].T).float()
            accf = accf + part * sc[:, c0 // g][None, :]
        total = accf if total is None else total + accf
    return total * xs[:, None]


def _w8a8_split(x, wi, ws, kc):
    """The GEMV's W8A8 sums: per rank the exact integer dot, the ranks'
    sums added in rank order (exact), float(acc) * xs * ws."""
    xi, xs = quantize_rows_plain(x)
    acc = torch.zeros((x.shape[0], wi.shape[0]), dtype=torch.int64)
    for lo, hi in _rank_chunks(x.shape[-1], 1, kc):
        acc = acc + xi[:, lo * CHUNK:hi * CHUNK].long() \
            @ wi[:, lo * CHUNK:hi * CHUNK].long().T
    return acc.float() * xs[:, None] * ws.float()[None, :]


def _row_err(got, want):
    d = (got - want).abs().amax(-1)
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return (d / rms).max().item()


@functools.lru_cache(maxsize=None)
def _w4a8_case(M, O, K, g):
    """Inputs from a seed and the JAX ref's fp32 output (its byte-pair
    layout needs K % 256 == 0; any g works with it)."""
    rng = np.random.default_rng(M * 1000 + K + g)
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    scales = (rng.uniform(0.005, 0.02, (O, K // g))
              * rng.choice([-1.0, 1.0], (O, K // g))).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    want = jint8.w4a8_matmul_ref(jnp.asarray(x),
                                 jint8.pack_w4_bytes(jnp.asarray(codes)),
                                 jnp.asarray(scales), g)
    return codes, scales, x, np.asarray(want)


# K = 1536 at g = 128 is 12 groups: kc = 8 leaves six ranks of 2 and two
# empty ones, kc = 16 twelve of 1 and four empty.  K = 1280 at g = 32 is 40
# chunks, each a group: kc = 16 leaves thirteen ranks of 3, one of 1 and
# two empty.  g = 96 groups are three chunks (kc = 8: eight ranks of one).
W4_SHAPES = [(40, 1536, 128), (24, 1280, 32), (24, 768, 96)]


@pytest.mark.parametrize("kc", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("O,K,g", W4_SHAPES)
def test_w4a8_split_matches_ref(O, K, g, kc):
    """Nine tokens: each output is summed on its own, so the number of
    tokens does not change the order."""
    codes, scales, x, want = _w4a8_case(9, O, K, g)
    xt = torch.from_numpy(x)
    qw = pack_w4(torch.from_numpy(codes))
    sc = torch.from_numpy(scales)
    got = _w4a8_split(xt, qw, sc, g, kc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = w4a8_matmul_plain(xt, qw, sc, g, torch.float32)
    if kc == 1:
        assert torch.equal(got, plain)
    assert _row_err(got, plain) <= F32_ROW_TOL


@pytest.mark.parametrize("kc", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("M,O,K", [(8, 32, 1056), (3, 8, 14336)])
def test_w8a8_split_is_exact(M, O, K, kc):
    """K = 1056 is 33 chunks (kc = 16: sixteen ranks of 3 or fewer, the
    last ones empty); K = 14336 at full code range carries the int32 sum
    past 2^24, where fp32 would round."""
    rng = np.random.default_rng(K + kc)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] = np.abs(x[0]) + 3.0
    wi = rng.integers(-128, 128, (O, K)).astype(np.int8)
    wi[0] = 127
    ws = rng.uniform(-0.02, 0.02, (O,)).astype(np.float32)
    xt, wt, st = (torch.from_numpy(a) for a in (x, wi, ws))
    got = _w8a8_split(xt, wt, st, kc)
    assert torch.equal(got, w8a8_matmul_plain(xt, wt, st, torch.float32))
    want = jint8.w8a8_matmul_ref(jnp.asarray(x), jnp.asarray(wi),
                                 jnp.asarray(ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-30)


@pytest.mark.parametrize("K,unit", [(1536, 4), (1280, 1), (768, 3),
                                    (1056, 1)])
def test_ranks_cover_k_once_in_whole_units(K, unit):
    """Every chunk of K lies in exactly one rank, each rank's range starts
    and ends on a unit (a W4A8 group) boundary, and the ranks come in
    order, so the sum over ranks is the sum over K in rank order."""
    for kc in (1, 2, 4, 8, 16):
        ranges = _rank_chunks(K, unit, kc)
        assert len(ranges) == kc
        chunks = [c for lo, hi in ranges for c in range(lo, hi)]
        assert chunks == list(range(K // CHUNK))
        assert all(lo % unit == 0 and (hi % unit == 0 or lo == hi)
                   for lo, hi in ranges)
