"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and skip without one.  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which these tests
neither use nor need.)  They cover the edges ``chip_smoke.py`` does not
reach: every GEMV template of the W4A16 kernels (ungrouped, grouped, asym),
ragged O, small groups, every activation layout the grouped kernel takes,
integral and fractional zero points, the int8 kinds (``quantize_rows``,
W8A8, W4A8, W8A16: every GEMV template and the GEMM body, ragged O, g of
32, 128 and 256, per-channel and per-group scales, negative scales, an
all-zero activation row), D = 256 and S < T flash attention (forward and
the backward pair, every GQA ratio, run-to-run bit equality, autograd
through the op), every GQA ratio and mask of the decode kernel, and the
wrappers' refusals.

Tolerance: both sides give bf16.  In each output row (last axis), max
|kernel - plain| over the RMS of the plain row must stay within the
kernel's limit (rows are held to their own scale: attention rows differ
~10x in size).  The limits are ``chip_smoke.py``'s, about 3x the worst
row error measured on an H100 at the main path's shapes (flash 0.034, the
same as SDPA's against the plain version; W4A16 0.037; decode attention
0.0072): bf16 output rounding plus the plain version's rounding of each
weight (W4A16) or probability (flash) to bf16.  The backward pair against
``flash_attention_bwd_plain``: measured worst rows dQ 0.027, dK 0.023, dV
0.020 at the main path's shapes, limit 0.07; a gradient row may be zero in
exact arithmetic (row 0 of dQ when S = T), so a row's RMS counts as at
least 1% of the tensor's.

The int8 kinds: ``quantize_rows`` gives the plain version's codes and
scales bit for bit.  The integer part of W8A8 and W4A8 is exact on both
sides, so their fp32 results before the cast are held directly: W8A8 and
the W4A8 GEMM body (M > 32) bit-equal to the plain version; the W4A8 GEMV
body (M <= 32) sums the groups' fp32 terms in another order (measured
worst row 2.1e-6 of the row's RMS on an H100, limit 1e-5).  W8A16 is held
like W4A16 (measured worst row 0.049 per channel at K = 14336, limit
0.15).

The float and 2-bit kinds (every GEMV template and the GEMM body, ragged O,
K edges where K is a multiple of 32 but not of 64, scales below 1e-12):
W2A16 as W4A16 (measured worst row 0.035, limit 0.1); MXFP4 / NVFP4 at g =
32 and 16 (the GEMV reads a second scale inside a 32-column chunk at g =
16; measured 0.036, limit 0.1); FP8 applies the channel scale to the fp32
sum where the plain version rounds w * s to bf16 first (measured 0.056,
limit 0.15).

Groups of 16 (and 48: a group that starts half way through a GEMV chunk)
for the sym, asym and grouped W4A16 kernels, held like W4A16; the decode
kernel at every head dim (64, 128, 256) and G (1 to 8) it takes, with the
window and sinks, the softcap and the chunk; the int8-QK attention against
its plain version on the same mean key (D 128 and 256, causal or not, T
> S, GQA 1 / 4 / 8; limit 0.1 as flash: the same codes and scores, P
rounded to bf16 after an online softmax), and its refusals.

The pipelined GEMM body (M > 32) in every weight format, at K with a half
last k-step (K % 64 == 32), groups of 16, 48, 128 and K, M edges, an odd
O, and the grouped form's expert axis with a shared slab and a slice
layout; the register-resident flash forward at D = 128 and 256, T = 320
(an odd tile count), S < T causal and GQA 1 / 4 / 8.  Both are held to the
limits above.

The backward pair on wgmma (dQ; dK/dV summed over the group): kv loops of
an odd tile count, one q tile against eight kv tiles, the tuning step's
B1 H32 Hkv8 S=T=512, D = 128 and 256, causal or not, held like the rest of
the pair with run-to-run bit equality and the autograd route; and each of
its two wgmma products alone against ``torch.matmul`` in fp32 (both operands
K-major from TMA boxes; A in registers with B read MN-major), to 1e-5
relative: the products of bf16 values are exact in fp32 and only the order
of the sums differs.

The decode kernel split over T: per-slot positions on piece boundaries, a
window and a chunk shorter than a piece (empty pieces, with the sinks
too), B = 1 and 16, run-to-run bit equality; the int8 GEMM body on wgmma
at M = 33, 255, 257 and 4096, a ragged O, K not a multiple of its
128-column k-step, g of 32, 64, 96, 128, 256 and K, its fp32 result
bit-equal to the plain version for W8A8 and W4A8.
"""

import pytest
import torch

from autoround_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_plain)
from autoround_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_plain)
from autoround_tpu_torch.ops.qmatmul import (pack_w4, w4a16_matmul,
                                             w4a16_matmul_grouped,
                                             w4a16_matmul_grouped_plain,
                                             w4a16_matmul_plain)
from autoround_tpu_torch.ops.qmatmul_ext import (
    fp8_matmul, fp8_matmul_plain, mxfp4_matmul, mxfp4_matmul_plain, pack_w2,
    w2a16_matmul, w2a16_matmul_plain, w4a16_asym_matmul,
    w4a16_asym_matmul_plain, w8a16_matmul, w8a16_matmul_plain)
from autoround_tpu_torch.ops.sage_attention import (sage_attention,
                                                    sage_attention_plain)
from autoround_tpu_torch.ops.qmatmul_int8 import (quantize_rows,
                                                  quantize_rows_plain,
                                                  w4a8_matmul,
                                                  w4a8_matmul_plain,
                                                  w8a8_matmul,
                                                  w8a8_matmul_plain)

pytestmark = pytest.mark.cuda
ROW_TOL = {"flash": 0.1, "w4a16": 0.1, "decode": 0.025, "flash_bwd": 0.07,
           "w8a16": 0.15, "w4a8_f32": 1e-5, "w2a16": 0.1, "mxfp4": 0.1,
           "fp8": 0.15, "sage": 0.1}
BWD_ROW_FLOOR = 0.01
LSE_ATOL = 1e-5      # lse is fp32 on both sides (~1e-6 measured)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _check(out, ref, kernel, floor=0.0):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    d = (out.float() - ref.float()).abs().amax(-1)
    ref2 = ref.float().pow(2)
    rms = ref2.mean(-1).sqrt().clamp_min(
        max(1e-30, floor * ref2.mean().sqrt().item()))
    row_err = (d / rms).max().item()
    assert row_err <= ROW_TOL[kernel], row_err


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 200])
@pytest.mark.parametrize("O,K,g", [(1000, 1024, 128), (72, 512, 32)])
def test_w4a16_all_regimes(gen, M, O, K, g):
    before = w4a16_matmul.launches
    codes = torch.randint(0, 16, (O, K), generator=gen, device="cuda")
    sc = (torch.rand(O, K // g, generator=gen, device="cuda") - 0.5) * 0.02
    qw = pack_w4(codes)
    x = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
    _check(w4a16_matmul(x, qw, sc, g), w4a16_matmul_plain(x, qw, sc, g),
           "w4a16")
    assert w4a16_matmul.launches == before + 1


@pytest.mark.parametrize("layout", ["contiguous", "shared", "slice"])
@pytest.mark.parametrize("C", [1, 2, 5, 8, 16, 17, 32, 33, 130])
@pytest.mark.parametrize("E,O,K,g", [(3, 200, 1024, 128), (2, 72, 512, 32)])
def test_grouped_all_regimes(gen, layout, C, E, O, K, g):
    """Same limit as the ungrouped kernel (the tile bodies are shared).
    Activation layouts: contiguous (E, C, K); one slab shared by all
    experts (expert stride 0); the first C rows of a taller (E, C + 1, K)
    buffer, as capacity dispatch hands it over."""
    before = w4a16_matmul_grouped.launches
    codes = torch.randint(0, 16, (E, O, K), generator=gen, device="cuda")
    sc = (torch.rand(E, O, K // g, generator=gen, device="cuda") - 0.5) * 0.02
    qw = torch.stack([pack_w4(codes[e]) for e in range(E)])
    if layout == "shared":
        x = torch.randn(C, K, generator=gen, device="cuda").bfloat16() \
            .expand(E, C, K)
    elif layout == "slice":
        x = torch.randn(E, C + 1, K, generator=gen,
                        device="cuda").bfloat16()[:, :C]
    else:
        x = torch.randn(E, C, K, generator=gen, device="cuda").bfloat16()
    _check(w4a16_matmul_grouped(x, qw, sc, g),
           w4a16_matmul_grouped_plain(x, qw, sc, g), "w4a16")
    assert w4a16_matmul_grouped.launches == before + 1


@pytest.mark.parametrize("zp_kind", ["integral", "fractional"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 200])
@pytest.mark.parametrize("O,K,g", [(1000, 1024, 128), (72, 512, 32)])
def test_asym_all_regimes(gen, zp_kind, M, O, K, g):
    """Same limit as the sym kernel: the GEMM body rounds (code - zp) *
    scale to bf16 as the plain version does, the GEMV body keeps it in
    fp32 (measured worst row on an H100 at the main path's shapes 0.035)."""
    before = w4a16_asym_matmul.launches
    codes = torch.randint(0, 16, (O, K), generator=gen, device="cuda")
    sc = torch.rand(O, K // g, generator=gen, device="cuda") * 0.01 + 0.002
    zp = torch.rand(O, K // g, generator=gen, device="cuda") * 15
    if zp_kind == "integral":
        zp = zp.round()
    qw = pack_w4(codes)
    x = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
    _check(w4a16_asym_matmul(x, qw, sc, zp, g),
           w4a16_asym_matmul_plain(x, qw, sc, zp, g), "w4a16")
    assert w4a16_asym_matmul.launches == before + 1


def _a8_input(gen, M, K):
    """(2, M, K) bf16 activations with an all-zero row."""
    x = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
    x[0, 0] = 0
    return x


@pytest.mark.parametrize("M,K", [(1, 512), (5, 4096), (33, 1024),
                                 (4096, 4096)])
def test_quantize_rows_bit_equal(gen, M, K):
    before = quantize_rows.launches
    x = _a8_input(gen, M, K)
    x[1, 0, :2] = torch.tensor([3.0, -3.0])
    xi, xs = quantize_rows(x)
    pi, ps = quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert xi.dtype == torch.int8 and xs.shape == (2, M)
    assert torch.equal(xi, pi) and torch.equal(xs, ps)
    assert not xi[0, 0].any() and xs[0, 0].item() == pytest.approx(1e-8)
    assert quantize_rows.launches == before + 1


@pytest.mark.parametrize("M", [1, 2, 5, 8, 16, 17, 32, 33, 200, 4096])
@pytest.mark.parametrize("O,K", [(1000, 1024), (72, 512), (256, 14336),
                                 (72, 96), (200, 1056)])
def test_w8a8_all_regimes(gen, M, O, K):
    """Exact int32 accumulation, then two fp32 multiplications in the plain
    version's order: the fp32 result is bit-equal, and so the bf16 one.
    K = 96 and 1056 are multiples of 32 and not of the GEMM's 64-column
    tile: its last tile is half empty."""
    if M == 4096 and K == 14336:
        pytest.skip("covered at M = 200")
    before = w8a8_matmul.launches
    x = _a8_input(gen, M, K)
    wi = torch.randint(-128, 128, (O, K), generator=gen,
                       device="cuda").to(torch.int8)
    ws = (torch.rand(O, generator=gen, device="cuda") - 0.5) * 0.002
    y32 = w8a8_matmul(x, wi, ws, torch.float32)
    y = w8a8_matmul(x, wi, ws)
    p32 = w8a8_matmul_plain(x, wi, ws, torch.float32)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (2, M, O)
    assert torch.equal(y32, p32)
    assert torch.equal(y, p32.bfloat16())
    assert not y[0, 0].any()
    assert w8a8_matmul.launches == before + 2


@pytest.mark.parametrize("M", [1, 2, 5, 8, 16, 17, 32, 33, 200, 4096])
@pytest.mark.parametrize("O,K,g", [(1000, 1024, 128), (72, 512, 32),
                                   (200, 2048, 256), (72, 96, 32),
                                   (72, 160, 32), (200, 1056, 96)])
def test_w4a8_all_regimes(gen, M, O, K, g):
    """The last three: K a multiple of 32 and not of the GEMM's 64-column
    tile, with a group that closes on the tile's first half."""
    before = w4a8_matmul.launches
    x = _a8_input(gen, M, K)
    qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device="cuda"))
    sc = (torch.rand(O, K // g, generator=gen, device="cuda") - 0.5) * 0.02
    y32 = w4a8_matmul(x, qw, sc, g, torch.float32)
    y = w4a8_matmul(x, qw, sc, g)
    p32 = w4a8_matmul_plain(x, qw, sc, g, torch.float32)
    torch.cuda.synchronize()
    if 2 * M > 32:                     # the GEMM body: the plain order
        assert torch.equal(y32, p32)
    _check(y32, p32, "w4a8_f32")
    assert y.dtype == torch.bfloat16 and torch.equal(y, y32.bfloat16())
    assert not y[0, 0].any()
    assert w4a8_matmul.launches == before + 2


@pytest.mark.parametrize("M", [1, 2, 5, 8, 16, 17, 32, 33, 200, 4096])
@pytest.mark.parametrize("O,K,g", [(1000, 1024, 128), (72, 512, 32),
                                   (200, 2048, 256), (1000, 1024, 0),
                                   (72, 14336, 0), (72, 96, 32)])
def test_w8a16_all_regimes(gen, M, O, K, g):
    """Per group and per channel (g = 0: scales (O, 1)), negative scales."""
    before = w8a16_matmul.launches
    x = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
    wi = torch.randint(-128, 128, (O, K), generator=gen,
                       device="cuda").to(torch.int8)
    sc = (torch.rand(O, K // g if g else 1, generator=gen, device="cuda")
          - 0.5) * 0.002
    _check(w8a16_matmul(x, wi, sc, g), w8a16_matmul_plain(x, wi, sc, g),
           "w8a16")
    assert w8a16_matmul.launches == before + 1


FLOAT_M = [1, 2, 3, 5, 8, 9, 16, 17, 32, 33, 200]


@pytest.mark.parametrize("M", FLOAT_M)
@pytest.mark.parametrize("O,K,g", [(1000, 2048, 128), (72, 512, 32),
                                   (200, 1056, 96), (72, 96, 32)])
def test_w2a16_all_regimes(gen, M, O, K, g):
    """Negative scales and one below 1e-12 (its group contributes 0)."""
    before = w2a16_matmul.launches
    x = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
    qw = pack_w2(torch.randint(0, 4, (O, K), generator=gen, device="cuda"))
    sc = (torch.rand(O, K // g, generator=gen, device="cuda") - 0.5) * 0.02
    sc[0, 0] = 1e-13
    _check(w2a16_matmul(x, qw, sc, g), w2a16_matmul_plain(x, qw, sc, g),
           "w2a16")
    assert w2a16_matmul.launches == before + 1


@pytest.mark.parametrize("M", FLOAT_M)
@pytest.mark.parametrize("O,K,g", [(1000, 2048, 32), (1000, 2048, 16),
                                   (72, 96, 32), (200, 1056, 16),
                                   (72, 48 * 2, 16)])
def test_mxfp4_all_regimes(gen, M, O, K, g):
    """MX (g = 32, powers of two) and NVFP4 (g = 16, any positive scale, one
    below 1e-12); every code value, the negative zero included."""
    before = mxfp4_matmul.launches
    x = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
    qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device="cuda"))
    if g == 32:
        sc = torch.exp2(torch.randint(-10, -3, (O, K // g), generator=gen,
                                      device="cuda").float())
    else:
        sc = torch.rand(O, K // g, generator=gen, device="cuda") * 0.01
        sc[0, 1] = 1e-13
    _check(mxfp4_matmul(x, qw, sc, g), mxfp4_matmul_plain(x, qw, sc, g),
           "mxfp4")
    assert mxfp4_matmul.launches == before + 1


@pytest.mark.parametrize("M", FLOAT_M)
@pytest.mark.parametrize("O,K", [(1000, 2048), (72, 512), (200, 1056),
                                 (72, 96)])
def test_fp8_all_regimes(gen, M, O, K):
    """e4m3 weights over their whole range (subnormals, ±448, zero) and
    channel scales, one below 1e-12."""
    before = fp8_matmul.launches
    x = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(O, K, generator=gen, device="cuda") * 100).clamp(
        -448, 448)
    w[0, :4] = torch.tensor([0.0, 2.0 ** -9, -448.0, 3 * 2.0 ** -9])
    wf = w.to(torch.float8_e4m3fn)
    sc = torch.rand(O, generator=gen, device="cuda") * 0.01 + 1e-4
    sc[1] = 1e-13
    _check(fp8_matmul(x, wf, sc), fp8_matmul_plain(x, wf, sc), "fp8")
    assert fp8_matmul.launches == before + 1


def test_float_wrappers_refuse_what_the_kernels_do_not_take(gen):
    xb = torch.randn(4, 256, generator=gen, device="cuda").bfloat16()
    qw4 = torch.zeros((64, 32), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):            # g 64 is no MX group
        mxfp4_matmul(xb, qw4, torch.ones((64, 4), device="cuda"), 64)
    with pytest.raises(ValueError):            # scales of another group count
        mxfp4_matmul(xb, qw4, torch.ones((64, 8), device="cuda"), 16)
    with pytest.raises(ValueError):            # fp32 activations
        mxfp4_matmul(xb.float(), qw4, torch.ones((64, 8), device="cuda"), 32)
    wf = torch.zeros((64, 256), dtype=torch.float8_e4m3fn, device="cuda")
    with pytest.raises(ValueError):            # e5m2 weights
        fp8_matmul(xb, wf.to(torch.float8_e5m2), torch.ones(64,
                                                            device="cuda"))
    with pytest.raises(ValueError):            # 2-D channel scales
        fp8_matmul(xb, wf, torch.ones((64, 1), device="cuda"))
    qw2 = torch.zeros((64, 16), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):            # group size not % 32
        w2a16_matmul(xb, qw2, torch.ones((64, 16), device="cuda"), 16)
    with pytest.raises(ValueError):            # 4-bit words for 2-bit codes
        w2a16_matmul(xb, qw4, torch.ones((64, 2), device="cuda"), 128)


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("S,T", [(64, 64), (128, 320)])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_shapes(gen, D, S, T, rep, causal):
    Hkv = 2
    q = torch.randn(2, Hkv * rep, S, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, Hkv, T, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(2, Hkv, T, D, generator=gen, device="cuda").bfloat16()
    out, lse = flash_attention(q, k, v, causal)
    pout, plse = flash_attention_plain(q, k, v, causal)
    _check(out, pout, "flash")
    assert (lse - plse).abs().max().item() <= LSE_ATOL


def _backward_pair(gen, B, Hkv, G, S, T, D, causal):
    q = torch.randn(B, Hkv * G, S, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, Hkv, T, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, Hkv, T, D, generator=gen, device="cuda").bfloat16()
    do = torch.randn(B, Hkv * G, S, D, generator=gen, device="cuda").bfloat16()
    out, lse = flash_attention(q, k, v, causal)
    counts = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches, flash_attention_bwd.launches)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches,
            flash_attention_bwd.launches) == tuple(c + 1 for c in counts)
    again = flash_attention_bwd(q, k, v, out, lse, do, causal)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)                 # same bits run to run
        _check(a, r, "flash_bwd", BWD_ROW_FLOOR)
    # autograd through the op launches the same kernels; the incoming dO
    # may be a transposed view
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    o2, lse2 = flash_attention(ql, kl, vl, causal)
    assert not lse2.requires_grad
    do_view = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not do_view.is_contiguous()
    grads = torch.autograd.grad(o2, (ql, kl, vl), do_view)
    for a, b in zip(grads, got):
        assert torch.equal(a, b)


# T = 320 and 448 give the kv loops an odd tile count for the two-slot
# ring; S = 64 T = 512 causal leaves one q tile against eight kv tiles (the
# dK/dV blocks each walk one step a head, the diagonal on the last)
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("S,T", [(64, 64), (128, 320), (256, 256), (64, 320),
                                 (192, 448), (64, 512)])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_pair(gen, D, S, T, G, causal):
    _backward_pair(gen, 2, 2, G, S, T, D, causal)


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_tuning_shape(gen, D, causal):
    """One sequence of the tuning step's attention: B1 H32 Hkv8 S=T=512."""
    _backward_pair(gen, 1, 8, 4, 512, 512, D, causal)


def _probe(mode, a, b, nbox, box0):
    """flash_attention_bwd_probe: one of the two wgmma products the backward
    kernels are built from, alone (csrc/flash_attention_bwd.cu)."""
    import ctypes

    from autoround_tpu_torch.ops import _build

    fn = _build.load("flash_attention_bwd").flash_attention_bwd_probe
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    c = torch.full((64, 64 if mode == 0 else 128), float("nan"),
                   device="cuda")
    err = fn(mode, a.data_ptr(), b.data_ptr(), c.data_ptr(), nbox, box0,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    torch.cuda.synchronize()
    return c


def test_wgmma_k_major_operands(gen):
    """m64n64k16 with both operands read K-major from TMA-loaded swizzled
    boxes (two 64-column boxes a 128-column row): a . b^T."""
    a = torch.randn(64, 128, generator=gen, device="cuda").bfloat16()
    b = torch.randn(64, 128, generator=gen, device="cuda").bfloat16()
    torch.testing.assert_close(_probe(0, a, b, 2, 0),
                               torch.matmul(a.float(), b.float().T),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("nbox,box0", [(2, 0), (4, 0), (4, 2)])
def test_wgmma_register_a_transposed_b(gen, nbox, box0):
    """m64n128k16 with A held in registers (the layout a score accumulator
    packs into) and B read MN-major from a TMA-loaded tile of nbox boxes,
    from box box0 on (D = 256: a warpgroup's half): a . b[:, cols]."""
    a = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    b = torch.randn(64, 64 * nbox, generator=gen, device="cuda").bfloat16()
    cols = slice(64 * box0, 64 * box0 + 128)
    torch.testing.assert_close(_probe(1, a, b, nbox, box0),
                               torch.matmul(a.float(), b[:, cols].float()),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["plain", "window", "chunk", "softcap",
                                  "sinks"])
def test_decode_masks_and_groups(gen, G, case):
    B, T, nkv = 4, 384, 2
    nh = nkv * G
    q = torch.randn(B, nh, 128, generator=gen, device="cuda").bfloat16()
    kc = torch.randint(-127, 128, (B, T, nkv, 128), generator=gen,
                       device="cuda").to(torch.int8)
    vc = torch.randint(-127, 128, (B, T, nkv, 128), generator=gen,
                       device="cuda").to(torch.int8)
    ks = torch.rand(nkv, generator=gen, device="cuda") * 0.02 + 0.01
    vs = torch.rand(nkv, generator=gen, device="cuda") * 0.02 + 0.01
    pos = torch.tensor([0, 63, 200, T - 1], dtype=torch.int32, device="cuda")
    kw = dict(softcap=30.0 if case == "softcap" else 0.0,
              window=50 if case == "window" else None,
              chunk=96 if case == "chunk" else None,
              sinks=(torch.randn(nh, generator=gen, device="cuda")
                     if case == "sinks" else None))
    _check(decode_attention(q, kc, vc, pos, ks, vs, 0.088, **kw),
           decode_attention_plain(q, kc, vc, pos, ks, vs, 0.088,
                                  kw["softcap"], kw["window"], kw["sinks"],
                                  chunk=kw["chunk"]), "decode")


@pytest.mark.parametrize("hd", [384, 512])
def test_model_attention_sends_wide_heads_to_the_flash_kernel(gen, hd):
    """The model's routing gate is the JAX one (hd % 128 == 0): a head the
    kernel does not take raises by name, it does not run plain on the card."""
    from autoround_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(num_heads=2, num_kv_heads=2, head_dim=hd,
                         hidden_size=2 * hd)
    q = torch.zeros((1, 512, 2, hd), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match=f"D={hd}"):
        tl.attention(q, q, q, None, cfg)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 256, generator=gen, device="cuda")
    qw = torch.zeros((64, 32), dtype=torch.int32, device="cuda")
    sc = torch.ones((64, 2), device="cuda")
    with pytest.raises(ValueError):            # fp32 activations
        w4a16_matmul(x, qw, sc, 128)
    with pytest.raises(ValueError):            # non-contiguous activations
        w4a16_matmul(x.bfloat16().T.contiguous().T, qw, sc, 128)
    xb = x.bfloat16()
    with pytest.raises(ValueError):            # fp16 zero points
        w4a16_asym_matmul(xb, qw, sc, sc.half(), 128)
    with pytest.raises(ValueError):            # zero points of another shape
        w4a16_asym_matmul(xb, qw, sc, sc[:, :1].contiguous(), 128)
    with pytest.raises(ValueError):            # group size not % 16
        w4a16_asym_matmul(xb, qw, torch.ones((64, 32), device="cuda"),
                          torch.ones((64, 32), device="cuda"), 8)
    with pytest.raises(ValueError):            # group size not % 16
        w4a16_matmul(xb, qw, torch.ones((64, 32), device="cuda"), 8)
    wi = torch.zeros((64, 256), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):            # fp32 activations
        w8a8_matmul(x, wi, torch.ones(64, device="cuda"))
    with pytest.raises(ValueError):            # 2-D channel scales
        w8a8_matmul(xb, wi, torch.ones((64, 1), device="cuda"))
    with pytest.raises(ValueError):            # int32 codes for int8
        w8a8_matmul(xb, wi.int(), torch.ones(64, device="cuda"))
    with pytest.raises(ValueError):            # group size not % 32
        w4a8_matmul(xb, qw, torch.ones((64, 16), device="cuda"), 16)
    with pytest.raises(ValueError):            # scales of another group count
        w4a8_matmul(xb, qw, sc, 64)
    with pytest.raises(ValueError):            # non-contiguous activations
        w4a8_matmul(xb.T.contiguous().T, qw, sc, 128)
    with pytest.raises(ValueError):            # fp32 activations
        quantize_rows(x)
    with pytest.raises(ValueError):            # per-group scales, g = 0 asked
        w8a16_matmul(xb, wi, sc, 0)
    with pytest.raises(ValueError):            # fp16 scales
        w8a16_matmul(xb, wi, sc.half(), 128)
    xe = xb[None].expand(3, 4, 256)
    qwe, sce = qw[None].expand(3, 64, 32), sc[None].expand(3, 64, 2)
    with pytest.raises(ValueError):            # stacked weights not contiguous
        w4a16_matmul_grouped(xe, qwe, sce.contiguous(), 128)
    with pytest.raises(ValueError):            # 2-D activations
        w4a16_matmul_grouped(xb, qwe.contiguous(), sce.contiguous(), 128)
    with pytest.raises(ValueError):            # slab rows not contiguous
        w4a16_matmul_grouped(
            torch.zeros((3, 4, 512), dtype=torch.bfloat16,
                        device="cuda")[:, :, :256],
            qwe.contiguous(), sce.contiguous(), 128)
    with pytest.raises(ValueError):            # another expert count
        w4a16_matmul_grouped(xe[:2], qwe.contiguous(), sce.contiguous(), 128)
    q = torch.zeros((1, 2, 96, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):            # S not a multiple of 64
        flash_attention(q, q, q)
    q = torch.zeros((1, 2, 128, 128), dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros((1, 2, 64, 128), dtype=torch.bfloat16, device="cuda")
    st = torch.zeros((1, 2, 128), device="cuda")
    with pytest.raises(ValueError):            # causal with T < S
        flash_attention_bwd_dq(q, kv, kv, q, st, st, True)
    with pytest.raises(ValueError):            # fp32 dO
        flash_attention_bwd_dkv(q, q, q, q.float(), st, st, True)
    with pytest.raises(ValueError):            # lse of the wrong shape
        flash_attention_bwd_dq(q, q, q, q, st[:, :1], st, True)
    with pytest.raises(ValueError):            # head_dim 64
        flash_attention_bwd_dkv(q[..., :64].contiguous(),
                                q[..., :64].contiguous(),
                                q[..., :64].contiguous(),
                                q[..., :64].contiguous(), st, st, True)
    qd = torch.zeros((1, 6, 96), dtype=torch.bfloat16, device="cuda")
    c = torch.zeros((1, 16, 2, 96), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="head_dim=96"):     # head_dim 96
        decode_attention(qd, c, c, 0, torch.ones(2, device="cuda"),
                         torch.ones(2, device="cuda"), 0.1)
    qd = torch.zeros((1, 32, 128), dtype=torch.bfloat16, device="cuda")
    c = torch.zeros((1, 16, 2, 128), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="num_heads=32 num_kv_heads=2"):
        decode_attention(qd, c, c, 0, torch.ones(2, device="cuda"),
                         torch.ones(2, device="cuda"), 0.1)   # G = 16


# ------------------------------------------------------------ this slice's
# edges: int4 groups of 16 (and 48: a group starting half way through a
# GEMV chunk), the decode kernel at every head dim and G it takes, and the
# int8-QK attention


@pytest.mark.parametrize("M", [1, 2, 5, 8, 16, 17, 32, 33, 200])
@pytest.mark.parametrize("O,K,g", [(1000, 1024, 16), (72, 1056, 16),
                                   (200, 1536, 48)])
@pytest.mark.parametrize("kind", ["sym", "asym", "grouped"])
def test_int4_small_groups(gen, kind, M, O, K, g):
    codes = torch.randint(0, 16, (O, K), generator=gen, device="cuda")
    qw = pack_w4(codes)
    sc = (torch.rand(O, K // g, generator=gen, device="cuda") - 0.5) * 0.02
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    if kind == "sym":
        _check(w4a16_matmul(x, qw, sc, g), w4a16_matmul_plain(x, qw, sc, g),
               "w4a16")
    elif kind == "asym":
        zp = torch.rand(O, K // g, generator=gen, device="cuda") * 15
        _check(w4a16_asym_matmul(x, qw, sc, zp, g),
               w4a16_asym_matmul_plain(x, qw, sc, zp, g), "w4a16")
    else:
        qwe = torch.stack([qw, qw.flip(0)])
        sce = torch.stack([sc, -sc])
        xe = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
        _check(w4a16_matmul_grouped(xe, qwe, sce, g),
               w4a16_matmul_grouped_plain(xe, qwe, sce, g), "w4a16")


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", range(1, 9))
@pytest.mark.parametrize("case", ["plain", "window_sinks", "softcap",
                                  "chunk"])
def test_decode_head_dims_and_groups(gen, hd, G, case):
    B, T, nkv = 4, 384, 2
    nh = nkv * G
    q = torch.randn(B, nh, hd, generator=gen, device="cuda").bfloat16()
    kc = torch.randint(-127, 128, (B, T, nkv, hd), generator=gen,
                       device="cuda").to(torch.int8)
    vc = torch.randint(-127, 128, (B, T, nkv, hd), generator=gen,
                       device="cuda").to(torch.int8)
    ks = torch.rand(nkv, generator=gen, device="cuda") * 0.02 + 0.01
    vs = torch.rand(nkv, generator=gen, device="cuda") * 0.02 + 0.01
    pos = torch.tensor([0, 63, 200, T - 1], dtype=torch.int32, device="cuda")
    kw = dict(softcap=30.0 if case == "softcap" else 0.0,
              window=50 if case == "window_sinks" else None,
              chunk=96 if case == "chunk" else None,
              sinks=(torch.randn(nh, generator=gen, device="cuda")
                     if case == "window_sinks" else None))
    before = decode_attention.launches
    _check(decode_attention(q, kc, vc, pos, ks, vs, hd ** -0.5, **kw),
           decode_attention_plain(q, kc, vc, pos, ks, vs, hd ** -0.5,
                                  kw["softcap"], kw["window"], kw["sinks"],
                                  chunk=kw["chunk"]), "decode")
    assert decode_attention.launches == before + 1


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("S,T", [(64, 64), (128, 320), (256, 256)])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_sage_shapes(gen, D, S, T, rep, causal):
    """The kernel against its plain version in the jitted form it follows
    (the same mean key, taken once by the wrapper's torch reduction); the
    +2 key offset is the common mode the smoothing removes."""
    B, Hkv = 2, 2
    H = Hkv * rep
    q = torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(B, Hkv, T, D, generator=gen, device="cuda")
         + 2).bfloat16()
    v = torch.randn(B, Hkv, T, D, generator=gen, device="cuda").bfloat16()
    before = sage_attention.launches
    _check(sage_attention(q, k, v, causal),
           sage_attention_plain(q, k, v, causal, recip=True), "sage")
    assert sage_attention.launches == before + 1


def test_sage_refuses_what_the_kernel_does_not_take(gen):
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="cuda")
    with pytest.raises(ValueError):            # D = 64
        sage_attention(t(1, 2, 64, 64), t(1, 2, 64, 64), t(1, 2, 64, 64))
    with pytest.raises(ValueError):            # S not a multiple of 64
        sage_attention(t(1, 2, 96, 128), t(1, 2, 128, 128),
                       t(1, 2, 128, 128))
    with pytest.raises(ValueError):            # causal with T < S
        sage_attention(t(1, 2, 128, 128), t(1, 2, 64, 128),
                       t(1, 2, 64, 128))
    with pytest.raises(ValueError):            # fp32
        sage_attention(t(1, 2, 64, 128, dtype=torch.float32),
                       t(1, 2, 64, 128, dtype=torch.float32),
                       t(1, 2, 64, 128, dtype=torch.float32))
    with pytest.raises(ValueError):            # H % Hkv
        sage_attention(t(1, 3, 64, 128), t(1, 2, 64, 128), t(1, 2, 64, 128))
    with pytest.raises(ValueError):            # non-contiguous q
        sage_attention(t(1, 2, 128, 64).transpose(2, 3)[:, :, :64],
                       t(1, 2, 64, 128), t(1, 2, 64, 128))
    # T < S without the causal mask is taken
    out = sage_attention(t(1, 2, 128, 128), t(1, 2, 64, 128),
                         t(1, 2, 64, 128), causal=False)
    assert out.shape == (1, 2, 128, 128)


# ------------------------------------------------------------ the pipelined
# GEMM body (M > 32: a cp.async ring of 64-column k-steps whose packed codes
# are dequantized into bf16 tiles for wgmma) and the register-resident flash
# forward (a 2-stage K/V ring; KV tiles of 64 rows at D = 128, 32 at 256)

# K % 64 == 32 leaves the GEMM a half last k-step (96, 1056); K = 1152 takes
# g = 128.  INT2 rows of K = 96 are 24 bytes: 8-byte copies.
PIPE_FORMATS = {"sym4": (16, 32, 48, 128), "asym4": (16, 32, 48, 128),
                "int2": (32, 128), "int8": (32, 128), "e4m3": (),
                "e2m1": (16, 32)}
PIPE_CASES = [(fmt, K, g) for fmt, gs in PIPE_FORMATS.items()
              for K in (96, 1056, 1152)
              for g in sorted({*(g for g in gs if K % g == 0), K})
              if fmt != "e2m1" or g in (16, 32)]


def _pipe_call(gen, fmt, x, O, K, g):
    """(kernel output, plain output) of the format's wrapper on random
    weights: signed scales, a zero point of any fraction, e4m3 over its
    range."""
    dev = "cuda"
    sc = (torch.rand(O, K // g, generator=gen, device=dev) - 0.5) * 0.02
    if fmt in ("sym4", "asym4", "e2m1"):
        qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device=dev))
        if fmt == "sym4":
            return (w4a16_matmul(x, qw, sc, g),
                    w4a16_matmul_plain(x, qw, sc, g))
        if fmt == "asym4":
            zp = torch.rand(O, K // g, generator=gen, device=dev) * 15
            return (w4a16_asym_matmul(x, qw, sc, zp, g),
                    w4a16_asym_matmul_plain(x, qw, sc, zp, g))
        sc = sc.abs()
        return mxfp4_matmul(x, qw, sc, g), mxfp4_matmul_plain(x, qw, sc, g)
    if fmt == "int2":
        qw = pack_w2(torch.randint(0, 4, (O, K), generator=gen, device=dev))
        return w2a16_matmul(x, qw, sc, g), w2a16_matmul_plain(x, qw, sc, g)
    if fmt == "int8":
        wi = torch.randint(-128, 128, (O, K), generator=gen,
                           device=dev).to(torch.int8)
        return w8a16_matmul(x, wi, sc, g), w8a16_matmul_plain(x, wi, sc, g)
    wf = (torch.randn(O, K, generator=gen, device=dev) * 100).clamp(
        -448, 448).to(torch.float8_e4m3fn)
    sc = sc[:, 0].abs() + 1e-4
    return fp8_matmul(x, wf, sc), fp8_matmul_plain(x, wf, sc)


PIPE_TOL = {"sym4": "w4a16", "asym4": "w4a16", "int2": "w2a16",
            "int8": "w8a16", "e4m3": "fp8", "e2m1": "mxfp4"}


@pytest.mark.parametrize("M", [33, 129, 200])
@pytest.mark.parametrize("fmt,K,g", PIPE_CASES)
def test_gemm_pipeline_edges(gen, fmt, K, g, M):
    """Every format through the GEMM body at half k-steps, groups of 16 (four
    in a k-step), 48 (a group across two k-steps), 128 and K, M edges of 1
    and 72 rows past a 128-row tile, and an odd O (pairwise stores fall back
    to single ones)."""
    O = 203
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    got, ref = _pipe_call(gen, fmt, x, O, K, g)
    _check(got, ref, PIPE_TOL[fmt])


@pytest.mark.parametrize("M", [33, 129, 200])
@pytest.mark.parametrize("layout", ["shared", "slice"])
@pytest.mark.parametrize("K,g", [(K, g) for fmt, K, g in PIPE_CASES
                                 if fmt == "sym4"])
def test_grouped_gemm_pipeline_edges(gen, K, g, layout, M):
    """The expert axis (E = 3) of the GEMM body: every pointer offset by its
    expert, the activation read at expert stride 0 (one shared slab) or from
    the first M rows of taller slabs."""
    E, O = 3, 203
    qw = torch.stack([pack_w4(torch.randint(0, 16, (O, K), generator=gen,
                                            device="cuda")) for _ in range(E)])
    sc = (torch.rand(E, O, K // g, generator=gen, device="cuda") - 0.5) * 0.02
    if layout == "shared":
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16() \
            .expand(E, M, K)
    else:
        x = torch.randn(E, M + 3, K, generator=gen,
                        device="cuda").bfloat16()[:, :M]
    _check(w4a16_matmul_grouped(x, qw, sc, g),
           w4a16_matmul_grouped_plain(x, qw, sc, g), "w4a16")


FLASH_PIPE = [(S, T, causal) for S, T in [(64, 320), (128, 320), (192, 320),
                                          (320, 320), (320, 128)]
              for causal in (True, False) if not (causal and T < S)]


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("S,T,causal", FLASH_PIPE)
@pytest.mark.parametrize("G", [1, 4, 8])
def test_flash_forward_pipeline(gen, D, S, T, causal, G):
    """T = 320: five 64-row KV tiles at D = 128, ten 32-row tiles at D = 256
    (an odd count for the two-stage ring); S < T causal shifts the diagonal
    off the tile grid of the q rows."""
    Hkv = 2
    q = torch.randn(2, Hkv * G, S, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, Hkv, T, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(2, Hkv, T, D, generator=gen, device="cuda").bfloat16()
    out, lse = flash_attention(q, k, v, causal)
    pout, plse = flash_attention_plain(q, k, v, causal)
    _check(out, pout, "flash")
    assert (lse - plse).abs().max().item() <= LSE_ATOL


# The decode kernel split over T (flash-decoding): per-slot positions at 0,
# inside the first tile, on the end and the start of a piece and at T - 1 in
# one batch; a window and a chunk shorter than one piece, so pieces are
# empty (with the sinks too); the softcap; B = 1 (the most pieces) and
# B = 16 (the fewest); held like the rest of row 6.
SPLIT_CASES = {"plain": {}, "short_window": {"window": 20},
               "short_chunk": {"chunk": 32},
               "sinks_short_window": {"window": 20, "sinks": True},
               "softcap": {"softcap": 30.0}}


def _decode_operands(gen, B, T, nkv, G, hd):
    nh = nkv * G
    q = torch.randn(B, nh, hd, generator=gen, device="cuda").bfloat16()
    kc = torch.randint(-127, 128, (B, T, nkv, hd), generator=gen,
                       device="cuda").to(torch.int8)
    vc = torch.randint(-127, 128, (B, T, nkv, hd), generator=gen,
                       device="cuda").to(torch.int8)
    ks = torch.rand(nkv, generator=gen, device="cuda") * 0.02 + 0.01
    vs = torch.rand(nkv, generator=gen, device="cuda") * 0.02 + 0.01
    sinks = torch.randn(nh, generator=gen, device="cuda")
    return q, kc, vc, ks, vs, sinks


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("hd,G", [(64, 4), (128, 7), (256, 8), (128, 1)])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_split_positions(gen, B, hd, G, case):
    from autoround_tpu_torch.ops.decode_attention import decode_splits

    T, nkv = 1024, 2
    q, kc, vc, ks, vs, sinks = _decode_operands(gen, B, T, nkv, G, hd)
    S = decode_splits(B, nkv, T)
    assert S > 1
    # pos 127 ends a piece and 128 is one piece's only token when S pieces
    # cut 129 tokens into 64-token tiles
    slots = [0, 40, 127, 128, 511, 700, T - 1]
    kw = dict(SPLIT_CASES[case])
    kw["sinks"] = sinks if kw.get("sinks") else None
    runs = ([torch.tensor([p], dtype=torch.int32, device="cuda")
             for p in slots] if B == 1 else
            [torch.tensor((slots * 3)[:B], dtype=torch.int32,
                          device="cuda")])
    before = decode_attention.launches
    for pos in runs:
        out = decode_attention(q, kc, vc, pos, ks, vs, hd ** -0.5, **kw)
        ref = decode_attention_plain(q, kc, vc, pos, ks, vs, hd ** -0.5,
                                     kw.get("softcap", 0.0), kw.get("window"),
                                     kw["sinks"], chunk=kw.get("chunk"))
        assert torch.isfinite(out.float()).all()
        _check(out, ref, "decode")
    assert decode_attention.launches == before + len(runs)


def test_decode_split_run_to_run(gen):
    """The combine adds the pieces in index order, with no atomics: two
    launches give the same bits."""
    B, T, nkv, G, hd = 8, 1024, 8, 4, 128
    q, kc, vc, ks, vs, sinks = _decode_operands(gen, B, T, nkv, G, hd)
    pos = torch.randint(0, T, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    a = decode_attention(q, kc, vc, pos, ks, vs, hd ** -0.5, window=300,
                         sinks=sinks)
    b = decode_attention(q, kc, vc, pos, ks, vs, hd ** -0.5, window=300,
                         sinks=sinks)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# The int8 GEMM body on wgmma (M > 32): M on both sides of a 128- and a
# 256-row tile, O not a multiple of the 128-column tile, K a multiple of 32
# and not of 64 or of the 128-column k-step, groups of 32, 64, 96, 128 and
# K; the fp32 result bit-equal to the plain version for W8A8 and W4A8.
WGMMA_M = [33, 255, 257, 4096]


@pytest.mark.parametrize("M", WGMMA_M)
@pytest.mark.parametrize("O,K", [(1000, 1088), (72, 1056), (136, 160),
                                 (200, 4096)])
def test_w8a8_wgmma_edges(gen, M, O, K):
    x = _a8_input(gen, M, K)[0]
    wi = torch.randint(-128, 128, (O, K), generator=gen,
                       device="cuda").to(torch.int8)
    ws = (torch.rand(O, generator=gen, device="cuda") - 0.5) * 0.002
    y32 = w8a8_matmul(x, wi, ws, torch.float32)
    p32 = w8a8_matmul_plain(x, wi, ws, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(y32, p32)
    assert torch.equal(w8a8_matmul(x, wi, ws), p32.bfloat16())


@pytest.mark.parametrize("M", WGMMA_M)
@pytest.mark.parametrize("O,K,g", [(1000, 1088, 64), (72, 1056, 96),
                                   (136, 160, 32), (200, 1024, 1024),
                                   (1000, 4096, 128), (72, 2048, 256),
                                   (72, 1152, 128), (200, 1024, 128)])
def test_w4a8_wgmma_edges(gen, M, O, K, g):
    """g = 128 takes the two-set body with its scales copied by TMA, which
    needs (K / g) % 4 == 0 and 16-byte aligned scales: K = 1152 (9 groups)
    and, at O = 200, scales one float into their buffer take the one-set
    body."""
    x = _a8_input(gen, M, K)[0]
    qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device="cuda"))
    sc = (torch.rand(O * (K // g) + 1, generator=gen, device="cuda") - 0.5) \
        * 0.02
    sc = sc[1:] if O == 200 else sc[:-1]
    sc = sc.view(O, K // g)
    y32 = w4a8_matmul(x, qw, sc, g, torch.float32)
    p32 = w4a8_matmul_plain(x, qw, sc, g, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(y32, p32)
    assert torch.equal(w4a8_matmul(x, qw, sc, g), p32.bfloat16())
