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
sides, so their fp32 results before the cast are held directly: W8A8
bit-equal to the plain version in both bodies, W4A8 in the GEMM body (M >
32) and in the GEMV body (M <= 32: ``mma.sync`` s8, each group closed in
the plain version's order) wherever its plan splits no K (kc = 1, read
from ``w4a8_matmul_gemv_info``); with K split over a cluster the ranks'
fp32 partial sums are added in rank order (limit 1e-5 of a row's RMS,
``chip_smoke.W4A8_F32_ROW_TOL``).  W8A16 is held
like W4A16 (measured worst row 0.049 per channel at K = 14336 in the GEMM
body, 0.012 in the GEMV, which rounds each weight to bf16 as the plain
version does; limit 0.15).

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
rounded to bf16 after an online softmax), and its refusals.  Rows 5 and 6
at the shapes GPT-OSS and Llama 4 give them (the 32 experts of 2880 x
2880 at g = 32, Scout's 16 of 8192 x 5120; a chunk of 256, the 64 / 8
heads with the 128 window and the sinks).

The GEMV body (M <= 32: weights as the A of mma.sync, K split over a
thread-block cluster) at one output row, K of a single chunk, K whose
split leaves a ragged last range, groups that start half way through a
lane's chunk, every expert layout, two launches bit-equal (the int8 kinds
too, in fp32), and its plan at the main path's shapes (the int8 GEMV's at
every decode launch of llama3-8b); the int8-QK attention's key pre-pass bit-equal to
``int8_rows`` and the attention at S = T = 2048.

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
from autoround_tpu_torch.ops.sage_attention import (_quantize_keys,
                                                    int8_rows, key_mean,
                                                    sage_attention,
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


# GEMV edges (M <= 32): one output row, K of one 32-column chunk, K whose
# split over a thread-block cluster leaves ragged and empty ranks (1056: 9
# steps of 128 over 8 ranks, four of 2, one of 1 whose step holds a single
# 32-column chunk, three empty), K split over a cluster of 8 ranks, 16 at
# M = 32 (14336), groups starting half way through a lane's chunk (48)
GEMV_EDGES = [(1, 32, 16), (72, 1056, 48), (1000, 14336, 128)]


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 200])
@pytest.mark.parametrize("O,K,g", [(1000, 1024, 128), (72, 512, 32)]
                         + GEMV_EDGES)
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
@pytest.mark.parametrize("E,O,K,g", [(3, 200, 1024, 128), (2, 72, 512, 32),
                                     (8, 72, 1056, 16), (1, 1000, 14336, 128),
                                     (5, 1, 32, 32)])
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


@pytest.mark.parametrize("layout", ["contiguous", "shared"])
@pytest.mark.parametrize("C", [1, 8, 130, 4096])
@pytest.mark.parametrize("E,O,K,g", [(32, 2880, 2880, 32),
                                     (16, 8192, 5120, 128),
                                     (16, 5120, 8192, 128)])
def test_grouped_gptoss_and_llama4_shapes(gen, layout, C, E, O, K, g):
    """Row 5 at the experts of gpt-oss-20b (E = 32, 2880 x 2880: K =
    22.5 x 128, so g = 32) and llama4-scout (E = 16, gate / up 8192 x 5120,
    down 5120 x 8192, g = 128), decode and prefill token counts."""
    codes = torch.randint(0, 16, (O, K), generator=gen, device="cuda")
    qw = torch.stack([pack_w4(codes.roll(e, dims=1)) for e in range(E)])
    del codes
    sc = (torch.rand(E, O, K // g, generator=gen, device="cuda") - 0.5) * 0.02
    if layout == "shared":
        x = torch.randn(C, K, generator=gen, device="cuda").bfloat16() \
            .expand(E, C, K)
    else:
        x = torch.randn(E, C, K, generator=gen, device="cuda").bfloat16()
    _check(w4a16_matmul_grouped(x, qw, sc, g),
           w4a16_matmul_grouped_plain(x, qw, sc, g), "w4a16")


@pytest.mark.parametrize("zp_kind", ["integral", "fractional"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 200])
@pytest.mark.parametrize("O,K,g", [(1000, 1024, 128), (72, 512, 32)]
                         + GEMV_EDGES)
def test_asym_all_regimes(gen, zp_kind, M, O, K, g):
    """Same limit as the sym kernel: both bodies round (code - zp) * scale
    to bf16 as the plain version does (measured worst row on an H100 at the
    main path's shapes 0.024)."""
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


def _a8_gemv_info(src, M, K, O, g=128):
    """{registers, spill bytes, shared bytes, blocks per SM, rw, kc} of the
    int8 GEMV of `src` at (M, K, O[, g])."""
    import ctypes

    from autoround_tpu_torch.ops import _build
    fn = getattr(_build.load(src), f"{src}_gemv_info")
    args = (M, K, O) if src == "w8a8_matmul" else (M, K, O, g)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    info = (ctypes.c_int * 6)()
    assert fn(*args, info) == 0
    return list(info)


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
                                 (72, 96), (200, 1056), (1, 1024),
                                 (1000, 14336)])
def test_w8a8_all_regimes(gen, M, O, K):
    """Exact int32 accumulation, then two fp32 multiplications in the plain
    version's order: the fp32 result is bit-equal, and so the bf16 one.
    K = 96 and 1056 are multiples of 32 and not of the GEMM's 64-column
    tile: its last tile is half empty.  The GEMV edges: one output row
    (its K split over a cluster of 8), and K = 14336 over 8 ranks."""
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
                                   (72, 160, 32), (200, 1056, 96),
                                   (1, 1024, 32), (1000, 14336, 32),
                                   (20480, 512, 32)])
def test_w4a8_all_regimes(gen, M, O, K, g):
    """K = 96, 160, 1056: a multiple of 32 and not of the GEMM's 64-column
    tile, with a group that closes on the tile's first half.  The GEMV
    edges: one output row, K = 14336 at g = 32 (a chunk of an mma is a
    whole group) over 8 ranks, and 20480 rows, whose plan splits no K.
    The GEMM body and a GEMV whose plan gives kc = 1 close the groups in
    the plain version's order: bit-equal.  With kc > 1 the ranks' partial
    sums are added in rank order; a row of one output (O = 1) is held to
    the tensor's RMS (the floor), not to its single, possibly cancelled,
    value."""
    before = w4a8_matmul.launches
    x = _a8_input(gen, M, K)
    qw = pack_w4(torch.randint(0, 16, (O, K), generator=gen, device="cuda"))
    sc = (torch.rand(O, K // g, generator=gen, device="cuda") - 0.5) * 0.02
    y32 = w4a8_matmul(x, qw, sc, g, torch.float32)
    y = w4a8_matmul(x, qw, sc, g)
    p32 = w4a8_matmul_plain(x, qw, sc, g, torch.float32)
    torch.cuda.synchronize()
    if 2 * M > 32 or _a8_gemv_info("w4a8_matmul", 2 * M, K, O, g)[5] == 1:
        assert torch.equal(y32, p32)
    _check(y32, p32, "w4a8_f32", floor=1.0 if O == 1 else 0.0)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y32.bfloat16())
    assert not y[0, 0].any()
    assert w4a8_matmul.launches == before + 2


@pytest.mark.parametrize("M", [1, 2, 5, 8, 16, 17, 32, 33, 200, 4096])
@pytest.mark.parametrize("O,K,g", [(1000, 1024, 128), (72, 512, 32),
                                   (200, 2048, 256), (1000, 1024, 0),
                                   (72, 14336, 0), (72, 96, 32), (1, 32, 32),
                                   (1000, 14336, 128)])
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
                                   (200, 1056, 96), (72, 96, 32), (1, 32, 32),
                                   (1000, 14336, 128)])
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
                                   (72, 48 * 2, 16), (1, 32, 16),
                                   (72, 14336, 32)])
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
                                 (72, 96), (8, 32), (1, 32), (1000, 14336)])
def test_fp8_all_regimes(gen, M, O, K):
    """e4m3 weights over their whole range (subnormals, ±448, zero) and
    channel scales, one below 1e-12.  At O = 1 an output row is a single
    value, whose own size may be a cancelled sum of 32 products: its
    error is held to the RMS of the whole output (``_check``'s floor), the
    scale a row of many outputs gives, under the same limit."""
    before = fp8_matmul.launches
    x = torch.randn(2, M, K, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(O, K, generator=gen, device="cuda") * 100).clamp(
        -448, 448)
    w[0, :4] = torch.tensor([0.0, 2.0 ** -9, -448.0, 3 * 2.0 ** -9])
    wf = w.to(torch.float8_e4m3fn)
    sc = torch.rand(O, generator=gen, device="cuda") * 0.01 + 1e-4
    sc[min(1, O - 1)] = 1e-13
    _check(fp8_matmul(x, wf, sc), fp8_matmul_plain(x, wf, sc), "fp8",
           floor=1.0 if O == 1 else 0.0)
    assert fp8_matmul.launches == before + 1


@pytest.mark.parametrize("M", [1, 8, 17, 32])
@pytest.mark.parametrize("kind", ["w4a16", "grouped", "asym", "w8a16",
                                  "w2a16", "fp8", "mxfp4", "w8a8", "w4a8"])
def test_gemv_run_to_run(gen, kind, M):
    """Two launches of the GEMV give the same bits: K = 14336 at O = 1000
    splits K over a thread-block cluster, whose partial sums rank 0 adds in
    rank order (no atomics).  The int8 kinds are held in fp32."""
    O, K = 1000, 14336
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    c4 = torch.randint(0, 16, (O, K), generator=gen, device="cuda")
    sc = (torch.rand(O, K // 128, generator=gen, device="cuda") - 0.5) * 0.02
    if kind == "w4a16":
        fn = lambda: w4a16_matmul(x, pack_w4(c4), sc, 128)
    elif kind == "grouped":
        qw = torch.stack([pack_w4(c4), pack_w4(15 - c4)])
        fn = lambda: w4a16_matmul_grouped(x.expand(2, M, K), qw,
                                          torch.stack([sc, -sc]), 128)
    elif kind == "asym":
        fn = lambda: w4a16_asym_matmul(x, pack_w4(c4), sc.abs(),
                                       sc.abs() * 700, 128)
    elif kind == "w8a16":
        fn = lambda: w8a16_matmul(x, (c4 - 8).to(torch.int8), sc, 128)
    elif kind == "w2a16":
        fn = lambda: w2a16_matmul(x, pack_w2(c4 % 4), sc, 128)
    elif kind == "fp8":
        fn = lambda: fp8_matmul(x, (c4 - 8).float().to(torch.float8_e4m3fn),
                                sc[:, 0].abs())
    elif kind == "w8a8":
        fn = lambda: w8a8_matmul(x, (c4 * 17 - 128).to(torch.int8),
                                 sc[:, 0].contiguous(), torch.float32)
    elif kind == "w4a8":
        fn = lambda: w4a8_matmul(x, pack_w4(c4), sc, 128, torch.float32)
    else:
        fn = lambda: mxfp4_matmul(x, pack_w4(c4), sc.repeat_interleave(4, 1)
                                  .abs(), 32)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.isfinite(a.float()).all() and torch.equal(a, b)


@pytest.mark.parametrize("src,E,M,K,O,want", [
    ("w4a16_matmul", 1, 8, 4096, 6144, (8, 4)),
    ("w4a16_matmul", 1, 8, 14336, 4096, (8, 8)),
    ("w4a16_matmul", 1, 8, 4096, 128256, (8, 2)),
    ("w4a16_matmul", 1, 32, 4096, 128256, (8, 4)),
    ("w4a16_matmul_grouped", 8, 8, 4096, 14336, (8, 2)),
    ("w4a16_matmul_grouped", 8, 8, 14336, 4096, (8, 8)),
    ("w8a16_matmul", 1, 8, 14336, 4096, (8, 8)),
    ("w4a16_matmul", 1, 32, 14336, 4096, (8, 16)),
    ("w2a16_matmul", 1, 1, 32, 1, (1, 1))] + [
    (src, 1, M, K, O, want) for src in ("w8a8_matmul", "w4a8_matmul")
    for M in (1, 8) for (K, O, want) in [
        (4096, 6144, (8, 4)), (4096, 4096, (8, 8)), (4096, 28672, (8, 1)),
        (14336, 4096, (8, 8)), (4096, 128256, (8, 1))]] + [
    ("w4a8_matmul", 1, 32, 4096, 128256, (8, 2)),
    ("w8a8_matmul", 1, 32, 14336, 4096, (8, 8))])
def test_gemv_plan(gen, src, E, M, K, O, want):
    """The GEMV's plan (row tiles a block, blocks a cluster along K) at the
    main path's shapes on a 132-SM H100 (a block's x within 32 KB at M <=
    8, 64 KB above: M = 32 at K = 14336 takes a cluster of 16), its shared
    memory within 96 KB (x and a 4 KB weight ring a warp), no spill and at
    least two blocks an SM.  The int8 GEMV (W8A8, W4A8 at g = 128) at every
    decode launch of llama3-8b: the same caps on half the bytes of x, a
    W4A8 ring of 5 KB a warp (the scales beside the weights: 104 KB at
    most), at least three blocks an SM at M <= 8."""
    props = torch.cuda.get_device_properties(0)
    if src in ("w8a8_matmul", "w4a8_matmul"):
        info = _a8_gemv_info(src, M, K, O)
        smem_max = 104 << 10 if src == "w4a8_matmul" else 96 << 10
        assert M > 8 or info[3] >= 3
    else:
        import ctypes

        from autoround_tpu_torch.ops import _build
        fn = getattr(_build.load(src), f"{src}_gemv_info")
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        info = (ctypes.c_int * 6)()
        assert fn(E, M, K, O, info) == 0
        smem_max = 96 << 10
    assert info[1] == 0 and info[2] <= smem_max and info[3] >= 2
    if props.multi_processor_count == 132:
        assert (info[4], info[5]) == want


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


@pytest.mark.parametrize("G", [1, 2, 4, 8, 12, 16])
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


@pytest.mark.parametrize("shape", ["llama4_chunk", "gptoss_sinks",
                                   "glm45_plain", "glm45_window_sinks"])
def test_decode_gptoss_and_llama4_shapes(gen, shape):
    """Row 6 where the families drive it: chunk 256 at llama3-8b's heads
    (B 8, T 1024, nh 32, nkv 8, hd 128, every slot at pos 700), gpt-oss's
    heads (nh 64, nkv 8, hd 64) at pos 511 with the 128 window and the
    sinks, and GLM-4.5-Air's G = 12 (nh 96, nkv 8, hd 128) plain at pos 700
    and with a 256 window and sinks at pos 511; slots at their own
    positions beside them."""
    B, T = 8, 1024
    nh, nkv, hd = {"llama4_chunk": (32, 8, 128), "gptoss_sinks": (64, 8, 64)
                   }.get(shape, (96, 8, 128))
    q = torch.randn(B, nh, hd, generator=gen, device="cuda").bfloat16()
    kc = torch.randint(-127, 128, (B, T, nkv, hd), generator=gen,
                       device="cuda").to(torch.int8)
    vc = torch.randint(-127, 128, (B, T, nkv, hd), generator=gen,
                       device="cuda").to(torch.int8)
    ks = torch.rand(nkv, generator=gen, device="cuda") * 0.02 + 0.01
    vs = torch.rand(nkv, generator=gen, device="cuda") * 0.02 + 0.01
    if shape == "llama4_chunk":
        kw = dict(chunk=256)
        pos0 = 700
    elif shape == "glm45_plain":
        kw = {}
        pos0 = 700
    else:
        kw = dict(window=128 if shape == "gptoss_sinks" else 256,
                  sinks=torch.randn(nh, generator=gen, device="cuda"))
        pos0 = 511
    for pos in (torch.full((B,), pos0, dtype=torch.int32, device="cuda"),
                torch.tensor([0, 127, 128, 255, 256, 511, 700, T - 1],
                             dtype=torch.int32, device="cuda")):
        _check(decode_attention(q, kc, vc, pos, ks, vs, hd ** -0.5, **kw),
               decode_attention_plain(q, kc, vc, pos, ks, vs, hd ** -0.5,
                                      window=kw.get("window"),
                                      sinks=kw.get("sinks"),
                                      chunk=kw.get("chunk")), "decode")


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
@pytest.mark.parametrize("G", range(1, 17))
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


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_sage_long(gen, D, rep, causal):
    """S = T = 2048, B = 1: 32 (D = 128) or 64 (D = 256) kv tiles a block."""
    B, Hkv, S = 1, 2, 2048
    H = Hkv * rep
    q = torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
         + 2).bfloat16()
    v = torch.randn(B, Hkv, S, D, generator=gen, device="cuda").bfloat16()
    _check(sage_attention(q, k, v, causal),
           sage_attention_plain(q, k, v, causal, recip=True), "sage")


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("T", [64, 320, 2048])
def test_sage_key_prepass_bit_equal(gen, D, T):
    """The pre-pass's int8 K and scales are int8_rows(k - key_mean(k),
    recip=True)'s bit for bit (a constant row gives the 1e-8 floor)."""
    B, Hkv = 2, 3
    k = (torch.randn(B, Hkv, T, D, generator=gen, device="cuda") * 3
         + 2).bfloat16()
    k[0, 0, 1] = 0
    km = key_mean(k).contiguous()
    ki, ks = _quantize_keys(k, km)
    want_i, want_s = int8_rows(k.float() - km[:, :, None], recip=True)
    torch.cuda.synchronize()
    assert torch.equal(ki, want_i) and torch.equal(ks, want_s[..., 0])


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
@pytest.mark.parametrize("hd,G", [(64, 4), (128, 7), (256, 8), (128, 1),
                                  (128, 12), (256, 16)])
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


# ------------------------------------------ the decode loop under a CUDA graph
#
# ``generate_scan`` on the card runs one decode step eagerly, captures the
# next as a CUDA graph and replays it: its tokens must equal ``generate``'s
# bit for bit (the same kernels, plans and order), every kernel's launch
# count must move exactly as under ``generate`` (the counters are Python, so
# each replay adds the capture's increase), and a second call must replay
# without a recapture.  The engines are llama3-8b at full width, 2 layers,
# int8 KV.

def _card_engine(scheme, seed):
    import dataclasses

    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(llama.CONFIG_PRESETS["llama3-8b"], num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    calib = torch.randint(0, cfg.vocab_size, (2, 256),
                          generator=torch.Generator().manual_seed(seed))
    res = AutoRound((params, cfg), scheme=scheme, iters=0,
                    quant_lm_head=True, donate_params=True).quantize(calib)
    return QuantizedLlama.from_quantize_result(res, cfg, max_seq=512,
                                               kv_quant="int8")


@pytest.fixture(scope="module")
def w4a16_engine():
    return _card_engine("W4A16", 0)


@pytest.fixture(scope="module")
def w4a8_engine():
    return _card_engine("W4A8", 1)


def _launches():
    from autoround_tpu_torch.ops._build import COUNTED
    return {f.__name__: f.launches for f in COUNTED}


def _scan_against_generate(eng, B, S, n_new, seed, sampling=None):
    prompts = torch.randint(0, eng.cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(seed))
    c0 = _launches()
    want = eng.generate(prompts, max_new_tokens=n_new, sampling=sampling)
    c1 = _launches()
    got = eng.generate_scan(prompts, max_new_tokens=n_new, sampling=sampling)
    c2 = _launches()
    assert torch.equal(got, want), (got, want)
    assert {n: c1[n] - c0[n] for n in c0} == {n: c2[n] - c1[n] for n in c0}


@pytest.mark.parametrize("B", [1, 8])
def test_generate_scan_w4a16(w4a16_engine, B):
    eng = w4a16_engine
    _scan_against_generate(eng, B, 128, 12, seed=B)
    caps = eng.captures
    assert caps >= 1
    _scan_against_generate(eng, B, 64, 20, seed=B + 100)   # new prompts
    assert eng.captures == caps


def test_generate_scan_w4a8_cluster_split(w4a8_engine):
    """W4A8: ``quantize_rows`` and the int8 GEMV inside the graph, with K
    split over a thread-block cluster (kc > 1) at qkv and down_proj."""
    assert _a8_gemv_info("w4a8_matmul", 8, 4096, 6144)[5] > 1
    assert _a8_gemv_info("w4a8_matmul", 8, 14336, 4096)[5] > 1
    eng = w4a8_engine
    _scan_against_generate(eng, 8, 128, 10, seed=3)
    caps = eng.captures
    _scan_against_generate(eng, 8, 96, 10, seed=4)
    assert eng.captures == caps >= 1


def test_generate_scan_sampled(w4a16_engine):
    from autoround_tpu_torch import SamplingParams

    sp = SamplingParams(temperature=0.7, top_p=0.95, seed=7)
    _scan_against_generate(w4a16_engine, 4, 64, 12, seed=5, sampling=sp)
    caps = w4a16_engine.captures
    _scan_against_generate(w4a16_engine, 4, 64, 12, seed=6,
                           sampling=SamplingParams(temperature=0.7,
                                                   top_p=0.95, seed=8))
    assert w4a16_engine.captures == caps


@pytest.mark.parametrize("scheme", ["W4A16", "W4A8"])
def test_replayed_launches_are_measured(w4a16_engine, w4a8_engine, scheme):
    """The port's kernels that replays of the captured step run, counted by
    torch.profiler, equal the capture's counter increases times the
    replays (``chip_smoke.profile_replays``, which every serving path of
    ``chip_smoke.py`` runs)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    eng = w4a16_engine if scheme == "W4A16" else w4a8_engine
    prompts = torch.randint(0, eng.cfg.vocab_size, (8, 64),
                            generator=torch.Generator().manual_seed(11))
    eng.generate_scan(prompts, max_new_tokens=4)
    with cs.counts_kept():
        prof = cs.profile_replays(cs._scan_step(eng, 8), scheme, n=2)
    gemv = "w4a16<0>" if scheme == "W4A16" else "a8<w4>"
    # a step: qkv, o, gate/up and down in each of 2 layers, and lm_head
    assert prof["launches"][gemv] == 2 * 4 + 1
    assert prof["launches"]["decode split"] == 2


def test_batcher_replay_equals_its_eager_step(w4a16_engine):
    """The batcher's decode step replayed from its graph against the same
    step run eagerly (a second batcher whose step never captures), with a
    request joining late and one leaving: bit-equal tokens and logits."""
    import types

    from autoround_tpu_torch.serve import ContinuousBatchingEngine

    kw = dict(max_batch=4, max_seq=512, prompt_buckets=(16, 64))
    graph = ContinuousBatchingEngine(w4a16_engine, **kw)
    eager = ContinuousBatchingEngine(w4a16_engine, **kw)
    eager._decode = types.SimpleNamespace(
        run=lambda n: [eager._decode_impl() for _ in range(n)])
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, 128256, (n,), generator=gen).tolist()
               for n in (12, 40, 7)]
    for e in (graph, eager):
        e.submit(prompts[0], max_new_tokens=6)
        e.submit(prompts[1], max_new_tokens=10)
    for t in range(12):
        if t == 6:
            for e in (graph, eager):
                e.submit(prompts[2], max_new_tokens=5)
        assert graph.step() == eager.step()
        assert torch.equal(graph.last_logits, eager.last_logits)
    assert graph._decode.graph is not None
    assert [graph.result(r) for r in range(3)] == [eager.result(r)
                                                   for r in range(3)]


# The Llama-family flags on the card: 2-layer full-width engines of
# qwen2.5-7b (q/k/v biases after the fused qkv GEMV, G = 7 through flash
# and decode) and gemma3-12b (hd 256, qk-norm with the norm offset, local
# rope on its sliding layers, the 1024 window), random weights with every
# gain and bias moved off its initial value, RTN W4A16 g128 with the lm_head
# quantized, int8 KV.  gemma3's prompt (1100 tokens) is longer than its
# window, so the sliding mask runs at prefill and the decode kernel drops
# the oldest keys at every step; the replayed graph must give ``generate``'s
# tokens and launches.

def _family_engine(preset, S):
    import dataclasses

    from autoround_tpu_torch import AutoRound, QuantizedLlama
    from autoround_tpu_torch.models import llama

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(llama.CONFIG_PRESETS[preset], num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for b in params["blocks"]:
        for t in b.values():
            if t.ndim == 1:
                t.add_(torch.randn(t.shape, generator=gen, device="cuda",
                                   dtype=t.dtype), alpha=0.1)
    calib = torch.randint(0, cfg.vocab_size, (2, S),
                          generator=torch.Generator().manual_seed(5))
    res = AutoRound((params, cfg), scheme="W4A16", iters=0,
                    quant_lm_head=True, donate_params=True).quantize(calib)
    return QuantizedLlama.from_quantize_result(res, cfg, max_seq=S + 64,
                                               kv_quant="int8")


@pytest.mark.parametrize("preset,S", [("qwen2.5-7b", 512),
                                      ("gemma3-12b", 1100)])
def test_generate_scan_llama_family(preset, S):
    from autoround_tpu_torch.models import llama

    eng = _family_engine(preset, S)
    cfg = eng.cfg
    assert "blocks.0.qkv" in eng.packed and "lm_head" in eng.packed
    if preset == "gemma3-12b":
        assert llama.layer_is_sliding(cfg, 0) and S > cfg.sliding_window
    _scan_against_generate(eng, 2, S, 12, seed=7)
    caps = eng.captures
    assert caps >= 1
    _scan_against_generate(eng, 2, S, 12, seed=8)       # new prompts
    assert eng.captures == caps



# -------------------------------------------------- AutoScheme and FP8 reads

AS_SCORE_RTOL = 6e-4

def test_autoscheme_gradient_pass_through_the_kernels(gen, monkeypatch):
    """AutoScheme's gradient pass on a 1-layer model (hd 128, 2 x 513
    tokens: 512 positions, where the flash gate takes the attention)
    launches the flash forward and both backward kernels, and its scores
    match the same pass on the plain attention per entry within
    ``AS_SCORE_RTOL`` relative (measured 1.88e-4 on an H100 80GB HBM3 at
    700 W; ``chip_smoke.py``'s llama3-8b x 2 pass reads 5.19e-5)."""
    from autoround_tpu_torch import AutoScheme
    from autoround_tpu_torch.models import llama
    from autoround_tpu_torch.quantize import auto_scheme as tas
    from autoround_tpu_torch.schemes import parse_scheme

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=512,
                            intermediate_size=1024, num_layers=1,
                            num_heads=4, num_kv_heads=2,
                            dtype=torch.bfloat16)
    params = llama.init_params(cfg, gen, "cuda")
    ids = torch.randint(0, 512, (2, 513), generator=gen, device="cuda")
    names = [f"blocks.0.{n}" for n in llama.block_linear_names(cfg)]
    options = ("W2A16", "W4A16", "W8A16")
    opts = [parse_scheme(o) for o in options]
    scheme = AutoScheme(avg_bits=4.5, options=options)
    counts = [flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches]
    kernel, _, _ = tas._score_matrices(params, cfg, scheme, ids, names, opts)
    assert flash_attention.launches > counts[0]
    assert flash_attention_bwd_dq.launches > counts[1]
    assert flash_attention_bwd_dkv.launches > counts[2]
    monkeypatch.setattr(llama, "flash_attention",
                        lambda q, k, v, causal=True: flash_attention_plain(
                            q, k, v, causal))
    plain, _, _ = tas._score_matrices(params, cfg, scheme, ids, names, opts)
    rel = abs(kernel - plain) / abs(plain)
    assert rel.max() < AS_SCORE_RTOL, rel.max()


@pytest.mark.parametrize("O,I", [(576, 7168), (24576, 1536), (256, 384)])
def test_fp8_source_dequant_on_the_card(gen, O, I):
    """The FP8-source dequant on the card (DeepSeek-V3's 576-row
    kv_a_proj_with_mqa and 24576-row q_b_proj) equals the host product of
    the e4m3 values and the 128 x 128 grid, and of a per-tensor scale."""
    from autoround_tpu_torch.quantize.model_free import _dequant_fp8_source

    w8 = (torch.randn(O, I, generator=gen, device="cuda") * 4).to(
        torch.float8_e4m3fn)
    grid = torch.rand(-(-O // 128), -(-I // 128), generator=gen,
                      device="cuda") * 0.01
    got = _dequant_fp8_source(w8.float(), grid)
    full = grid.cpu().repeat_interleave(128, 0).repeat_interleave(
        128, 1)[:O, :I]
    assert torch.equal(got.cpu(), w8.cpu().float() * full)
    one = torch.tensor([0.0123], device="cuda")
    assert torch.equal(_dequant_fp8_source(w8.float(), one).cpu(),
                       w8.cpu().float() * 0.0123)
