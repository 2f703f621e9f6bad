"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and skip without one.  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which these tests
neither use nor need.)  They cover the edges ``chip_smoke.py`` does not
reach: every GEMV template of the W4A16 kernel, ragged O, small groups,
D = 256 and S < T flash attention, every GQA ratio and mask of the decode
kernel, and the wrappers' refusals.

Tolerance: both sides give bf16.  In each output row (last axis), max
|kernel - plain| over the RMS of the plain row must stay within the
kernel's limit (rows are held to their own scale: attention rows differ
~10x in size).  The limits are ``chip_smoke.py``'s, about 3x the worst
row error measured on an H100 at the main path's shapes (flash 0.034, the
same as SDPA's against the plain version; W4A16 0.037; decode attention
0.0072): bf16 output rounding plus the plain version's rounding of each
weight (W4A16) or probability (flash) to bf16.
"""

import pytest
import torch

from autoround_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_plain)
from autoround_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)
from autoround_tpu_torch.ops.qmatmul import (pack_w4, w4a16_matmul,
                                             w4a16_matmul_plain)

pytestmark = pytest.mark.cuda
ROW_TOL = {"flash": 0.1, "w4a16": 0.1, "decode": 0.025}
LSE_ATOL = 1e-5      # lse is fp32 on both sides (~1e-6 measured)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _check(out, ref, kernel):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    d = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().pow(2).mean(-1).sqrt().clamp_min(1e-30)
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


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 256, generator=gen, device="cuda")
    qw = torch.zeros((64, 32), dtype=torch.int32, device="cuda")
    sc = torch.ones((64, 2), device="cuda")
    with pytest.raises(ValueError):            # fp32 activations
        w4a16_matmul(x, qw, sc, 128)
    with pytest.raises(ValueError):            # non-contiguous activations
        w4a16_matmul(x.bfloat16().T.contiguous().T, qw, sc, 128)
    q = torch.zeros((1, 2, 96, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):            # S not a multiple of 64
        flash_attention(q, q, q)
    qd = torch.zeros((1, 6, 64), dtype=torch.bfloat16, device="cuda")
    c = torch.zeros((1, 16, 2, 64), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):            # head_dim 64, G = 3
        decode_attention(qd, c, c, 0, torch.ones(2, device="cuda"),
                         torch.ones(2, device="cuda"), 0.1)
