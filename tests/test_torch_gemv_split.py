"""The A16 GEMV's order of summation, on the CPU.

``csrc/w4a16_tiles.cuh``'s GEMV (M <= 32) runs its products on tensor
cores: each weight is dequantized in fp32 and rounded once to bf16 (the
plain version's value).  K is cut into steps of 128 columns (4-bit
formats: four lanes of one 32-column chunk each), and ``gemv_plan`` may
split the steps over a thread-block cluster of kc blocks (kc in 1, 2, 4, 8,
16, from host shapes only).  Rank r takes the contiguous steps r * spb ..
r * spb + spb - 1 with spb = ceil(steps / kc), so the last ranks may hold
fewer steps or none.  Inside a rank each mma.sync takes 16 columns: four
consecutive codes 4q .. 4q + 3 of each lane's chunk, q = 0 .. 7.  The
products of even q go to one fp32 accumulator set and those of odd q to
another, in step order; the two are added at the end.  Rank 0 then adds
the ranks' sums in the order 1, 2, ... through distributed shared memory.
The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
there); here ``_split_then_reduce`` mirrors that order in torch and is held
against the JAX package's ``w4a16_matmul_ref`` on inputs made from a seed
with numpy.

Tolerance: both sides multiply the same bf16 weights and activations
exactly in fp32 and round the output to bf16; only the order of the fp32
sums differs, which moves an output by at most one bf16 ulp (rtol = atol
= 2^-7, as ``test_torch_ops.py``'s bf16 rounding test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.ops.qmatmul import pack_w4_planes, w4a16_matmul_ref
from autoround_tpu_torch.ops.qmatmul import (pack_w4, unpack_w4,
                                             w4a16_matmul_plain)

CHUNK = 32           # columns of one lane's chunk (4-bit formats)
STEP = 4 * CHUNK     # columns of one step


def _mma_columns(step, q, K):
    """The 16 columns of mma q of a step: codes 4q .. 4q + 3 of each of the
    four lanes' chunks (the kernel zero-fills columns past K)."""
    cols = [step * STEP + CHUNK * t + 4 * q + j
            for t in range(4) for j in range(4)]
    return [c for c in cols if c < K]


def _split_then_reduce(x, qweight, scales, g, kc):
    """The GEMV's sums in torch: bf16 weights (code - 8) * scale, each
    rank's contiguous range of steps, the two accumulator sets of even and
    odd q added at the end of a rank, the ranks added in order 0, 1, ...;
    the bf16 output."""
    K = x.shape[-1]
    s = scales.float().repeat_interleave(g, dim=1)[:, :K]
    w = ((unpack_w4(qweight) - 8).float() * s).to(torch.bfloat16).float()
    xf = x.float()
    n_steps = -(-K // STEP)
    spb = -(-n_steps // kc)
    total = None
    for rank in range(kc):
        acc = [torch.zeros(x.shape[0], w.shape[0]) for _ in range(2)]
        for step in range(rank * spb, min(n_steps, (rank + 1) * spb)):
            for q in range(8):
                cols = _mma_columns(step, q, K)
                acc[q % 2] = acc[q % 2] + xf[:, cols] @ w[:, cols].T
        part = acc[0] + acc[1]
        total = part if total is None else total + part
    return total.to(torch.bfloat16)


def _inputs(M, O, K, g, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, (O, K)).astype(np.int32)
    scales = (rng.uniform(0.005, 0.02, (O, K // g))
              * rng.choice([-1.0, 1.0], (O, K // g))).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return codes, scales, x


# K = 1152 is 9 steps: kc = 2 leaves ranks of 5 and 4, kc = 8 ranks of 2
# and a last one of 1 (and empty ranks); groups of 48 start half way
# through a lane's chunk.  K = 2432 is 19 steps: kc = 16 leaves ranks of 2,
# a rank of 1 and empty ones; groups of 16 switch scale inside every chunk.
# K = 1056 is 9 steps, the last one 32 columns (one lane's chunk); JAX's
# nibble planes need K % (8 g) == 0, so that one is held against the plain
# version alone.  kc never exceeds the steps (nor does gemv_plan's).
SHAPES = [(72, 1152, 48), (40, 2432, 16), (24, 1056, 32)]
CASES = [(kc, O, K, g) for (O, K, g) in SHAPES for kc in (1, 2, 4, 8, 16)
         if kc <= -(-K // STEP)]


@pytest.mark.parametrize("M", [1, 8, 17])
@pytest.mark.parametrize("kc,O,K,g", CASES)
def test_split_then_reduce_matches_ref(kc, O, K, g, M):
    codes, scales, x = _inputs(M, O, K, g, seed=kc * 100 + M + g)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    qw = pack_w4(torch.from_numpy(codes))
    got = _split_then_reduce(xt, qw, torch.from_numpy(scales), g, kc)
    if K % (8 * g) == 0:
        want = w4a16_matmul_ref(jnp.asarray(x, jnp.bfloat16),
                                pack_w4_planes(jnp.asarray(codes), g),
                                jnp.asarray(scales), g)
        np.testing.assert_allclose(np.asarray(want.astype(jnp.float32)),
                                   got.float().numpy(), rtol=2 ** -7,
                                   atol=2 ** -7)
    # and the plain version the card tests hold the kernel against
    plain = w4a16_matmul_plain(xt, qw, torch.from_numpy(scales), g)
    np.testing.assert_allclose(plain.float().numpy(), got.float().numpy(),
                               rtol=2 ** -7, atol=2 ** -7)


def test_mma_columns_cover_each_step_once():
    """The 8 mmas of a step take each of its 128 columns exactly once, and
    a step past K's last full chunk only the columns before K."""
    for step, K in ((0, 1152), (8, 1152), (8, 1056)):
        cols = sorted(c for q in range(8) for c in _mma_columns(step, q, K))
        assert cols == list(range(step * STEP, min(K, (step + 1) * STEP)))
