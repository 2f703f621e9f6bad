"""Port parity: the flash attention backward against the JAX package.

The contract is ``jax.vjp(flash_attention_ref)``, which is also what the
JAX package itself runs off the TPU.  Held against it here, on the CPU:
``flash_attention_bwd_plain`` (the plain version of the two CUDA kernels:
P recomputed from the saved lse, delta = rowsum(dO * O), P and dS rounded
to the working dtype, fp32 group sum) and autograd through
``flash_attention`` on CPU tensors, which is what a tuning step
differentiates on the CPU.  The kernels themselves are held against the
plain version on the card (``tests/test_torch_cuda.py``).

Tolerances: fp32 atol 1e-5 (gradients are O(0.1..1); the two sides sum
the same fp32 products in different orders).  bf16: both sides round P, dS
and the outputs to bf16 at different places (the reference differentiates
through its bf16 casts; the flash algebra takes delta from the rounded
output), so they agree to bf16 rounding only.  Measure: worst row of max
|a - b| / RMS(row), a row's RMS counted as at least 10% of the tensor's (a
causal row that sees two keys, one with P = 1, is zero up to cancellation
in the reference and not in the flash algebra).  Measured 0.19 over these
cases; limit 0.5.  The fp32 cases hold the algebra; these hold the casts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.ops.flash_attention import flash_attention_ref
from autoround_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_plain)

FP32_ATOL = 1e-5
BF16_ROW_TOL = 0.5

CASES = [(rep, S, T, D, causal)
         for rep in (1, 4) for (S, T) in ((64, 64), (32, 96))
         for D in (64, 128) for causal in (True, False)]


def _inputs(rep, S, T, D, seed):
    rng = np.random.default_rng(seed)
    B, Hkv = 2, 2
    q = rng.standard_normal((B, Hkv * rep, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    do = rng.standard_normal((B, Hkv * rep, S, D)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, causal, dtype):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(a, b, c, causal),
                       *args)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in (out, *grads)]


def _row_err(a, b):
    d = np.abs(a - b).max(-1)
    rms = np.sqrt((b ** 2).mean(-1))
    return float((d / np.maximum(rms, 0.1 * np.sqrt((b ** 2).mean()))).max())


@pytest.mark.parametrize("rep,S,T,D,causal", CASES)
def test_bwd_plain_and_autograd_fp32(rep, S, T, D, causal):
    q, k, v, do = _inputs(rep, S, T, D, seed=S + D + rep)
    jout, *jgrads = _jax_vjp(q, k, v, do, causal, jnp.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal)
    assert not lse.requires_grad and lse.shape == q.shape[:3]
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=FP32_ATOL)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    plain = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                      out.detach(), lse, torch.from_numpy(do),
                                      causal)
    for name, jg, a, p in zip("qkv", jgrads, auto, plain):
        assert p.shape == jg.shape and p.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), jg, atol=FP32_ATOL,
                                   err_msg=f"autograd d{name}")
        np.testing.assert_allclose(p.numpy(), jg, atol=FP32_ATOL,
                                   err_msg=f"plain d{name}")


@pytest.mark.parametrize("rep,S,T,D,causal", CASES)
def test_bwd_plain_bf16(rep, S, T, D, causal):
    q, k, v, do = _inputs(rep, S, T, D, seed=S + D + rep + 1)
    _, *jgrads = _jax_vjp(q, k, v, do, causal, jnp.bfloat16)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal)
    plain = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal)
    for name, jg, p in zip("qkv", jgrads, plain):
        assert p.dtype == torch.bfloat16
        err = _row_err(p.float().numpy(), jg)
        assert err <= BF16_ROW_TOL, (name, err)


def test_cpu_tensors_never_reach_the_kernels():
    """On CPU tensors ``flash_attention`` is the plain version under
    autograd and no kernel is counted; the kernel wrappers themselves take
    CUDA tensors only and raise on anything else."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 64, 64, 128, 0))
    counts = [f.launches for f in (flash_attention, flash_attention_bwd,
                                   flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    q.requires_grad_(True)
    out, lse = flash_attention(q, k, v, True)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert counts == [f.launches for f in (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dq,
        flash_attention_bwd_dkv)]
    delta = torch.zeros_like(lse)
    b16 = [t.detach().bfloat16() for t in (q, k, v, do)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dq(*b16, lse, delta, True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dkv(*b16, lse, delta, True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(*b16[:3], out.detach().bfloat16(), lse, b16[3])


def test_llama_attention_differentiates_through_flash_on_cpu():
    """At the routing gate's shapes the tuning forward goes through
    ``flash_attention``; its gradients equal those of the plain math path
    (the gate closed by an all-zero additive mask is not comparable, so the
    reference is the JAX attention's vjp)."""
    from autoround_tpu.models import llama as jl
    from autoround_tpu_torch.models import llama as tl

    rng = np.random.default_rng(3)
    B, S, nh, nkv, hd = 1, 512, 4, 2, 128
    q = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    jcfg = jl.LlamaConfig(num_heads=nh, num_kv_heads=nkv, head_dim=hd,
                          hidden_size=nh * hd, dtype=jnp.float32)
    tcfg = tl.LlamaConfig(num_heads=nh, num_kv_heads=nkv, head_dim=hd,
                          hidden_size=nh * hd, dtype=torch.float32)
    jout, vjp = jax.vjp(lambda a, b, c: jl.attention(a, b, c, None, jcfg),
                        *(jnp.asarray(a) for a in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = flash_attention.launches
    tout = tl.attention(tq, tk, tv, None, tcfg)
    assert tl._flash_eligible(tq, tk, None)
    assert flash_attention.launches == before       # CPU: plain version
    tg = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=FP32_ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FP32_ATOL)
