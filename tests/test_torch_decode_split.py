"""The split plan of the int8-KV decode kernel, on the CPU.

``csrc/decode_attention.cu`` cuts each slot's token range into
``decode_splits(B, nkv, T)`` pieces, one block each, that write a partial
softmax state (m, l, acc) which a second kernel combines.  The kernel runs
only on the card (``tests/test_torch_cuda.py`` holds it there); here
``_split_then_combine`` mirrors its arithmetic in torch (the same ranges,
the same fp32 partials, the same combine: rescale by exp(m_s - m), an empty
split weighs 0, the sinks enter the denominator once, l == 0 divides by 1)
and is held against the JAX package's ``decode_attention_ref`` on inputs
made from a seed with numpy.

Tolerance: both sides compute in fp32 from the same inputs and reduce in
other orders (per split, then across splits; the K scale folded into the
score scale), so they agree to a few fp32 ulps of the output: rtol = atol
= 1e-5, as the port's other decode parity tests.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.ops.decode_attention import decode_attention_ref
from autoround_tpu_torch.ops.decode_attention import (SPLIT_TILE,
                                                      decode_splits)
from _port_threads import one_torch_thread  # noqa: F401


def _split_range(pos, T, window, chunk, S, split, tile=SPLIT_TILE):
    """The kernel's `split_range`: [s_lo, s_hi] of piece `split` of S."""
    hi = min(pos, T - 1)
    lo = 0
    if window:
        lo = max(lo, pos - window + 1)
    if chunk:
        lo = max(lo, (pos // chunk) * chunk)
    ntok = hi - lo + 1
    if ntok <= 0:
        return 1, 0
    per = -(-(-(-ntok // S)) // tile) * tile
    s_lo = lo + split * per
    return s_lo, min(hi, s_lo + per - 1)


def _split_then_combine(q, kc, vc, pos, ks, vs, sm, softcap=0.0, window=None,
                        sinks=None, chunk=None, S=None):
    """The kernel's split-then-combine in torch fp32 (the test's mirror)."""
    B, nh, hd = q.shape
    T, nkv = kc.shape[1], kc.shape[2]
    G = nh // nkv
    S = decode_splits(B, nkv, T) if S is None else S
    out = torch.empty(B, nh, hd)
    heads = torch.arange(nh) // G
    kscale = sm * ks[heads]                                   # (nh,)
    for b in range(B):
        parts = []
        for s in range(S):
            s_lo, s_hi = _split_range(int(pos[b]), T, window, chunk, S, s)
            if s_lo > s_hi:
                parts.append(None)                        # m = -inf, l = 0
                continue
            k = kc[b, s_lo:s_hi + 1].float()[:, heads]    # (n, nh, hd)
            v = vc[b, s_lo:s_hi + 1].float()[:, heads]
            sc = torch.einsum("nd,tnd->nt", q[b].float(), k) * kscale[:, None]
            if softcap:
                sc = softcap * torch.tanh(sc / softcap)
            m = sc.amax(-1)
            e = torch.exp(sc - m[:, None])
            parts.append((m, e.sum(-1), torch.einsum("nt,tnd->nd", e, v)))
        m = torch.full((nh,), -math.inf)
        for p in parts:
            if p is not None:
                m = torch.maximum(m, p[0])
        l = torch.zeros(nh)
        acc = torch.zeros(nh, hd)
        for p in parts:
            if p is None:
                continue
            w = torch.exp(p[0] - m)
            l = l + w * p[1]
            acc = acc + w[:, None] * p[2]
        if sinks is not None:
            l = l + torch.exp(sinks - m)
        inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
        out[b] = acc * inv[:, None] * vs[heads][:, None]
    return out


@pytest.mark.parametrize("B,nkv,T", [(1, 8, 1024), (8, 8, 1024),
                                     (8, 4, 1024), (16, 8, 1024),
                                     (32, 8, 2048), (4, 2, 64)])
def test_decode_splits_from_host_shapes_only(B, nkv, T):
    """S >= 1, no piece shorter than one tile (and none empty) when a
    slot's range is the whole cache, one to two waves of blocks over 132
    SMs where the cache is long enough, and nothing but (B, nkv, T)
    decides it (no `pos`)."""
    assert list(inspect.signature(decode_splits).parameters) == [
        "B", "nkv", "T"]
    S = decode_splits(B, nkv, T)
    assert isinstance(S, int) and S >= 1
    assert S == decode_splits(B, nkv, T)
    tiles = -(-T // SPLIT_TILE)
    assert S <= tiles
    assert 2 * B * nkv * S >= min(2 * 132, B * nkv * tiles)
    assert B * nkv * (S - 1) < 2 * 132 or S == 1
    # at pos = T - 1 every piece but the last holds whole tiles, none empty
    ranges = [_split_range(T - 1, T, None, None, S, s) for s in range(S)]
    assert all(lo <= hi for lo, hi in ranges)
    assert all((hi - lo + 1) % SPLIT_TILE == 0 for lo, hi in ranges[:-1])
    assert ranges[0][0] == 0 and ranges[-1][1] == T - 1


def _inputs(B, T, nkv, G, hd, seed):
    rng = np.random.default_rng(seed)
    nh = nkv * G
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, (B, T, nkv, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (B, T, nkv, hd)).astype(np.int8)
    ks = rng.uniform(0.01, 0.03, (nkv,)).astype(np.float32)
    vs = rng.uniform(0.01, 0.03, (nkv,)).astype(np.float32)
    sinks = rng.standard_normal((nh,)).astype(np.float32)
    return q, kc, vc, ks, vs, sinks


@pytest.mark.parametrize("S", [None, 1, 7])
@pytest.mark.parametrize("case", ["plain", "window", "chunk", "softcap",
                                  "sinks", "window_sinks"])
def test_split_then_combine_matches_jax_ref(case, S):
    """pos puts a slot at 0, inside the first tile, on a tile boundary and
    at T - 1; a window of 50 and a chunk of 96 are shorter than the pieces
    at S = 7, so some pieces are empty (with the sinks too)."""
    B, T, nkv, G, hd = 4, 384, 2, 4, 64
    q, kc, vc, ks, vs, sinks = _inputs(B, T, nkv, G, hd, seed=11)
    pos = np.array([0, 40, 192, T - 1], np.int32)
    softcap = 30.0 if case == "softcap" else 0.0
    window = 50 if case.startswith("window") else None
    chunk = 96 if case == "chunk" else None
    use_sinks = case.endswith("sinks")
    sm = 1.0 / np.sqrt(hd)
    ref = decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        jnp.asarray(ks), jnp.asarray(vs), sm, softcap, window,
        jnp.asarray(sinks) if use_sinks else None, chunk=chunk)
    got = _split_then_combine(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        pos, torch.from_numpy(ks), torch.from_numpy(vs), sm, softcap, window,
        torch.from_numpy(sinks) if use_sinks else None, chunk, S)
    if S == 7 and window:
        assert any(_split_range(int(p), T, window, chunk, S, s)[0]
                   > _split_range(int(p), T, window, chunk, S, s)[1]
                   for p in pos for s in range(S))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(np.asarray(ref, np.float32), got.numpy(),
                               rtol=1e-5, atol=1e-5)
