"""Port parity of the SignRound options: ``qdq_asym_wo_round``, alg_ext's
searched init and outlier threshold, AdamRound's update, and
``tune_block`` with alg_ext, Adam, norm / bias offsets and an ``lfq_fn``,
against the JAX package on the same numpy-seeded inputs (CPU, fp32).

Tolerances:
  * ``qdq_asym_wo_round`` values bit-equal, eager and jitted; gradients
    w.r.t. ``v`` rtol 1e-6 (the half gradient on the lower bound at
    ``v = 0`` exactly);
  * the searched init: int sym the same candidate in every group (the
    value to one float32 ulp, rtol 2e-7, as ``search_init_scale_ratio``'s
    test states); the int asym and MXFP4 sweeps the same candidate index in
    every group (the candidates themselves to one ulp: XLA may fold
    ``1 - 0.05 k`` into one multiply-add);
  * the outlier threshold: to one float32 ulp of ``jnp.quantile`` (rtol
    1.2e-7), below, at and above 2^24 elements, and the kept set equal
    element for element;
  * the Adam update over 5 steps: within 1e-6 of the step's largest
    update (measured 2.7e-7: the bias correction's power and the
    divisions round once more or less under XLA);
  * ``tune_block``: the limits of ``test_torch_signround.py`` (first loss
    rtol 1e-4, best loss and trace rtol 5e-6, at least 99.8% of the codes
    equal).  Adam meets them too: at step 1 its update is ±lr whatever the
    gradient's size, as sign-SGD's is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoround_tpu.algorithms import signround as jsr
from autoround_tpu.dtypes import intq as jintq
from autoround_tpu.schemes import parse_scheme as j_parse
from autoround_tpu_torch.algorithms import signround as tsr
from autoround_tpu_torch.algorithms.adam import adam
from autoround_tpu_torch.dtypes import intq as tintq
from autoround_tpu_torch.schemes import parse_scheme as t_parse
from test_torch_signround import j_linear, t_linear, toy_problem
from _port_threads import one_torch_thread  # noqa: F401

FIRST_LOSS_RTOL = 1e-4
BEST_LOSS_RTOL = 5e-6
CODES_EQUAL_MIN = 0.998
ULP_RTOL = 1.2e-7


# ------------------------------------------------------ qdq_asym_wo_round

@pytest.mark.parametrize("kind", ["norm", "bias", "bias_at_init"])
def test_qdq_asym_wo_round_values_and_gradients(kind):
    rng = np.random.default_rng({"norm": 0, "bias": 1, "bias_at_init": 2}
                                [kind])
    n = 96
    w = (1.0 + 0.1 * rng.standard_normal(n) if kind == "norm"
         else 0.05 * rng.standard_normal(n)).astype(np.float32)
    v = (np.zeros(n) if kind == "bias_at_init"
         else 0.3 * rng.standard_normal(n)).astype(np.float32)
    cot = rng.standard_normal(n).astype(np.float32)

    jf = lambda vv: jnp.sum(jintq.qdq_asym_wo_round(jnp.asarray(w), vv)
                            * cot)
    # eager (the bake) and jitted (the tuning loss: XLA multiplies by
    # fp32(1 / 15) where the eager code divides), each bit-equal
    for recip, jfn in ((False, jintq.qdq_asym_wo_round),
                       (True, jax.jit(jintq.qdq_asym_wo_round))):
        jq = np.asarray(jfn(jnp.asarray(w), jnp.asarray(v)))
        tq = tintq.qdq_asym_wo_round(torch.from_numpy(w),
                                     torch.from_numpy(v), recip=recip)
        np.testing.assert_array_equal(tq.numpy(), jq)
    jg = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(v)))
    tv = torch.from_numpy(v).requires_grad_(True)
    tq = tintq.qdq_asym_wo_round(torch.from_numpy(w), tv, recip=True)
    (tq * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), jg, rtol=1e-6, atol=0)
    if kind == "bias_at_init":
        # the minimum sits exactly on the lower bound: half its gradient
        i = int(np.argmin(w))
        scale = (w.max() - w.min()) / 15.0
        np.testing.assert_allclose(tv.grad[i].item(), 0.5 * scale * cot[i],
                                   rtol=1e-6)
        assert 0.0 < abs(jg[i]) < abs(jg).max()


# ------------------------------------------------------ alg_ext init search

@pytest.mark.parametrize("scheme", ["W2A16G64", "W4A16", "W2A16G64:asym",
                                    "MXFP4"])
def test_search_init_max_scale_against_jax(scheme):
    name, _, asym = scheme.partition(":")
    over = dict(sym=False) if asym else {}
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((48, 256)) * 0.05).astype(np.float32)
    w[:, :8] *= 6.0                          # outliers in the first group
    js, ts = j_parse(name, **over), t_parse(name, **over)
    jm = np.asarray(jsr._search_init_max_scale(jnp.asarray(w), js))
    tm = tsr._search_init_max_scale(torch.from_numpy(w), ts).numpy()
    assert tm.shape == jm.shape
    np.testing.assert_allclose(tm, jm, rtol=ULP_RTOL, atol=0)
    # the same candidate in every group
    cands = np.concatenate([1.0 - 0.05 * np.arange(10),
                            1.0 + 0.25 * np.arange(1, 5)])
    if name.startswith("W") and not asym:
        cands = 1.0 - 0.01 * np.arange(90 if "W2" in name else 30)
    pick = lambda m: np.abs(m[..., None] - cands).argmin(-1)
    np.testing.assert_array_equal(pick(tm), pick(jm))
    if name != "MXFP4":     # (on these weights every MX group keeps 1.0)
        assert len(np.unique(tm)) > 1        # the search moved something


def test_init_tune_params_alg_ext_seeds_both_scales():
    w, _, _ = toy_problem(4)
    cfg = tsr.TuneConfig(iters=10, enable_alg_ext=True)
    p = tsr.init_tune_params({"w": torch.from_numpy(w)},
                             {"w": t_parse("W2A16G64")}, cfg)["w"]
    assert not torch.allclose(p["max_scale"], torch.ones(()))
    assert torch.equal(p["min_scale"], p["max_scale"])
    # two tensors: the tuner updates each in place
    assert p["min_scale"].data_ptr() != p["max_scale"].data_ptr()


# ------------------------------------------------------ outlier threshold

_jquantile = jax.jit(lambda x, q: jnp.quantile(x.reshape(-1), q))


@pytest.mark.parametrize("n", [4097, 1 << 24, (1 << 24) + 1])
def test_outlier_threshold_against_jnp_quantile(n):
    rng = np.random.default_rng(n % 1000)
    x = (rng.standard_normal(n, dtype=np.float32) ** 2).astype(np.float32)
    q = 1.0 - 0.001
    jt = np.float32(_jquantile(jnp.asarray(x), q))
    tt = tsr.outlier_threshold(torch.from_numpy(x), q)
    np.testing.assert_allclose(tt.item(), jt, rtol=ULP_RTOL, atol=0)
    if n > 1 << 24:
        with pytest.raises(RuntimeError):
            torch.quantile(torch.from_numpy(x), q)
    keep_t = (torch.from_numpy(x) <= tt).numpy()
    np.testing.assert_array_equal(keep_t, x <= jt)


# ------------------------------------------------------ Adam

def test_adam_update_against_optax():
    lr, iters = 0.01, 7
    tx = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(
        lambda t: -lr * jnp.maximum(1.0 - t / max(iters, 1), 0.0)))
    rng = np.random.default_rng(5)
    shapes = {"w": {"v": (33, 17), "max_scale": (33, 1)},
              "_nb": {"q_bias": {"v": (5,)}}}
    zeros = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
    jstate = tx.init(zeros)
    t_init, t_update = adam(lr, iters)
    tstate = t_init(jax.tree.map(torch.from_numpy, zeros))
    jupd = jax.jit(tx.update)
    for _ in range(5):
        g = jax.tree.map(
            lambda z: (rng.standard_normal(z.shape)
                       * 10 ** rng.uniform(-6, 2)).astype(np.float32), zeros)
        ju, jstate = jupd(g, jstate)
        tu, tstate = t_update(jax.tree.map(
            lambda a: torch.from_numpy(a.copy()), g), tstate)
        for a, b in zip(jax.tree.leaves(ju), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), tu))):
            a = np.asarray(a)
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())


# ------------------------------------------------------ tune_block

def _tune_pair(scheme, cfg_kw, seed=0, lfq=False, widen=False):
    w, x, ref = toy_problem(seed)
    jcfg, tcfg = jsr.TuneConfig(**cfg_kw), tsr.TuneConfig(**cfg_kw)
    js, ts = j_parse(scheme, group_size=32), t_parse(scheme, group_size=32)
    j_lfq = t_lfq = None
    if lfq:
        # a next-position log-softmax NLL over the layer's 32 outputs
        labels = np.random.default_rng(seed).integers(0, 32, x.shape[:2])

        def j_lfq(out, idx):
            lp = jax.nn.log_softmax(out[:, :-1], axis=-1)
            lab = jnp.take(jnp.asarray(labels), idx, axis=0)[:, 1:, None]
            return -jnp.mean(jnp.take_along_axis(lp, lab, axis=-1))

        def t_lfq(out, idx):
            lp = torch.log_softmax(out[:, :-1], dim=-1)
            lab = torch.from_numpy(labels).index_select(0, idx)[:, 1:, None]
            return -lp.gather(-1, lab).mean()
    jbest, jinfo = jsr.tune_block(
        j_linear, {"w": jnp.asarray(w)}, jnp.asarray(x), jnp.asarray(ref),
        {"w": js}, jcfg, lfq_fn=j_lfq)
    tbest, tinfo = tsr.tune_block(
        t_linear, {"w": torch.from_numpy(w)}, torch.from_numpy(x),
        torch.from_numpy(ref), {"w": ts}, tcfg, lfq_fn=t_lfq)
    if widen:
        jcfg = dataclasses.replace(jcfg, clip_lo=0.0, clip_hi=2.0)
        tcfg = dataclasses.replace(tcfg, clip_lo=0.0, clip_hi=2.0)
    jq = np.asarray(jsr.make_qdq_weights({"w": jnp.asarray(w)}, jbest,
                                         {"w": js}, jcfg)["w"])
    tq = tsr.make_qdq_weights({"w": torch.from_numpy(w)}, tbest, {"w": ts},
                              tcfg)["w"].numpy()
    return (jbest, jinfo, jq), (tbest, tinfo, tq)


def _codes_equal(jq, tq, jbest, tbest, bits):
    """Share of equal integer codes (recovered with the JAX scale)."""
    step = np.abs(np.diff(np.unique(jq), axis=0)).min()
    return float(np.mean(np.rint(jq / step) == np.rint(tq / step)))


@pytest.mark.parametrize("scheme,kw", [
    ("W4A16", dict(iters=20, batch_size=8, seed=0, enable_alg_ext=True)),
    ("W2A16", dict(iters=20, batch_size=8, seed=1, enable_alg_ext=True)),
    ("W2A16", dict(iters=20, batch_size=8, seed=2, optimizer="adam",
                   lr=0.01, minmax_lr=0.5, momentum=0.9)),
    ("W4A16", dict(iters=12, batch_size=8, seed=3, lfq=True)),
])
def test_tune_block_options_against_jax(scheme, kw):
    kw = dict(kw)
    lfq = kw.pop("lfq", False)
    (jbest, jinfo, jq), (tbest, tinfo, tq) = _tune_pair(
        scheme, kw, seed=kw["seed"], lfq=lfq,
        widen=kw.get("enable_alg_ext", False))
    jt, tt = jinfo["loss_trace"], tinfo["loss_trace"]
    np.testing.assert_allclose(tt[0], jt[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(tt, jt, rtol=BEST_LOSS_RTOL)
    np.testing.assert_allclose(tinfo["best_loss"], jinfo["best_loss"],
                               rtol=BEST_LOSS_RTOL)
    assert tinfo["best_loss"] <= tinfo["first_loss"]
    same = _codes_equal(jq, tq, jbest, tbest, t_parse(scheme).bits)
    assert same >= CODES_EQUAL_MIN, same
    if kw.get("enable_alg_ext"):
        ms = tbest["w"]["max_scale"]
        assert float(ms.min()) >= 0.0 and float(ms.max()) <= 2.0
    if lfq:
        assert tt[0] < 10.0                  # an NLL, not MSE x 1000


def test_outlier_mask_applies_below_four_bits_only():
    """W2 under alg_ext drops the top 0.1% squared errors (its first loss
    is below the plain MSE x 1000 at the same searched init), W4 does
    not (equal)."""
    w, x, ref = toy_problem(6)
    for scheme, masked in (("W2A16", True), ("W4A16", False)):
        s = t_parse(scheme, group_size=32)
        cfg = tsr.TuneConfig(iters=1, batch_size=32, enable_alg_ext=True)
        _, info = tsr.tune_block(t_linear, {"w": torch.from_numpy(w)},
                                 torch.from_numpy(x), torch.from_numpy(ref),
                                 {"w": s}, cfg)
        wide = dataclasses.replace(cfg, clip_hi=2.0)
        p = tsr.init_tune_params({"w": torch.from_numpy(w)}, {"w": s}, wide)
        q = tsr.make_qdq_weights({"w": torch.from_numpy(w)}, p, {"w": s},
                                 wide)
        mse = float(tsr.mse_loss(t_linear(q, torch.from_numpy(x)),
                                 torch.from_numpy(ref))) * 1000.0
        if masked:
            assert info["first_loss"] < mse
        else:
            np.testing.assert_allclose(info["first_loss"], mse, rtol=1e-6)
