"""Port parity: sign-SGD, the STE gradients of the int qdq, the scale
searches and ``tune_block`` against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; both
run on the CPU in fp32.

Tolerances:
  * sign-SGD deltas and the decay: 1e-7 (the same float32 arithmetic);
  * qdq gradients w.r.t. ``v`` / ``min_scale`` / ``max_scale``: rtol 1e-5
    with an absolute floor of 1e-5 of the largest gradient (both sides
    differentiate the same fp32 graph; scale gradients are sums over a
    group, taken in different orders);
  * ``opt_rtn_int_sym`` (qdq and scales): bit-exact.
    ``search_init_scale_ratio``: the same candidate chosen in every group;
    the returned ratio ``1 - 0.01 k`` equal to one float32 ulp (rtol 2e-7):
    the JAX function is jitted, and XLA on the CPU fuses the gather of the
    chosen ratio into a single-rounding multiply-add, where eager float32
    arithmetic (the port's, and JAX's own outside jit) rounds twice;
  * ``tune_block`` on the toy linear problem: iteration-0 loss and
    first-step gradients rtol 1e-4.  Sign-SGD turns last-bit differences
    into different updates, so after N steps there is no bitwise target.
    Measured over the cases below and three longer ones (100 and 200
    steps): the loss traces agree to 2.7e-6 relative at every step, the
    best loss to 1.7e-6, and all 2048 codes are equal.  Limits, about 3x:
    best loss rtol 5e-6; at least 99.8% of the codes equal (4 of 2048: a
    tie in one sign step moves one code).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.algorithms import signround as jsr
from autoround_tpu.algorithms.signsgd import (
    linear_decay_schedule as j_schedule, sign_sgd as j_sign_sgd)
from autoround_tpu.dtypes import intq as jintq
from autoround_tpu.schemes import parse_scheme as j_parse
from autoround_tpu_torch.algorithms import signround as tsr
from autoround_tpu_torch.algorithms.signsgd import (
    linear_decay_schedule as t_schedule, sign_sgd as t_sign_sgd)
from autoround_tpu_torch.dtypes import intq as tintq
from autoround_tpu_torch.schemes import parse_scheme as t_parse

BEST_LOSS_RTOL = 5e-6
CODES_EQUAL_MIN = 0.998


def _np(t):
    return t.detach().numpy()


# --------------------------------------------------------------- sign-SGD

class TestSignSgd:
    def test_update_is_sign(self):
        g = np.array([3.0, -0.5, 0.0], np.float32)
        _, ju = j_sign_sgd(lr=0.1, total_steps=10)
        ti, tu = t_sign_sgd(lr=0.1, total_steps=10)
        jup, _ = ju({"v": jnp.asarray(g)}, j_sign_sgd(0.1, 10)[0](
            {"v": jnp.asarray(g)}))
        tup, state = tu({"v": torch.tensor(g)}, ti({"v": torch.tensor(g)}))
        np.testing.assert_allclose(_np(tup["v"]), [-0.1, 0.1, 0.0], atol=1e-7)
        np.testing.assert_allclose(_np(tup["v"]), np.asarray(jup["v"]),
                                   atol=1e-7)
        assert state.step == 1

    @pytest.mark.parametrize("total", [1, 7, 10, 200])
    def test_linear_decay(self, total):
        js, ts = j_schedule(0.3, total), t_schedule(0.3, total)
        for t in (0, 1, total // 2, total - 1, total, total + 3):
            np.testing.assert_allclose(float(ts(t)), float(js(jnp.array(t))),
                                       atol=1e-7)
        assert float(ts(0)) == np.float32(0.3) and float(ts(total)) == 0.0

    def test_minmax_lr_scaling_over_steps(self):
        rng = np.random.default_rng(0)
        scale_fn = lambda n: 2.5 if "scale" in n else 1.0
        jinit, ju = j_sign_sgd(lr=0.05, total_steps=6, lr_scale_fn=scale_fn)
        tinit, tu = t_sign_sgd(lr=0.05, total_steps=6, lr_scale_fn=scale_fn)
        shapes = {"w": {"v": (4, 8), "min_scale": (4, 2), "max_scale": (4, 2)}}
        zeros = {n: {k: np.zeros(s, np.float32) for k, s in d.items()}
                 for n, d in shapes.items()}
        js = jinit(jax.tree.map(jnp.asarray, zeros))
        ts = tinit({n: {k: torch.from_numpy(a) for k, a in d.items()}
                    for n, d in zeros.items()})
        for _ in range(8):                       # past the end: lr stays 0
            g = {n: {k: np.sign(rng.standard_normal(s)).astype(np.float32)
                     * rng.integers(0, 2, s).astype(np.float32)
                     for k, s in d.items()} for n, d in shapes.items()}
            jup, js = ju(jax.tree.map(jnp.asarray, g), js)
            tup, ts = tu({n: {k: torch.from_numpy(a) for k, a in d.items()}
                          for n, d in g.items()}, ts)
            for k in shapes["w"]:
                np.testing.assert_allclose(_np(tup["w"][k]),
                                           np.asarray(jup["w"][k]), atol=1e-7)
        assert float(np.abs(_np(tup["w"]["v"])).max()) == 0.0

    def test_momentum(self):
        g = np.array([1.0, -2.0, 0.5], np.float32)
        jinit, ju = j_sign_sgd(0.1, 10, momentum=0.9)
        tinit, tu = t_sign_sgd(0.1, 10, momentum=0.9)
        js, ts = jinit({"v": jnp.asarray(g)}), tinit({"v": torch.tensor(g)})
        for sgn in (1.0, -0.3, -0.3):
            jup, js = ju({"v": jnp.asarray(g * sgn)}, js)
            tup, ts = tu({"v": torch.tensor(g * sgn)}, ts)
            np.testing.assert_allclose(_np(tup["v"]), np.asarray(jup["v"]),
                                       atol=1e-7)
            np.testing.assert_allclose(_np(ts.momentum["v"]),
                                       np.asarray(js.momentum["v"]), rtol=1e-6)


# ------------------------------------------------------- STE qdq gradients

def _grad_case(O, I, g, seed, zero_group=True):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((O, I)) * 0.05).astype(np.float32)
    w[::2] = np.abs(w[::2]) + 0.01           # positive-dominant groups
    gg = I if g == -1 else min(g, I)
    if zero_group:
        w[1, :gg] = 0.0                      # one all-zero group
    n_groups = O * (-(-I // gg))
    v = rng.uniform(-0.4, 0.4, (O, I)).astype(np.float32)
    mn = rng.uniform(0.6, 1.0, (n_groups,)).astype(np.float32)
    mx = rng.uniform(0.6, 1.0, (n_groups,)).astype(np.float32)
    # some multipliers sit exactly on the clip bound (their init value),
    # where the clip passes half the gradient
    mn[::3] = 1.0
    mx[1::3] = 1.0
    cot = rng.standard_normal((O, I)).astype(np.float32)
    return w, v, mn, mx, cot


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape,g", [((6, 64), 32), ((4, 256), 128),
                                     ((4, 200), 128), ((5, 70), -1)])
def test_qdq_ste_gradients(sym, bits, shape, g):
    w, v, mn, mx, cot = _grad_case(*shape, g, seed=bits + shape[1])
    jfn = jintq.qdq_int_sym if sym else jintq.qdq_int_asym
    tfn = tintq.qdq_int_sym if sym else tintq.qdq_int_asym

    def jloss(v_, mn_, mx_):
        r = jfn(jnp.asarray(w), bits, g, v=v_, min_scale=mn_, max_scale=mx_)
        return jnp.sum(r.qdq * jnp.asarray(cot))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(mn), jnp.asarray(mx))

    tv, tmn, tmx = (torch.from_numpy(a).requires_grad_(True)
                    for a in (v, mn, mx))
    r = tfn(torch.from_numpy(w), bits, g, v=tv, min_scale=tmn, max_scale=tmx)
    tg = torch.autograd.grad((r.qdq * torch.from_numpy(cot)).sum(),
                             (tv, tmn, tmx))
    for name, a, b in zip(("v", "min_scale", "max_scale"), jg, tg):
        a, b = np.asarray(a), _np(b)
        assert np.isfinite(b).all(), name
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(a).max(), 1e-30),
                                   err_msg=name)
    # the forward values stay bit-equal with the gradient-matching clip
    rj = jfn(jnp.asarray(w), bits, g, v=jnp.asarray(v),
             min_scale=jnp.asarray(mn), max_scale=jnp.asarray(mx))
    np.testing.assert_array_equal(np.asarray(rj.qdq), _np(r.qdq))


def test_qdq_gradients_at_init_are_half_on_the_bound():
    """min/max_scale start at 1.0 == clip_hi: both packages pass half the
    gradient there (a clip is minimum(maximum(x, lo), hi))."""
    w, v, _, _, cot = _grad_case(4, 64, 32, seed=0, zero_group=False)
    ones = np.ones((8,), np.float32)

    def tgrad(clip_hi):
        tmx = torch.from_numpy(ones.copy()).requires_grad_(True)
        r = tintq.qdq_int_asym(torch.from_numpy(w), 4, 32, max_scale=tmx,
                               clip_hi=clip_hi)
        return _np(torch.autograd.grad(
            (r.qdq * torch.from_numpy(cot)).sum(), tmx)[0])
    jg = jax.grad(lambda m: jnp.sum(jintq.qdq_int_asym(
        jnp.asarray(w), 4, 32, max_scale=m).qdq * jnp.asarray(cot)))(
            jnp.asarray(ones))
    on_bound, inside = tgrad(1.0), tgrad(2.0)
    np.testing.assert_allclose(on_bound, np.asarray(jg), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(on_bound, 0.5 * inside, rtol=1e-6, atol=1e-8)
    assert np.abs(on_bound).max() > 0


# ----------------------------------------------------------- scale searches

@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("shape,g", [((8, 128), 32), ((6, 200), 128),
                                     ((4, 96), -1)])
@pytest.mark.parametrize("with_imatrix", [False, True])
def test_scale_search_exact(bits, shape, g, with_imatrix):
    w, *_ = _grad_case(*shape, g, seed=7 * bits + shape[0])
    im = None
    if with_imatrix:
        im = np.random.default_rng(bits).uniform(
            0.05, 3.0, (shape[1],)).astype(np.float32)
    jim = None if im is None else jnp.asarray(im)
    tim = None if im is None else torch.from_numpy(im)
    a = jintq.search_init_scale_ratio(jnp.asarray(w), bits, g, imatrix=jim)
    b = tintq.search_init_scale_ratio(torch.from_numpy(w), bits, g,
                                      imatrix=tim)
    step = lambda r: np.rint((1.0 - np.asarray(r, np.float64)) / 0.01)
    np.testing.assert_array_equal(step(a), step(_np(b)))
    np.testing.assert_allclose(_np(b), np.asarray(a), rtol=2e-7, atol=0)
    assert (_np(b) < 1.0).any()                  # the search found shrinks
    ra = jintq.opt_rtn_int_sym(jnp.asarray(w), bits, g, imatrix=jim)
    rb = tintq.opt_rtn_int_sym(torch.from_numpy(w), bits, g, imatrix=tim)
    np.testing.assert_array_equal(np.asarray(ra.qdq), _np(rb.qdq))
    np.testing.assert_array_equal(np.asarray(ra.scale), _np(rb.scale))


# --------------------------------------------------------------- batch order

@pytest.mark.parametrize("nsamples,bs,iters,accum", [
    (32, 8, 10, 1), (16, 8, 20, 1), (10, 4, 7, 3), (3, 8, 5, 2),
    (16, 16, 4, 1)])
def test_batch_indices_equal_the_jax_order(nsamples, bs, iters, accum):
    """The JAX ``tune_block`` builds its index tensor inline; hand it a
    forward that records nothing and read the indices from the loss: each
    sample's target is its own index."""
    cfg = tsr.TuneConfig(iters=iters, batch_size=bs, seed=11,
                         gradient_accumulate_steps=accum)
    got = tsr.batch_indices(nsamples, cfg)
    assert got.shape == (iters, accum, min(bs, nsamples))
    # the JAX package's construction, statement for statement
    b = min(bs, nsamples)
    rng = np.random.default_rng(11)
    n_per = max(nsamples // b, 1)
    epochs = []
    while len(epochs) * n_per < iters * accum:
        epochs.append(rng.permutation(nsamples)[: n_per * b].reshape(n_per, b))
    want = np.concatenate(epochs)[: iters * accum].reshape(iters, accum, b)
    np.testing.assert_array_equal(got, want)
    # and through the JAX tune_block itself: with weights frozen
    # (no tuning leaves) the loss of step t is a function of its batch only
    x = np.arange(nsamples, dtype=np.float32).reshape(nsamples, 1, 1)
    jcfg = jsr.TuneConfig(iters=iters, batch_size=bs, seed=11,
                          gradient_accumulate_steps=accum,
                          enable_round_tuning=False,
                          enable_minmax_tuning=False, loss_scale=1.0)
    _, info = jsr.tune_block(
        lambda ws, xb: xb * 0.0, {"w": jnp.zeros((1, 1))}, jnp.asarray(x),
        jnp.asarray(x), {}, jcfg)
    want_loss = (got.astype(np.float64) ** 2).mean(axis=(1, 2))
    np.testing.assert_allclose(info["loss_trace"], want_loss, rtol=1e-5)


# ------------------------------------------------------------------ tune_block

def toy_problem(seed=0, nsamples=32, seq=8, din=64, dout=32):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((dout, din)) * 0.1).astype(np.float32)
    x = rng.standard_normal((nsamples, seq, din)).astype(np.float32)
    return w, x, np.einsum("bsi,oi->bso", x, w)


def j_linear(weights, x):
    return jnp.einsum("bsi,oi->bso", x, weights["w"])


def t_linear(weights, x):
    return torch.einsum("bsi,oi->bso", x, weights["w"])


def _tune_both(scheme, cfg_kw, seed=0, mask=None):
    w, x, ref = toy_problem(seed)
    jcfg = jsr.TuneConfig(**cfg_kw)
    tcfg = tsr.TuneConfig(**cfg_kw)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jbest, jinfo = jsr.tune_block(
        j_linear, {"w": jnp.asarray(w)}, jnp.asarray(x), jnp.asarray(ref),
        {"w": j_parse(scheme, group_size=32)}, jcfg, mask=jm)
    tbest, tinfo = tsr.tune_block(
        t_linear, {"w": torch.from_numpy(w)}, torch.from_numpy(x),
        torch.from_numpy(ref), {"w": t_parse(scheme, group_size=32)}, tcfg,
        mask=tm)
    jq = jsr.make_qdq_weights({"w": jnp.asarray(w)}, jbest,
                              {"w": j_parse(scheme, group_size=32)}, jcfg)
    tq = tsr.make_qdq_weights({"w": torch.from_numpy(w)}, tbest,
                              {"w": t_parse(scheme, group_size=32)}, tcfg)
    return (jbest, jinfo, np.asarray(jq["w"])), (tbest, tinfo, _np(tq["w"]))


@pytest.mark.parametrize("scheme,kw", [
    ("W2A16", dict(iters=30, batch_size=8, seed=0)),
    ("W4A16", dict(iters=30, batch_size=8, seed=1)),
    ("W4A16", dict(iters=12, batch_size=4, seed=2,
                   gradient_accumulate_steps=2)),
    ("GGUF:Q4_1", dict(iters=20, batch_size=8, seed=3, minmax_lr=0.02)),
    ("W4A16", dict(iters=20, batch_size=8, seed=4,
                   enable_minmax_tuning=False)),
])
def test_tune_block_against_jax(scheme, kw):
    (jbest, jinfo, jq), (tbest, tinfo, tq) = _tune_both(scheme, kw,
                                                        seed=kw["seed"])
    np.testing.assert_allclose(tinfo["first_loss"], jinfo["first_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tinfo["best_loss"], jinfo["best_loss"],
                               rtol=BEST_LOSS_RTOL)
    assert tinfo["loss_trace"].shape == jinfo["loss_trace"].shape
    assert tinfo["best_loss"] <= tinfo["loss_trace"].min() + 1e-6
    assert tinfo["best_loss"] <= tinfo["first_loss"]
    assert (tinfo["best_loss"] < tinfo["first_loss"]) \
        == (jinfo["best_loss"] < jinfo["first_loss"])
    assert set(tbest["w"]) == set(jbest["w"])
    for k in tbest["w"]:
        assert tbest["w"][k].shape == tuple(jbest["w"][k].shape)
        assert tbest["w"][k].dtype == torch.float32
        assert not tbest["w"][k].requires_grad
    assert np.mean(tq == jq) >= CODES_EQUAL_MIN


def test_first_step_gradients_against_jax():
    """Gradients of the scaled tuning loss at the initial state."""
    w, x, ref = toy_problem(5)
    idx = np.arange(8)
    jscheme, tscheme = j_parse("W2A16", group_size=32), \
        t_parse("W2A16", group_size=32)
    jcfg, tcfg = jsr.TuneConfig(), tsr.TuneConfig()
    jp = jsr.init_tune_params({"w": jnp.asarray(w)}, {"w": jscheme}, jcfg)
    tp = tsr.init_tune_params({"w": torch.from_numpy(w)}, {"w": tscheme}, tcfg)

    def jloss(p):
        qw = jsr.make_qdq_weights({"w": jnp.asarray(w)}, p, {"w": jscheme},
                                  jcfg)
        return jsr.mse_loss(j_linear(qw, jnp.asarray(x[idx])),
                            jnp.asarray(ref[idx])) * jcfg.loss_scale
    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = [t.requires_grad_(True) for t in tp["w"].values()]
    qw = tsr.make_qdq_weights({"w": torch.from_numpy(w)}, tp, {"w": tscheme},
                              tcfg)
    tl = tsr.mse_loss(t_linear(qw, torch.from_numpy(x[idx])),
                      torch.from_numpy(ref[idx])) * tcfg.loss_scale
    tg = dict(zip(tp["w"], torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k in tg:
        a = np.asarray(jg["w"][k])
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(_np(tg[k]), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=k)


def test_init_tune_params_shapes():
    w = torch.zeros((6, 200))
    p = tsr.init_tune_params({"a": w, "b": w}, {
        "a": t_parse("W4A16"), "b": t_parse("W4A16", group_size=-1)},
        tsr.TuneConfig())
    assert p["a"]["v"].shape == (6, 200) and p["a"]["v"].abs().max() == 0
    assert p["a"]["min_scale"].shape == (6, 2) == p["a"]["max_scale"].shape
    assert p["b"]["max_scale"].shape == (6, 1)
    assert bool((p["a"]["min_scale"] == 1).all())
    assert p["a"]["min_scale"] is not p["a"]["max_scale"]
    p = tsr.init_tune_params({"a": w}, {"a": t_parse("W4A16")},
                             tsr.TuneConfig(enable_round_tuning=False))
    assert sorted(p["a"]) == ["max_scale", "min_scale"]


def test_masked_loss_against_jax():
    mask = np.ones((32, 8), np.float32)
    mask[:, -2:] = 0
    mask[3] = 0
    (_, jinfo, _), (_, tinfo, _) = _tune_both(
        "W4A16", dict(iters=10, batch_size=8, seed=6), seed=6, mask=mask)
    np.testing.assert_allclose(tinfo["first_loss"], jinfo["first_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tinfo["best_loss"], jinfo["best_loss"],
                               rtol=BEST_LOSS_RTOL)
    # the mask is honoured: the unmasked run reads another loss
    (_, _, _), (_, tfull, _) = _tune_both(
        "W4A16", dict(iters=10, batch_size=8, seed=6), seed=6)
    assert abs(tfull["first_loss"] - tinfo["first_loss"]) \
        > 1e-3 * tfull["first_loss"]
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    m = (rng.uniform(size=(4, 5)) > 0.4).astype(np.float32)
    np.testing.assert_allclose(
        float(tsr.mse_loss(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(m))),
        float(jsr.mse_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m))),
        rtol=1e-6)


def test_dynamic_max_gap_freezes():
    """After ``gap`` steps without a new best the parameters stop moving:
    with the batch fixed (batch_size = nsamples) the loss then repeats."""
    kw = dict(iters=40, batch_size=32, seed=0, dynamic_max_gap=2, lr=0.2)
    (_, jinfo, _), (_, tinfo, _) = _tune_both("W4A16", kw, seed=7)
    trace = tinfo["loss_trace"]
    best_at = int(np.argmin(trace))
    assert best_at < len(trace) - 4
    tail = trace[best_at + 3:]
    assert np.all(tail == tail[0]), "updates after the gap are frozen"
    np.testing.assert_allclose(tinfo["best_loss"], jinfo["best_loss"],
                               rtol=BEST_LOSS_RTOL)
    free = _tune_both("W4A16", dict(kw, dynamic_max_gap=-1), seed=7)[1][1]
    assert len(np.unique(free["loss_trace"][best_at + 3:])) > 1


def test_use_best_params_and_remat():
    w, x, ref = toy_problem(8)
    args = (t_linear, {"w": torch.from_numpy(w)}, torch.from_numpy(x),
            torch.from_numpy(ref), {"w": t_parse("W2A16", group_size=32)})
    cfg = tsr.TuneConfig(iters=15, batch_size=8, seed=0)
    best, info = tsr.tune_block(*args, cfg)
    last, info_last = tsr.tune_block(
        *args, dataclasses.replace(cfg, use_best_params=False))
    remat, info_remat = tsr.tune_block(
        *args, dataclasses.replace(cfg, use_remat=True))
    np.testing.assert_array_equal(info["loss_trace"], info_last["loss_trace"])
    assert int(np.argmin(info["loss_trace"])) < 14      # best is not the last
    assert not torch.equal(best["w"]["v"], last["w"]["v"])
    np.testing.assert_array_equal(info["loss_trace"],
                                  info_remat["loss_trace"])
    assert torch.equal(best["w"]["v"], remat["w"]["v"])
    # the step runs with gradients whatever the caller's mode
    with torch.no_grad():
        ng, info_ng = tsr.tune_block(*args, cfg)
    assert torch.equal(best["w"]["v"], ng["w"]["v"])


@pytest.mark.parametrize("kw,item", [
    (dict(cfg=dict(enable_alg_ext=True)), "A3"),
    (dict(cfg=dict(optimizer="adam")), "A3"),
    (dict(cfg=dict(tune_act_scales=True)), None),      # ported: runs
    (dict(cfg=dict(enable_norm_bias_tuning=True)), "A3"),
    (dict(lfq_fn=lambda out, idx: out.sum()), "A5"),
    (dict(extras={"w": {}}), "A9"),
    (dict(init_scales={"w": None}), "A12"),
])
def test_unported_options_raise(kw, item):
    w, x, ref = toy_problem(9)
    cfg = tsr.TuneConfig(iters=2, **kw.pop("cfg", {}))
    if item is None:
        # no static activation scales in the weights: nothing more to tune
        best, info = tsr.tune_block(
            t_linear, {"w": torch.from_numpy(w)}, torch.from_numpy(x),
            torch.from_numpy(ref), {"w": t_parse("W4A16", group_size=32)},
            cfg)
        assert sorted(best) == ["w"] and np.isfinite(info["loss_trace"]).all()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tsr.tune_block(t_linear, {"w": torch.from_numpy(w)},
                       torch.from_numpy(x), torch.from_numpy(ref),
                       {"w": t_parse("W4A16", group_size=32)}, cfg, **kw)


def test_tuner_leaves_no_reference_cycles():
    """With the cyclic collector off, everything a tuning run allocated is
    freed by reference counting alone: a closure that calls itself (as
    ``set_by_path`` and the sign-SGD update once did) would keep qdq
    weights and their graphs alive until a collection happened to run,
    which on the card showed as gigabytes of dead tensors."""
    import gc
    import weakref

    from autoround_tpu_torch.utils.pytree import set_by_path

    rng = np.random.default_rng(0)
    w = {"a": torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32)), "b": [{"c": torch.from_numpy(rng.standard_normal(
            (32, 64)).astype(np.float32))}]}
    x = torch.from_numpy(rng.standard_normal((8, 4, 128)).astype(np.float32))

    def fwd(ws, xb):
        return torch.relu(xb @ ws["a"].T) @ ws["b"][0]["c"].T

    schemes = {"a": t_parse("W4A16G32"), "b.0.c": t_parse("W4A16G32")}
    gc.collect()
    gc.disable()
    try:
        value = torch.zeros(3)
        ref = weakref.ref(value)
        tree = set_by_path(w, "b.0.c", value)
        del tree, value
        assert ref() is None
        for momentum in (0.0, 0.5):
            best, _ = tsr.tune_block(
                fwd, w, x, fwd(w, x), schemes,
                tsr.TuneConfig(iters=3, batch_size=4, momentum=momentum))
            refs = [weakref.ref(t) for p in best.values()
                    for t in p.values()]
            del best
            assert all(r() is None for r in refs)
            assert gc.collect() == 0
    finally:
        gc.enable()
