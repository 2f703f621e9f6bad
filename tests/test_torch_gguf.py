"""Port parity of the GGUF k-quant data types, W4FP8 and the float zero
point, and the GGUF per-layer cascade, against the JAX package.

Tolerances:
  * RTN (``rtn_int_dq_*``, with and without an imatrix) and
    ``search_dq_grid``: codes and qdq bit-equal, and ``d_hat`` / ``m_hat``
    / ``d_super`` / ``m_super`` within one fp32 ulp (measured: equal).
    The searches' sums add left to right as XLA's CPU reduction does; the
    least-squares refit cancels, so another order moves its last bits.
  * the tunable qdq: values within 1e-6 (the loss, a sum of 4096 of
    them, 1e-5) and gradients with respect to
    ``v``, ``min_scale`` and ``max_scale`` within 1e-5 of the largest
    (backward sums in other orders), eager and under ``jax.jit``
    (``recip``: XLA multiplies by a constant's reciprocal there).
  * w4fp8 / float zp: bit-equal to JAX's qdq.
  * cascade plans: equal scheme for scheme.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu.dtypes import extra as jextra
from autoround_tpu.dtypes import gguf as jg
from autoround_tpu.dtypes.registry import QUANT_FUNCS as JFUNCS
from autoround_tpu.export import gguf as jexp
from autoround_tpu.models.registry import ALL_PRESETS as JPRESETS
from autoround_tpu.models.registry import get_model_fns as j_model_fns
from autoround_tpu.quantize import layer_config as jlc
from autoround_tpu.schemes import PRESET_SCHEMES as JSCHEMES
from autoround_tpu_torch.dtypes import extra as textra
from autoround_tpu_torch.dtypes import gguf as tg
from autoround_tpu_torch.dtypes.registry import QUANT_FUNCS as TFUNCS
from autoround_tpu_torch.export import gguf as texp
from autoround_tpu_torch.models.registry import get_model_fns as t_model_fns
from autoround_tpu_torch.quantize import layer_config as tlc
from autoround_tpu_torch.schemes import PRESET_SCHEMES as TSCHEMES
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401

GGUF = ["GGUF:Q2_K_S", "GGUF:Q3_K_S", "GGUF:Q4_K_S", "GGUF:Q4_K_M",
        "GGUF:Q5_K_S", "GGUF:Q6_K"]
GRAD_TOL = 1e-5


def _weights(seed, O=8, I=512):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((O, I)) * 0.05).astype(np.float32)
    w[0, :7] *= 12.0                           # an outlier group
    im = rng.random(I).astype(np.float32)
    return w, im


def _kw(s):
    return dict(super_bits=s.super_bits, super_group_size=s.super_group_size)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                  err_msg=what)


@pytest.mark.parametrize("imatrix", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("name", GGUF)
def test_rtn_codes_and_supers_equal_jax(name, imatrix):
    s = TSCHEMES[name]
    w, im = _weights(3)
    kw = _kw(s)
    if imatrix:
        kw_j = dict(kw, imatrix=jnp.asarray(im))
        kw_t = dict(kw, imatrix=torch.from_numpy(im))
    else:
        kw_j = kw_t = kw
    jf = jg.rtn_int_dq_sym if s.sym else jg.rtn_int_dq_asym
    tf = tg.rtn_int_dq_sym if s.sym else tg.rtn_int_dq_asym
    jr = jf(jnp.asarray(w), s.bits, s.group_size, **kw_j)
    tr = tf(torch.from_numpy(w), s.bits, s.group_size, **kw_t)
    _eq(jr.qdq, tr.qdq, "qdq")
    _eq(jr.scale, tr.scale, "scale")
    if s.sym:
        assert jr.zp is None and tr.zp is None
    else:
        _eq(jr.zp, tr.zp, "zp")
    assert sorted(jr.extras) == sorted(tr.extras)
    for k, v in jr.extras.items():
        if isinstance(v, (bool, int)):
            assert tr.extras[k] == v, k
        else:
            _eq(v, tr.extras[k], k)
    # through the registry as the RTN driver resolves it
    fn = TFUNCS["opt_rtn_int_dq_sym" if s.sym else "opt_rtn_int_dq_asym"]
    assert torch.equal(fn(torch.from_numpy(w), bits=s.bits,
                          group_size=s.group_size, **kw_t).qdq, tr.qdq)


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
def test_search_dq_grid_equal_and_chunked(sym, monkeypatch):
    """The grid equal to JAX's, and unchanged when the rows run in several
    chunks (the ratio loop's memory bound at an embedding's size)."""
    s = TSCHEMES["GGUF:Q6_K" if sym else "GGUF:Q2_K_S"]
    w, im = _weights(5, O=24)
    for imx in (None, im):
        jgrid = jg.search_dq_grid(jnp.asarray(w), s.bits, s.group_size,
                                  s.super_bits, s.super_group_size, sym,
                                  None if imx is None else jnp.asarray(imx))
        tgrid = tg.search_dq_grid(torch.from_numpy(w), s.bits,
                                  s.group_size, s.super_bits,
                                  s.super_group_size, sym,
                                  None if imx is None
                                  else torch.from_numpy(imx))
        assert sorted(jgrid) == sorted(tgrid)
        for k in jgrid:
            _eq(jgrid[k], tgrid[k], k)
    rtn = tg.rtn_int_dq_sym if sym else tg.rtn_int_dq_asym
    whole = rtn(torch.from_numpy(w), s.bits, s.group_size, **_kw(s))
    monkeypatch.setattr(tg, "CHUNK_ELEMS", 5 * 512)
    assert len(tg._row_chunks(24, 512)) == 5
    chunked = rtn(torch.from_numpy(w), s.bits, s.group_size, **_kw(s))
    assert torch.equal(whole.qdq, chunked.qdq)
    for k, v in whole.extras.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, chunked.extras[k]), k
    grid = tg.search_dq_grid(torch.from_numpy(w), s.bits, s.group_size,
                             s.super_bits, s.super_group_size, sym)
    _eq(jg.search_dq_grid(jnp.asarray(w), s.bits, s.group_size,
                          s.super_bits, s.super_group_size, sym)["frozen_d"],
        grid["frozen_d"], "chunked grid")


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("name", ["GGUF:Q2_K_S", "GGUF:Q3_K_S",
                                  "GGUF:Q4_K_S", "GGUF:Q6_K"])
@pytest.mark.parametrize("frozen", [False, True], ids=["minmax", "frozen"])
def test_tunable_qdq_and_gradients_like_jax(name, jit, frozen):
    s = TSCHEMES[name]
    O, I = 8, 512
    w, _ = _weights(7)
    rng = np.random.default_rng(11)
    v = ((rng.random((O, I)) - 0.5) * 0.3).astype(np.float32)
    n_g = I // s.group_size
    mn = (0.8 + 0.4 * rng.random((O, n_g))).astype(np.float32)
    mx = (0.8 + 0.4 * rng.random((O, n_g))).astype(np.float32)
    R = rng.standard_normal((O, I)).astype(np.float32)
    kw = dict(_kw(s), clip_lo=0.0, clip_hi=2.0)
    if frozen:
        grid = jg.search_dq_grid(jnp.asarray(w), s.bits, s.group_size,
                                 s.super_bits, s.super_group_size, s.sym)
        jkw = dict(kw, **grid)
        tkw = dict(kw, **{k: torch.from_numpy(np.array(a))
                          for k, a in grid.items()})
    else:
        jkw = tkw = kw
    jf = jg.qdq_int_dq_sym if s.sym else jg.qdq_int_dq_asym
    tf = tg.qdq_int_dq_sym if s.sym else tg.qdq_int_dq_asym

    def jloss(vv, a, b):
        return jnp.sum(jf(jnp.asarray(w), s.bits, s.group_size, v=vv,
                          min_scale=a, max_scale=b, **jkw).qdq * R)
    f = jax.value_and_grad(jloss, argnums=(0, 1, 2))
    val, grads = (jax.jit(f) if jit else f)(
        jnp.asarray(v), jnp.asarray(mn), jnp.asarray(mx))
    tv, tmn, tmx = (torch.tensor(a, requires_grad=True) for a in (v, mn, mx))
    r = tf(torch.from_numpy(w), s.bits, s.group_size, v=tv, min_scale=tmn,
           max_scale=tmx, recip=jit, **tkw)
    loss = (r.qdq * torch.from_numpy(R)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5)

    def jqdq(vv, a, b):
        return jf(jnp.asarray(w), s.bits, s.group_size, v=vv, min_scale=a,
                  max_scale=b, **jkw).qdq
    want = (jax.jit(jqdq) if jit else jqdq)(
        jnp.asarray(v), jnp.asarray(mn), jnp.asarray(mx))
    np.testing.assert_allclose(r.qdq.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    for jgrad, t in zip(grads, (tv, tmn, tmx)):
        jgrad = np.asarray(jgrad)
        got = np.zeros_like(jgrad) if t.grad is None else t.grad.numpy()
        scale = max(np.abs(jgrad).max(), 1e-30)
        assert np.abs(got - jgrad).max() <= GRAD_TOL * scale
    assert r.extras["sym"] is s.sym and r.extras["group_size"] == \
        s.group_size


def test_w4fp8_and_float_zp_like_jax():
    w, _ = _weights(13, O=16, I=256)
    rng = np.random.default_rng(2)
    v = ((rng.random(w.shape) - 0.5) * 0.2).astype(np.float32)
    ms = (0.7 + 0.3 * rng.random((16, 2))).astype(np.float32)
    for name in ("w4fp8", "rtn_w4fp8", "int_asym_float_zp",
                 "rtn_int_asym_float_zp"):
        assert name in TFUNCS and name in JFUNCS
        tuned = not name.startswith("rtn_")
        kw_j = dict(v=jnp.asarray(v), min_scale=jnp.asarray(ms),
                    max_scale=jnp.asarray(ms)) if tuned else {}
        kw_t = dict(v=torch.from_numpy(v), min_scale=torch.from_numpy(ms),
                    max_scale=torch.from_numpy(ms)) if tuned else {}
        jr = JFUNCS[name](jnp.asarray(w), bits=4, group_size=128, **kw_j)
        tr = TFUNCS[name](torch.from_numpy(w), bits=4, group_size=128,
                          **kw_t)
        _eq(jr.qdq, tr.qdq, name)
        _eq(jr.scale, tr.scale, name)
        if jr.zp is not None:
            _eq(jr.zp, tr.zp, name)
    jr = jextra.qdq_w4fp8(jnp.asarray(w), 4, 32)
    tr = textra.qdq_w4fp8(torch.from_numpy(w), 4, 32)
    _eq(jr.qdq, tr.qdq, "w4fp8 g32")


def test_registry_names_equal_jax():
    """Every double-quant, W4FP8 and float-zp name of the JAX registry is
    the port's."""
    keys = [k for k in JFUNCS if "dq" in k or "w4fp8" in k
            or "float_zp" in k]
    assert len(keys) == 16
    assert all(k in TFUNCS for k in keys)


# ----------------------------------------------------------------- cascade

KINDS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
         "ffn_up", "ffn_down", "output", "token_embd", "other")


def test_select_layer_qtype_table_equals_jax():
    T = jexp.GGMLType
    bases = [T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K, T.Q4_0, T.Q5_0,
             T.Q8_0]
    for base in bases:
        for kind in KINDS:
            for bi in range(0, 32, 3):
                for I in (4096, 14336, 2880, 48):
                    for n_gqa, n_exp, imx in ((1, 0, False), (4, 8, True),
                                              (8, 0, True)):
                        args = (base, bi, 32, kind, I)
                        kw = dict(n_gqa=n_gqa, n_expert=n_exp,
                                  has_imatrix=imx)
                        assert texp.select_layer_qtype(*args, **kw) == \
                            jexp.select_layer_qtype(*args, **kw), (args, kw)


WIDE = dict(hidden_size=256, intermediate_size=512)
MODELS = {"tiny": ("tiny", {}), "tiny-wide": ("tiny", WIDE),
          "tiny-moe": ("tiny-moe", {}), "tiny-moe-wide": ("tiny-moe", WIDE)}


@pytest.fixture(scope="module")
def cascade_models():
    out = {}
    for key, (preset, over) in MODELS.items():
        jcfg = dataclasses.replace(JPRESETS[preset], **over)
        jp = j_model_fns(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = config_from_jax(dataclasses.asdict(jcfg))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        out[key] = (jcfg, jp, tcfg, tp)
    return out


def _plans(scheme, jcfg, jp, tcfg, tp, quant_lm_head):
    """(JAX plan, port plan) as the two APIs build them."""
    def build(lc, schemes, fns, cfg, params):
        names = fns(cfg).block_linear_names(cfg)
        special = lc.handle_special_scheme(scheme, names, quant_lm_head)
        base, layer_config, qlh, pinned = scheme, None, quant_lm_head, ()
        if special is not None:
            base, overrides, qlh = special[:3]
            pinned = tuple(overrides)
            layer_config = dict(overrides)
        plan = lc.resolve_layer_schemes(cfg.num_layers, names,
                                        schemes[base], layer_config=
                                        layer_config, quant_lm_head=qlh)
        plan = lc.prune_missing_layers(plan, params)
        plan = lc.apply_gguf_cascade(plan, params, cfg.num_layers, base,
                                     quant_lm_head=qlh, pinned=pinned,
                                     model_cfg=cfg)
        if special is not None and "embed_tokens" in plan:
            plan["embed_tokens"] = schemes["GGUF:Q8_0"]
        return {k: v.key() for k, v in plan.items()}
    return (build(jlc, JSCHEMES, j_model_fns, jcfg, jp),
            build(tlc, TSCHEMES, t_model_fns, tcfg, tp))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("scheme", ["GGUF:Q4_K_S", "GGUF:Q4_K_M",
                                    "GGUF:Q2_K_MIXED"])
def test_cascade_plans_equal_jax(cascade_models, model, scheme):
    """Plan for plan, the embedding's entry included; at width 64 every
    k-quant falls back to Q8_0 (64 % 256), at 256 / 512 the k-quants and
    the ``_M`` upgrades stand."""
    jp_plan, tp_plan = _plans(scheme, *cascade_models[model],
                              quant_lm_head=True)
    assert tp_plan == jp_plan
    assert "embed_tokens" in tp_plan
    wide = model.endswith("wide")
    dq = {k for k, v in tp_plan.items() if "int_dq" in v}
    assert bool(dq) == wide
    if not wide:
        assert set(tp_plan.values()) == {"w8_g32_sym_int"}
