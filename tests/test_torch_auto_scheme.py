"""Port parity for AutoScheme (``autoround_tpu_torch/quantize/
auto_scheme.py``) against the JAX package, and the API's legacy names.

``tiny`` cut to one block and a widened copy (hidden 256, MLP 256, so the
GGUF k-quant options score without their fallback), fp32, CPU, 4
calibration rows of 32 tokens.  Tolerances:
  * ``scheme_storage_bits``: equal (the same float arithmetic);
  * the score matrices: rtol 1e-4 against the JAX package's cached ones.
    The weight side is sum |dL/dW * (W - qdq(W))| with the qdq bit-equal
    and dL/dW from two autodiff engines (XLA's and torch's fp32 sums in
    their own orders), the activation side the same over the probes'
    gradients: measured 6.4e-7 (weight), 6.6e-7 (act) and 4.3e-5 (imatrix:
    the imatrix-weighted k-quant search moves with the x^2 means' last
    bits) relative at most; 1e-4 is about 2.3x the largest;
  * the plan: :func:`select_plan` fed the JAX package's own cached matrices
    returns the JAX package's plan exactly (float64 numpy both);
  * a plan quantized end to end: every layer's qdq equal to JAX's (RTN).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import AutoRound as JAutoRound
from autoround_tpu.models import llama as jl
from autoround_tpu.quantize import auto_scheme as jas
from autoround_tpu.schemes import parse_scheme as j_parse
from autoround_tpu_torch import (AutoRound, AutoRoundAdam,
                                 AutoRoundDiffusion, AutoRoundLLM,
                                 AutoRoundMLLM, AutoScheme)
from autoround_tpu_torch.quantize import auto_scheme as tas
from autoround_tpu_torch.schemes import parse_scheme
from autoround_tpu_torch.utils.convert import config_from_jax, params_from_jax
from _port_threads import one_torch_thread  # noqa: F401

# one block: every search reads 7 block layers (and the head), which the
# selector's bisection and greedy pass both work through, at half the JAX
# side's gradient-pass work of the preset's two blocks
JCFG = dataclasses.replace(jl.CONFIG_PRESETS["tiny"], num_layers=1)
W2G32 = {"bits": 2, "group_size": 32}
W8G32 = {"bits": 8, "group_size": 32}
WIDE = dataclasses.replace(JCFG, hidden_size=256, intermediate_size=256,
                           num_heads=2, num_kv_heads=1, num_layers=1)
SCORE_RTOL = 1e-4


def _pair(jcfg):
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 32))
    return jp, tcfg, tp, ids


@pytest.fixture(scope="module")
def tiny():
    return _pair(JCFG)


@pytest.fixture(scope="module")
def wide():
    return _pair(WIDE)


@pytest.mark.parametrize("scheme", [
    "W2A16", "W4A16", "W8A16", "W4A16G32", "W3A16", "W8A8", "FP8_STATIC",
    "FP8_BLOCK", "MXFP4", "NVFP4", "GGUF:Q4_K_S", "GGUF:Q2_K_S",
    "GGUF:Q6_K", {"bits": 4, "group_size": 64, "sym": False},
    {"bits": 4, "group_size": -1}, {"bits": 8, "group_size": 0}])
@pytest.mark.parametrize("shape", [(64, 64), (4096, 14336), (300, 200)])
def test_storage_bits_like_jax(scheme, shape):
    assert tas.scheme_storage_bits(parse_scheme(scheme), shape) == \
        jas.scheme_storage_bits(j_parse(scheme), shape)


_JAX_RUNS = {}


def _jax_scores(pair, jcfg, options, tmp_path_factory, use_imatrix=False,
                head=False):
    """The JAX package's score matrices (its ``enable_cache`` file under
    its own ``AR_WORK_SPACE``), the layer names and that directory; one run
    a case a module."""
    key = (jcfg.hidden_size, repr(options), use_imatrix, head)
    if key not in _JAX_RUNS:
        jp, _, _, ids = pair
        ws = str(tmp_path_factory.mktemp("ws"))
        names = _names(jcfg, head)
        old = os.environ.get("AR_WORK_SPACE")
        os.environ["AR_WORK_SPACE"] = ws
        try:
            jas.gen_auto_scheme(
                jp, jcfg, jas.AutoScheme(avg_bits=6.0, options=options,
                                         enable_cache=True,
                                         use_imatrix=use_imatrix),
                jnp.asarray(ids), layer_names=names)
        finally:
            if old is None:
                os.environ.pop("AR_WORK_SPACE")
            else:
                os.environ["AR_WORK_SPACE"] = old
        (path,) = glob.glob(os.path.join(ws, "auto_scheme_cache", "*.npz"))
        z = np.load(path)
        _JAX_RUNS[key] = ((z["scores"], z["bits_cost"], z["nparams"]),
                          names, ws)
    return _JAX_RUNS[key]


def _names(jcfg, head):
    names = [f"blocks.{i}.{ln}" for i in range(jcfg.num_layers)
             for ln in jl.block_linear_names(jcfg)]
    return names + ["lm_head"] if head else names


CASES = {
    "weight": (JCFG, (W2G32, "W4A16G32", W8G32), False),
    "act": (JCFG, ("W4A16G32", "W8A8", "W4A8"), False),
    "imatrix": (WIDE, ("GGUF:Q2_K_S", "GGUF:Q4_K_S", "W8A16"), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scores_like_jax(tiny, wide, tmp_path_factory, case):
    jcfg, options, use_im = CASES[case]
    pair = tiny if jcfg is JCFG else wide
    # the head's row only on the weight side: JAX's activation pass
    # splits every name as blocks.<i>.<linear> and stops on "lm_head"
    # (an IndexError, ROADMAP C)
    (js, jb, jn), names, _ = _jax_scores(pair, jcfg, options,
                                         tmp_path_factory, use_im,
                                         head=case == "weight")
    _, tcfg, tp, ids = pair
    ts, tb, tn = tas._score_matrices(
        tp, tcfg, AutoScheme(avg_bits=6.0, options=options,
                             use_imatrix=use_im),
        torch.as_tensor(ids), names, [parse_scheme(o) for o in options])
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)


@pytest.mark.parametrize("avg_bits", [2.6, 3.3, 4.5, 6.0, 7.9])
@pytest.mark.parametrize("head", [False, True])
def test_selector_returns_jax_plan(tiny, tmp_path_factory, monkeypatch,
                                   avg_bits, head):
    """The JAX package's cached matrices through the port's selector give
    the JAX package's plan (its run reads its cache, so it scores once);
    with the head the lm-head trick restricts it to W8 (relaxed only when
    the JAX arithmetic says the budget is infeasible: it never does, the
    NaN of a restricted entry makes its sum NaN, ROADMAP C)."""
    options = (W2G32, "W4A16G32", W8G32)
    jp, tcfg, tp, ids = tiny
    (js, jb, jn), names, ws = _jax_scores(tiny, JCFG, options,
                                          tmp_path_factory, head=head)
    monkeypatch.setenv("AR_WORK_SPACE", ws)
    jplan = jas.gen_auto_scheme(
        jp, JCFG, jas.AutoScheme(avg_bits=avg_bits, options=options,
                                 enable_cache=True), jnp.asarray(ids),
        layer_names=names)
    opts = [parse_scheme(o) for o in options]
    choice, used, _ = tas.select_plan(js, jb, jn, opts, avg_bits,
                                      names.index("lm_head") if head
                                      else None)
    assert [opts[c].key() for c in choice] == [jplan[n].key()
                                              for n in names]
    assert used <= avg_bits * jn.sum() or head
    if head:
        assert jplan["lm_head"].bits == 8
    # the port's own run reads the same file (its key is its own): the
    # selector alone decides, so scoring is skipped
    monkeypatch.setattr(tas, "_score_matrices", _no_scoring)
    monkeypatch.setattr(tas, "_cache_path", lambda *a: os.path.join(
        ws, "auto_scheme_cache", os.listdir(os.path.join(
            ws, "auto_scheme_cache"))[0]))
    tplan = tas.gen_auto_scheme(tp, tcfg, AutoScheme(
        avg_bits=avg_bits, options=options, enable_cache=True), ids,
        layer_names=names)
    assert {k: v.key() for k, v in tplan.items()} == \
        {k: v.key() for k, v in jplan.items()}


def _no_scoring(*a, **k):
    raise AssertionError("scored although the cache holds the matrices")


def test_gguf_fallback_and_unreachable_budget(tiny, tmp_path_factory,
                                              monkeypatch):
    """A k-quant option on 64-wide layers takes the int8 g32 scheme (its
    bits cost too), as in JAX; a budget out of reach raises on both
    sides."""
    options = ("GGUF:Q2_K_S", "W4A16G32")
    jp, tcfg, tp, ids = tiny
    (js, jb, jn), names, ws = _jax_scores(tiny, JCFG, options,
                                          tmp_path_factory)
    monkeypatch.setenv("AR_WORK_SPACE", ws)
    opts = [parse_scheme(o) for o in options]
    seen = set()
    for avg_bits in (4.6, 8.4):
        jplan = jas.gen_auto_scheme(
            jp, JCFG, jas.AutoScheme(avg_bits=avg_bits, options=options,
                                     enable_cache=True), jnp.asarray(ids),
            layer_names=names)
        choice, _, _ = tas.select_plan(js, jb, jn, opts, avg_bits)
        plan = [tas._effective_option(opts[c], (64, 64)).key()
                for c in choice]
        assert plan == [jplan[n].key() for n in names]
        seen.update(plan)
    assert seen == {"w8_g32_sym_int", "w4_g32_sym_int"}
    for avg_bits in (1.0, 12.0):
        with pytest.raises(ValueError, match="outside reachable range"):
            tas.select_plan(js, jb, jn, opts, avg_bits)
        with pytest.raises(ValueError, match="outside reachable range"):
            jas.gen_auto_scheme(
                jp, JCFG, jas.AutoScheme(avg_bits=avg_bits, options=options,
                                         enable_cache=True),
                jnp.asarray(ids), layer_names=names)


def test_one_host_transfer_and_cache_round_trip(tiny, tmp_path,
                                                monkeypatch):
    """Every score crosses to the host in one transfer; a second search
    with another budget reads the cache under ``AR_WORK_SPACE`` and scores
    nothing."""
    _, tcfg, tp, ids = tiny
    calls = []
    real = tas._to_host
    monkeypatch.setattr(tas, "_to_host",
                        lambda s: calls.append(len(s)) or real(s))
    monkeypatch.setenv("AR_WORK_SPACE", str(tmp_path))
    options = (W2G32, "W4A16G32", "W8A8")
    p1 = tas.gen_auto_scheme(tp, tcfg, AutoScheme(
        avg_bits=4.5, options=options, enable_cache=True), ids)
    # 4 weight shapes x 3 options, and W8A8's activation side a layer
    assert calls == [4 * 3 + 7]
    files = glob.glob(str(tmp_path / "auto_scheme_cache" / "*.npz"))
    assert len(files) == 1
    monkeypatch.setattr(tas, "_score_matrices", _no_scoring)
    p2 = tas.gen_auto_scheme(tp, tcfg, AutoScheme(
        avg_bits=4.5, options=options, enable_cache=True), ids)
    assert {k: v.key() for k, v in p2.items()} == \
        {k: v.key() for k, v in p1.items()}


def test_autoround_with_autoscheme_like_jax(tiny, tmp_path_factory,
                                           monkeypatch):
    """``AutoRound(scheme=AutoScheme(...))``: the plan found at
    ``quantize()`` (the port's own gradient pass and scores; the JAX
    package's run reads the matrices its earlier run cached, so it does
    not score again), ``ignore_layers`` dropping names from it, the plan
    and every layer's RTN qdq equal to the JAX package's; a dict batch
    refused."""
    jp, tcfg, tp, ids = tiny
    opts = (W2G32, "W4A16G32", W8G32)
    _, _, ws = _jax_scores(tiny, JCFG, opts, tmp_path_factory)
    monkeypatch.setenv("AR_WORK_SPACE", ws)
    kw = dict(iters=0, ignore_layers=["down_proj"])
    jar = JAutoRound((jp, JCFG), scheme=jas.AutoScheme(
        avg_bits=5.2, options=opts, enable_cache=True), **kw)
    jres = jar.quantize(jnp.asarray(ids))
    ar = AutoRound((tp, tcfg), scheme=AutoScheme(avg_bits=5.2, options=opts),
                   device="cpu", **kw)
    assert ar.layer_schemes is None
    tres = ar.quantize(ids)
    assert {k: v.key() for k, v in ar.layer_schemes.items()} == \
        {k: v.key() for k, v in jar.layer_schemes.items()}
    assert not any(k.endswith("down_proj") for k in ar.layer_schemes)
    assert len({s.bits for s in ar.layer_schemes.values()}) > 1
    for name, jq in jres.layers.items():
        np.testing.assert_array_equal(tres.layers[name].qdq.numpy(),
                                      np.asarray(jq.qdq), err_msg=name)
    with pytest.raises(NotImplementedError, match="multimodal"):
        AutoRound((tp, tcfg), scheme=AutoScheme(avg_bits=5, options=opts),
                  device="cpu").quantize({"input_ids": ids})


def test_legacy_entry_names(tiny):
    """The JAX package's legacy names: subclasses of ``AutoRound``;
    ``AutoRoundAdam`` defaults the optimizer to Adam, as JAX's does."""
    import autoround_tpu as jpkg
    import autoround_tpu_torch as tpkg
    _, tcfg, tp, _ = tiny
    for name in ("AutoRoundLLM", "AutoRoundMLLM", "AutoRoundDiffusion",
                 "AutoRoundAdam", "AutoScheme"):
        assert name in tpkg.__all__ and name in jpkg.__all__
    for cls in (AutoRoundLLM, AutoRoundMLLM, AutoRoundDiffusion):
        assert issubclass(cls, AutoRound)
        assert cls((tp, tcfg), device="cpu").cfg.optimizer == "signsgd"
    assert AutoRoundAdam((tp, tcfg), device="cpu").cfg.optimizer == "adam"
    assert AutoRoundAdam((tp, tcfg), device="cpu",
                         optimizer="signsgd").cfg.optimizer == "signsgd"
