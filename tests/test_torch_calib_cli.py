"""Calibration data, the ``AutoRound`` dataset arguments, ``envs`` and the
CLI of the port against the JAX package's: ``get_calib_batch`` ids and
masks equal (the same numpy draws) for every local spec, the parsers'
namespaces equal over a set of argvs, and ``main`` writing an
``autoround`` export byte-equal to the JAX CLI's from the same HF
directory and ``.npy`` ids.  Unported options raise naming their ROADMAP
item.  All comparisons are exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoround_tpu import cli as jcli
from autoround_tpu.models import llama as jl
from autoround_tpu.quantize import calib_data as jcd
from autoround_tpu.utils.hf_loader import save_hf_checkpoint as j_save_hf
from autoround_tpu_torch import AutoRound, envs
from autoround_tpu_torch import cli as tcli
from autoround_tpu_torch.quantize import calib_data as tcd
from test_calib_data import ChatTokenizer, FakeTokenizer


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    d = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    lines = [" ".join(rng.choice(words, rng.integers(2, 30)))
             for _ in range(40)]
    (d / "t.txt").write_text("\n".join(lines))
    (d / "t.json").write_text(json.dumps(
        [{"text": t} if i % 2 else t for i, t in enumerate(lines)]))
    msgs = [{"role": "user", "content": "hi there"},
            {"role": "assistant", "content": "hello"}]
    with open(d / "t.jsonl", "w") as f:
        for t in lines:
            f.write(json.dumps({"text": t}) + "\n")
    # message records go through a chat template only
    with open(d / "m.jsonl", "w") as f:
        for i, t in enumerate(lines):
            f.write(json.dumps({"messages": msgs} if i % 3 == 0
                               else {"text": t}) + "\n")
    return d


def _reject_system():
    tok = ChatTokenizer()
    tok.reject_system = True
    return tok


SPECS = {
    "synthetic": ("synthetic", {}),
    "txt": ("local:{d}/t.txt", {}),
    "json": ("local:{d}/t.json", {}),
    "jsonl": ("local:{d}/t.jsonl", {}),
    "chat": ("local:{d}/m.jsonl", dict(apply_chat_template=True)),
    "chat-system": ("local:{d}/t.txt", dict(apply_chat_template=True,
                                            system_prompt="be brief")),
    "chat-no-template": ("local:{d}/t.txt", dict(apply_chat_template=True)),
    "mix": ("synthetic:0.25,local:{d}/t.txt", {}),
    "mix-three": ("synthetic:0.2,synthetic,local:{d}/t.json", {}),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_calib_batch_equals_jax(texts, name):
    spec, kw = SPECS[name]
    spec = spec.format(d=texts)
    tok = FakeTokenizer() if name == "chat-no-template" else ChatTokenizer()
    for seed in (0, 42):
        args = dict(nsamples=6, seqlen=24, vocab_size=250, seed=seed, **kw)
        want = jcd.get_calib_batch(spec, tokenizer=tok, **args)
        got = tcd.get_calib_batch(spec, tokenizer=tok, **args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_calib_arrays_token_lists_and_chat_fallback(texts):
    arr = np.arange(64).reshape(4, 16)
    lists = [[1] * 20, [2] * 10, [3] * 3]
    for data, kw in ((arr, {}), (lists, dict(nsamples=2, seqlen=16)),
                     (lists, dict(nsamples=8, seqlen=12))):
        for a, b in zip(tcd.get_calib_batch(data, **kw),
                        jcd.get_calib_batch(data, **kw)):
            np.testing.assert_array_equal(a, b)
    spec = f"local:{texts}/t.txt"
    kw = dict(nsamples=4, seqlen=32, apply_chat_template=True,
              system_prompt="be brief")
    for a, b in zip(tcd.get_calib_batch(spec, tokenizer=_reject_system(),
                                        **kw),
                    jcd.get_calib_batch(spec, tokenizer=_reject_system(),
                                        **kw)):
        np.testing.assert_array_equal(a, b)


def test_calib_registry_and_unported():
    for name in jcd.CALIB_DATASETS:
        assert name in tcd.CALIB_DATASETS, name
    with pytest.raises(NotImplementedError, match="A8.*local:"):
        tcd.get_calib_batch("pile-10k", nsamples=2, seqlen=8,
                            tokenizer=FakeTokenizer())
    with pytest.raises(ValueError, match="unknown dataset"):
        tcd.get_calib_batch("not-a-dataset", nsamples=2, seqlen=8)
    with pytest.raises(NotImplementedError, match="A14"):
        tcd.get_mllm_calib_batch(None)
    with pytest.raises(NotImplementedError, match="A14"):
        tcd.get_diffusion_calib_batch(None)


def test_autoround_builds_its_batch(texts):
    """``quantize()`` with no ids calibrates on the constructor's dataset:
    the same result as handing it JAX's batch and mask."""
    from autoround_tpu_torch.models import llama as tl
    cfg = tl.CONFIG_PRESETS["tiny"]
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = f"local:{texts}/t.json"
    kw = dict(nsamples=4, seqlen=16)
    ar = AutoRound((params, cfg), iters=0, dataset=spec,
                   tokenizer=FakeTokenizer(), device="cpu", **kw)
    res = ar.quantize()
    ids, mask = jcd.get_calib_batch(spec, tokenizer=FakeTokenizer(),
                                    vocab_size=cfg.vocab_size, seed=42, **kw)
    ref = AutoRound((params, cfg), iters=0, device="cpu").quantize(ids, mask)
    for name, ql in ref.layers.items():
        assert torch.equal(res.layers[name].qdq, ql.qdq), name
    with pytest.raises(ValueError, match="dataset"):
        AutoRound((params, cfg), iters=0, device="cpu").quantize()
    with pytest.raises(NotImplementedError, match="A12"):
        AutoRound((params, cfg), enable_rotation="r1", device="cpu")


# ----------------------------------------------------------------- the CLI

ARGVS = [
    ["--model", "tiny"],
    ["--model", "tiny", "--seq-len", "16", "--nsample", "4", "--train-bs",
     "2", "--target-bits", "3.5", "--output-dir", "/tmp/x",
     "--low-gpu-mem-usage"],
    ["--model", "tiny", "--scheme", "W4A16", "--bits", "3", "--group-size",
     "32", "--asym", "--act-bits", "8", "--act-asym",
     "--disable-act-dynamic", "--data-type", "int", "--scale-dtype", "fp16"],
    ["--model-name-or-path", "m", "--recipe", "light", "--iters", "5",
     "--lr", "0.01", "--minmax-lr", "0.02", "--dataset", "local:x.txt",
     "--tokenizer", "tk", "--apply-chat-template", "--system-prompt", "s",
     "--formats", "fake,autoround", "--seed", "7", "--device", "cpu"],
    ["--model", "m", "--recipe", "opt-rtn", "--device-map", "none",
     "--model-dtype", "f32", "--cache-batch", "4", "--resume-dir", "r",
     "--immediate-save-dir", "i", "--shard-size-gb", "2",
     "--not-use-best-mse"],
    ["--model", "m", "--quant-lm-head", "--ignore-layers", "a", "b",
     "--fp-layers", "down_proj", "--to-quant-block-names", "0-1",
     "--layer-config", "{}", "--options", "W4A16", "W8A16", "--nblocks",
     "2", "--gradient-accumulate-steps", "2", "--optimizer", "adam",
     "--dynamic-max-gap", "5", "--disable-quanted-input",
     "--disable-minmax-tuning", "--enable-alg-ext", "--enable-awq",
     "--enable-norm-bias-tuning", "--enable-lfq", "--quant-attention",
     "--enable-rotation", "r1", "--model-free"],
    ["--model", "m", "--mllm", "--template", "llava",
     "--quant-nontext-module", "--extra-data-dir", "d", "--eval-ppl",
     "--eval-greedy-acc", "--iter", "3", "--bs", "4", "--dtype", "mx_fp",
     "--act-dtype", "mx_fp", "--super-bits", "6", "--super-group-size",
     "16", "--act-group-size", "32"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parser_equals_jax(argv):
    assert vars(tcli.build_parser().parse_args(argv)) == \
        vars(jcli.build_parser().parse_args(argv))
    assert tcli.RECIPES == jcli.RECIPES


def test_parser_device_choices(capsys):
    """The one flag whose choices differ: the JAX parser takes tpu / cpu,
    the port's cuda / cpu (default None: the card), so ``--device tpu``
    is left out of the parity argvs above."""
    p = tcli.build_parser()
    assert p.parse_args(["--model", "m"]).device is None
    assert p.parse_args(["--model", "m", "--device", "cuda"]).device == "cuda"
    with pytest.raises(SystemExit):
        p.parse_args(["--model", "m", "--device", "tpu"])
    capsys.readouterr()


@pytest.mark.parametrize("extra,label", [
    (["--mllm"], "A14"), (["--eval-ppl"], "A14"), (["--eval-greedy-acc"],
                                                   "A14"),
    (["--model-free"], "A12"), (["--avg-bits", "3"], "A12"),
    (["--enable-awq"], "A12"), (["--enable-rotation", "r1"], "A12"),
    (["--resume-dir", "r"], "A12"), (["--nblocks", "2"], "A5"),
    (["--enable-lfq"], "A5"), (["--immediate-save-dir", "i"], "A5"),
    (["--device-map", "offload"], "A5"), (["--enable-alg-ext"], "A3"),
    (["--optimizer", "adam"], "A3"), (["--enable-norm-bias-tuning"], "A3"),
    (["--format", "gptq"], "A13"), (["--format", "fake,gguf:q4_k_m"],
                                    "A13"),
])
def test_unported_flags_raise_before_work(extra, label):
    # "/nonexistent" would fail to load: the raise comes first
    with pytest.raises(NotImplementedError, match=label):
        tcli.main(["--model", "/nonexistent", "--device", "cpu"] + extra)


@pytest.mark.parametrize("sub", ["eval", "mllm"])
def test_unported_subcommands_raise(sub):
    with pytest.raises(NotImplementedError, match="A14"):
        tcli.main([sub, "--model", "tiny"])


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    cfg = jl.LlamaConfig(vocab_size=128, hidden_size=256,
                         intermediate_size=512, num_layers=2, num_heads=4,
                         num_kv_heads=2, rope_theta=5e5, dtype=jnp.bfloat16)
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                     jl.init_params(cfg, jax.random.PRNGKey(3)))
    j_save_hf(p, cfg, str(d / "m"), hf_extra={
        "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                         "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 16}})
    ids = np.random.default_rng(1).integers(0, 128, (4, 32))
    np.save(d / "ids.npy", ids)
    return d


@pytest.mark.parametrize("extra", [
    ["--quant-lm-head"],
    ["--bits", "8", "--group-size", "64", "--fp-layers", "down_proj",
     "--to-quant-block-names", "1"],
], ids=["w4-head", "w8-selected"])
def test_main_export_equals_jax_cli(hf_dir, tmp_path, capsys, monkeypatch,
                                    extra):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    argv = ["--model", str(hf_dir / "m"), "--recipe", "rtn", "--iters", "0",
            "--dataset", str(hf_dir / "ids.npy"), "--nsamples", "4",
            "--seqlen", "32", "--format", "autoround", "--device", "cpu"]
    assert jcli.main(argv + ["--output", str(tmp_path / "j")] + extra) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv + ["--output", str(tmp_path / "t")] + extra) == 0
    trep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trep["layers"] == jrep["layers"] > 0
    for f in ("model.safetensors", "quantization_config.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f


def test_envs_accessors(monkeypatch):
    from autoround_tpu import envs as jenvs
    assert set(dir(envs)) == set(jenvs.environment_variables)
    for k, v in (("AR_LOG_LEVEL", "DEBUG"), ("AR_MOE_CAPACITY_FACTOR", "2.5"),
                 ("AR_ENABLE_ACT_MINMAX_TUNING", "1"),
                 ("AR_MODEL_FREE_SHARD_PARALLELISM", "3"),
                 ("AR_CALIB_SUBPROCESS_TIMEOUT", "7")):
        monkeypatch.setenv(k, v)
    for name in jenvs.environment_variables:
        assert getattr(envs, name) == getattr(jenvs, name), name
    monkeypatch.delenv("AR_MOE_CAPACITY_FACTOR")
    assert envs.AR_MOE_CAPACITY_FACTOR == 0.0
    with pytest.raises(AttributeError):
        envs.AR_NOT_A_FLAG


def test_cli_maps_the_environment(monkeypatch, tmp_path, capsys):
    """AR_LOG_LEVEL sets the logger, AR_ENABLE_ACT_MINMAX_TUNING the
    quantizer's switch (seen in the config the CLI hands AutoRound)."""
    import logging

    from autoround_tpu_torch import api
    from autoround_tpu_torch.utils.logger import TRACE, logger
    seen = {}
    real = api.AutoRound.quantize

    def spy(self, *a, **k):
        seen["act"] = self.cfg.enable_act_minmax_tuning
        return real(self, *a, **k)
    monkeypatch.setattr(api.AutoRound, "quantize", spy)
    monkeypatch.setenv("AR_LOG_LEVEL", "TRACE")
    monkeypatch.setenv("AR_ENABLE_ACT_MINMAX_TUNING", "1")
    level = logger.level
    try:
        assert tcli.main(["--model", "tiny", "--recipe", "rtn", "--nsamples",
                          "2", "--seqlen", "16", "--device", "cpu",
                          "--output", str(tmp_path / "q")]) == 0
        assert logger.level == TRACE and seen["act"] is True
    finally:
        logger.setLevel(level or logging.NOTSET)
    capsys.readouterr()


def test_new_modules_import_no_jax():
    """The loading and entry modules import neither JAX nor the JAX
    package (``python -m autoround_tpu_torch`` included)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "import autoround_tpu_torch.cli, autoround_tpu_torch.__main__, "
            "autoround_tpu_torch.envs, autoround_tpu_torch.utils.hf_loader, "
            "autoround_tpu_torch.utils.safetensors_io, "
            "autoround_tpu_torch.serve.gptq_loader, "
            "autoround_tpu_torch.export.formats, "
            "autoround_tpu_torch.quantize.calib_data\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'autoround_tpu', 'safetensors')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       env=dict(os.environ, PYTHONPATH=str(repo)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
