"""Command line (counterpart of ``autoround_tpu/cli.py``): quantize a model
and export it.

    python -m autoround_tpu_torch --model <hf_ckpt_dir | preset> \\
        --scheme W4A16 --recipe default --dataset <spec | ids.npy> \\
        --output out/ --format autoround

The parser takes every flag of the JAX package's with the same names,
defaults and choices, ``RECIPES`` included; only ``--device`` differs: its
choices are ``cuda`` and ``cpu``, and its default (None) means the CUDA
card, which the run needs unless ``--device cpu`` is given.  ``main``
runs the LLM path: a preset (random weights from ``--seed``) or a local
HF directory, a tokenizer if ``transformers`` loads one, a ``.npy`` /
``synthetic`` / ``local:`` dataset, the scheme overrides, the layer
selection, the ported quantizer options, ``save_quantized`` and one JSON
report line.  Options whose feature is not ported raise
``NotImplementedError`` naming their ROADMAP item before any work.
``AR_LOG_LEVEL`` sets the logger's level and
``AR_ENABLE_ACT_MINMAX_TUNING`` the quantizer's
``enable_act_minmax_tuning`` (``envs.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

RECIPES = {
    "default": dict(iters=200, nsamples=128, seqlen=2048, batch_size=8),
    "best": dict(iters=1000, nsamples=512, seqlen=2048, batch_size=8),
    "light": dict(iters=50, nsamples=128, seqlen=2048, batch_size=8, lr=5e-3),
    "rtn": dict(iters=0, nsamples=1, seqlen=32, batch_size=1),
    "opt-rtn": dict(iters=0, nsamples=64, seqlen=2048, batch_size=8,
                    imatrix=True),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="autoround_tpu_torch",
        description="AutoRound post-training quantization in PyTorch / CUDA")
    p.add_argument("--model", "--model-name-or-path", dest="model",
                   required=True,
                   help="HF checkpoint dir or a model-zoo preset name")
    p.add_argument("--recipe", default="default", choices=sorted(RECIPES))
    p.add_argument("--iters", "--iter", dest="iters", type=int, default=None)
    p.add_argument("--nsamples", "--nsample", dest="nsamples", type=int,
                   default=None)
    p.add_argument("--seqlen", "--seq-len", dest="seqlen", type=int,
                   default=None)
    p.add_argument("--batch-size", "--train-bs", "--bs", dest="batch_size",
                   type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--minmax-lr", type=float, default=None)
    p.add_argument("--dataset", default="synthetic",
                   help="dataset name, local:<path>, or .npy token file")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer dir (defaults to --model)")
    p.add_argument("--apply-chat-template", action="store_true",
                   help="render calib text through the tokenizer's chat "
                        "template (instruct models)")
    p.add_argument("--system-prompt", default=None,
                   help="optional system turn for --apply-chat-template")
    p.add_argument("--output", "--output-dir", dest="output",
                   default="quantized/")
    p.add_argument("--format", "--formats", dest="format", default="fake",
                   help="fake | autoround (gptq, awq, llm_compressor, gguf "
                        "are not ported yet); comma-separated for several")
    p.add_argument("--seed", type=int, default=42)

    sch = p.add_argument_group(
        "scheme overrides (win over --scheme preset fields)")
    sch.add_argument("--scheme", default="W4A16")
    sch.add_argument("--bits", type=int, default=None,
                     help="weight bit width")
    sch.add_argument("--group-size", type=int, default=None)
    sch.add_argument("--asym", action="store_true", default=None,
                     help="asymmetric weight quantization")
    sch.add_argument("--data-type", "--dtype", dest="data_type",
                     default=None, help="weight dtype: int | mx_fp | nv_fp "
                                        "| fp8 ...")
    sch.add_argument("--act-bits", type=int, default=None)
    sch.add_argument("--act-group-size", type=int, default=None)
    sch.add_argument("--act-data-type", "--act-dtype", dest="act_data_type",
                     default=None)
    sch.add_argument("--act-asym", action="store_true", default=None)
    sch.add_argument("--disable-act-dynamic", action="store_true",
                     help="static (calibrated) activation scales instead "
                          "of dynamic per-token")
    sch.add_argument("--super-bits", type=int, default=None,
                     help="GGUF double-quant metadata bits")
    sch.add_argument("--super-group-size", type=int, default=None)
    sch.add_argument("--scale-dtype", default=None,
                     help="storage dtype for scales (fp16/bf16/fp32)")

    rt = p.add_argument_group("runtime")
    rt.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the run computes (default: the CUDA card; "
                         "cpu runs the plain PyTorch versions)")
    rt.add_argument("--device-map", default=None,
                    help="'offload' keeps FP weights in host RAM (not "
                         "ported yet); 'none' keeps all on the device")
    rt.add_argument("--low-gpu-mem-usage", "--remat", dest="remat",
                    action="store_true",
                    help="recompute the tuning forward in the backward pass")
    rt.add_argument("--model-dtype", default=None,
                    choices=("bf16", "bfloat16", "f32", "float32"),
                    help="cast loaded FP params before quantization")
    rt.add_argument("--cache-batch", type=int, default=None,
                    help="batch size for the cache-advance forwards")
    rt.add_argument("--resume-dir", default=None,
                    help="crash-resume directory (not ported yet)")
    rt.add_argument("--immediate-save-dir", default=None,
                    help="stream packed blocks to sharded safetensors as "
                         "they finish (not ported yet)")
    rt.add_argument("--shard-size-gb", type=float, default=4.0)
    rt.add_argument("--not-use-best-mse", action="store_true",
                    help="keep the LAST iterate instead of the best-loss "
                         "snapshot")

    tune = p.add_argument_group("tuning")
    tune.add_argument("--quant-lm-head", action="store_true")
    tune.add_argument("--ignore-layers", nargs="*", default=None)
    tune.add_argument("--fp-layers", default=None,
                      help="comma-separated layer name fragments kept in "
                           "full precision")
    tune.add_argument("--to-quant-block-names", default=None,
                      help="comma-separated block indices (or ranges a-b) "
                           "to quantize; all other blocks stay FP")
    tune.add_argument("--layer-config", default=None,
                      help="JSON file or inline JSON: per-layer-pattern "
                           "scheme overrides")
    tune.add_argument("--avg-bits", "--target-bits", dest="avg_bits",
                      type=float, default=None,
                      help="AutoScheme mixed-precision search (not ported "
                           "yet)")
    tune.add_argument("--scheme-options", "--options", dest="scheme_options",
                      nargs="*", default=None,
                      help="candidate schemes for AutoScheme")
    tune.add_argument("--nblocks", type=int, default=1,
                      help="tune N consecutive blocks jointly")
    tune.add_argument("--gradient-accumulate-steps", type=int, default=None)
    tune.add_argument("--optimizer", default=None,
                      choices=("signsgd", "adam"))
    tune.add_argument("--dynamic-max-gap", type=int, default=None,
                      help="early-stop tuning when best loss stalls this "
                           "many iters (-1 = off)")
    tune.add_argument("--disable-quanted-input", action="store_true",
                      help="tune against FP block inputs instead of the "
                           "quantized chain")
    tune.add_argument("--disable-minmax-tuning", action="store_true")
    tune.add_argument("--enable-alg-ext", action="store_true",
                      help="sign_roundv2 extensions (not ported yet)")
    tune.add_argument("--enable-awq", action="store_true",
                      help="AWQ smoothing + clip search before tuning (not "
                           "ported yet)")
    tune.add_argument("--enable-norm-bias-tuning", action="store_true")
    tune.add_argument("--enable-lfq", action="store_true",
                      help="last-block LM cross-entropy loss")
    tune.add_argument("--quant-attention", action="store_true",
                      help="collect static q/k/v FP8 attention scales")
    tune.add_argument("--enable-rotation", default=None,
                      help="pre-quantization rotations (not ported yet)")
    tune.add_argument("--model-free", action="store_true",
                      help="streaming shard RTN without model "
                           "instantiation (not ported yet)")

    mllm = p.add_argument_group("multimodal (not ported yet)")
    mllm.add_argument("--mllm", action="store_true")
    mllm.add_argument("--template", default=None)
    mllm.add_argument("--quant-nontext-module", action="store_true")
    mllm.add_argument("--extra-data-dir", default=None)

    ev = p.add_argument_group("evaluation (not ported yet)")
    ev.add_argument("--eval-ppl", action="store_true")
    ev.add_argument("--eval-greedy-acc", action="store_true")
    return p


def _parse_block_names(spec: str, num_layers: int):
    """'0,2,5-8' → set of block indices to QUANTIZE."""
    keep = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-", 1)
            keep.update(range(int(a), int(b) + 1))
        else:
            keep.add(int(part))
    return keep


def _scheme_overrides(args) -> dict:
    ov = {}
    for flag in ("bits", "group_size", "data_type", "act_bits",
                 "act_group_size", "act_data_type", "super_bits",
                 "super_group_size", "scale_dtype"):
        v = getattr(args, flag)
        if v is not None:
            ov[flag] = v
    if args.asym:
        ov["sym"] = False
    if args.act_asym:
        ov["act_sym"] = False
    if args.disable_act_dynamic:
        ov["act_dynamic"] = False
    return ov


# flags whose feature is not ported: (flag, is it set, ROADMAP item)
def _unported_flags(args):
    return (
        ("--mllm / --template / --quant-nontext-module / --extra-data-dir",
         args.mllm or args.template is not None or args.quant_nontext_module
         or args.extra_data_dir is not None, "A14"),
        ("--eval-ppl / --eval-greedy-acc",
         args.eval_ppl or args.eval_greedy_acc, "A14"),
        ("--model-free", args.model_free, "A12"),
        ("--avg-bits (AutoScheme)", args.avg_bits is not None, "A12"),
        ("--enable-awq", args.enable_awq, "A12"),
        ("--enable-rotation", bool(args.enable_rotation), "A12"),
        ("--resume-dir", args.resume_dir is not None, "A12"),
        ("--enable-alg-ext", args.enable_alg_ext, "A3"),
        ("--optimizer adam", args.optimizer == "adam", "A3"),
        ("--enable-norm-bias-tuning", args.enable_norm_bias_tuning, "A3"),
    )


def _quantize_kwargs(args) -> dict:
    """The recipe and the quantizer flags as ``AutoRound`` keywords
    (nsamples and seqlen included)."""
    recipe = dict(RECIPES[args.recipe])
    if recipe.pop("imatrix", False):
        recipe["use_imatrix"] = True
    for k in ("iters", "nsamples", "seqlen", "batch_size", "lr"):
        v = getattr(args, k)
        if v is not None:
            recipe[k] = v
    kw = dict(recipe)
    if args.device_map is not None:
        kw["offload_params"] = args.device_map.lower() in (
            "offload", "cpu", "auto")
    if args.remat:
        kw["use_remat"] = True
    for flag in ("cache_batch", "immediate_save_dir",
                 "gradient_accumulate_steps", "optimizer",
                 "dynamic_max_gap"):
        v = getattr(args, flag)
        if v is not None:
            kw[flag] = v
    if args.not_use_best_mse:
        kw["use_best_params"] = False
    if args.nblocks != 1:
        kw["nblocks"] = args.nblocks
    for flag in ("enable_lfq", "quant_attention"):
        if getattr(args, flag):
            kw[flag] = True
    if args.disable_quanted_input:
        kw["enable_quanted_input"] = False
    if args.disable_minmax_tuning:
        kw["enable_minmax_tuning"] = False
    return kw


def _check_ported(args, kw) -> None:
    """Raise for every option this port leaves out, before any work."""
    from .export import _UNPORTED_FORMATS
    from .quantize.orchestrator import _UNPORTED

    for flag, on, item in _unported_flags(args):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")
    for name, off, what, item in _UNPORTED:
        if kw.get(name, off) != off:
            raise NotImplementedError(
                f"{name}={kw[name]!r} ({what}) is not ported yet "
                f"(ROADMAP {item})")
    for fmt in (f.strip() for f in args.format.split(",")):
        if fmt in _UNPORTED_FORMATS or fmt.startswith("gguf"):
            raise NotImplementedError(
                f"export format {fmt!r} is not ported yet (ROADMAP A13)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("eval", "mllm"):
        raise NotImplementedError(
            f"the {argv[0]!r} subcommand is not ported yet (ROADMAP A14)")
    args = build_parser().parse_args(argv)
    kw = _quantize_kwargs(args)
    _check_ported(args, kw)

    import numpy as np
    import torch

    from . import envs
    from ._device import resolve_device
    from .api import AutoRound
    from .models.registry import ALL_PRESETS, get_model_fns
    from .quantize.calib_data import get_calib_batch
    from .utils.logger import setup

    setup(envs.AR_LOG_LEVEL)
    device = resolve_device(args.device)
    nsamples = kw.pop("nsamples")
    seqlen = kw.pop("seqlen")
    if envs.AR_ENABLE_ACT_MINMAX_TUNING:
        kw["enable_act_minmax_tuning"] = True

    tokenizer = None
    if args.model in ALL_PRESETS:
        cfg = ALL_PRESETS[args.model]
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = get_model_fns(cfg).init_params(cfg, gen, device)
    else:
        from .utils.hf_loader import load_hf_checkpoint
        params, cfg = load_hf_checkpoint(args.model, device=device)
        tok_path = args.tokenizer or args.model
        try:
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(tok_path)
        except Exception:
            print(f"warning: no tokenizer at {tok_path}; "
                  "text datasets unavailable", file=sys.stderr)

    if args.model_dtype is not None:
        import dataclasses

        from .utils.pytree import tree_map
        tgt = (torch.bfloat16 if args.model_dtype in ("bf16", "bfloat16")
               else torch.float32)
        params = tree_map(lambda t: t.to(tgt) if t.is_floating_point()
                          else t, params)
        cfg = dataclasses.replace(cfg, dtype=tgt)

    if args.dataset.endswith(".npy"):
        ids = np.load(args.dataset)[:nsamples, :seqlen]
        mask = np.ones(ids.shape, np.float32)
    else:
        ids, mask = get_calib_batch(
            args.dataset, nsamples=nsamples, seqlen=seqlen,
            tokenizer=tokenizer, vocab_size=cfg.vocab_size, seed=args.seed,
            apply_chat_template=args.apply_chat_template,
            system_prompt=args.system_prompt)

    scheme = args.scheme
    overrides = _scheme_overrides(args)
    if overrides:
        from .schemes import parse_scheme
        scheme = parse_scheme(args.scheme, **overrides)

    ignore = list(args.ignore_layers or [])
    if args.fp_layers:
        ignore += [f.strip() for f in args.fp_layers.split(",") if f.strip()]
    if args.to_quant_block_names:
        keep = _parse_block_names(args.to_quant_block_names, cfg.num_layers)
        ignore += [rf"blocks\.{i}\..*" for i in range(cfg.num_layers)
                   if i not in keep]
    layer_config = None
    if args.layer_config:
        if os.path.exists(args.layer_config):
            with open(args.layer_config) as f:
                layer_config = json.load(f)
        else:
            layer_config = json.loads(args.layer_config)

    ar = AutoRound((params, cfg), scheme=scheme, tokenizer=tokenizer,
                   minmax_lr=args.minmax_lr,
                   quant_lm_head=args.quant_lm_head,
                   ignore_layers=ignore or None, layer_config=layer_config,
                   seed=args.seed, device=device, **kw)
    del params
    result = ar.quantize(ids, mask=mask)
    out = ar.save_quantized(args.output, format=args.format)
    print(json.dumps({"output": out, "layers": len(result.layers)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
