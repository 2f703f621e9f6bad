"""Calibration data (counterpart of ``autoround_tpu/quantize/calib_data.py``):
resolve a dataset spec into a fixed ``(nsamples, seqlen)`` int32 token
batch and a float32 validity mask (numpy), equal to the JAX package's for
the same spec, tokenizer and seed (the same numpy generator draws).

Specs: a registered name (``synthetic``), ``local:<path>`` (a text file,
one sample a line, or a ``.json`` list / ``.jsonl`` lines of strings,
``{"text": ...}`` or ``{"messages": [...]}`` records), a raw token array,
a list of token lists, or a mix ``"a:0.3,b"``.  ``apply_chat_template``
renders text samples through the tokenizer's chat template first.

The port reads local files only: the hub names of the JAX registry stay
registered and raise ``NotImplementedError`` naming ROADMAP A8 with what
to do instead (the port needs no network and no ``datasets`` package).
The JAX package's subprocess isolation of hub loading is not ported with
them.  Multimodal and diffusion calibration batches wait for their models
(A14).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..utils.logger import warning_once

__all__ = ["CALIB_DATASETS", "register_dataset", "get_calib_batch",
           "apply_chat_template_to_samples", "get_mllm_calib_batch",
           "get_diffusion_calib_batch"]

CALIB_DATASETS: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        CALIB_DATASETS[name] = fn
        return fn
    return deco


def apply_chat_template_to_samples(samples, tokenizer,
                                   system_prompt: Optional[str] = None
                                   ) -> List[str]:
    """Render raw calibration texts through the tokenizer's chat template:
    each sample becomes a user turn (after an optional system turn) with
    the generation prompt appended; a sample that is already a message
    list is the conversation.  A template that rejects the system role is
    retried without it."""
    rendered = []
    for text in samples:
        msgs = []
        if system_prompt:
            msgs.append({"role": "system", "content": system_prompt})
        if isinstance(text, list) and text and isinstance(text[0], dict):
            msgs += text
        else:
            msgs.append({"role": "user", "content": text})
        try:
            rendered.append(tokenizer.apply_chat_template(
                msgs, tokenize=False, add_generation_prompt=True))
        except Exception:
            warning_once(
                "chat template rejected the system role; retrying without")
            msgs = [m for m in msgs if m["role"] != "system"]
            rendered.append(tokenizer.apply_chat_template(
                msgs, tokenize=False, add_generation_prompt=True))
    return rendered


def _pack_texts(texts: List[str], tokenizer, nsamples: int, seqlen: int,
                seed: int, apply_chat_template: bool = False,
                system_prompt: Optional[str] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize, keep samples of at least seqlen / 2 tokens (4 when chat
    rendered), truncate to seqlen, pick nsamples in a seeded order and pad;
    pad positions are masked 0."""
    rng = np.random.default_rng(seed)
    if apply_chat_template:
        if getattr(tokenizer, "chat_template", None) is None:
            warning_once("apply_chat_template requested but the tokenizer "
                         "has no chat template; using raw text")
        else:
            texts = apply_chat_template_to_samples(texts, tokenizer,
                                                   system_prompt)
    min_len = 4 if apply_chat_template else seqlen // 2
    ids_list = []
    for t in texts:
        toks = tokenizer(t)
        toks = toks["input_ids"] if isinstance(toks, dict) else toks
        if len(toks) >= min_len:
            ids_list.append(np.asarray(toks[: seqlen], np.int32))
        if len(ids_list) >= nsamples * 4:
            break
    if not ids_list:
        raise ValueError("no calibration sample reached seqlen/2 tokens")
    order = rng.permutation(len(ids_list))[:nsamples]
    batch = np.zeros((len(order), seqlen), np.int32)
    mask = np.zeros((len(order), seqlen), np.float32)
    for i, j in enumerate(order):
        t = ids_list[j]
        batch[i, : len(t)] = t
        mask[i, : len(t)] = 1.0
    return batch, mask


@register_dataset("synthetic")
def _synthetic(nsamples, seqlen, tokenizer=None, vocab_size=32000, seed=42,
               **_):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, (nsamples, seqlen), dtype=np.int64)
    return ids.astype(np.int32), np.ones((nsamples, seqlen), np.float32)


@register_dataset("local")
def _local(nsamples, seqlen, tokenizer=None, path=None, seed=42,
           apply_chat_template=False, system_prompt=None, **_):
    """A local text / json / jsonl file: one sample a line, or a json list
    of strings / {"text": ...} / {"messages": [...]} records."""
    if tokenizer is None:
        raise ValueError("the local dataset needs a tokenizer")
    texts = []

    def add(item):
        if isinstance(item, dict):
            texts.append(item.get("text") or item.get("messages"))
        else:
            texts.append(item)

    with open(path) as f:
        if path.endswith(".json"):
            for item in json.load(f):
                add(item)
        else:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                add(json.loads(line) if path.endswith(".jsonl") else line)
    return _pack_texts(texts, tokenizer, nsamples, seqlen, seed,
                       apply_chat_template, system_prompt)


def _hub_dataset(hub_name: str):
    def load(*_, **__):
        raise NotImplementedError(
            f"dataset {hub_name!r} is on the Hugging Face hub, which the "
            f"port does not read (ROADMAP A8: hub datasets left out; no "
            f"network): save its texts to a local .txt / .json / .jsonl "
            f"file and pass dataset='local:<path>'")
    return load


# the JAX registry's hub names (and their hub ids)
for _names, _hub in [
    (("pile-10k", "NeelNanda/pile-10k"), "NeelNanda/pile-10k"),
    (("pile-val-backup", "swift/pile-val-backup"),
     "mit-han-lab/pile-val-backup"),
    (("ultrachat_200k", "HuggingFaceH4/ultrachat_200k"),
     "HuggingFaceH4/ultrachat_200k"),
    (("mbpp", "google-research-datasets/mbpp"), "mbpp"),
    (("github-code-clean", "codeparrot/github-code-clean"),
     "codeparrot/github-code-clean"),
    (("CCI3-HQ", "BAAI/CCI3-HQ"), "BAAI/CCI3-HQ"),
    (("opencode-instruct", "nvidia/OpenCodeInstruct"),
     "nvidia/OpenCodeInstruct"),
    (("openbmb/Ultra-FineWeb",), "openbmb/Ultra-FineWeb"),
    (("new-title-chinese", "madao33/new-title-chinese"),
     "madao33/new-title-chinese"),
]:
    for _name in _names:
        CALIB_DATASETS[_name] = _hub_dataset(_hub)


def get_calib_batch(
    dataset: Union[str, np.ndarray, List[List[int]]],
    nsamples: int = 128,
    seqlen: int = 2048,
    tokenizer=None,
    vocab_size: int = 32000,
    seed: int = 42,
    apply_chat_template: bool = False,
    system_prompt: Optional[str] = None,
    **kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve a dataset spec into (input_ids int32, mask float32)."""
    kw.update(apply_chat_template=apply_chat_template,
              system_prompt=system_prompt)
    if isinstance(dataset, np.ndarray):
        ids = dataset.astype(np.int32)
        return ids, np.ones(ids.shape, np.float32)
    if isinstance(dataset, (list, tuple)):
        batch = np.zeros((min(len(dataset), nsamples), seqlen), np.int32)
        mask = np.zeros_like(batch, dtype=np.float32)
        for i, toks in enumerate(dataset[:nsamples]):
            t = np.asarray(toks[:seqlen], np.int32)
            batch[i, : len(t)] = t
            mask[i, : len(t)] = 1.0
        return batch, mask
    if isinstance(dataset, str):
        if "," in dataset:
            # mixing syntax "name1:frac,name2"
            parts = []
            for spec in dataset.split(","):
                if ":" in spec and not spec.startswith("local:"):
                    name, frac = spec.rsplit(":", 1)
                    parts.append((name.strip(), float(frac)))
                else:
                    parts.append((spec.strip(), None))
            n_unspec = sum(1 for _, f in parts if f is None)
            rem = 1.0 - sum(f for _, f in parts if f is not None)
            counts = []
            for name, f in parts:
                share = f if f is not None else rem / max(n_unspec, 1)
                counts.append((name, max(1, int(round(nsamples * share)))))
            ids_list, mask_list = [], []
            for i, (name, n) in enumerate(counts):
                a, m = get_calib_batch(name, nsamples=n, seqlen=seqlen,
                                       tokenizer=tokenizer,
                                       vocab_size=vocab_size,
                                       seed=seed + i, **kw)
                ids_list.append(a)
                mask_list.append(m)
            ids = np.concatenate(ids_list)[:nsamples]
            mask = np.concatenate(mask_list)[:nsamples]
            order = np.random.default_rng(seed).permutation(len(ids))
            return ids[order], mask[order]
        if dataset.startswith("local:"):
            return CALIB_DATASETS["local"](
                nsamples, seqlen, tokenizer=tokenizer,
                path=dataset.split(":", 1)[1], seed=seed, **kw)
        if dataset in CALIB_DATASETS:
            return CALIB_DATASETS[dataset](
                nsamples, seqlen, tokenizer=tokenizer,
                vocab_size=vocab_size, seed=seed, **kw)
        raise ValueError(
            f"unknown dataset {dataset!r}; known: {sorted(CALIB_DATASETS)}")
    raise TypeError(f"cannot build calib batch from {type(dataset)}")


def get_mllm_calib_batch(*_, **__):
    raise NotImplementedError(
        "multimodal calibration batches are not ported yet (ROADMAP A14: "
        "the VLM and omni models)")


def get_diffusion_calib_batch(*_, **__):
    raise NotImplementedError(
        "diffusion calibration batches are not ported yet (ROADMAP A14: "
        "dit / mmdit)")
