"""Hadamard rotations (counterpart of ``autoround_tpu/transforms/
hadamard.py``): QuaRot's R1 on the residual stream and its online R4 on
the down_proj input.

R1 first folds the RMSNorm gains into the linears that read the normed
stream (a rotation commutes only with a unit-gain RMSNorm), then

    embed       E  -> E H          (x' = H^T x for every residual tensor)
    read-side   W  -> W H          (q/k/v/gate/up, lm_head)
    write-side  W  -> H^T W        (o_proj, down_proj)

with H a scaled Sylvester Hadamard (H H^T = I), block-diagonal in
power-of-two blocks for other sizes, optionally times a ±1 diagonal drawn
from ``np.random.default_rng(seed)`` as the JAX package draws it, so the
two packages' matrices are equal.  The products run in fp32.  The
transforms read Llama-shaped blocks; another family raises
``NotImplementedError`` naming it (where the JAX package stops with a
``KeyError``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.llama import LlamaConfig, hadamard_block
from ..utils.logger import logger

__all__ = ["hadamard_matrix", "fuse_rms_gains", "apply_r1_rotation",
           "apply_r4_rotation"]

_READ = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_WRITE = ("o_proj", "down_proj")
_NORMS = ("input_layernorm", "post_attention_layernorm")


def _sylvester(k: int) -> np.ndarray:
    h = np.array([[1.0]])
    for _ in range(k):
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_matrix(n: int, seed: Optional[int] = None) -> np.ndarray:
    """Orthonormal (scaled) Hadamard-like matrix of size n (float64 numpy):
    Sylvester for a power of two, else a block diagonal of the largest
    power-of-two blocks; optionally times a random ±1 diagonal."""
    blocks = []
    rem = n
    while rem > 0:
        k = rem.bit_length() - 1
        size = 1 << k
        blocks.append(_sylvester(k) / np.sqrt(size))
        rem -= size
    if len(blocks) == 1:
        h = blocks[0]
    else:
        h = np.zeros((n, n))
        off = 0
        for b in blocks:
            s = b.shape[0]
            h[off:off + s, off:off + s] = b
            off += s
    if seed is not None:
        rng = np.random.default_rng(seed)
        d = rng.choice([-1.0, 1.0], size=n)
        h = h * d[None, :]
    return h


def check_llama_blocks(params: Dict[str, Any], cfg, need) -> None:
    """Raise ``NotImplementedError`` naming the family when a block lacks
    a leaf the rotation reads (a MoE or MLA block)."""
    for bi, block in enumerate(params["blocks"]):
        missing = [n for n in need if n not in block]
        if missing:
            raise NotImplementedError(
                f"rotations read Llama-shaped blocks; {type(cfg).__name__} "
                f"block {bi} has no {missing} (the JAX transforms stop with "
                f"a KeyError there)")


def fuse_rms_gains(params: Dict[str, Any], cfg: LlamaConfig
                   ) -> Dict[str, Any]:
    """Fold the RMSNorm gains into the linears that read them; the norms
    become 1 (input_layernorm → q/k/v; post_attention_layernorm →
    gate/up; the final norm → lm_head, kept with tied embeddings)."""
    check_llama_blocks(params, cfg, _READ + _NORMS)
    out = dict(params)
    new_blocks = []
    for block in params["blocks"]:
        b = dict(block)
        g1 = b["input_layernorm"].float()
        for n in ("q_proj", "k_proj", "v_proj"):
            b[n] = (b[n].float() * g1[None, :]).to(b[n].dtype)
        b["input_layernorm"] = torch.ones_like(b["input_layernorm"])
        g2 = b["post_attention_layernorm"].float()
        for n in ("gate_proj", "up_proj"):
            b[n] = (b[n].float() * g2[None, :]).to(b[n].dtype)
        b["post_attention_layernorm"] = torch.ones_like(
            b["post_attention_layernorm"])
        new_blocks.append(b)
    out["blocks"] = new_blocks
    if out.get("lm_head") is not None:
        gf = out["norm"].float()
        out["lm_head"] = (out["lm_head"].float() * gf[None, :]).to(
            out["lm_head"].dtype)
        out["norm"] = torch.ones_like(out["norm"])
    else:
        # the tied embedding is also the input side: keep the final norm
        logger.warning("tied embeddings: final norm gain left in place")
    return out


def rotate_residual(p: Dict[str, Any], R: torch.Tensor) -> Dict[str, Any]:
    """Apply an orthogonal residual rotation ``R`` (fp32) to gain-fused
    params: the embedding and the read-side weights ``W R``, the
    write-side ``R^T W``."""
    def on(w):
        return R.to(w.device)

    def rot_read(w):
        return (w.float() @ on(w)).to(w.dtype)

    def rot_write(w):
        return (on(w).t() @ w.float()).to(w.dtype)

    p = dict(p)
    p["embed_tokens"] = rot_read(p["embed_tokens"])
    if p.get("lm_head") is not None:
        p["lm_head"] = rot_read(p["lm_head"])
    new_blocks = []
    for block in p["blocks"]:
        b = dict(block)
        for n in _READ:
            b[n] = rot_read(b[n])
        for n in _WRITE:
            b[n] = rot_write(b[n])
        new_blocks.append(b)
    p["blocks"] = new_blocks
    return p


def apply_r1_rotation(params: Dict[str, Any], cfg: LlamaConfig,
                      seed: Optional[int] = None) -> Dict[str, Any]:
    """The residual-stream rotation: new params whose model outputs are
    unchanged up to rounding (an orthogonal reparameterization)."""
    check_llama_blocks(params, cfg, _READ + _WRITE + _NORMS)
    p = fuse_rms_gains(params, cfg)
    H = torch.tensor(hadamard_matrix(cfg.hidden_size, seed),
                     dtype=torch.float32)
    p = rotate_residual(p, H)
    logger.info("applied R1 Hadamard rotation (hidden=%d, seed=%s)",
                cfg.hidden_size, seed)
    return p


def apply_r4_rotation(params: Dict[str, Any], cfg: LlamaConfig,
                      block: int = 128) -> Tuple[Dict[str, Any], Any]:
    """QuaRot's online R4: down_proj's input side rotated in blocks of
    ``block`` (W' = W H), so the block Hadamard the model applies to its
    input at run time (``cfg.online_r4``) makes it an exact
    reparameterization.  Returns (new params, the config with
    ``online_r4`` / ``r4_block`` set)."""
    check_llama_blocks(params, cfg, ("down_proj",))

    def rot(w):
        O, I = w.shape
        H = hadamard_block(block, w.device, torch.float32)
        w3 = w.float().reshape(O, I // block, block)
        return torch.einsum("oib,bc->oic", w3, H).reshape(O, I).to(w.dtype)

    p = dict(params)
    p["blocks"] = [dict(b, down_proj=rot(b["down_proj"]))
                   for b in params["blocks"]]
    new_cfg = dataclasses.replace(cfg, online_r4=True, r4_block=block)
    logger.info("applied online R4 rotation (block=%d) to %d down_proj",
                block, len(p["blocks"]))
    return p, new_cfg
