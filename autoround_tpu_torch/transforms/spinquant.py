"""SpinQuant-style trained rotations through the Cayley transform
(counterpart of ``autoround_tpu/transforms/spinquant.py``).

R = H · C(A) with H the scaled Hadamard of ``transforms.hadamard`` and
C(A) = (I − A)(I + A)^{-1} the Cayley transform of a skew-symmetric A, so
R is orthogonal at every step; sign-SGD on A (step ``lr``, the best-loss A
kept) learns it.  The R1 objective is the weight-space quantization error
of the rotated read weights, Σ ‖rot(W) − qdq(rot(W))‖² / n, or with
``calib_x`` the block-output MSE of the rotated, RTN'd blocks against the
FP blocks over real block-0 inputs.  R2 rotates each layer's value heads
and the matching o_proj columns by a per-layer (hd, hd) rotation, trained
on the weight-space error of v_proj and o_proj.  The solves are
``torch.linalg.solve`` in fp32; the step loop is a Python loop (the JAX
package scans) that keeps the best loss on the device.  The rotations read
Llama-shaped blocks; another family raises ``NotImplementedError`` naming
it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..dtypes.registry import get_quant_func
from ..models import llama
from ..schemes import QuantizationScheme
from ..utils.logger import logger
from .hadamard import (check_llama_blocks, fuse_rms_gains, hadamard_matrix,
                       rotate_residual)

__all__ = ["SpinQuantConfig", "cayley", "train_r1_rotation",
           "apply_trained_rotation", "train_r2_rotations",
           "apply_trained_r2"]

_READ = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_WRITE = ("o_proj", "down_proj")


@dataclass(frozen=True)
class SpinQuantConfig:
    steps: int = 50
    lr: float = 1e-3
    layers_per_block: tuple = ("q_proj", "k_proj", "v_proj", "gate_proj",
                               "up_proj")
    max_blocks: Optional[int] = None   # the objective's first N blocks


def cayley(A: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric A (…, n, n) → orthogonal (I + A)^{-1} (I − A)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(eye + A, eye - A)


def _skew(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M - M.transpose(-1, -2))


def _sign_sgd(loss_fn, A0: torch.Tensor, sq_cfg: SpinQuantConfig):
    """``steps`` sign-SGD steps on A (``A -= lr * sign(skew(grad))``);
    returns (the A of the least loss, the loss trace)."""
    A = A0.clone()
    best_A = A0.clone()
    best_l = torch.full((), float("inf"), dtype=torch.float32,
                        device=A0.device)
    losses = []
    for _ in range(sq_cfg.steps):
        with torch.enable_grad():
            A.requires_grad_(True)
            loss = loss_fn(A)
            (g,) = torch.autograd.grad(loss, A)
        A = A.detach()
        loss = loss.detach()
        is_best = loss < best_l
        best_A = torch.where(is_best, A, best_A)
        best_l = torch.minimum(best_l, loss)
        A = A - sq_cfg.lr * torch.sign(_skew(g))
        losses.append(loss)
    return best_A, torch.stack(losses).cpu()


def train_r1_rotation(
    params: Dict[str, Any],
    cfg: llama.LlamaConfig,
    scheme: QuantizationScheme,
    sq_cfg: SpinQuantConfig = SpinQuantConfig(),
    imatrix: Optional[Dict[str, torch.Tensor]] = None,
    seed: int = 0,
    calib_x: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Learn the R1 rotation.  Returns R (hidden, hidden) fp32.  Without
    ``calib_x``: the weight-space objective; with it ((B, S, hidden)
    block-0 inputs): the block-output objective, the FP targets computed
    once in the unrotated basis and rotated per step."""
    check_llama_blocks(params, cfg, _READ + _WRITE)
    dev = params["embed_tokens"].device
    H = torch.tensor(hadamard_matrix(cfg.hidden_size, seed),
                     dtype=torch.float32, device=dev)
    qfn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym,
                         mode="rtn")

    def qdq(w):
        return qfn(w, bits=scheme.bits, group_size=scheme.group_size).qdq

    fused = fuse_rms_gains(params, cfg) if calib_x is not None else params
    blocks = fused["blocks"]
    if sq_cfg.max_blocks:
        blocks = blocks[: sq_cfg.max_blocks]

    with torch.no_grad():
        if calib_x is not None:
            cos, sin = llama.rope_tables(cfg, calib_x.shape[1], device=dev)
            blocks = [{k: v.to(dev).float() if isinstance(v, torch.Tensor)
                       else v for k, v in b.items()} for b in blocks]
            x0 = calib_x.to(dev).float()
            fp_outs = []
            xc = x0
            for b in blocks:
                xc = llama.block_fwd(b, xc, cos, sin, cfg)
                fp_outs.append(xc)
        else:
            read_ws = [b[n].to(dev).float() for b in blocks
                       for n in sq_cfg.layers_per_block]

    if calib_x is not None:
        def loss_fn(A):
            R = H @ cayley(_skew(A))
            total = 0.0
            x = x0 @ R
            for b, fp in zip(blocks, fp_outs):
                br = dict(b)
                for n in _READ:
                    br[n] = qdq(b[n] @ R)
                for n in _WRITE:
                    br[n] = qdq(R.t() @ b[n])
                x = llama.block_fwd(br, x, cos, sin, cfg)
                total = total + ((x - fp @ R) ** 2).mean()
            return total * 1000.0
    else:
        def loss_fn(A):
            R = H @ cayley(_skew(A))
            total = 0.0
            for w in read_ws:
                wr = w @ R
                total = total + ((wr - qdq(wr)) ** 2).sum()
            return total / len(read_ws)

    A0 = torch.zeros((cfg.hidden_size, cfg.hidden_size), dtype=torch.float32,
                     device=dev)
    best_A, losses = _sign_sgd(loss_fn, A0, sq_cfg)
    logger.info("SpinQuant R1: loss %.5g -> %.5g over %d steps",
                float(losses[0]), float(losses.min()), sq_cfg.steps)
    with torch.no_grad():
        return H @ cayley(_skew(best_A))


def train_r2_rotations(
    params: Dict[str, Any],
    cfg: llama.LlamaConfig,
    scheme: QuantizationScheme,
    sq_cfg: SpinQuantConfig = SpinQuantConfig(),
    seed: int = 0,
) -> torch.Tensor:
    """Learn the per-layer R2 rotations of the value / output head space
    (an exact reparameterization: the softmax weights are per-head
    scalars).  All layers train jointly as one (L, hd, hd) parameter.
    Returns the R2 stack (L, hd, hd) fp32."""
    check_llama_blocks(params, cfg, ("v_proj", "o_proj"))
    hd = cfg.hd
    L = len(params["blocks"])
    dev = params["embed_tokens"].device
    H2 = torch.tensor(hadamard_matrix(hd, seed), dtype=torch.float32,
                      device=dev)
    qfn = get_quant_func(scheme.data_type, scheme.bits, scheme.sym,
                         mode="rtn")
    with torch.no_grad():
        wv = torch.stack([b["v_proj"].to(dev).float().reshape(
            cfg.num_kv_heads, hd, -1) for b in params["blocks"]])
        wo = torch.stack([b["o_proj"].to(dev).float().reshape(
            -1, cfg.num_heads, hd) for b in params["blocks"]])

    def qdq_err(w2d):
        q = qfn(w2d, bits=scheme.bits, group_size=scheme.group_size).qdq
        return ((w2d - q) ** 2).sum()

    def loss_fn(As):
        Rs = H2 @ cayley(_skew(As))                        # (L, hd, hd)
        wv_r = torch.einsum("lde,lkeH->lkdH", Rs.transpose(1, 2), wv)
        wo_r = torch.einsum("lHne,led->lHnd", wo, Rs)
        total = 0.0
        for li in range(L):
            total = total + qdq_err(wv_r[li].reshape(
                cfg.num_kv_heads * hd, -1))
            total = total + qdq_err(wo_r[li].reshape(wo.shape[1], -1))
        return total / (2 * L)

    A0 = torch.zeros((L, hd, hd), dtype=torch.float32, device=dev)
    best_A, losses = _sign_sgd(loss_fn, A0, sq_cfg)
    logger.info("SpinQuant R2: loss %.5g -> %.5g over %d steps",
                float(losses[0]), float(losses.min()), sq_cfg.steps)
    with torch.no_grad():
        return H2 @ cayley(_skew(best_A))


def apply_trained_r2(params: Dict[str, Any], cfg: llama.LlamaConfig,
                     R2s: torch.Tensor) -> Dict[str, Any]:
    """Bake the per-layer R2 into v_proj (and v_bias) and o_proj."""
    hd = cfg.hd
    new_blocks = []
    for li, block in enumerate(params["blocks"]):
        b = dict(block)
        wv = b["v_proj"]
        R = R2s[li].float().to(wv.device)
        b["v_proj"] = torch.einsum(
            "de,keH->kdH", R.t(),
            wv.float().reshape(cfg.num_kv_heads, hd, -1)).reshape(
                cfg.num_kv_heads * hd, -1).to(wv.dtype)
        if b.get("v_bias") is not None:
            vb = b["v_bias"].float().reshape(cfg.num_kv_heads, hd)
            b["v_bias"] = (vb @ R).reshape(-1).to(block["v_bias"].dtype)
        wo = b["o_proj"].float().reshape(-1, cfg.num_heads, hd)
        b["o_proj"] = torch.einsum("Hne,ed->Hnd", wo, R).reshape(
            wo.shape[0], -1).to(block["o_proj"].dtype)
        new_blocks.append(b)
    out = dict(params)
    out["blocks"] = new_blocks
    return out


def apply_trained_rotation(params: Dict[str, Any], cfg: llama.LlamaConfig,
                           R: torch.Tensor) -> Dict[str, Any]:
    """An orthogonal residual rotation ``R`` applied as
    ``transforms.hadamard.apply_r1_rotation`` applies H."""
    check_llama_blocks(params, cfg, _READ + _WRITE)
    return rotate_residual(fuse_rms_gains(params, cfg), R.float())
