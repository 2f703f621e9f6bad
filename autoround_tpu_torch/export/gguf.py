"""GGUF per-layer type choice (counterpart of the type-choice part of
``autoround_tpu/export/gguf.py``): the ggml type ids, their block sizes
and llama.cpp's per-layer cascade, which ``quantize.layer_config.
apply_gguf_cascade`` needs so each layer tunes on the grid the file will
store.  The GGUF container writer and the k-quant block packers are not
ported yet (ROADMAP A13, queue A item 7).
"""

from __future__ import annotations

__all__ = ["QK", "QK_K", "GGMLType", "BLOCK_ELEMS", "select_layer_qtype"]

QK = 32       # simple-quant block
QK_K = 256    # k-quant super-block


class GGMLType:
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14


BLOCK_ELEMS = {GGMLType.Q4_0: QK, GGMLType.Q4_1: QK, GGMLType.Q5_0: QK,
               GGMLType.Q5_1: QK, GGMLType.Q8_0: QK, GGMLType.Q2_K: QK_K,
               GGMLType.Q3_K: QK_K, GGMLType.Q4_K: QK_K,
               GGMLType.Q5_K: QK_K, GGMLType.Q6_K: QK_K}


def _use_more_bits(block_idx: int, n_blocks: int) -> bool:
    """llama.cpp's mixed-precision block rule: the first and last eighth
    of the blocks and every third block between get more bits."""
    return (block_idx < n_blocks // 8
            or block_idx >= n_blocks - n_blocks // 8
            or block_idx % 3 == 2)


def select_layer_qtype(base_type: int, block_idx: int, n_blocks: int,
                       layer_kind: str, in_features: int,
                       n_gqa: int = 1, n_expert: int = 0,
                       has_imatrix: bool = False) -> int:
    """llama.cpp's ``llama_tensor_get_type`` cascade:

      * output / token_embd → at least Q6_K (Q8_0 stays)
      * attn_v — Q2_K base: Q4_K when GQA ≥ 4 else Q3_K; Q3_K: Q5_K for
        the first two blocks else Q4_K; Q4_K / Q5_K → Q6_K on more-bits
        blocks; 8-expert models pin Q8_0
      * attn_k (8-expert models) → Q8_0
      * ffn_down — Q2_K: Q3_K; Q3_K: Q5_K below n / 16 else Q4_K;
        Q4_K / Q5_K → Q6_K on more-bits blocks; Q4_0 / Q5_0 with an
        imatrix → Q4_1 / Q5_1 for the first n / 8 blocks
      * attn_output — Q2_K: Q3_K; Q3_K: Q4_K; 8-expert low-bit → Q5_K
      * rows not divisible by 256 fall back to Q8_0, then F16
    """
    t = base_type
    if layer_kind in ("output", "token_embd"):
        if t != GGMLType.Q8_0:
            t = max(t, GGMLType.Q6_K)
    elif layer_kind == "attn_v":
        if base_type == GGMLType.Q2_K:
            t = GGMLType.Q4_K if n_gqa >= 4 else GGMLType.Q3_K
        elif base_type == GGMLType.Q3_K:
            t = GGMLType.Q5_K if block_idx < 2 else GGMLType.Q4_K
        elif base_type in (GGMLType.Q4_K, GGMLType.Q5_K) \
                and _use_more_bits(block_idx, n_blocks):
            t = GGMLType.Q6_K
        if n_expert == 8:
            t = GGMLType.Q8_0
    elif layer_kind == "attn_k" and n_expert == 8:
        t = GGMLType.Q8_0
    elif layer_kind == "ffn_down":
        if base_type == GGMLType.Q2_K:
            t = GGMLType.Q3_K
        elif base_type == GGMLType.Q3_K:
            t = (GGMLType.Q5_K if block_idx < n_blocks // 16
                 else GGMLType.Q4_K)
        elif base_type in (GGMLType.Q4_K, GGMLType.Q5_K) \
                and _use_more_bits(block_idx, n_blocks):
            t = GGMLType.Q6_K
        elif (base_type == GGMLType.Q4_0 and has_imatrix
              and block_idx < n_blocks // 8):
            t = GGMLType.Q4_1
        elif (base_type == GGMLType.Q5_0 and has_imatrix
              and block_idx < n_blocks // 8):
            t = GGMLType.Q5_1
    elif layer_kind == "attn_output":
        if n_expert == 8:
            if base_type in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K):
                t = GGMLType.Q5_K
        elif base_type == GGMLType.Q2_K:
            t = GGMLType.Q3_K
        elif base_type == GGMLType.Q3_K:
            t = GGMLType.Q4_K
    if BLOCK_ELEMS.get(t) == QK_K and in_features % QK_K != 0:
        t = GGMLType.Q8_0 if in_features % QK == 0 else GGMLType.F16
    if BLOCK_ELEMS.get(t) == QK and in_features % QK != 0:
        t = GGMLType.F16
    return t
