// Grouped (MoE) W4A16 dequant-matmul: y[e] = x[e] . ((code[e] - 8) *
// scale[e])^T for all E experts in one launch, bf16 in/out.
//
// Replaces: autoround_tpu/ops/qmatmul.py, `w4a16_matmul_grouped` ->
// `_grouped_kernel` (the Pallas TPU kernel whose leading grid axis selects
// the expert).
//
// As there, the expert is a grid axis and the tile body is the ungrouped
// one (w4a16_tiles.cuh).  Unlike there, the token count C needs no padding
// to 16 (the ragged edge is masked), and the activation's expert stride may
// be 0: dense-then-mask routing gives every expert the same C rows, which
// are then read through L2 instead of being copied E times.
//
// What bounds it on an H100: at decode (C = batch) every expert's packed
// weights stream once per launch whatever the routing, ~0.53 byte per
// weight, so memory bounds it (the GEMV body, E x O/(16 rw) blocks); at
// prefill (C in the thousands) 2*C operations per weight bound it (wgmma GEMM
// bodies with per-tile dequant, E x C/128 x O/128 blocks).

#include "w4a16_tiles.cuh"

// x (E, C, K) bf16, each (C, K) slab contiguous, at an expert stride of
// `x_stride_e` elements (a multiple of 8; C*K when contiguous, 0 for one
// slab shared by all experts), qweight (E, O, K/8) int32, scales
// (E, O, K/g) fp32, y (E, C, O) bf16, contiguous.  E, C >= 1, K % 32 == 0,
// g % 16 == 0, K % g == 0.  Returns the cudaError_t of the launch.
extern "C" int w4a16_matmul_grouped(const void* x, const void* qw,
                                    const void* sc, void* y, int E,
                                    long long x_stride_e, int C, int K, int O,
                                    int g, void* stream) {
  return w4a16::launch<w4a16::SYM4>(x, qw, sc, nullptr, y, E, x_stride_e, C, K, O,
                              g, stream);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMM
// body (M > 32) into info[0..3].  Returns a cudaError_t.
extern "C" int w4a16_matmul_grouped_gemm_info(int* info) {
  return w4a16::gemm_info<w4a16::SYM4>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (E, M, K, O), into info[0..5].
// Returns a cudaError_t.
extern "C" int w4a16_matmul_grouped_gemv_info(int E, int M, int K, int O, int* info) {
  return w4a16::gemv_info<w4a16::SYM4>(E, M, K, O, info);
}
