// FP8 weight-only matmul: y = (x . e4m3(W)^T) * scale_row with float8_e4m3fn
// weights and one fp32 scale per output channel, bf16 activations in and
// out, fp32 accumulation.
//
// Replaces: autoround_tpu/ops/qmatmul_ext.py, `fp8_matmul` -> `_fp8_kernel`
// (the Pallas TPU kernel).
//
// As in the TPU kernel, each e4m3 weight becomes a bf16 (exact: 3 mantissa
// bits fit bf16's 7) and the per-channel scale multiplies the fp32 sum in
// the epilogue.  The tile bodies are those of w4a16_tiles.cuh in their E4M3
// format: a byte load and a bit-placement decode in registers.  The plain
// version (fp8_matmul_ref's order) rounds w * s to bf16 before the product
// instead, so the two differ by that rounding, up to 2^-9 of each weight.
//
// The H100's fp8 tensor cores are not used: they would take the
// activations as fp8 too, which quantizes them and changes the result of a
// weight-only kind.  What bounds it on an H100: decode streams one byte a
// weight; prefill is bound by the bf16 tensor cores.

#include "w4a16_tiles.cuh"

// x (M, K) bf16, w (O, K) float8_e4m3fn bytes, scales (O,) fp32, y (M, O)
// bf16, all contiguous.  M >= 1, K % 32 == 0.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int fp8_matmul(const void* x, const void* w, const void* sc,
                          void* y, int M, int K, int O, void* stream) {
  return w4a16::launch<w4a16::E4M3>(x, w, sc, nullptr, y, 1, 0, M, K, O, K,
                                    stream);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMM
// body (M > 32) into info[0..3].  Returns a cudaError_t.
extern "C" int fp8_matmul_gemm_info(int* info) {
  return w4a16::gemm_info<w4a16::E4M3>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (E, M, K, O), into info[0..5].
// Returns a cudaError_t.
extern "C" int fp8_matmul_gemv_info(int E, int M, int K, int O, int* info) {
  return w4a16::gemv_info<w4a16::E4M3>(E, M, K, O, info);
}
