// MXFP4 / NVFP4 weight-only matmul: y = x . (e2m1(code) * scale)^T with
// 4-bit E2M1 codes and one fp32 scale per group of g = 32 (MX: a power of
// two) or g = 16 (NVFP4: an e4m3 value over the global scale, folded into
// the scale at packing time) input columns; bf16 activations in and out,
// fp32 accumulation.
//
// Replaces: autoround_tpu/ops/qmatmul_ext.py, `mxfp4_matmul` ->
// `_mxfp4_kernel` (the Pallas TPU kernel, which expands each plane's scales
// onto its lanes with a one-hot matrix product because its vector unit has
// no interleaving repeat).
//
// Here a code is decoded by placing its bits into an fp32 (exact for all 16
// values) and multiplied by its group's scale in registers before the tile
// product, as mxfp4_matmul_ref does, and rounded to bf16 (exact for MX's
// power-of-two scales, one bf16 rounding for NVFP4's): the GEMV body (M <=
// 32) into its mma.sync A fragments, the GEMM body (M > 32) into its
// shared-memory tile for wgmma.  Codes use the W4A16 kernel's nibble layout; at g = 16
// a 32-column chunk spans two groups, and the bodies read the second scale.
//
// What bounds it on an H100: decode streams half a byte a weight plus 4
// bytes of scale per group (1/4 of the codes' bytes at g = 32, 1/2 at g =
// 16); prefill is bound by the bf16 tensor cores.

#include "w4a16_tiles.cuh"

// x (M, K) bf16, qweight (O, K/8) int32, scales (O, K/g) fp32, y (M, O)
// bf16, all contiguous.  M >= 1, K % 32 == 0, g in {16, 32}, K % g == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mxfp4_matmul(const void* x, const void* qw, const void* sc,
                            void* y, int M, int K, int O, int g,
                            void* stream) {
  if (g != 16 && g != 32) return (int)cudaErrorInvalidValue;
  return w4a16::launch<w4a16::E2M1>(x, qw, sc, nullptr, y, 1, 0, M, K, O, g,
                                    stream);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMM
// body (M > 32) into info[0..3].  Returns a cudaError_t.
extern "C" int mxfp4_matmul_gemm_info(int* info) {
  return w4a16::gemm_info<w4a16::E2M1>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (E, M, K, O), into info[0..5].
// Returns a cudaError_t.
extern "C" int mxfp4_matmul_gemv_info(int E, int M, int K, int O, int* info) {
  return w4a16::gemv_info<w4a16::E2M1>(E, M, K, O, info);
}
