// W8A16 dequant-matmul: y = x . (Wi * scale)^T with int8 weights and one
// fp32 scale per group of g input columns (g = K: one per output channel),
// bf16 activations in and out, fp32 accumulation.
//
// Replaces: autoround_tpu/ops/qmatmul_ext.py, `w8a16_matmul` ->
// `_w8_kernel` (the Pallas TPU kernel).
//
// The TPU kernel multiplies the unscaled int8 tile (cast to bf16) per group
// and scales each group's partial product afterwards, with the scales
// transposed to (K/g, O) for its lanes.  Here the tile bodies are those of
// the W4A16 kernels (w4a16_tiles.cuh) in their INT8 format, a byte load
// where the nibble unpack is: the GEMM body (M > 32) dequantizes each
// k-step's codes once into a bf16 shared-memory tile as bf16(float(wi) *
// s), exactly what the plain version rounds, for wgmma; the GEMV body
// (M <= 32) rounds the same value in registers into the A fragments of
// mma.sync.  The scales stay (O, K/g) as the engine stores them.
//
// What bounds it on an H100: decode streams 1 byte a weight (twice the
// W4A16 stream), prefill is bound by the bf16 tensor cores as W4A16 is.

#include "w4a16_tiles.cuh"

// x (M, K) bf16, wi (O, K) int8, scales (O, K/g) fp32, y (M, O) bf16, all
// contiguous.  M >= 1, K % 32 == 0, g % 32 == 0, K % g == 0 (g = K: one
// scale per output channel).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int w8a16_matmul(const void* x, const void* wi, const void* sc,
                            void* y, int M, int K, int O, int g,
                            void* stream) {
  return w4a16::launch<w4a16::INT8>(x, wi, sc, nullptr, y, 1, 0, M, K, O, g,
                                    stream);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMM
// body (M > 32) into info[0..3].  Returns a cudaError_t.
extern "C" int w8a16_matmul_gemm_info(int* info) {
  return w4a16::gemm_info<w4a16::INT8>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (E, M, K, O), into info[0..5].
// Returns a cudaError_t.
extern "C" int w8a16_matmul_gemv_info(int E, int M, int K, int O, int* info) {
  return w4a16::gemv_info<w4a16::INT8>(E, M, K, O, info);
}
