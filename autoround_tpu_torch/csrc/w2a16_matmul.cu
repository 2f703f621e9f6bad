// W2A16 dequant-matmul: y = x . ((code - 2) * scale)^T with symmetric
// full-range 2-bit codes in [0, 3], one signed fp32 scale per group of g
// input columns, bf16 activations in and out, fp32 accumulation.
//
// Replaces: autoround_tpu/ops/qmatmul_ext.py, `w2a16_matmul` -> `_w2_kernel`
// (the Pallas TPU kernel over its 16 bit-plane layout).
//
// The TPU kernel multiplies the unscaled (code - 2) plane of each group in
// bf16 and scales that group's partial product afterwards.  Here the tile
// bodies are those of the W4A16 kernels (w4a16_tiles.cuh) in their INT2
// format: the port packs 16 codes per int32 word in K order (column 16w+j in
// bits 2j..2j+1 of word w).  The GEMV body (M <= 32) turns each code into
// bf16((code - 2) * s) in registers, the A of its mma.sync products; the
// GEMM body (M > 32) dequantizes the packed codes of each k-step once into
// a bf16 shared-memory tile as bf16((code - 2) * s), exactly what the plain
// version rounds, and runs wgmma over it.
//
// What bounds it on an H100: decode streams a quarter of a byte a weight
// plus 4 bytes of scale per group (for g = 128 the scales are 1/8 of the
// codes' bytes); prefill is bound by the bf16 tensor cores as W4A16 is.

#include "w4a16_tiles.cuh"

// x (M, K) bf16, qweight (O, K/16) int32, scales (O, K/g) fp32, y (M, O)
// bf16, all contiguous.  M >= 1, K % 32 == 0, g % 32 == 0, K % g == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int w2a16_matmul(const void* x, const void* qw, const void* sc,
                            void* y, int M, int K, int O, int g,
                            void* stream) {
  return w4a16::launch<w4a16::INT2>(x, qw, sc, nullptr, y, 1, 0, M, K, O, g,
                                    stream);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMM
// body (M > 32) into info[0..3].  Returns a cudaError_t.
extern "C" int w2a16_matmul_gemm_info(int* info) {
  return w4a16::gemm_info<w4a16::INT2>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (E, M, K, O), into info[0..5].
// Returns a cudaError_t.
extern "C" int w2a16_matmul_gemv_info(int E, int M, int K, int O, int* info) {
  return w4a16::gemv_info<w4a16::INT2>(E, M, K, O, info);
}
