// W4A16 dequant-matmul: y = x . ((code - 8) * scale)^T, bf16 in/out.
//
// Replaces: autoround_tpu/ops/qmatmul.py, `w4a16_matmul` -> `_kernel`
// (the Pallas TPU kernel over the nibble-plane layout).
//
// The kernels, the packed layout and what bounds them on an H100 are in
// w4a16_tiles.cuh (shared with the grouped and the asym products); this is
// the one-expert, zero-of-8 instance.

#include "w4a16_tiles.cuh"

// x (M, K) bf16, qweight (O, K/8) int32, scales (O, K/g) fp32, y (M, O)
// bf16, all contiguous.  M >= 1, K % 32 == 0, g % 16 == 0, K % g == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int w4a16_matmul(const void* x, const void* qw, const void* sc,
                            void* y, int M, int K, int O, int g,
                            void* stream) {
  return w4a16::launch<w4a16::SYM4>(x, qw, sc, nullptr, y, 1, 0, M, K, O, g,
                              stream);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMM
// body (M > 32) into info[0..3].  Returns a cudaError_t.
extern "C" int w4a16_matmul_gemm_info(int* info) {
  return w4a16::gemm_info<w4a16::SYM4>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (E, M, K, O), into info[0..5].
// Returns a cudaError_t.
extern "C" int w4a16_matmul_gemv_info(int E, int M, int K, int O, int* info) {
  return w4a16::gemv_info<w4a16::SYM4>(E, M, K, O, info);
}
