// Asymmetric W4A16 dequant-matmul: y = x . ((code - zp) * scale)^T with a
// per-group fp32 zero point (integral or fractional), bf16 in/out.
//
// Replaces: autoround_tpu/ops/qmatmul_ext.py, `w4a16_asym_matmul` ->
// `_asym_kernel` (the Pallas TPU kernel over the nibble-plane layout).
//
// The TPU kernel keeps the codes unsigned through its matrix unit and
// applies the zero point as a rank-1 correction rowsum(x_g) (x) (s * z) per
// group.  Here the dequant already runs per code in registers (GEMV) or per
// weight tile (GEMM), so the zero point is subtracted there: (code - zp) *
// scale in fp32, one more subtraction per weight and no second reduction
// over x.  Both bodies round that product to bf16 exactly as the plain
// version does before their tensor-core products.
//
// Bounds and tile bodies as in w4a16_tiles.cuh; the zero points add 4 bytes
// per group of g weights to the stream.

#include "w4a16_tiles.cuh"

// x (M, K) bf16, qweight (O, K/8) int32, scales and zps (O, K/g) fp32, y
// (M, O) bf16, all contiguous.  M >= 1, K % 32 == 0, g % 16 == 0,
// K % g == 0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int w4a16_asym_matmul(const void* x, const void* qw,
                                 const void* sc, const void* zp, void* y,
                                 int M, int K, int O, int g, void* stream) {
  return w4a16::launch<w4a16::ASYM4>(x, qw, sc, zp, y, 1, 0, M, K, O, g, stream);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMM
// body (M > 32) into info[0..3].  Returns a cudaError_t.
extern "C" int w4a16_asym_matmul_gemm_info(int* info) {
  return w4a16::gemm_info<w4a16::ASYM4>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (E, M, K, O), into info[0..5].
// Returns a cudaError_t.
extern "C" int w4a16_asym_matmul_gemv_info(int E, int M, int K, int O, int* info) {
  return w4a16::gemv_info<w4a16::ASYM4>(E, M, K, O, info);
}
