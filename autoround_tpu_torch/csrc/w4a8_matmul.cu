// W4A8 product: per group of g columns the exact int32 dot of q8(x) with
// (code - 8), times the group's fp32 scale, summed in fp32, times the row
// scale xs; int8 activations quantized per row on the fly, bf16 in and
// out.
//
// Replaces: autoround_tpu/ops/qmatmul_int8.py, `w4a8_matmul` ->
// `_w4a8_kernel` (the Pallas TPU kernel) and the `quantize_rows` pass in
// front of it.
//
// The TPU kernel reads a byte-pair layout of its own (two groups' codes
// in one int8, the high one XOR 8) because its int8 vector unit can only
// AND, corrects the low half with -8 * rowsum(x) and folds 1/16 into the
// high half's scale; it is fixed at g = 128.  Here a nibble becomes a
// signed int8 `code - 8` (mask, byte permute, per-byte subtract; once a
// k-step into a shared tile in the GEMM body) and goes to the int8
// product, so the kernel reads the same packed words as the W4A16
// kernels: no second copy of the weights for the A8 serving modes, no
// correction term, any g that is a multiple of 32.
//
// Bounds and bodies: a8_tiles.cuh.

#include "a8_tiles.cuh"

// x (M, K) bf16, qweight (O, K/8) int32, scales (O, K/g) fp32, scratch xi
// (M, K) int8 and xs (M,) fp32, y (M, O) bf16 (or, when y32 is not null,
// fp32 written there), all contiguous.  M >= 1, K % 32 == 0, g % 32 == 0,
// K % g == 0.  Returns the cudaError_t of the launches (0 on success).
extern "C" int w4a8_matmul(const void* x, const void* qw, const void* sc,
                           void* xi, void* xs, void* y, void* y32, int M,
                           int K, int O, int g, void* stream) {
  return a8::launch<true>(x, qw, sc, xi, xs, y, y32, M, K, O, g, stream);
}

// The GEMM body's registers, spill bytes, dynamic shared memory and blocks
// per SM on this card (info[4]): at the served g = 128, and at any other g.
extern "C" int w4a8_matmul_gemm_info(int* info) {
  return a8::gemm_info<a8::W4_G128>(info);
}

extern "C" int w4a8_matmul_gemm_any_info(int* info) {
  return a8::gemm_info<a8::W4_ANY>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (M, K, O, g), into info[0..5].
// Returns a cudaError_t.
extern "C" int w4a8_matmul_gemv_info(int M, int K, int O, int g, int* info) {
  return a8::gemv_info<true>(M, K, O, g, info);
}
