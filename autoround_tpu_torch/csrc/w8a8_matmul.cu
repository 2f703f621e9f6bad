// W8A8 product: y = (q8(x) . Wi^T) * xs * ws, int8 activations quantized
// per row on the fly, int8 weights with one fp32 scale per output channel
// (signed: the sign carries the full-range flip of the symmetric
// quantizer), bf16 in and out.
//
// Replaces: autoround_tpu/ops/qmatmul_int8.py, `w8a8_matmul` ->
// `_w8a8_kernel` (the Pallas TPU kernel) and the `quantize_rows` pass in
// front of it.
//
// The TPU kernel carries an int32 tile in scratch memory across its K grid
// steps and lane-replicates the row scales for its epilogue.  Here a block
// loops over K itself with its int32 sums in registers (wgmma m64n128k32
// s8 for M > 32; mma.sync m16n8k32 s8 for M <= 32, K split over a
// thread-block cluster where the rows alone give too few warps), and the
// epilogue reads xs[m] and ws[o] directly: `float(acc) * xs * ws`, in that
// order.  Row-major Wi (O, K) is already the K-major operand of both, so
// the weights are served as they are stored.
//
// Bounds and bodies: a8_tiles.cuh.

#include "a8_tiles.cuh"

// x (M, K) bf16, wi (O, K) int8, ws (O,) fp32, scratch xi (M, K) int8 and
// xs (M,) fp32, y (M, O) bf16 (or, when y32 is not null, fp32 written
// there), all contiguous.  M >= 1, K % 32 == 0.  Returns the cudaError_t
// of the launches (0 on success).
extern "C" int w8a8_matmul(const void* x, const void* wi, const void* ws,
                           void* xi, void* xs, void* y, void* y32, int M,
                           int K, int O, void* stream) {
  return a8::launch<false>(x, wi, ws, xi, xs, y, y32, M, K, O, 0, stream);
}

// x (M, K) bf16 -> xi (M, K) int8, xs (M,) fp32.  K % 8 == 0.
extern "C" int quantize_rows(const void* x, void* xi, void* xs, int M, int K,
                             void* stream) {
  if (M <= 0 || K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  a8::launch_quantize_rows(x, xi, xs, M, K,
                           static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The GEMM body's registers, spill bytes, dynamic shared memory and blocks
// per SM on this card (info[4]).
extern "C" int w8a8_matmul_gemm_info(int* info) {
  return a8::gemm_info<a8::W8>(info);
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the GEMV
// body (M <= 32) at M's n-tile tier, and its plan (rw row tiles a block, K
// split over a cluster of kc blocks) for (M, K, O), into info[0..5].
// Returns a cudaError_t.
extern "C" int w8a8_matmul_gemv_info(int M, int K, int O, int* info) {
  return a8::gemv_info<false>(M, K, O, 32, info);
}
