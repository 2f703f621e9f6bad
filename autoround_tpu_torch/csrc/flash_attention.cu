// Flash attention forward with log-sum-exp, bf16 in/out, fp32 statistics.
//
// Replaces: autoround_tpu/ops/flash_attention.py, `_flash_fwd_impl` ->
// `_kernel` (the Pallas TPU forward with lane-replicated (B,H,S,128) lse).
//
// What bounds it on an H100: at the prefill / calibration shapes of the
// main path (S = T = 512, D = 128, 32 heads) the work is 4*B*H*S*T*D
// operations against ~(2*B*H*S*D + 2*B*Hkv*T*D)*2 bytes, i.e. several
// hundred operations per byte: the tensor cores bound it, not memory.
//
// Design: one block per (q-tile of 64 rows, head, batch) loops over the KV
// tiles inside the block (the TPU's sequential 4th grid axis becomes this
// loop; nothing carries between blocks).  4 warps, 16 query rows each.
// Q.K^T and P.V run on the tensor cores through WMMA bf16 16x16x16 tiles
// with fp32 accumulation.  WMMA hides the accumulator's element layout, so
// the running output lives in shared memory as fp32: each KV tile rescales
// it by alpha in place, loads it back as the accumulator and adds P.V.
// The online softmax (m, l in fp32) runs on the score tile in shared
// memory, two lanes per row.  GQA reads KV head h / rep directly; K/V are
// never repeated.  The causal mask is anchored bottom-right
// (col <= row + T - S): fully masked KV tiles are skipped, the diagonal
// tiles mask with -0.7 * FLT_MAX as the JAX kernel does.  P is rounded to
// bf16 before P.V, as flash_attention_ref rounds the probabilities.
// Simple on purpose: single-buffered tiles, no cp.async / TMA / wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <float.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // kv rows per tile
constexpr int NWARP = 4;     // 16 query rows per warp
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

template <int D>
struct Smem {
  static constexpr int LDH = D + 8;      // bf16 row stride (Q, K, V)
  static constexpr int LDS = BKV + 4;    // fp32 score row stride
  static constexpr int LDP = BKV + 8;    // bf16 probability row stride
  static constexpr int LDO = D + 4;      // fp32 output row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BQ * LDH;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BKV * LDH;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * BKV * LDH;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t bytes = o_off + sizeof(float) * BQ * LDO;
};

// copy rows x D bf16 from global (row stride D) into shared (row stride ldh)
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int rows, int ldh) {
  constexpr int VEC = 8;                 // 8 bf16 = 16 bytes
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(dst + r * ldh + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

template <int D>
__global__ void __launch_bounds__(NWARP * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int H, int Hkv, int S, int T, int causal, float sm_scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int ts_off = T - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const __nv_bfloat16* qg = q + (((size_t)b * H + h) * S + q0) * D;
  const __nv_bfloat16* kg = k + ((size_t)b * Hkv + hk) * T * D;
  const __nv_bfloat16* vg = v + ((size_t)b * Hkv + hk) * T * D;

  load_tile<D>(Qs, qg, BQ, L::LDH);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += blockDim.x) Os[i] = 0.f;

  // this lane's row of the warp's 16 and its half of the 64 score columns
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int grow = q0 + row;
  float m_i = -INFINITY, l_i = 0.f;

  int n_tiles = T / BKV;
  if (causal) {
    int last = q0 + BQ - 1 + ts_off;     // last column any row may see
    n_tiles = min(n_tiles, last / BKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();                     // previous tile's K/V reads done
    load_tile<D>(Ks, kg + (size_t)kv0 * D, BKV, L::LDH);
    load_tile<D>(Vs, vg + (size_t)kv0 * D, BKV, L::LDH);
    __syncthreads();

    // S_w (16 x 64) = Q_w (16 x D) . K^T
    for (int n = 0; n < BKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(bf, Ks + n * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + n * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this lane's 32 columns of its row
    float* srow = Ss + row * L::LDS + half * 32;
    float mx = -INFINITY;
    for (int j = 0; j < 32; ++j) {
      float s = srow[j] * sm_scale;
      int col = kv0 + half * 32 + j;
      if (causal && col > grow + ts_off) s = MASK_VALUE;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
    __nv_bfloat16* prow = Ps + row * L::LDP + half * 32;
    for (int j = 0; j < 32; ++j) {
      float p = expf(srow[j] - m_new);
      sum += p;
      prow[j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = alpha * l_i + sum;
    m_i = m_new;
    float* orow = Os + row * L::LDO + half * (D / 2);
    for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
    __syncwarp();

    // O_w (16 x D) += P_w (16 x 64) . V (64 x D)
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* optr = Os + warp * 16 * L::LDO + n * 16;
      wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(a, Ps + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(bf, Vs + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // epilogue: normalise (l == 0 guard as in the JAX kernel), write O, lse
  const float inv = (l_i == 0.f) ? 1.f : 1.f / l_i;
  const float* orow = Os + row * L::LDO + half * (D / 2);
  __nv_bfloat16* og = out + (((size_t)b * H + h) * S + grow) * D + half * (D / 2);
  for (int j = 0; j < D / 2; ++j) og[j] = __float2bfloat16(orow[j] * inv);
  if (half == 0)
    lse[((size_t)b * H + h) * S + grow] = m_i + logf(l_i == 0.f ? 1.f : l_i);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Hkv, int S, int T, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Hkv, S,
      T, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,S,D), k/v (B,Hkv,T,D) bf16 contiguous; out (B,H,S,D) bf16,
// lse (B,H,S) fp32.  S % 64 == 0, T % 64 == 0, D in {128, 256}, H % Hkv == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int H, int Hkv, int S, int T, int D,
                                   int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, out, lse, B, H, Hkv, S, T, causal, sm_scale,
                       st);
  if (D == 256)
    return launch<256>(q, k, v, out, lse, B, H, Hkv, S, T, causal, sm_scale,
                       st);
  return (int)cudaErrorInvalidValue;
}
