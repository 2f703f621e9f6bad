// Flash attention backward: dQ and dK/dV, bf16 in/out, fp32 accumulation.
//
// Replaces: autoround_tpu/ops/flash_attention.py, `_flash_bwd` ->
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (the two Pallas TPU backward
// passes) and the XLA sum over the GQA group that follows the second.
//
// Both recompute the probabilities from the forward's log-sum-exp:
//   S = Q.K^T * scale (masked with -0.7 * FLT_MAX),  P = exp(S - lse),
//   dP = dO.V^T,  dS = P * (dP - delta) * scale,  delta = rowsum(dO * O),
//   dQ = sum_kv dS.K,   dV = sum_q P^T.dO,   dK = sum_q dS^T.Q,
// with P and dS rounded to bf16 before the products that consume them, as
// the TPU kernels round them.  delta (B, H, S) fp32 comes from the caller.
//
// What bounds them on an H100: at the tuning shape (S = T = 512, D = 128,
// 32 heads over 8 KV heads) dQ is 3 and dK/dV 4 matrix products per score
// tile against tiles that are read once: hundreds of operations per byte,
// so the tensor cores bound both, not memory.
//
// Design.  The TPU's sequential last grid axis becomes a loop inside the
// block; nothing carries between blocks, and there are no atomics: every
// output element is written once by one thread, in a fixed summation
// order, so two runs on the same inputs give the same bits.
//  * dQ: one block per (q-tile of 64 rows, head, batch) loops over the KV
//    tiles up to the bottom-right diagonal.
//  * dK/dV: one block per (kv-tile of 64 rows, KV head, batch) loops over
//    the `rep` query heads of its group and over the q-tiles from the
//    diagonal down, so the group sum happens in the fp32 accumulators and
//    dK, dV (B, Hkv, T, D) are written once.  It computes the transposed
//    score tile S^T = K.Q^T directly, so P^T and dS^T are plain row-major
//    operands of the two accumulating products.
// WMMA bf16 16x16x16 tiles with fp32 accumulation.  A warp owns 16 rows of
// the block's tile and 128 output columns: its dQ (or dK and dV)
// accumulators are 8 (or 16) fragments held in registers for the whole
// loop.  D = 256 runs 8 warps, two per row group, each owning one half of
// D and computing one half of the score columns.  WMMA hides the
// accumulator's element layout, so the elementwise step P * (dP - delta)
// runs on the score tiles in shared memory, two lanes per row, and the
// final fp32 -> bf16 conversion goes through a small per-warp staging tile.
// Simple on purpose: single-buffered tiles, no cp.async / TMA / wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <float.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BT = 64;       // rows of every q / kv tile
constexpr int DW = 128;      // accumulator columns owned by one warp
constexpr int NF = DW / 16;  // accumulator fragments per warp and output
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr int LDX = 20;      // fp32 row stride of the per-warp staging tile

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    BFragRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BFragCol;

template <int D>
struct Cfg {
  static constexpr int NSPLIT = D / DW;        // warps per row group
  static constexpr int NWARP = 4 * NSPLIT;
  static constexpr int THREADS = 32 * NWARP;
  static constexpr int CW = BT / NSPLIT;       // score columns per warp
  static constexpr int LDH = D + 8;            // bf16 row stride (Q,dO,K,V)
  static constexpr int LDS = BT + 4;           // fp32 score row stride
  static constexpr int LDP = BT + 8;           // bf16 score row stride
  static constexpr size_t tile = sizeof(bf16) * BT * LDH;
  static constexpr size_t sc32 = sizeof(float) * BT * LDS;
  static constexpr size_t sc16 = sizeof(bf16) * BT * LDP;
  // dQ: Q, dO, K, V | S, dP (fp32) | dS (bf16)
  static constexpr size_t dq_bytes = 4 * tile + 2 * sc32 + sc16;
  // dK/dV: K, V, Q, dO | S^T, dP^T (fp32) | P^T, dS^T (bf16) | lse, delta
  static constexpr size_t dkv_bytes =
      4 * tile + 2 * sc32 + 2 * sc16 + 2 * sizeof(float) * BT;
};

// copy BT x D bf16 from global (row stride D) into shared (row stride ldh)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int ldh) {
  constexpr int PER_ROW = D / 8;               // 8 bf16 = 16 bytes
  for (int i = threadIdx.x; i < BT * PER_ROW; i += blockDim.x) {
    int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldh + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

// dst (16 x NT*16 fp32, stride ldd) = A (16 x D, row stride ldh) . B^T,
// B (NT*16 x D, row stride ldh)
template <int D, int NT>
__device__ __forceinline__ void mma_nt(float* dst, int ldd, const bf16* A,
                                       const bf16* B, int ldh) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    AccFrag acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      AFrag a;
      BFragCol b;
      wmma::load_matrix_sync(a, A + kk * 16, ldh);
      wmma::load_matrix_sync(b, B + n * 16 * ldh + kk * 16, ldh);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(dst + n * 16, acc, ldd, wmma::mem_row_major);
  }
}

// acc[n] (16 x 16) += A (16 x BT bf16, stride lda) . B (BT x 128 columns
// starting at B, row stride ldb)
__device__ __forceinline__ void mma_acc(AccFrag (&acc)[NF], const bf16* A,
                                        int lda, const bf16* B, int ldb) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    AFrag a;
    wmma::load_matrix_sync(a, A + kk * 16, lda);
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      BFragRow b;
      wmma::load_matrix_sync(b, B + kk * 16 * ldb + n * 16, ldb);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// write a warp's 16 x 128 fp32 accumulators as bf16 to global rows of
// stride D starting at dst, through the warp's staging tile
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, AccFrag (&acc)[NF],
                                          float* stage, int lane) {
  const int row = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    wmma::store_matrix_sync(stage, acc[n], LDX, wmma::mem_row_major);
    __syncwarp();
    const float* s = stage + row * LDX + c;
    __nv_bfloat162 h0 = __floats2bfloat162_rn(s[0], s[1]);
    __nv_bfloat162 h1 = __floats2bfloat162_rn(s[2], s[3]);
    __nv_bfloat162 h2 = __floats2bfloat162_rn(s[4], s[5]);
    __nv_bfloat162 h3 = __floats2bfloat162_rn(s[6], s[7]);
    uint4 u;
    u.x = *reinterpret_cast<uint32_t*>(&h0);
    u.y = *reinterpret_cast<uint32_t*>(&h1);
    u.z = *reinterpret_cast<uint32_t*>(&h2);
    u.w = *reinterpret_cast<uint32_t*>(&h3);
    *reinterpret_cast<uint4*>(dst + (size_t)row * D + n * 16 + c) = u;
    __syncwarp();
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Hkv, int S, int T, int causal,
                    float sm_scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + C::tile);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * C::tile);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * C::tile);
  float* Ss = reinterpret_cast<float*>(smem + 4 * C::tile);
  float* dPs = reinterpret_cast<float*>(smem + 4 * C::tile + C::sc32);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 4 * C::tile + 2 * C::sc32);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BT;
  const int ts_off = T - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4;            // row group: 16 query rows
  const int sp = warp / 4;            // which half of D / of the columns

  const size_t qbase = (((size_t)b * H + h) * S + q0) * D;
  const bf16* kg = k + ((size_t)b * Hkv + hk) * T * D;
  const bf16* vg = v + ((size_t)b * Hkv + hk) * T * D;

  load_tile<D>(Qs, q + qbase, C::LDH);
  load_tile<D>(dOs, dO + qbase, C::LDH);

  // this lane's row of the warp's 16 and its share of the warp's columns
  const int row = rg * 16 + (lane >> 1);
  const int c0 = sp * C::CW + (lane & 1) * (C::CW / 2);
  const int grow = q0 + row;
  const float lse_r = lse[((size_t)b * H + h) * S + grow];
  const float delta_r = delta[((size_t)b * H + h) * S + grow];

  AccFrag acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);

  int n_tiles = T / BT;
  if (causal) n_tiles = min(n_tiles, (q0 + BT - 1 + ts_off) / BT + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BT;
    __syncthreads();                   // previous tile's K / V / dS reads done
    load_tile<D>(Ks, kg + (size_t)kv0 * D, C::LDH);
    load_tile<D>(Vs, vg + (size_t)kv0 * D, C::LDH);
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T for this warp's 16 rows x CW columns
    mma_nt<D, C::CW / 16>(Ss + rg * 16 * C::LDS + sp * C::CW, C::LDS,
                          Qs + rg * 16 * C::LDH,
                          Ks + sp * C::CW * C::LDH, C::LDH);
    mma_nt<D, C::CW / 16>(dPs + rg * 16 * C::LDS + sp * C::CW, C::LDS,
                          dOs + rg * 16 * C::LDH,
                          Vs + sp * C::CW * C::LDH, C::LDH);
    __syncwarp();

    const float* srow = Ss + row * C::LDS + c0;
    const float* prow = dPs + row * C::LDS + c0;
    bf16* drow = dSs + row * C::LDP + c0;
    for (int j = 0; j < C::CW / 2; ++j) {
      float s = srow[j] * sm_scale;
      if (causal && kv0 + c0 + j > grow + ts_off) s = MASK_VALUE;
      const float p = expf(s - lse_r);
      drow[j] = __float2bfloat16(p * (prow[j] - delta_r) * sm_scale);
    }
    __syncthreads();                   // the other half's dS columns

    // dQ (16 x 128 of this warp) += dS (16 x 64) . K (64 x 128)
    mma_acc(acc, dSs + rg * 16 * C::LDP, C::LDP, Ks + sp * DW, C::LDH);
  }

  __syncthreads();                     // Ss is free: stage through it
  store_acc<D>(dq + qbase + (size_t)rg * 16 * D + sp * DW, acc,
               Ss + warp * 16 * LDX, lane);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Hkv, int S, int T,
                     int causal, float sm_scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + C::tile);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * C::tile);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * C::tile);
  float* STs = reinterpret_cast<float*>(smem + 4 * C::tile);
  float* dPTs = reinterpret_cast<float*>(smem + 4 * C::tile + C::sc32);
  bf16* PTs = reinterpret_cast<bf16*>(smem + 4 * C::tile + 2 * C::sc32);
  bf16* dSTs =
      reinterpret_cast<bf16*>(smem + 4 * C::tile + 2 * C::sc32 + C::sc16);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * C::tile + 2 * C::sc32 +
                                          2 * C::sc16);
  float* delta_s = lse_s + BT;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int kv0 = kt * BT;
  const int ts_off = T - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4;            // row group: 16 kv rows
  const int sp = warp / 4;            // which half of D / of the columns

  const size_t kbase = (((size_t)b * Hkv + hk) * T + kv0) * D;
  load_tile<D>(Ks, k + kbase, C::LDH);
  load_tile<D>(Vs, v + kbase, C::LDH);

  // this lane's kv row of the warp's 16 and its share of the q columns
  const int row = rg * 16 + (lane >> 1);
  const int c0 = sp * C::CW + (lane & 1) * (C::CW / 2);
  const int gk = kv0 + row;

  AccFrag dk_acc[NF], dv_acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  // first q tile with a row that sees this kv tile (bottom-right diagonal)
  int qt0 = 0;
  if (causal) {
    const int lo = kv0 - ts_off - (BT - 1);
    qt0 = lo <= 0 ? 0 : (lo + BT - 1) / BT;
  }

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const size_t hbase = ((size_t)b * H + h) * S;
    for (int qt = qt0; qt < S / BT; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                 // previous Q / dO / P^T / dS^T reads
      load_tile<D>(Qs, q + (hbase + q0) * D, C::LDH);
      load_tile<D>(dOs, dO + (hbase + q0) * D, C::LDH);
      if (threadIdx.x < BT) {
        lse_s[threadIdx.x] = lse[hbase + q0 + threadIdx.x];
        delta_s[threadIdx.x] = delta[hbase + q0 + threadIdx.x];
      }
      __syncthreads();

      // S^T = K.Q^T and dP^T = V.dO^T: this warp's 16 kv rows x CW q cols
      mma_nt<D, C::CW / 16>(STs + rg * 16 * C::LDS + sp * C::CW, C::LDS,
                            Ks + rg * 16 * C::LDH,
                            Qs + sp * C::CW * C::LDH, C::LDH);
      mma_nt<D, C::CW / 16>(dPTs + rg * 16 * C::LDS + sp * C::CW, C::LDS,
                            Vs + rg * 16 * C::LDH,
                            dOs + sp * C::CW * C::LDH, C::LDH);
      __syncwarp();

      const float* srow = STs + row * C::LDS + c0;
      const float* prow = dPTs + row * C::LDS + c0;
      bf16* pt = PTs + row * C::LDP + c0;
      bf16* dst = dSTs + row * C::LDP + c0;
      for (int j = 0; j < C::CW / 2; ++j) {
        const int qi = c0 + j;
        float s = srow[j] * sm_scale;
        if (causal && gk > q0 + qi + ts_off) s = MASK_VALUE;
        const float p = expf(s - lse_s[qi]);
        pt[j] = __float2bfloat16(p);
        dst[j] = __float2bfloat16(p * (prow[j] - delta_s[qi]) * sm_scale);
      }
      __syncthreads();                 // the other half's q columns

      // dV += P^T (16 x 64) . dO (64 x 128),  dK += dS^T . Q
      mma_acc(dv_acc, PTs + rg * 16 * C::LDP, C::LDP, dOs + sp * DW, C::LDH);
      mma_acc(dk_acc, dSTs + rg * 16 * C::LDP, C::LDP, Qs + sp * DW, C::LDH);
    }
  }

  __syncthreads();                     // STs is free: stage through it
  float* stage = STs + warp * 16 * LDX;
  const size_t obase = kbase + (size_t)rg * 16 * D + sp * DW;
  store_acc<D>(dk + obase, dk_acc, stage, lane);
  store_acc<D>(dv + obase, dv_acc, stage, lane);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Hkv, int S, int T, int causal, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = Cfg<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BT, H, B);
  flash_bwd_dq_kernel<D><<<grid, Cfg<D>::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Hkv, S, T, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Hkv, int S, int T, int causal, float sm_scale,
               cudaStream_t stream) {
  const size_t smem = Cfg<D>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T / BT, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, Cfg<D>::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, S, T, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dO (B,H,S,D), k/v (B,Hkv,T,D) bf16 contiguous; lse, delta (B,H,S)
// fp32; dq (B,H,S,D) bf16.  S % 64 == 0, T % 64 == 0, D in {128, 256},
// H % Hkv == 0, T >= S when causal.  Returns the launch's cudaError_t.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int Hkv, int S,
                                      int T, int D, int causal,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dq<128>(q, k, v, dO, lse, delta, dq, B, H, Hkv, S, T,
                          causal, sm_scale, st);
  if (D == 256)
    return launch_dq<256>(q, k, v, dO, lse, delta, dq, B, H, Hkv, S, T,
                          causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// Same inputs; dk, dv (B,Hkv,T,D) bf16, already summed over each KV head's
// group of query heads.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dO,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Hkv, int S, int T, int D,
                                       int causal, float sm_scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv, S, T,
                           causal, sm_scale, st);
  if (D == 256)
    return launch_dkv<256>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv, S, T,
                           causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
