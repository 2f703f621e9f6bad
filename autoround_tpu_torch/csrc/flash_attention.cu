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
// Design (the register-resident FlashAttention-2 form on mma.sync): one
// block per (q-tile of 64 rows, head, batch), 4 warps of 16 query rows,
// loops over the KV tiles (the TPU's sequential 4th grid axis becomes this
// loop; nothing carries between blocks).  Q.K^T and P.V run on
// mma.sync.m16n8k16 bf16 with fp32 accumulators in registers:
//  * Q is loaded once; at D = 128 it stays in registers as A fragments
//    (ldmatrix), at D = 256 it is re-read from shared memory per tile (the
//    128 fp32 output values a lane holds leave no room for it).
//  * S = Q.K^T stays in registers.  The online softmax runs on them: row
//    max and row sum over the 4 lanes that share a row (shuffles), scores
//    in log2 units (ex2.approx), lse returned in natural-log units.
//  * P is packed from the S accumulators straight into bf16 A fragments
//    (the C layout of m16n8k16 is the A layout of the next product), so P
//    is rounded to bf16 before P.V while l sums the fp32 p, as
//    flash_attention_ref does.
//  * O accumulates in registers, is rescaled by alpha there and normalised
//    once in the epilogue (l == 0 guard as in the JAX kernel), which writes
//    it through shared memory with 16-byte stores.
//  * K/V tiles run through a two-stage ring in dynamic shared memory filled
//    by cp.async.cg: tile t+1 loads while tile t computes; one barrier per
//    tile.  Rows are stored with their 16-byte chunks XOR-swizzled by the
//    row index, so ldmatrix of K (B of Q.K^T) and ldmatrix.trans of V (B of
//    P.V) are free of bank conflicts.
// KV tile: 64 rows at D = 128 (80 KB of shared memory, two blocks per SM),
// 32 at D = 256 (96 KB, two blocks per SM), so T % 64 == 0 means whole
// tiles.  GQA reads KV head h / rep directly.  The causal mask is anchored
// bottom-right (col <= row + T - S): fully masked KV tiles are skipped, only
// the diagonal tiles compute the mask, with -0.7 * FLT_MAX as the JAX kernel
// does; causal blocks start with the longest q-tiles.  Bounded by mma.sync
// (no wgmma) and by every warp reading the whole K and V tile through
// ldmatrix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

using namespace ptx;

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;       // query rows per block
constexpr int NWARP = 4;     // 16 query rows per warp
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int BKV = D == 128 ? 64 : 32;      // kv rows per tile
  static constexpr bool Q_IN_REGS = D == 128;
  static constexpr size_t bytes = sizeof(bf16) * (BQ + 4 * BKV) * D;
};

// element offset of 16-byte chunk c of row r in a swizzled tile of width D
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// rows x D bf16 from global (row stride D) into a swizzled shared tile
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NWARP * 32) {
    const int r = i / CH, c = i % CH;
    cp_async<16>(dst + swz<D>(r, c), src + (size_t)r * D + c * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(NWARP * 32, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int S, int T,
                 int causal, float sm_scale) {
  constexpr int BKV = Cfg<D>::BKV;
  constexpr int NT = BKV / 8;          // score n-tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * D;              // two stages
  bf16* Vs = Ks + 2 * BKV * D;         // two stages

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int ts_off = T - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;     // the warp's first query row
  const float c_log2 = sm_scale * LOG2E;

  const bf16* qg = q + (((size_t)b * H + h) * S + q0) * D;
  const bf16* kg = k + ((size_t)b * Hkv + hk) * T * D;
  const bf16* vg = v + ((size_t)b * Hkv + hk) * T * D;

  int n_tiles = T / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1 + ts_off) / BKV + 1);

  load_tile<D>(Qs, qg, BQ);
  load_tile<D>(Ks, kg, BKV);
  load_tile<D>(Vs, vg, BKV);
  cp_commit();

  uint32_t qf[Cfg<D>::Q_IN_REGS ? D / 16 : 1][4];
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    cp_wait<0>();
    __syncthreads();                   // tile it landed; tile it-1 is done
    if (it + 1 < n_tiles) {
      load_tile<D>(Ks + (st ^ 1) * BKV * D, kg + (size_t)(it + 1) * BKV * D,
                   BKV);
      load_tile<D>(Vs + (st ^ 1) * BKV * D, vg + (size_t)(it + 1) * BKV * D,
                   BKV);
    }
    cp_commit();
    if constexpr (Cfg<D>::Q_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[kk],
                  Qs + swz<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
      }
    }
    const int kv0 = it * BKV;
    // this warp's rows see no column of this tile
    if (causal && kv0 > wrow + 15 + ts_off) continue;

    // S (16 x BKV) = Q_w . K^T, in registers
    const bf16* Kt = Ks + st * BKV * D;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (Cfg<D>::Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, Qs + swz<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                kk * 2 + ((lane >> 3) & 1)));
        mma16816(s[2 * np], a, bk[0], bk[1]);
        mma16816(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scores in log2 units; the mask only in diagonal tiles
    const bool diag = causal && kv0 + BKV - 1 > wrow + ts_off;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * c_log2;
        if (diag) {
          const int col = kv0 + 8 * j + 2 * t + (e & 1);
          const int row = wrow + g + 8 * (e >> 1);
          if (col > row + ts_off) x = MASK_VALUE;
        }
        s[j][e] = x;
      }

    // online softmax on the registers: lane holds rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float p0 = ex2(s[j][2 * r] - m_new);
        const float p1 = ex2(s[j][2 * r + 1] - m_new);
        l[r] += p0 + p1;
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
      }
    }

    // O_w (16 x D) += bf16(P_w) (16 x BKV) . V (BKV x D)
    const bf16* Vt = Vs + st * BKV * D;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + swz<D>(kk * 16 + (lane & 15), dp * 2 + (lane >> 4)));
        mma16816(o[2 * dp], a, bv[0], bv[1]);
        mma16816(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

  // epilogue: the quad's partial sums, normalise, O through the warp's own
  // (no longer read) rows of Qs, 16-byte stores; lse in natural-log units
  cp_wait<0>();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = (l[r] == 0.f) ? 1.f : 1.f / l[r];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(Qs + swz<D>(row, j) + 2 * t) =
          pack_bf16(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
    }
  __syncwarp();
  constexpr int CH = D / 8;
  bf16* og = out + (((size_t)b * H + h) * S + wrow) * D;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(og + (size_t)r * D + c * 8) =
        *reinterpret_cast<const uint4*>(Qs + swz<D>(warp * 16 + r, c));
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[((size_t)b * H + h) * S + wrow + g + 8 * r] =
          m[r] * LN2 + logf(l[r] == 0.f ? 1.f : l[r]);
  }
}

template <int D>
int fwd_info(int* out) {
  const int smem = (int)Cfg<D>::bytes;
  int blocks = 0;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, flash_fwd_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_fwd_kernel<D>, NWARP * 32, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Hkv, int S, int T, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Cfg<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Hkv, S, T, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,S,D), k/v (B,Hkv,T,D) bf16 contiguous; out (B,H,S,D) bf16,
// lse (B,H,S) fp32.  S % 64 == 0, T % 64 == 0, D in {128, 256}, H % Hkv == 0,
// T >= S when causal.  Returns the cudaError_t of the launch (0 on success).
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

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the
// D = 128 or 256 instance into info[0..3].  Returns a cudaError_t.
extern "C" int flash_attention_fwd_info(int D, int* info) {
  if (D == 128) return fwd_info<128>(info);
  if (D == 256) return fwd_info<256>(info);
  return (int)cudaErrorInvalidValue;
}
