// INT8-QK (SageAttention-style) attention forward, bf16 in / out.
//
// Replaces: autoround_tpu/ops/sage_attention.py, `sage_attention` ->
// `_kernel` (the Pallas TPU kernel: smoothed per-token int8 q and k, int32
// QK^T on the MXU, fp32 online softmax, bf16 P.V).
//
// What it computes (the contract of `sage_attention_ref`, in the division
// form the jitted JAX op compiles to): with k_mean the per-(batch, kv head)
// mean key over all T (one torch reduction before the launch),
//   qs = max(amax(q_row), 1e-8) * fp32(1/127),  qi = rint(q / qs)
//   ks = max(amax(k_row - k_mean), 1e-8) * fp32(1/127),
//   ki = rint((k - k_mean) / ks)
//   s  = ((float(qi . ki) * qs) * ks) * fp32(1/sqrt(D))
// (IEEE divisions, round half to even: the codes and scales are the plain
// version's bit for bit; the scale order is the reference's), the
// bottom-right causal mask (col <= row + T - S, masked value -0.7 *
// FLT_MAX), softmax in fp32, P rounded to bf16, P.V summed in fp32.
//
// What bounds it on an H100: at the prefill shapes (S = T = 512, D = 128,
// 32 heads, GQA 4) the bytes of q, k, v and the output (0.025 ms at 3.35
// TB/s) outweigh the operations (half of them int8 at 1979 TOP/s, half
// bf16 at 989 TFLOP/s); at S = 2048 the operations bound it.
//
// Design (simple on purpose): one
// block per (q tile of 64 rows, head, batch) loops over the kv tiles of 64
// keys, skipping those wholly above the causal diagonal; 4 warps, 16 query
// rows each.  The block quantizes its q tile once and each k tile as it
// arrives, in shared memory: a warp per row, each lane holding D / 32
// values (the lane's share of k_mean stays in registers), the row's amax
// by warp shuffles.  QK^T runs on `mma.sync.m16n8k32.s32.s8.s8.s32` (the
// fragment layout of `a8_tiles.cuh`): each warp's 16 x 64 int32 scores stay
// in registers, are dequantized there and stored as fp32 for the online
// softmax (two lanes per row, m and l in fp32).  P.V runs on bf16 WMMA
// with the running output in shared memory as fp32.  No cp.async / TMA /
// wgmma, single-buffered: right first.

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

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct Smem {
  static constexpr int LDI = D + 16;     // int8 row stride (Qi, Ki), bytes
  static constexpr int LDH = D + 8;      // bf16 row stride (V)
  static constexpr int LDS = BKV + 4;    // fp32 score row stride
  static constexpr int LDP = BKV + 8;    // bf16 probability row stride
  static constexpr int LDO = D + 4;      // fp32 output row stride
  static constexpr size_t qi_off = 0;
  static constexpr size_t ki_off = qi_off + align128((size_t)BQ * LDI);
  static constexpr size_t v_off = ki_off + align128((size_t)BKV * LDI);
  static constexpr size_t s_off = v_off + align128(2 * (size_t)BKV * LDH);
  static constexpr size_t p_off = s_off + align128(4 * (size_t)BQ * LDS);
  static constexpr size_t o_off = p_off + align128(2 * (size_t)BQ * LDP);
  static constexpr size_t qs_off = o_off + align128(4 * (size_t)BQ * LDO);
  static constexpr size_t ks_off = qs_off + align128(4 * BQ);
  static constexpr size_t bytes = ks_off + align128(4 * BKV);
};

// D (16 x 8, int32) += A (16 x 32, int8, row) . B (32 x 8, int8, col);
// the fragment layout is the one `a8_tiles.cuh` documents.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// EPL = D / 32 bf16 values of a row, this lane's, as fp32.
template <int EPL>
__device__ __forceinline__ void load_row_part(const __nv_bfloat16* src,
                                              float* f) {
  if constexpr (EPL == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// Quantize one row held across the warp (EPL fp32 values a lane): the
// row's scale max(amax, 1e-8) * fp32(1/127) and codes rint(x / scale),
// written to dst (EPL bytes a lane) and, from lane 0, to *scale.
template <int EPL>
__device__ __forceinline__ void quantize_row(const float* f, int lane,
                                             int8_t* dst, float* scale) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(f[e]));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  uint32_t w[EPL / 4];
#pragma unroll
  for (int i = 0; i < EPL / 4; ++i) {
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = __float2int_rn(__fdiv_rn(f[4 * i + e], s));
      word |= (uint32_t)(c & 0xFF) << (8 * e);
    }
    w[i] = word;
  }
  if constexpr (EPL == 4) {
    *reinterpret_cast<uint32_t*>(dst + lane * 4) = w[0];
  } else {
    *reinterpret_cast<uint2*>(dst + lane * 8) = make_uint2(w[0], w[1]);
  }
  if (lane == 0) *scale = s;
}

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
sage_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ k_mean,
                __nv_bfloat16* __restrict__ out, int H, int Hkv, int S,
                int T, int causal, float rsd) {
  using L = Smem<D>;
  constexpr int EPL = D / 32;            // values of a row per lane
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Qi = reinterpret_cast<int8_t*>(smem + L::qi_off);
  int8_t* Ki = reinterpret_cast<int8_t*>(smem + L::ki_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* qsc = reinterpret_cast<float*>(smem + L::qs_off);
  float* ksc = reinterpret_cast<float*>(smem + L::ks_off);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int ts_off = T - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t4 = lane % 4;

  const __nv_bfloat16* qg = q + (((size_t)b * H + h) * S + q0) * D;
  const __nv_bfloat16* kg = k + ((size_t)b * Hkv + hk) * T * D;
  const __nv_bfloat16* vg = v + ((size_t)b * Hkv + hk) * T * D;

  // this lane's columns of the mean key, kept for every k tile
  float km[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    km[e] = __ldg(k_mean + ((size_t)b * Hkv + hk) * D + lane * EPL + e);

  // the q tile, quantized once: warp w takes rows 16w .. 16w + 15
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float f[EPL];
    load_row_part<EPL>(qg + (size_t)r * D + lane * EPL, f);
    quantize_row<EPL>(f, lane, Qi + r * L::LDI, qsc + r);
  }
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
    __syncthreads();                     // previous tile's reads done
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float f[EPL];
      load_row_part<EPL>(kg + (size_t)(kv0 + r) * D + lane * EPL, f);
#pragma unroll
      for (int e = 0; e < EPL; ++e) f[e] = __fsub_rn(f[e], km[e]);
      quantize_row<EPL>(f, lane, Ki + r * L::LDI, ksc + r);
    }
    load_tile<D>(Vs, vg + (size_t)kv0 * D, BKV, L::LDH);
    __syncthreads();

    // S_w (16 x 64) = Qi_w (16 x D) . Ki^T in int32, 8 n-tiles of 8 keys
    int acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
    for (int ks = 0; ks < D; ks += 32) {
      uint32_t a[4];
      const int8_t* pa = Qi + (warp * 16 + gid) * L::LDI + ks + t4 * 4;
      a[0] = *reinterpret_cast<const uint32_t*>(pa);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * L::LDI);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * L::LDI + 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bb[2];
        const int8_t* pb = Ki + (j * 8 + gid) * L::LDI + ks + t4 * 4;
        bb[0] = *reinterpret_cast<const uint32_t*>(pb);
        bb[1] = *reinterpret_cast<const uint32_t*>(pb + 16);
        mma_s8(acc[j], a, bb);
      }
    }
    // dequantize in the reference's order and stage as fp32
    {
      const int r0 = warp * 16 + gid;
      const float qa = qsc[r0], qb = qsc[r0 + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8, c = j * 8 + t4 * 2 + (e & 1);
          const float qsr = (e >> 1) ? qb : qa;
          Ss[r * L::LDS + c] = __fmul_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[j][e]), qsr), ksc[c]),
              rsd);
        }
    }
    __syncwarp();

    // online softmax on this lane's 32 columns of its row
    float* srow = Ss + row * L::LDS + half * 32;
    float mx = -INFINITY;
    for (int j = 0; j < 32; ++j) {
      float s = srow[j];
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
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      float* optr = Os + warp * 16 * L::LDO + n * 16;
      wmma::load_matrix_sync(o, optr, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(o, pa, vb, o);
      }
      wmma::store_matrix_sync(optr, o, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // epilogue: normalise (l == 0 guard as in the JAX kernel) and write O
  const float inv = (l_i == 0.f) ? 1.f : 1.f / l_i;
  const float* orow = Os + row * L::LDO + half * (D / 2);
  __nv_bfloat16* og = out + (((size_t)b * H + h) * S + grow) * D + half * (D / 2);
  for (int j = 0; j < D / 2; ++j) og[j] = __float2bfloat16(orow[j] * inv);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* km,
           void* out, int B, int H, int Hkv, int S, int T, int causal,
           float rsd, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      sage_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BQ, H, B);
  sage_fwd_kernel<D><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(km),
      static_cast<__nv_bfloat16*>(out), H, Hkv, S, T, causal, rsd);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,S,D), k/v (B,Hkv,T,D) bf16 contiguous; k_mean (B,Hkv,D) fp32;
// out (B,H,S,D) bf16.  S % 64 == 0, T % 64 == 0, D in {128, 256},
// H % Hkv == 0, T >= S when causal; rsd = fp32(1 / sqrt(D)).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sage_attention_fwd(const void* q, const void* k,
                                  const void* v, const void* k_mean,
                                  void* out, int B, int H, int Hkv, int S,
                                  int T, int D, int causal, float rsd,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || S % BQ || T <= 0
      || T % BKV || (causal && T < S) || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return launch<128>(q, k, v, k_mean, out, B, H, Hkv, S, T, causal, rsd,
                       st);
  if (D == 256)
    return launch<256>(q, k, v, k_mean, out, B, H, Hkv, S, T, causal, rsd,
                       st);
  return (int)cudaErrorInvalidValue;
}
