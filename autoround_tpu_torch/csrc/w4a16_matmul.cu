// W4A16 dequant-matmul: y = x . ((code - 8) * scale)^T, bf16 in/out.
//
// Replaces: autoround_tpu/ops/qmatmul.py, `w4a16_matmul` -> `_kernel`
// (the Pallas TPU kernel over the nibble-plane layout).
//
// Layout (the port's own, chosen for coalesced 16-byte loads on the card):
// qweight (O, K/8) int32, word w of row o holds the codes of columns
// 8w..8w+7, column 8w+j in nibble j.  scales (O, K/g) fp32, signed: the
// sign carries the full-range flip of the symmetric quantizer, so nothing
// here takes an abs or a log.
//
// What bounds it on an H100:
//  * decode (M = batch <= 32): ~0.5 byte of codes per weight against 2*M
//    operations per weight, far below the card's ~295 operations per byte:
//    the weight stream from memory bounds it.  `gemv_kernel` streams each
//    row's codes once with 16-byte coalesced loads (32 codes per lane),
//    dequantizes each code once into fp32 registers and reuses it for all
//    M activation rows, accumulates in fp32 and reduces across the block
//    (warp shuffles, then shared memory).  Each block owns R output rows
//    and splits K over its 4 warps, so even O = 4096 gives ~1000 blocks.
//    At M = 8 the M fp32 FMAs per weight on the CUDA cores come close to
//    the memory time; that is the next thing to move to tensor cores.
//  * prefill (M = B*S in the thousands): 2*M operations per weight, the
//    tensor cores bound it.  `gemm_kernel` tiles M x O x K as 128 x 128 x
//    32: each block dequantizes its 128 x 32 weight tile ONCE into shared
//    memory as bf16 ((code - 8) * scale rounded to bf16, exactly what the
//    plain version does) and runs WMMA bf16 16x16x16 with fp32
//    accumulation over it for all 128 activation rows of its M tile.
// The ragged M and O edges are masked in the kernels (zero-filled tiles,
// guarded stores).  Needs K % 32 == 0 and g % 32 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// code in [0, 15] -> (code - 8) as fp32: the magic-number conversion
// 0x4B000000 | c is the float 2^23 + c exactly.
__device__ __forceinline__ float code_m8(uint32_t word, int j) {
  uint32_t c = (word >> (4 * j)) & 0xFu;
  return __uint_as_float(0x4B000000u | c) - 8388616.0f;   // 2^23 + 8
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

constexpr int GEMV_WARPS = 4;

// MT: activation rows held in registers (power of two >= M); R: output
// rows per block.  Lane l of warp w handles 32-code chunks c = w*32 + l,
// stepping by 128 chunks.
template <int MT, int R>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv_kernel(const __nv_bfloat16* __restrict__ x,
            const uint32_t* __restrict__ qw, const float* __restrict__ sc,
            __nv_bfloat16* __restrict__ y, int M, int K, int O, int g) {
  __shared__ float red[GEMV_WARPS][R][MT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o0 = blockIdx.x * R;
  const int n_chunks = K / 32;
  const int kw = K / 8;                   // words per row
  const int ng = K / g;                   // groups per row

  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  for (int c = warp * 32 + lane; c < n_chunks; c += GEMV_WARPS * 32) {
    uint4 wv[R];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = o0 + r;
      if (o < O) {
        wv[r] = __ldg(reinterpret_cast<const uint4*>(qw + (size_t)o * kw) + c);
        s[r] = __ldg(sc + (size_t)o * ng + (c * 32) / g);
      } else {
        wv[r] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u,
                           0x88888888u);
        s[r] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {         // the 4 words of the chunk
      float wf[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t word = (q == 0) ? wv[r].x : (q == 1) ? wv[r].y
                            : (q == 2) ? wv[r].z : wv[r].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) wf[r][j] = code_m8(word, j) * s[r];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          float xf[8];
          bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(
                            x + (size_t)m * K + c * 32 + q * 8)), xf);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][m] = fmaf(xf[j], wf[r][j],
                                                         acc[r][m]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[r][m];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r][m] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < R * MT; i += blockDim.x) {
    const int r = i / MT, m = i % MT;
    const int o = o0 + r;
    if (o < O && m < M) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < GEMV_WARPS; ++w) v += red[w][r][m];
      y[(size_t)m * O + o] = __float2bfloat16(v);
    }
  }
}

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDT = BK + 8;               // bf16 row stride of the tiles
constexpr int GEMM_THREADS = 256;         // 8 warps: 2 (M) x 4 (N)

__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const uint32_t* __restrict__ qw, const float* __restrict__ sc,
            __nv_bfloat16* __restrict__ y, int M, int K, int O, int g) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDT];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * LDT];
  __shared__ __align__(128) float stage[GEMM_THREADS / 32][16 * 16];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;   // warp tile 64 (M) x 32 (N)
  const int kw = K / 8, ng = K / g;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: 128 rows x 32 bf16 = 4 x 16 bytes per row
    for (int i = threadIdx.x; i < BM * 4; i += GEMM_THREADS) {
      const int r = i / 4, cv = (i % 4) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        val = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + k0 + cv));
      *reinterpret_cast<uint4*>(As + r * LDT + cv) = val;
    }
    // weight tile: 128 rows x 32 codes; two threads per row, 16 codes each
    {
      const int r = threadIdx.x / 2, hlf = threadIdx.x % 2;
      const int o = n0 + r;
      uint2 wv = make_uint2(0x88888888u, 0x88888888u);
      float s = 0.f;
      if (o < O) {
        wv = __ldg(reinterpret_cast<const uint2*>(
            qw + (size_t)o * kw + k0 / 8 + hlf * 2));
        s = __ldg(sc + (size_t)o * ng + k0 / g);
      }
      __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        vals[j] = __float2bfloat16(code_m8(wv.x, j) * s);
        vals[8 + j] = __float2bfloat16(code_m8(wv.y, j) * s);
      }
      uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDT + hlf * 16);
      dst[0] = *reinterpret_cast<const uint4*>(vals);
      dst[1] = *reinterpret_cast<const uint4*>(vals + 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDT + kk, LDT);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                   acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rr = lane / 2, cc = (lane % 2) * 8;
      const int m = m0 + wm * 64 + i * 16 + rr;
      const int nb = n0 + wn * 32 + j * 16 + cc;
      if (m < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (nb + e < O)
            y[(size_t)m * O + nb + e] = __float2bfloat16(st[rr * 16 + cc + e]);
      }
      __syncwarp();
    }
}

template <int MT, int R>
void launch_gemv(const void* x, const void* qw, const void* sc, void* y, int M,
                 int K, int O, int g, cudaStream_t st) {
  dim3 grid((O + R - 1) / R);
  gemv_kernel<MT, R><<<grid, GEMV_WARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(sc), static_cast<__nv_bfloat16*>(y), M, K, O,
      g);
}

}  // namespace

// x (M, K) bf16, qweight (O, K/8) int32, scales (O, K/g) fp32, y (M, O)
// bf16, all contiguous.  M >= 1, K % 32 == 0, g % 32 == 0, K % g == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int w4a16_matmul(const void* x, const void* qw, const void* sc,
                            void* y, int M, int K, int O, int g,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K % 32 || g % 32 || K % g) return (int)cudaErrorInvalidValue;
  if (M == 1)       launch_gemv<1, 4>(x, qw, sc, y, M, K, O, g, st);
  else if (M <= 2)  launch_gemv<2, 4>(x, qw, sc, y, M, K, O, g, st);
  else if (M <= 4)  launch_gemv<4, 4>(x, qw, sc, y, M, K, O, g, st);
  else if (M <= 8)  launch_gemv<8, 4>(x, qw, sc, y, M, K, O, g, st);
  else if (M <= 16) launch_gemv<16, 2>(x, qw, sc, y, M, K, O, g, st);
  else if (M <= 32) launch_gemv<32, 1>(x, qw, sc, y, M, K, O, g, st);
  else {
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<<<grid, GEMM_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const uint32_t*>(qw), static_cast<const float*>(sc),
        static_cast<__nv_bfloat16*>(y), M, K, O, g);
  }
  return (int)cudaGetLastError();
}
