// Tile bodies shared by the A16 dequant-matmul family:
//   w4a16_matmul.cu          y    = x    . ((code - 8)  * scale)^T
//   w4a16_matmul_grouped.cu  y[e] = x[e] . ((code[e] - 8) * scale[e])^T
//   w4a16_asym_matmul.cu     y    = x    . ((code - zp) * scale)^T
//   w8a16_matmul.cu          y    = x    . (Wi * scale)^T        (Wi int8)
//   w2a16_matmul.cu          y    = x    . ((code - 2)  * scale)^T  (2-bit)
//   fp8_matmul.cu            y    = (x   . e4m3(W)^T) * scale_row
//   mxfp4_matmul.cu          y    = x    . (e2m1(code)  * scale)^T
// bf16 activations in and out, fp32 accumulation.  The bodies are templated
// on the weight format (SYM4, ASYM4, INT8, INT2, E4M3, E2M1): it decides how
// a chunk of a weight row is read and dequantized, and where the scale
// enters, nothing else.
//
// Layout (the port's own, chosen for coalesced loads on the card):
// qweight (E, O, K/8) int32, word w of row o holds the codes of columns
// 8w..8w+7, column 8w+j in nibble j (SYM4, ASYM4; E2M1 codes likewise);
// INT2: (O, K/16) int32, column 16w+j in bits 2j..2j+1 of word w; INT8 and
// E4M3: (E, O, K) bytes as they lie.  scales (E, O, K/g) fp32, signed: the
// sign carries the full-range flip of the symmetric quantizer, so nothing
// here takes an abs or a log; E4M3 has one scale per output row, applied to
// the fp32 sum (as the TPU kernel does).  zps (O, K/g) fp32 for the asym
// kernel (may be fractional); the sym kernels use the constant 8 (INT2: 2),
// the float formats have none.
//
// The expert is a grid axis (y of the GEMV grid, z of the GEMM grid): block
// (.., e) offsets every pointer by its expert's slab, so one launch serves
// all E experts.  The activation's expert stride is a parameter: 0 means
// all experts read the same (M, K) rows (dense-then-mask routing), which
// then stay in L2 instead of being copied E times.  E = 1 is the ungrouped
// product.
//
// What bounds it on an H100:
//  * decode (M = batch <= 32): ~0.5 byte of codes per weight (INT8, E4M3:
//    1; INT2: 0.25) against 2*M operations per weight, far below the card's
//    ~295 operations per byte:
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
//    memory as bf16 ((code - zero) * scale rounded to bf16, exactly what
//    the plain version does) and runs WMMA bf16 16x16x16 with fp32
//    accumulation over it for all 128 activation rows of its M tile.
// The ragged M and O edges are masked in the kernels (zero-filled tiles,
// guarded stores).  Needs K % 32 == 0 and g % 32 == 0 (SYM4, ASYM4, E2M1:
// g % 16 == 0, so one 32-column GEMV chunk may span two groups; E4M3: g =
// K).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace w4a16 {

using namespace nvcuda;

// code in [0, 15] -> (code - zero) as fp32.  The magic-number conversion
// 0x4B000000 | c is the float 2^23 + c exactly; the sym kernels fold their
// zero of 8 into the same subtraction, the asym kernels subtract their
// (possibly fractional) zero point in a second exact-input step.
constexpr int SYM4 = 0, ASYM4 = 1, INT8 = 2, INT2 = 3, E4M3 = 4, E2M1 = 5;

template <int FMT>
__device__ __forceinline__ float code_minus_zero(uint32_t word, int j,
                                                 float zero) {
  uint32_t c = (word >> (4 * j)) & 0xFu;
  if (FMT == ASYM4)
    return (__uint_as_float(0x4B000000u | c) - 8388608.0f) - zero;
  return __uint_as_float(0x4B000000u | c) - 8388616.0f;   // 2^23 + 8
}

// byte j of `word` (an int8) as fp32: (b ^ 0x80) is b + 128 unsigned, and
// 0x4B000000 | u is the float 2^23 + u exactly.
__device__ __forceinline__ float s8_to_f32(uint32_t word, int j) {
  const uint32_t u = __byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7650 + j);
  return __uint_as_float(u) - 8388736.0f;            // 2^23 + 128
}

// e4m3 byte j of `word` as fp32, exactly: its 7 magnitude bits placed at
// bit 20 of an fp32 are the same number times 2^-120 (normals and, as fp32
// subnormals, the e4m3 subnormals alike).  0x7F / 0xFF (NaN) never occur:
// the quantizer clips to 448 first.
__device__ __forceinline__ float e4m3_to_f32(uint32_t word, int j) {
  const uint32_t b = (word >> (8 * j)) & 0xFFu;
  return __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20))
         * 0x1p120f;
}

// e2m1 nibble j of `word` as fp32, exactly: sign to bit 31, the 3 bits of
// exponent and mantissa to bit 22 give the value times 2^-126 (the
// subnormal 0.5 included): {0, .5, 1, 1.5, 2, 3, 4, 6} and their negatives.
__device__ __forceinline__ float e2m1_to_f32(uint32_t word, int j) {
  const uint32_t c = (word >> (4 * j)) & 0xFu;
  return __uint_as_float(((c & 8u) << 28) | ((c & 7u) << 22)) * 0x1p126f;
}

// 2-bit code j of `word` minus 2 as fp32 (the magic-number conversion).
__device__ __forceinline__ float c2_minus_two(uint32_t word, int j) {
  return __uint_as_float(0x4B000000u | ((word >> (2 * j)) & 3u))
         - 8388610.0f;                                 // 2^23 + 2
}

// Formats that take g = 16 (a 32-column GEMV chunk then spans two groups);
// the others need g % 32 == 0.
template <int FMT>
constexpr bool G16 = FMT == SYM4 || FMT == ASYM4 || FMT == E2M1;

// Weights of one chunk of a row that a GEMV lane loads (16 bytes; INT2: 8
// bytes), and bytes in a row of K weights.
template <int FMT>
constexpr int CHUNK = (FMT == INT8 || FMT == E4M3) ? 16 : 32;
template <int FMT>
__device__ __forceinline__ size_t row_bytes(int K) {
  return (FMT == INT8 || FMT == E4M3) ? (size_t)K
         : FMT == INT2 ? (size_t)K / 4 : (size_t)K / 2;
}

// Weights 8q..8q+7 of the 16-byte chunk `wv`, dequantized into wf.
template <int FMT>
__device__ __forceinline__ void dequant8(const uint4& wv, int q, float z,
                                         float s, float* wf) {
  if (FMT == INT8 || FMT == E4M3) {
    const uint32_t w0 = q == 0 ? wv.x : wv.z, w1 = q == 0 ? wv.y : wv.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (FMT == INT8) {
        wf[j] = s8_to_f32(w0, j) * s;
        wf[4 + j] = s8_to_f32(w1, j) * s;
      } else {
        wf[j] = e4m3_to_f32(w0, j);
        wf[4 + j] = e4m3_to_f32(w1, j);
      }
    }
  } else if (FMT == INT2) {
    const uint32_t word = q < 2 ? wv.x : wv.y;
#pragma unroll
    for (int j = 0; j < 8; ++j) wf[j] = c2_minus_two(word, 8 * (q & 1) + j) * s;
  } else if (FMT == E2M1) {
    const uint32_t word = (q == 0) ? wv.x : (q == 1) ? wv.y
                        : (q == 2) ? wv.z : wv.w;
#pragma unroll
    for (int j = 0; j < 8; ++j) wf[j] = e2m1_to_f32(word, j) * s;
  } else {
    const uint32_t word = (q == 0) ? wv.x : (q == 1) ? wv.y
                        : (q == 2) ? wv.z : wv.w;
#pragma unroll
    for (int j = 0; j < 8; ++j) wf[j] = code_minus_zero<FMT>(word, j, z) * s;
  }
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
// rows per block.  Lane l of warp w handles the 16-byte chunks (32 codes or
// 16 int8) c = w*32 + l, stepping by 128 chunks.  blockIdx.y is the expert.
template <int MT, int R, int FMT>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ qw, const float* __restrict__ sc,
            const float* __restrict__ zp, __nv_bfloat16* __restrict__ y,
            long long x_stride_e, int M, int K, int O, int g) {
  __shared__ float red[GEMV_WARPS][R][MT];
  constexpr int CW = CHUNK<FMT>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o0 = blockIdx.x * R;
  const int n_chunks = K / CW;
  const size_t rb = row_bytes<FMT>(K);
  const int ng = K / g;                   // groups per row
  const size_t e = blockIdx.y;
  x += e * (size_t)x_stride_e;
  qw += e * (size_t)O * rb;
  sc += e * (size_t)O * ng;
  if (FMT == ASYM4) zp += e * (size_t)O * ng;
  y += e * (size_t)M * O;

  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  for (int c = warp * 32 + lane; c < n_chunks; c += GEMV_WARPS * 32) {
    uint4 wv[R];
    float s[R], z[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = o0 + r;
      z[r] = 0.f;
      if (o < O) {
        if (FMT == INT2) {
          const uint2 h = __ldg(
              reinterpret_cast<const uint2*>(qw + (size_t)o * rb) + c);
          wv[r] = make_uint4(h.x, h.y, 0u, 0u);
        } else {
          wv[r] = __ldg(reinterpret_cast<const uint4*>(qw + (size_t)o * rb)
                        + c);
        }
        s[r] = FMT == E4M3 ? 1.f : __ldg(sc + (size_t)o * ng + (c * CW) / g);
        if (FMT == ASYM4) z[r] = __ldg(zp + (size_t)o * ng + (c * CW) / g);
      } else {                            // any codes: their scale is 0
        wv[r] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u,
                           0x88888888u);
        s[r] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < CW / 8; ++q) {    // the chunk, 8 weights at a time
      // g % 32 == 16 (SYM4, ASYM4, E2M1): a group may start half way
      // through the chunk, with its own scale (and zero point)
      if (G16<FMT> && q == 2 && (c * CW + 16) % g == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (o0 + r < O) {
            const size_t gi = (size_t)(o0 + r) * ng + (c * CW + q * 8) / g;
            s[r] = __ldg(sc + gi);
            if (FMT == ASYM4) z[r] = __ldg(zp + gi);
          }
      }
      float wf[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r) dequant8<FMT>(wv[r], q, z[r], s[r], wf[r]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          float xf[8];
          bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(
                            x + (size_t)m * K + c * CW + q * 8)), xf);
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
      if (FMT == E4M3) v *= __ldg(sc + o);   // the row's scale, after the sum
      y[(size_t)m * O + o] = __float2bfloat16(v);
    }
  }
}

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDT = BK + 8;               // bf16 row stride of the tiles
constexpr int GEMM_THREADS = 256;         // 8 warps: 2 (M) x 4 (N)

// blockIdx.z is the expert.  Two blocks per SM (2 x 28 KB of shared memory
// fit easily): the bound keeps the kernel at 128 registers a thread; at 130
// only one block of 256 threads fits an SM's 65,536 registers and the
// product takes 1.7-1.9x as long (measured on an H100).
template <int FMT>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ qw, const float* __restrict__ sc,
            const float* __restrict__ zp, __nv_bfloat16* __restrict__ y,
            long long x_stride_e, int M, int K, int O, int g) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDT];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * LDT];
  __shared__ __align__(128) float stage[GEMM_THREADS / 32][16 * 16];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;   // warp tile 64 (M) x 32 (N)
  const size_t rb = row_bytes<FMT>(K);
  const int ng = K / g;
  const size_t e = blockIdx.z;
  x += e * (size_t)x_stride_e;
  qw += e * (size_t)O * rb;
  sc += e * (size_t)O * ng;
  if (FMT == ASYM4) zp += e * (size_t)O * ng;
  y += e * (size_t)M * O;

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
    // weight tile: 128 rows x 32 weights; two threads per row, 16 weights
    // each (8 bytes of codes or 16 int8), rounded to bf16 as the plain
    // version rounds them
    {
      const int r = threadIdx.x / 2, hlf = threadIdx.x % 2;
      const int o = n0 + r;
      // the thread's 16 weights lie in one group (g % 16 == 0)
      const int gi = (k0 + hlf * 16) / g;
      float s = 0.f, z = 0.f;
      if (o < O) {
        s = FMT == E4M3 ? 1.f : __ldg(sc + (size_t)o * ng + gi);
        if (FMT == ASYM4) z = __ldg(zp + (size_t)o * ng + gi);
      }
      __align__(16) __nv_bfloat16 vals[16];
      if (FMT == INT8 || FMT == E4M3) {
        uint4 wv = make_uint4(0u, 0u, 0u, 0u);
        if (o < O)
          wv = __ldg(reinterpret_cast<const uint4*>(
              qw + (size_t)o * rb + k0 + hlf * 16));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (FMT == INT8) {
            vals[j] = __float2bfloat16(s8_to_f32(wv.x, j) * s);
            vals[4 + j] = __float2bfloat16(s8_to_f32(wv.y, j) * s);
            vals[8 + j] = __float2bfloat16(s8_to_f32(wv.z, j) * s);
            vals[12 + j] = __float2bfloat16(s8_to_f32(wv.w, j) * s);
          } else {                        // exact in bf16; scale after
            vals[j] = __float2bfloat16(e4m3_to_f32(wv.x, j));
            vals[4 + j] = __float2bfloat16(e4m3_to_f32(wv.y, j));
            vals[8 + j] = __float2bfloat16(e4m3_to_f32(wv.z, j));
            vals[12 + j] = __float2bfloat16(e4m3_to_f32(wv.w, j));
          }
        }
      } else if (FMT == INT2) {
        uint32_t wv = 0u;
        if (o < O)
          wv = __ldg(reinterpret_cast<const uint32_t*>(
              qw + (size_t)o * rb + k0 / 4 + hlf * 4));
#pragma unroll
        for (int j = 0; j < 16; ++j)
          vals[j] = __float2bfloat16(c2_minus_two(wv, j) * s);
      } else if (FMT == E2M1) {
        uint2 wv = make_uint2(0u, 0u);
        if (o < O)
          wv = __ldg(reinterpret_cast<const uint2*>(
              qw + (size_t)o * rb + k0 / 2 + hlf * 8));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          vals[j] = __float2bfloat16(e2m1_to_f32(wv.x, j) * s);
          vals[8 + j] = __float2bfloat16(e2m1_to_f32(wv.y, j) * s);
        }
      } else {
        uint2 wv = make_uint2(0x88888888u, 0x88888888u);
        if (o < O)
          wv = __ldg(reinterpret_cast<const uint2*>(
              qw + (size_t)o * rb + k0 / 2 + hlf * 8));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          vals[j] = __float2bfloat16(code_minus_zero<FMT>(wv.x, j, z) * s);
          vals[8 + j] = __float2bfloat16(code_minus_zero<FMT>(wv.y, j, z) * s);
        }
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
        for (int e8 = 0; e8 < 8; ++e8)
          if (nb + e8 < O) {
            float v = st[rr * 16 + cc + e8];
            if (FMT == E4M3) v *= __ldg(sc + nb + e8);   // row scale last
            y[(size_t)m * O + nb + e8] = __float2bfloat16(v);
          }
      }
      __syncwarp();
    }
}

template <int MT, int R, int FMT>
void launch_gemv(const __nv_bfloat16* x, const uint8_t* qw, const float* sc,
                 const float* zp, __nv_bfloat16* y, int E, long long xse,
                 int M, int K, int O, int g, cudaStream_t st) {
  dim3 grid((O + R - 1) / R, E);
  gemv_kernel<MT, R, FMT><<<grid, GEMV_WARPS * 32, 0, st>>>(
      x, qw, sc, zp, y, xse, M, K, O, g);
}

// x (E, M, K) bf16, each (M, K) slab contiguous, at an expert stride of
// `x_stride_e` elements (a multiple of 8; M*K when contiguous, 0 for one
// slab shared by all experts), qweight (E, O, K/8) int32 (SYM4, ASYM4,
// E2M1), (E, O, K/16) int32 (INT2) or (E, O, K) bytes (INT8, E4M3), scales
// and (ASYM4) zps (E, O, K/g) fp32, y (E, M, O) bf16, contiguous.  E, M >=
// 1, E <= 65535, K % 32 == 0, g % 32 == 0 (SYM4, ASYM4, E2M1: g % 16 == 0;
// E4M3: g = K),
// K % g == 0 (g = K: one scale per output channel).  Returns the
// cudaError_t of the launch (0 on success).
template <int FMT>
int launch(const void* x_, const void* qw_, const void* sc_, const void* zp_,
           void* y_, int E, long long x_stride_e, int M, int K, int O, int g,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || E > 65535 || M <= 0 || O <= 0 || K <= 0 || K % 32 || g <= 0
      || g % (G16<FMT> ? 16 : 32) || K % g || (FMT == E4M3 && g != K)
      || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(x_);
  const uint8_t* qw = static_cast<const uint8_t*>(qw_);
  const float* sc = static_cast<const float*>(sc_);
  const float* zp = static_cast<const float*>(zp_);
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(y_);
  const long long xse = x_stride_e;
#define W4A16_GEMV(MT, R) \
  launch_gemv<MT, R, FMT>(x, qw, sc, zp, y, E, xse, M, K, O, g, st)
  if (M == 1)       W4A16_GEMV(1, 4);
  else if (M <= 2)  W4A16_GEMV(2, 4);
  else if (M <= 4)  W4A16_GEMV(4, 4);
  else if (M <= 8)  W4A16_GEMV(8, 4);
  else if (M <= 16) W4A16_GEMV(16, 2);
  else if (M <= 32) W4A16_GEMV(32, 1);
  else {
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, E);
    gemm_kernel<FMT><<<grid, GEMM_THREADS, 0, st>>>(x, qw, sc, zp, y, xse, M,
                                                     K, O, g);
  }
#undef W4A16_GEMV
  return (int)cudaGetLastError();
}

}  // namespace w4a16
