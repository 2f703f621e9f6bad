// Bodies shared by the two int8-activation products:
//   w8a8_matmul.cu  y = (q8(x) . Wi^T) * xs * ws          (Wi int8, per-channel ws)
//   w4a8_matmul.cu  y = sum_g (q8(x)_g . (code_g - 8)^T) * s_g * xs
// bf16 activations in and out.  q8 is the dynamic per-row quantizer
// (`quantize_rows_kernel`): xs = max(amax * fp32(1 / 127), 1e-8) (the
// constant division as XLA compiles it), xi = clip(rint(x / xs), -127, 127)
// with IEEE division and round-half-to-even, so the codes and scales are
// those of the plain version bit for bit.
//
// Integer arithmetic is exact: int8 x int8 products accumulate in int32 on
// the tensor cores (mma.sync m16n8k32, GEMM body, M > 32) or on the CUDA
// cores (dp4a, GEMV body, M <= 32).  The W8A8 kernels keep one int32 sum
// over the whole K and apply `float(acc) * xs * ws` in that order.  The
// W4A8 kernels unpack each nibble to a signed int8 `code - 8` in registers
// and feed it to the same product; the GEMM body closes every group of g
// columns by `accf += float(acc) * s_g` (separate multiply and add, no
// FMA: the plain version's fp32 operations in its order) and ends with
// `* xs`.
//
// Layouts: xi (M, K) int8 row-major is the A operand; Wi (O, K) int8
// row-major is the `col` B operand as it lies; the int4 words are those of
// the W4A16 kernels (word w of a row holds columns 8w..8w+7, column 8w+j
// in nibble j), so one packed copy of the weights serves A16 and A8.
//
// What bounds them on an H100: at decode (M <= 32) the weight stream (1 or
// 0.5 byte a weight against 2*M operations); at prefill the int8 tensor
// cores (1979 TOP/s dense).  The GEMM here is a plain shared-memory tile
// loop (128 x 128 x 64, one buffer, 16 warps of 32 x 32): right first.
// The ragged M and O edges are masked (zero-filled tiles, guarded stores).
// Needs K % 32 == 0 (W4: g % 32 == 0 and K % g == 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace a8 {

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ---------------------------------------------------------- quantize_rows

constexpr int QR_THREADS = 256;

// One block per row of x (M, K) bf16, K % 8 == 0: xs[row] and the row's
// int8 codes.  The row is read twice (the second pass hits L1 / L2).
__global__ void __launch_bounds__(QR_THREADS)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     int8_t* __restrict__ xi, float* __restrict__ xs, int K) {
  __shared__ float red[QR_THREADS / 32];
  __shared__ float s_sh;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * (size_t)K);
  const int nv = K / 8;
  float amax = 0.f;
  for (int i = threadIdx.x; i < nv; i += QR_THREADS) {
    float f[8];
    bf16x8_to_f32(__ldg(xr + i), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(f[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = red[0];
#pragma unroll
    for (int w = 1; w < QR_THREADS / 32; ++w) a = fmaxf(a, red[w]);
    const float s = fmaxf(__fmul_rn(a, 1.0f / 127.0f), 1e-8f);
    s_sh = s;
    xs[row] = s;
  }
  __syncthreads();
  const float s = s_sh;
  uint2* out = reinterpret_cast<uint2*>(xi + row * (size_t)K);
  for (int i = threadIdx.x; i < nv; i += QR_THREADS) {
    float f[8];
    bf16x8_to_f32(__ldg(xr + i), f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(f[j], s)), -127.f), 127.f);
      w[j / 4] |= ((uint32_t)(int)q & 0xFFu) << (8 * (j % 4));
    }
    out[i] = make_uint2(w[0], w[1]);
  }
}

inline void launch_quantize_rows(const void* x, void* xi, void* xs, int M,
                                 int K, cudaStream_t st) {
  quantize_rows_kernel<<<M, QR_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xi),
      static_cast<float*>(xs), K);
}

// ------------------------------------------------------------- unpacking

// Nibbles j = 0..7 of `word` minus 8 as eight int8: lo holds columns
// 0..3, hi columns 4..7 (one byte each, in column order).
__device__ __forceinline__ void w4_to_s8(uint32_t word, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t even = word & 0x0F0F0F0Fu;          // nibbles 0, 2, 4, 6
  const uint32_t odd = (word >> 4) & 0x0F0F0F0Fu;    // nibbles 1, 3, 5, 7
  lo = __vsub4(__byte_perm(even, odd, 0x5140), 0x08080808u);
  hi = __vsub4(__byte_perm(even, odd, 0x7362), 0x08080808u);
}

// ------------------------------------------------------------------ GEMV

constexpr int GEMV_WARPS = 4;

template <int R, int MT>
__device__ __forceinline__ void block_reduce_store_i32(
    int (&acc)[R][MT], int (*red)[R][MT], int warp, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      int v = acc[r][m];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r][m] = v;
    }
}

// W8A8, M <= MT <= 32.  Each block owns R output rows and splits K over
// its 4 warps; lane l of warp w takes the 16-byte chunks w*32 + l, + 128,
// ...  One int32 sum per (row, m) over the whole K: exact.
template <int MT, int R>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
w8a8_gemv_kernel(const int8_t* __restrict__ xi, const float* __restrict__ xs,
                 const int8_t* __restrict__ wi, const float* __restrict__ ws,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ y32,
                 int M, int K, int O) {
  __shared__ int red[GEMV_WARPS][R][MT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o0 = blockIdx.x * R;
  const int n_chunks = K / 16;
  int acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0;

  for (int c = warp * 32 + lane; c < n_chunks; c += GEMV_WARPS * 32) {
    uint4 wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = o0 + r;
      wv[r] = (o < O) ? __ldg(reinterpret_cast<const uint4*>(
                                  wi + (size_t)o * K) + c)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const uint4 xv = __ldg(reinterpret_cast<const uint4*>(
                                   xi + (size_t)m * K) + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          int a = acc[r][m];
          a = __dp4a((int)wv[r].x, (int)xv.x, a);
          a = __dp4a((int)wv[r].y, (int)xv.y, a);
          a = __dp4a((int)wv[r].z, (int)xv.z, a);
          a = __dp4a((int)wv[r].w, (int)xv.w, a);
          acc[r][m] = a;
        }
      }
    }
  }
  block_reduce_store_i32<R, MT>(acc, red, warp, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < R * MT; i += blockDim.x) {
    const int r = i / MT, m = i % MT;
    const int o = o0 + r;
    if (o < O && m < M) {
      int v = 0;
#pragma unroll
      for (int w = 0; w < GEMV_WARPS; ++w) v += red[w][r][m];
      const float f = __fmul_rn(__fmul_rn(__int2float_rn(v), xs[m]), ws[o]);
      if (y32) y32[(size_t)m * O + o] = f;
      else y[(size_t)m * O + o] = __float2bfloat16(f);
    }
  }
}

// W4A8, M <= MT <= 32.  A lane's chunk is 16 bytes of packed words = 32
// columns, inside one group (g % 32 == 0): its int32 dot is exact, then
// `float(dot) * s_g` accumulates in fp32 (per chunk here, per group in the
// GEMM body and the plain version: the same sum in another order).
template <int MT, int R>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
w4a8_gemv_kernel(const int8_t* __restrict__ xi, const float* __restrict__ xs,
                 const uint32_t* __restrict__ qw, const float* __restrict__ sc,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ y32,
                 int M, int K, int O, int g) {
  __shared__ float red[GEMV_WARPS][R][MT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o0 = blockIdx.x * R;
  const int n_chunks = K / 32;
  const int kw = K / 8, ng = K / g;
  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  for (int c = warp * 32 + lane; c < n_chunks; c += GEMV_WARPS * 32) {
    uint32_t w8[R][8];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = o0 + r;
      uint4 wv = make_uint4(0x88888888u, 0x88888888u, 0x88888888u,
                            0x88888888u);
      s[r] = 0.f;
      if (o < O) {
        wv = __ldg(reinterpret_cast<const uint4*>(qw + (size_t)o * kw) + c);
        s[r] = __ldg(sc + (size_t)o * ng + (c * 32) / g);
      }
      w4_to_s8(wv.x, w8[r][0], w8[r][1]);
      w4_to_s8(wv.y, w8[r][2], w8[r][3]);
      w4_to_s8(wv.z, w8[r][4], w8[r][5]);
      w4_to_s8(wv.w, w8[r][6], w8[r][7]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const uint4* xp = reinterpret_cast<const uint4*>(
                              xi + (size_t)m * K) + 2 * c;
        const uint4 x0 = __ldg(xp), x1 = __ldg(xp + 1);
        const int xw[8] = {(int)x0.x, (int)x0.y, (int)x0.z, (int)x0.w,
                           (int)x1.x, (int)x1.y, (int)x1.z, (int)x1.w};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          int d = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) d = __dp4a((int)w8[r][j], xw[j], d);
          acc[r][m] = fmaf(__int2float_rn(d), s[r], acc[r][m]);
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
      const float f = __fmul_rn(v, xs[m]);
      if (y32) y32[(size_t)m * O + o] = f;
      else y[(size_t)m * O + o] = __float2bfloat16(f);
    }
  }
}

// ------------------------------------------------------------------ GEMM

constexpr int BM = 128, BN = 128, BK = 64;   // BK in int8 columns
constexpr int LDS = BK + 16;                 // byte row stride of the tiles
constexpr int GEMM_THREADS = 512;            // 16 warps: 4 (M) x 4 (N)

// D (16 x 8, int32) += A (16 x 32, int8, row) . B (32 x 8, int8, col).
// Lane l: gid = l / 4, t = l % 4.  a[0]: row gid, columns 4t..4t+3; a[1]:
// row gid + 8; a[2], a[3]: the same rows, columns 16 + 4t...  b[0]: column
// gid of B, k = 4t..4t+3; b[1]: k = 16 + 4t...  c[0], c[1]: row gid,
// columns 2t, 2t + 1; c[2], c[3]: row gid + 8.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// W4 = false: w is Wi (O, K) int8, sc is ws (O,).  W4 = true: w is the
// packed words (O, K / 8), sc is (O, K / g).
template <bool W4>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const int8_t* __restrict__ xi, const float* __restrict__ xs,
            const void* __restrict__ w_, const float* __restrict__ sc,
            __nv_bfloat16* __restrict__ y, float* __restrict__ y32,
            int M, int K, int O, int g) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;    // warp tile 32 (M) x 32 (N)
  const int gid = lane / 4, t = lane % 4;
  const int ng = W4 ? K / g : 1;

  int acc[2][4][4];
  float accf[W4 ? 2 : 1][W4 ? 4 : 1][W4 ? 4 : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if constexpr (W4) accf[i][j][e] = 0.f;
      }

  // tile loads: 128 rows x 64 bytes, one 16-byte piece per thread.  K is a
  // multiple of 32, not of BK: the last tile may hold only 32 columns, and
  // then its upper half is neither loaded (zero-filled) nor multiplied.
  const int lr = threadIdx.x / 4, lq = threadIdx.x % 4;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool in_k = k0 + lq * 16 < K;
    {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in_k && m0 + lr < M)
        v = __ldg(reinterpret_cast<const uint4*>(
            xi + (size_t)(m0 + lr) * K + k0 + lq * 16));
      *reinterpret_cast<uint4*>(As + lr * LDS + lq * 16) = v;
    }
    {
      const int o = n0 + lr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in_k && o < O) {
        if constexpr (W4) {
          const uint2 p = __ldg(reinterpret_cast<const uint2*>(
              static_cast<const uint32_t*>(w_) + (size_t)o * (K / 8)
              + k0 / 8 + lq * 2));
          w4_to_s8(p.x, v.x, v.y);
          w4_to_s8(p.y, v.z, v.w);
        } else {
          v = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const int8_t*>(w_) + (size_t)o * K + k0 + lq * 16));
        }
      }
      *reinterpret_cast<uint4*>(Bs + lr * LDS + lq * 16) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      if (k0 + ks >= K) break;   // block-uniform: the K edge of the last tile
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = As + (wm * 32 + i * 16 + gid) * LDS + ks + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (wn * 32 + j * 8 + gid) * LDS + ks + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
      if constexpr (W4) if ((k0 + ks + 32) % g == 0) {
        // the group ends here: accf += float(acc) * s_g, acc = 0
        const int gi = (k0 + ks) / g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = n0 + wn * 32 + j * 8 + t * 2;
          const float s0 = (o < O) ? __ldg(sc + (size_t)o * ng + gi) : 0.f;
          const float s1 = (o + 1 < O) ? __ldg(sc + (size_t)(o + 1) * ng + gi)
                                       : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              accf[i][j][e] = __fadd_rn(
                  accf[i][j][e],
                  __fmul_rn(__int2float_rn(acc[i][j][e]), (e & 1) ? s1 : s0));
              acc[i][j][e] = 0;
            }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int m = m0 + wm * 32 + i * 16 + gid + e2 * 8;
      if (m >= M) continue;
      const float xsm = xs[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int o = n0 + wn * 32 + j * 8 + t * 2 + e1;
          if (o >= O) continue;
          const int e = e2 * 2 + e1;
          float f;
          if constexpr (W4) f = __fmul_rn(accf[i][j][e], xsm);
          else f = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), xsm),
                             sc[o]);
          if (y32) y32[(size_t)m * O + o] = f;
          else y[(size_t)m * O + o] = __float2bfloat16(f);
        }
    }
}

// Quantize the rows of x into the scratch (xi, xs), then the product.
// x (M, K) bf16, y (M, O) bf16 or, when y32 is not null, fp32 there (the
// result before the cast); all contiguous.  Returns the cudaError_t of the
// launches (0 on success).
template <bool W4>
int launch(const void* x, const void* w, const void* sc_, void* xi_,
           void* xs_, void* y_, void* y32_, int M, int K, int O, int g,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || O <= 0 || K <= 0 || K % 32 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (W4 && (g <= 0 || g % 32 || K % g)) return (int)cudaErrorInvalidValue;
  launch_quantize_rows(x, xi_, xs_, M, K, st);
  const int8_t* xi = static_cast<const int8_t*>(xi_);
  const float* xs = static_cast<const float*>(xs_);
  const float* sc = static_cast<const float*>(sc_);
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(y_);
  float* y32 = static_cast<float*>(y32_);
#define A8_GEMV(MT, R)                                                       \
  do {                                                                       \
    dim3 grid((O + R - 1) / R);                                              \
    if constexpr (W4)                                                        \
      w4a8_gemv_kernel<MT, R><<<grid, GEMV_WARPS * 32, 0, st>>>(             \
          xi, xs, static_cast<const uint32_t*>(w), sc, y, y32, M, K, O, g);  \
    else                                                                     \
      w8a8_gemv_kernel<MT, R><<<grid, GEMV_WARPS * 32, 0, st>>>(             \
          xi, xs, static_cast<const int8_t*>(w), sc, y, y32, M, K, O);       \
  } while (0)
  if (M == 1)       A8_GEMV(1, 4);
  else if (M <= 2)  A8_GEMV(2, 4);
  else if (M <= 4)  A8_GEMV(4, 4);
  else if (M <= 8)  A8_GEMV(8, 4);
  else if (M <= 16) A8_GEMV(16, 2);
  else if (M <= 32) A8_GEMV(32, 1);
  else {
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<W4><<<grid, GEMM_THREADS, 0, st>>>(xi, xs, w, sc, y, y32, M,
                                                   K, O, g);
  }
#undef A8_GEMV
  return (int)cudaGetLastError();
}

}  // namespace a8
