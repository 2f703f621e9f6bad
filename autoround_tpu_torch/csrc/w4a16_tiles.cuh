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
//    tensor cores bound it.  `gemm_kernel` tiles M x O x K as 256 x 128 x
//    64, four warpgroups of 64 x 128.  A ring of 4 slots in dynamic shared
//    memory, filled by cp.async (zero-filling past M, O and K), holds each
//    k-step's activation tile and PACKED weight codes; each thread reads
//    the scale (zero point) of its 16-column slice from global memory a
//    step before it needs it.  Each k-step issues its products as
//    asynchronous wgmma (m64n128k16, both operands read from shared memory
//    through descriptors, K-major with the 128-byte swizzle) and, while
//    they run, the block dequantizes the next step's codes once into one
//    of three bf16 tiles (bf16((code - zero) * scale), exactly what the
//    plain version rounds); one barrier per k-step, with the products of
//    two steps in flight across it.  Every dequantized weight feeds 256
//    rows.  The epilogue writes bf16 from the fp32 accumulators in
//    registers.  What bounds it: all 16 warps take turns at copy issue,
//    dequantization and wgmma issue around one barrier a step (no warp
//    specialisation, no TMA), at 128 registers a thread.
// The ragged M and O edges are masked in the kernels (zero-filled tiles,
// guarded stores; K % 64 == 32 leaves the GEMM a half last k-step, zero-
// filled).  Needs K % 32 == 0 and g % 32 == 0 (SYM4, ASYM4, E2M1: g % 16 ==
// 0, so one 32-column GEMV chunk, or a 16-column GEMM slice's neighbour,
// may lie in another group; E4M3: g = K).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace w4a16 {

using namespace ptx;

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

// ---- the GEMM body (M > 32) ----------------------------------------------

constexpr int BM = 256, BN = 128, BK = 64;
constexpr int GEMM_THREADS = 512;         // 4 warpgroups of 64 x 128
constexpr int STAGES = 4;                 // ring slots of one k-step each
constexpr int NB = 3;                     // dequantized bf16 weight tiles
constexpr int GROUP_M = 16;               // m-tiles a band of blocks shares

// Bytes of codes in one weight row's BK columns.
template <int FMT>
constexpr int W_ROW = (FMT == INT8 || FMT == E4M3) ? BK : FMT == INT2
                                                               ? BK / 4
                                                               : BK / 2;

// One ring slot: the activation tile (BM x BK bf16, 16-byte chunks XOR-
// swizzled by row) and the packed weight tile (BN rows of W_ROW bytes).
// After the slots, NB dequantized weight tiles (BN x BK bf16, swizzled).
template <int FMT>
struct Slot {
  static constexpr int w_off = BM * BK * 2;
  static constexpr int bytes = w_off + BN * W_ROW<FMT>;
  static_assert(bytes % 1024 == 0, "tiles start on 1 KB (wgmma swizzle)");
  static constexpr int smem = STAGES * bytes + NB * BN * BK * 2 + 1024;
};

// d (64 x 128 fp32 of this warpgroup) += A (64 x 16) . B (16 x 128), both
// read from shared memory through their descriptors (K-major, 128-byte
// swizzle); issued asynchronously, complete after wgmma_wait
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// element offset of 16-byte chunk c of row r in a swizzled BK-wide bf16
// tile (128-byte rows)
__device__ __forceinline__ int swz(int r, int c) { return swz128(r, c) >> 1; }

// Fill ring slot `st` with k-step k0: every copy past M, O or K reads
// nothing and leaves zeros.
template <int FMT>
__device__ __forceinline__ void load_slot(
    unsigned char* st, const __nv_bfloat16* x, const uint8_t* qw, int m0,
    int n0, int k0, int M, int K, int O, size_t rb) {
  const int tid = threadIdx.x;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(st);
  for (int i = tid; i < BM * 8; i += GEMM_THREADS) {   // 8 chunks a row
    const int r = i >> 3, c = i & 7;
    const bool ok = m0 + r < M && k0 + 8 * c < K;
    cp_async<16>(As + swz(r, c),
                 ok ? x + (size_t)(m0 + r) * K + k0 + 8 * c : x, ok);
  }
  // codes: a row's 64 columns in pieces of 32 (16 bytes; INT2: 8) or,
  // for the byte formats, 16 (16 bytes)
  unsigned char* Ws = st + Slot<FMT>::w_off;
  constexpr int PC = (FMT == INT8 || FMT == E4M3) ? 16 : 32;  // columns
  constexpr int PB = PC * W_ROW<FMT> / BK;                    // bytes
  for (int i = tid; i < BN * (BK / PC); i += GEMM_THREADS) {
    const int r = i / (BK / PC), c = i % (BK / PC);
    const bool ok = n0 + r < O && k0 + PC * c < K;
    cp_async<PB>(Ws + r * W_ROW<FMT> + PB * c,
                 ok ? qw + (size_t)(n0 + r) * rb + (k0 + PC * c) * PB / PC
                    : qw, ok);
  }
}

// The scale (and zero point) of the 16-column slice a thread dequantizes,
// k-step after k-step, read from global memory one step before its use.
// Thread (r, q) owns slice q of row r; the group index is stepped by BK
// columns a step (no division in the loop).  Past O or K the scale is 0
// (zero-filled codes under it are weight 0).
template <int FMT>
struct SliceScale {
  const float* sc;
  const float* zp;
  int g, K, col, grp, grem;
  bool row_ok;
  float s, z;

  __device__ __forceinline__ SliceScale(const float* sc_, const float* zp_,
                                        int n0, int O, int K_, int g_,
                                        int ng)
      : g(g_), K(K_) {
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    row_ok = n0 + r < O;
    sc = sc_ + (row_ok ? (size_t)(n0 + r) * ng : 0);
    zp = FMT == ASYM4 ? zp_ + (row_ok ? (size_t)(n0 + r) * ng : 0) : zp_;
    col = 16 * q;
    grp = col / g;
    grem = col % g;
  }

  // fetch the current step's values, then step to the next
  __device__ __forceinline__ void fetch() {
    const bool ok = row_ok && col < K;
    s = FMT == E4M3 ? 1.f : ok ? __ldg(sc + grp) : 0.f;
    z = FMT == ASYM4 && ok ? __ldg(zp + grp) : 0.f;
    col += BK;
    for (grem += BK; grem >= g; grem -= g) ++grp;
  }
};

// Dequantize the packed slot `st` into the bf16 tile Bs: thread (r, q)
// turns columns 16q..16q+15 of weight row r (one 16-column slice, one
// scale s, zero point z) into bf16(fp32(code - zero) * scale), as the plain
// version rounds them (E4M3: the exact e4m3 value; its row scale
// multiplies the fp32 sum).
template <int FMT>
__device__ __forceinline__ void dequant_slot(const unsigned char* st,
                                             __nv_bfloat16* Bs, float s,
                                             float z) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const unsigned char* w = st + Slot<FMT>::w_off + r * W_ROW<FMT>
                           + q * (W_ROW<FMT> / 4);
  uint4 wv;
  if (FMT == INT8 || FMT == E4M3) {
    wv = *reinterpret_cast<const uint4*>(w);
  } else if (FMT == INT2) {
    wv = make_uint4(*reinterpret_cast<const uint32_t*>(w), 0u, 0u, 0u);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(w);
    wv = make_uint4(v.x, v.y, 0u, 0u);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {         // 8 columns each
    float wf[8];
    dequant8<FMT>(wv, c, z, s, wf);
    *reinterpret_cast<uint4*>(Bs + swz(r, 2 * q + c)) = make_uint4(
        pack_bf16(wf[0], wf[1]), pack_bf16(wf[2], wf[3]),
        pack_bf16(wf[4], wf[5]), pack_bf16(wf[6], wf[7]));
  }
}

// blockIdx.z is the expert.  Blocks walk the (m-tile, n-tile) grid in bands
// of GROUP_M m-tiles, so the blocks resident at once share their weight
// tiles through L2.  Warpgroup w (4 warps) owns rows 64w..64w+63 of the
// tile and all 128 columns: 64 fp32 accumulators a thread, 128 registers
// at most (512 threads fill an SM's 65,536).  Every dequantized weight
// feeds 256 rows.  One block per SM: the slots and the three bf16 tiles
// take at most 209 KB.
template <int FMT>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ qw, const float* __restrict__ sc,
            const float* __restrict__ zp, __nv_bfloat16* __restrict__ y,
            long long x_stride_e, int M, int K, int O, int g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int SB = Slot<FMT>::bytes;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * SB);

  const int mt = (M + BM - 1) / BM, nt = (O + BN - 1) / BN;
  const long long pid = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const long long band = (long long)GROUP_M * nt;
  const int first_m = (int)(pid / band) * GROUP_M;
  const int gsz = min(mt - first_m, GROUP_M);
  const int local = (int)(pid % band);
  const int m0 = (first_m + local % gsz) * BM, n0 = (local / gsz) * BN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w4 = warp % 4;
  const int gq = lane >> 2, t = lane & 3;
  const size_t rb = row_bytes<FMT>(K);
  const int ng = K / g;
  const size_t e = blockIdx.z;
  x += e * (size_t)x_stride_e;
  qw += e * (size_t)O * rb;
  sc += e * (size_t)O * ng;
  if (FMT == ASYM4) zp += e * (size_t)O * ng;
  y += e * (size_t)M * O;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // k-step ks multiplies slot ks % STAGES's activations by Bs[ks % NB],
  // which step ks - 1 dequantized while the products of steps ks - 2 and
  // ks - 1 ran; two steps of products stay in flight across the barrier,
  // so the tensor cores do not drain at each k-step.  Copies run two steps
  // ahead.  K % 64 == 32 leaves a half last step.
  const int nk = (K + BK - 1) / BK;
  SliceScale<FMT> ss(sc, zp, n0, O, K, g, ng);
  constexpr int AHEAD = STAGES - 2;       // copies this many steps ahead
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nk)
      load_slot<FMT>(smem + s * SB, x, qw, m0, n0, s * BK, M, K, O, rb);
    cp_commit();
  }
  ss.fetch();
  float s_cur = ss.s, z_cur = ss.z;
  ss.fetch();                           // step 1's, used one step later
  cp_wait<AHEAD - 1>();
  __syncthreads();
  dequant_slot<FMT>(smem, Bs, s_cur, z_cur);

  for (int ks = 0; ks < nk; ++ks) {
    wgmma_wait<1>();      // step ks - 2's products (and their reads) done
    fence_acc(acc);
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();      // slot ks + 1 landed, Bs[ks % NB] written
    if (ks + AHEAD < nk)    // into the slot of step ks - 2
      load_slot<FMT>(smem + ((ks + AHEAD) % STAGES) * SB, x, qw, m0, n0,
                     (ks + AHEAD) * BK, M, K, O, rb);
    cp_commit();

    const unsigned char* At = smem + (ks % STAGES) * SB + wg * 64 * BK * 2;
    const unsigned char* Bt =
        reinterpret_cast<const unsigned char*>(Bs + (ks % NB) * BN * BK);
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(acc, smem_desc(At + 32 * kk), smem_desc(Bt + 32 * kk));
    wgmma_commit();
    fence_acc(acc);

    if (ks + 1 < nk) {  // into the tile of step ks - 2
      s_cur = ss.s;
      z_cur = ss.z;
      ss.fetch();         // step ks + 2's
      dequant_slot<FMT>(smem + ((ks + 1) % STAGES) * SB,
                        Bs + ((ks + 1) % NB) * BN * BK, s_cur, z_cur);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_wait<0>();

  // epilogue: bf16 straight from the accumulators (E4M3: row scale first);
  // value 4j + c of a lane is row 16 w4 + gq + 8 (c / 2), column 8j + 2t +
  // c % 2 of its warpgroup's 64 x 128
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    float s0 = 1.f, s1 = 1.f;
    if (FMT == E4M3) {
      if (n < O) s0 = __ldg(sc + n);
      if (n + 1 < O) s1 = __ldg(sc + n + 1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wg * 64 + w4 * 16 + gq + 8 * r;
      if (m >= M) continue;
      const float v0 = acc[4 * j + 2 * r] * s0;
      const float v1 = acc[4 * j + 2 * r + 1] * s1;
      __nv_bfloat16* dst = y + (size_t)m * O + n;
      if (n + 1 < O && O % 2 == 0) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
      } else {
        if (n < O) dst[0] = __float2bfloat16(v0);
        if (n + 1 < O) dst[1] = __float2bfloat16(v1);
      }
    }
  }
}

// Dynamic shared memory of the GEMM body: set once per instance before its
// first launch (above 48 KB it must be asked for).
template <int FMT>
cudaError_t gemm_smem(int* bytes) {
  *bytes = Slot<FMT>::smem;
  return cudaFuncSetAttribute(gemm_kernel<FMT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *bytes);
}

// The GEMM body's resources on this card: info = {registers a thread, local
// (spill) bytes a thread, dynamic shared bytes a block, blocks per SM}.
template <int FMT>
int gemm_info(int* info) {
  int smem = 0, blocks = 0;
  cudaFuncAttributes a;
  cudaError_t err = gemm_smem<FMT>(&smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, gemm_kernel<FMT>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gemm_kernel<FMT>, GEMM_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return 0;
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
    int smem = 0;
    const cudaError_t err = gemm_smem<FMT>(&smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, E);
    gemm_kernel<FMT><<<grid, GEMM_THREADS, smem, st>>>(x, qw, sc, zp, y, xse,
                                                        M, K, O, g);
  }
#undef W4A16_GEMV
  return (int)cudaGetLastError();
}

}  // namespace w4a16
