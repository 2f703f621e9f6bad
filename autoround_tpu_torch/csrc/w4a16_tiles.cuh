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
//    ~295 operations per byte: the weight stream from memory bounds it.
//    `gemv_kernel` runs the products on mma.sync.m16n8k16 bf16 with the
//    operands swapped (weights as A, 16 rows a warp; activations as B, 8
//    tokens an n-tile, up to 4), so the CUDA cores only dequantize: per
//    weight a byte permute (the magic-number conversion), a subtraction, a
//    product with the scale and half a cvt.rn.bf16x2.f32.  A lane's four A
//    values of an mma are four consecutive codes of its own chunk (4-bit:
//    one word feeds two mmas; INT8 / E4M3: one; INT2: four), and x is
//    staged once a block in shared memory in the same k order (fragment
//    order: a warp's B operands are 512 contiguous bytes).  Each warp
//    streams its 16 rows through a ring of two 2 KB slots in shared memory
//    (128 bytes of each row a slot: each copy instruction reads four whole
//    128-byte row segments) by cp.async; the scales come 4 steps (INT2: 8)
//    ahead in registers.  Bytes in flight (Little's law): 3.35 TB/s x ~1
//    us of loaded HBM latency is ~3.4 MB, ~25 KB an SM; 24 warps (M <= 8:
//    three blocks of 8 at 80 registers) or 16 (two at <= 128) keep 24-48
//    KB in flight with a slot each.  A block takes 8 row tiles, so each
//    staged x feeds 128 rows; where those blocks give too few warps
//    (qkv, down_proj) or a block's x would pass 32 KB (M <= 8) or 64 KB,
//    K is split over a thread-block cluster of up to 16 blocks, whose
//    partial sums rank 0 adds in a fixed order through distributed shared
//    memory (no workspace, no atomics: two launches give the same bits).
//    `gemv_plan` picks the split from host shapes (E, M, K, O) and the SM
//    count only, so the launch is capturable.  What bounds it now (H100,
//    lm_head at M = 8): the instructions a code costs; without the
//    dequantization the same loop streams at ~2.3 TB/s.  The time hardly
//    depends on M, so at M = 1 and small O (o_proj, down_proj) the work a
//    code costs and the cluster's reduction, which waits for its slowest
//    rank, leave it slower than the design it replaced.  Was: fp32 FMAs
//    on the CUDA cores, M FMAs per weight with x reloaded and reconverted
//    per row, 4 warps a block splitting K, R <= 4 rows of 16-byte loads
//    in flight a lane, the weight kept in fp32.
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

#include <cooperative_groups.h>

#include "sm90_ptx.cuh"

namespace w4a16 {

namespace cg = cooperative_groups;

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

// ---- the GEMV body (M <= 32) ---------------------------------------------
//
// Products on mma.sync.m16n8k16 bf16 with the operands swapped: the weights
// are A (16 output rows x 16 k), the activations B (16 k x 8 tokens), so
// M <= 8 is one n-tile, M <= 16 two and M <= 32 four.  The k order inside
// an mma is free so long as A and B agree: lane (g, t) feeds logical k 2t,
// 2t + 1, 2t + 8, 2t + 9 with four CONSECUTIVE codes of its own chunk of a
// row (codes 4q..4q+3 for the chunk's q-th mma), and B with the activations
// of those same columns.  So a lane takes one chunk of a row (16 bytes: 32
// 4-bit codes, 16 bytes of int8 / e4m3; INT2: 8 bytes, 32 codes) for rows
// g and g + 8 of its warp's 16-row tile, and four lanes (t = 0..3) cover a
// step of 4 chunks of K.  Each weight is dequantized once in fp32 (bf16 of
// (code - zero) * scale, e2m1 * scale, wi * scale: the plain version's
// value; E4M3 its exact e4m3 value, the row scale after the sum) and
// rounded once to bf16 (cvt.rn.bf16x2.f32).

// Columns of one warp step (4 lanes x one chunk), bytes of a lane's chunk,
// steps a 128-byte row segment of the weight ring holds, steps of scales a
// lane keeps in flight in registers (two ring slots), x bytes a block may
// stage, ring slots.
template <int FMT>
constexpr int STEP_K = 4 * CHUNK<FMT>;
template <int FMT>
constexpr int CHUNK_BYTES = FMT == INT2 ? 8 : 16;
template <int FMT>
constexpr int SLOT_STEPS = 128 / (4 * CHUNK_BYTES<FMT>);
template <int FMT>
constexpr int DEPTH = 2 * SLOT_STEPS<FMT>;
constexpr int GEMV_MAX_WARPS = 8;
constexpr int GEMV_MAX_CLUSTER = 16;      // beyond 8: a non-portable size
constexpr int GEMV_SLOTS = 2;             // a warp's ring: 2 x 16 rows x 128 B
constexpr int GEMV_RING = GEMV_SLOTS * 16 * 128;
// x a block may stage, and blocks an SM: one n-tile (M <= 8) keeps three
// blocks of 8 warps (80 registers, 64 KB of shared memory each; ASYM4,
// whose zero points would spill there, two), more n-tiles two (x up to 64
// KB)
constexpr int gemv_x_max(int nt) { return nt == 1 ? 32 << 10 : 64 << 10; }
constexpr int gemv_min_blocks(int fmt, int nt) {
  return nt == 1 && fmt != ASYM4 ? 3 : 2;
}
constexpr int GEMV_SMEM_MAX = gemv_x_max(2) + GEMV_MAX_WARPS * GEMV_RING;

// One step's scales of a lane: for rows g and g + 8, the scale (and zero
// point) of each 16-column half of its chunk (G16 formats: a group may
// start half way).
struct GemvScales {
  float s[2][2], z[2][2];
};

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// byte b of `bytes` as the float 2^23 + byte (the magic-number conversion)
__device__ __forceinline__ float magic_byte(uint32_t bytes, int b) {
  return __uint_as_float(__byte_perm(bytes, 0x4B000000u, 0x7650 + b));
}

// The four values of mma q of a chunk (codes 4q..4q+3), in fp32: exactly
// the plain version's dequantized weight before its bf16 rounding.  The
// 4-bit and 2-bit codes are first spread one to a byte with masks (a word
// of 8 nibbles: even nibbles in one register, odd in another), so each
// code costs one byte permute, one subtraction and one product.
template <int FMT>
__device__ __forceinline__ void dequant4(const uint4& w, int q, float s,
                                         float z, float* f) {
  if (FMT == SYM4 || FMT == ASYM4) {
    const uint32_t word = word_of(w, q / 2);
    const uint32_t ev = word & 0x0F0F0F0Fu, od = (word >> 4) & 0x0F0F0F0Fu;
    const int b = 2 * (q % 2);          // nibbles 4 (q % 2) + 0..3
    const float v[4] = {magic_byte(ev, b), magic_byte(od, b),
                        magic_byte(ev, b + 1), magic_byte(od, b + 1)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = (FMT == ASYM4 ? (v[i] - 8388608.0f) - z : v[i] - 8388616.0f)
             * s;
  } else if (FMT == INT2) {
    const uint32_t word = word_of(w, q / 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)        // code 4 (q % 4) + i: byte q % 4 of
      f[i] = (magic_byte((word >> (2 * i)) & 0x03030303u, q % 4)
              - 8388610.0f) * s;         // the codes i, i + 4, ... of word
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (FMT == INT8)
        f[i] = s8_to_f32(word_of(w, q), i) * s;
      else if (FMT == E4M3)
        f[i] = e4m3_to_f32(word_of(w, q), i);
      else
        f[i] = e2m1_to_f32(word_of(w, q / 2), 4 * (q % 2) + i) * s;
    }
  }
}

// A lane's scale (and zero point) rows for its weight rows g and g + 8.
struct GemvRows {
  const float* s[2];
  const float* z[2];
  bool ok[2];
};

// Scales of local step i (the lane's chunk at column k = (s_lo + i) *
// STEP_K + CHUNK * t); past O, K or the block's range they are 0.  The
// group index is k * ceil(2^32 / g) >> 32 (exact for k * g < 2^32), no
// division.
template <int FMT>
__device__ __forceinline__ void gemv_scales(GemvScales& sl,
                                            const GemvRows& rw, int i,
                                            int n_local, int s_lo, int t,
                                            int K, uint32_t g_magic) {
  const int k = (s_lo + i) * STEP_K<FMT> + CHUNK<FMT> * t;
  const bool in = i < n_local && k < K;
  const uint32_t gi = __umulhi((uint32_t)k, g_magic);
  const bool split = G16<FMT> && __umulhi((uint32_t)k + 16, g_magic) != gi;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sl.s[h][0] = sl.s[h][1] = 0.f;
    sl.z[h][0] = sl.z[h][1] = 0.f;
    if (in && rw.ok[h] && FMT != E4M3) {
      sl.s[h][0] = __ldg(rw.s[h] + gi);
      sl.s[h][1] = split ? __ldg(rw.s[h] + gi + 1) : sl.s[h][0];
      if (FMT == ASYM4) {
        sl.z[h][0] = __ldg(rw.z[h] + gi);
        sl.z[h][1] = split ? __ldg(rw.z[h] + gi + 1) : sl.z[h][0];
      }
    }
  }
}

// A lane's part of copying one ring slot of the warp's 16 weight rows (a
// 128-byte segment of each) into shared memory: 16 rows x 128 bytes,
// 16-byte chunk c of row r at chunk c ^ 4 (r & 1), so a quarter warp's
// fragment reads (rows 2q, 2q + 1, four chunks each) hit distinct banks.
// Each copy instruction of the warp reads whole 128-byte row segments (4
// rows; INT2, whose rows need not be 16-byte aligned: 8-byte copies, 2
// rows).  Everything but the segment's column is fixed for the lane, so it
// is worked out once.
template <int FMT>
struct GemvCopy {
  static constexpr int PB = FMT == INT2 ? 8 : 16;   // bytes a copy
  static constexpr int PER_ROW = 128 / PB;
  static constexpr int N = 16 * PER_ROW / 32;       // copies a lane
  const uint8_t* src[N];   // the lane's row at the range's first byte
  int off[N];              // its place in a slot
  bool row_ok[N];
  int col;                 // its byte within a segment

  __device__ __forceinline__ GemvCopy(const uint8_t* w0, size_t rb, int rows,
                                      size_t b_lo, int lane) {
    col = (lane % PER_ROW) * PB;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int r = (32 * j + lane) / PER_ROW;
      row_ok[j] = r < rows;
      src[j] = w0 + (row_ok[j] ? (size_t)r * rb : 0) + b_lo + col;
      off[j] = r * 128 + (((col / 16) ^ ((r & 1) << 2)) << 4) + col % 16;
    }
  }

  // segment `st` of the range (bytes b_lo + 128 st ..) into `slot`; rows
  // past O and bytes past the row or the block's range (n_bytes) are zeros
  __device__ __forceinline__ void copy(unsigned char* slot, int st,
                                       size_t n_bytes) const {
    const bool in = (size_t)st * 128 + col < n_bytes;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool ok = in && row_ok[j];
      cp_async<PB>(slot + off[j], ok ? src[j] + (size_t)st * 128 : src[j],
                   ok);
    }
  }
};

// Stage the block's x (steps s_lo .. s_lo + n - 1) into `dst` in fragment
// order: 16-byte piece p (8 bf16) of lane (g, t)'s chunk of n-tile nt, step
// j lies at ((j * NT + nt) * P + p) * 32 + 4 g + t, so a warp's B operands
// are 512 contiguous bytes.  Eight neighbouring threads write 128
// contiguous bytes; a warp reads two x rows' 256 contiguous bytes (128 for
// the byte formats: four rows).  Rows past M and columns past K are zeros.
template <int FMT, int NT>
__device__ __forceinline__ void gemv_stage(uint4* dst, const __nv_bfloat16* x,
                                           int s_lo, int n, int M, int K) {
  constexpr int CW = CHUNK<FMT>, P = CW / 8;
  const int pieces = n * NT * P * 32;
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    int v = i;
    const int t = v & 3;
    v >>= 2;
    const int gl = v & 1;
    v >>= 1;
    const int p = v % P;
    v /= P;
    const int gp = v & 3;
    v >>= 2;
    const int nt = v % NT, j = v / NT;
    const int gq = 2 * gp + gl, m = 8 * nt + gq;
    const int k = (s_lo + j) * STEP_K<FMT> + CW * t + 8 * p;
    const bool ok = m < M && k < K;
    cp_async<16>(dst + ((j * NT + nt) * P + p) * 32 + 4 * gq + t,
                 ok ? x + (size_t)m * K + k : x, ok);
  }
}

// A block of rw warps (blockDim.x / 32), warp w owning row tile w of the
// block's 16 rw rows, over one range of steps_pb steps of K: the block's
// rank in a thread-block cluster of kc blocks along K (blockIdx.x % kc).
// The block stages its x range once (at most gemv_x_max, x_bytes of shared
// memory; each warp's weight ring lies after it).  Each warp streams its
// rows' codes through a ring of GEMV_SLOTS slots of 16 rows x 128 bytes
// (two to four steps a slot) by cp.async, GEMV_SLOTS - 1 slots ahead of
// their use, with one warp barrier a slot and no block barrier in the
// loop; the scales arrive DEPTH steps ahead in registers.  The mma sums
// alternate between two accumulator sets (a shorter dependence chain),
// added at the end.  With kc > 1 the cluster's blocks add their partial
// sums into rank 0 through distributed shared memory in the order rank 0,
// 1, ... (no workspace, no atomics: two launches give the same bits).
// blockIdx.y is the expert.
template <int FMT, int NT>
__global__ void __launch_bounds__(GEMV_MAX_WARPS * 32,
                                  gemv_min_blocks(FMT, NT))
gemv_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ qw, const float* __restrict__ sc,
            const float* __restrict__ zp, __nv_bfloat16* __restrict__ y,
            long long x_stride_e, int M, int K, int O, int g,
            uint32_t g_magic, int kc, int steps_pb, int x_bytes) {
  constexpr int CW = CHUNK<FMT>, CB = CHUNK_BYTES<FMT>, P = CW / 8;
  constexpr int SS = SLOT_STEPS<FMT>, D = DEPTH<FMT>;
  extern __shared__ __align__(128) unsigned char gemv_smem_raw[];
  uint4* xs = reinterpret_cast<uint4*>(gemv_smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int n_warps = blockDim.x / 32;
  unsigned char* ring = gemv_smem_raw + x_bytes + warp * GEMV_RING;
  const int kr = blockIdx.x % kc;
  const int row0 = ((blockIdx.x / kc) * n_warps + warp) * 16;
  const int r0 = row0 + gq;
  const size_t rb = row_bytes<FMT>(K);
  const int ng = K / g;
  const size_t e = blockIdx.y;
  x += e * (size_t)x_stride_e;
  qw += e * (size_t)O * rb;
  sc += e * (size_t)O * ng;
  if (FMT == ASYM4) zp += e * (size_t)O * ng;
  y += e * (size_t)M * O;

  const int n_steps = (K + STEP_K<FMT> - 1) / STEP_K<FMT>;
  const int s_lo = kr * steps_pb;
  const int n_local = max(0, min(n_steps - s_lo, steps_pb));
  const int n_slots = (n_local + SS - 1) / SS;
  // the warp's rows in the ring: n_bytes bytes of each from byte b_lo
  const size_t b_lo = (size_t)s_lo * 4 * CB;
  const size_t b_hi = b_lo + (size_t)n_local * 4 * CB;
  const GemvCopy<FMT> wcopy(qw + (size_t)min(row0, O - 1) * rb, rb,
                            min(16, O - row0), b_lo, lane);
  const size_t n_bytes = (b_hi < rb ? b_hi : rb) - b_lo;
  GemvRows srows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    srows.ok[h] = r < O;
    const size_t rr = srows.ok[h] ? (size_t)r : 0;
    srows.s[h] = sc + rr * ng;
    srows.z[h] = FMT == ASYM4 ? zp + rr * ng : zp;
  }

  float c[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[a][n][i] = 0.f;

  gemv_stage<FMT, NT>(xs, x, s_lo, n_local, M, K);
  cp_commit();
#pragma unroll
  for (int st = 0; st < GEMV_SLOTS - 1; ++st) {
    if (st < n_slots) wcopy.copy(ring + st * 2048, st, n_bytes);
    cp_commit();
  }
  GemvScales sl[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    gemv_scales<FMT>(sl[d], srows, d, n_local, s_lo, t, K, g_magic);
  cp_wait<GEMV_SLOTS - 1>();              // x has landed (this thread's)
  __syncthreads();                        // (every thread's)

  // ring slot st holds steps st * SS .. st * SS + SS - 1; scales of step
  // i sit in sl[i % D] (D = 2 SS: the loop advances two slots at a time)
  for (int st0 = 0; st0 < n_slots; st0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int st = st0 + u;
      if (st < n_slots) {
        cp_wait<GEMV_SLOTS - 2>();        // slot st landed (this lane's)
        __syncwarp();                     // (every lane's), slot st - 1 read
        const int nx = st + GEMV_SLOTS - 1;
        if (nx < n_slots)
          wcopy.copy(ring + (nx % GEMV_SLOTS) * 2048, nx, n_bytes);
        cp_commit();
        const unsigned char* slot = ring + (st % GEMV_SLOTS) * 2048;
#pragma unroll
        for (int ss = 0; ss < SS; ++ss) {
          const int i = st * SS + ss, d = u * SS + ss;
          if (i < n_local) {
            // this lane's chunk of rows g, g + 8 at byte (ss * 4 + t) * CB
            // of the slot's 128-byte row segments
            const int cb = (ss * 4 + t) * CB;
            uint4 w[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = gq + 8 * h;
              const unsigned char* src =
                  slot + r * 128 + (((cb / 16) ^ ((r & 1) << 2)) << 4)
                  + cb % 16;
              if (FMT == INT2) {
                const uint2 v = *reinterpret_cast<const uint2*>(src);
                w[h] = make_uint4(v.x, v.y, 0u, 0u);
              } else {
                w[h] = *reinterpret_cast<const uint4*>(src);
              }
            }
            const uint4* xb = xs + i * NT * P * 32 + lane;
#pragma unroll
            for (int p = 0; p < P; ++p) {
              uint4 xv[NT];
#pragma unroll
              for (int n = 0; n < NT; ++n) xv[n] = xb[(n * P + p) * 32];
#pragma unroll
              for (int hq = 0; hq < 2; ++hq) {
                const int q = 2 * p + hq;
                const int half = (4 * q) / 16;
                float f0[4], f1[4];
                dequant4<FMT>(w[0], q, sl[d].s[0][half], sl[d].z[0][half],
                              f0);
                dequant4<FMT>(w[1], q, sl[d].s[1][half], sl[d].z[1][half],
                              f1);
                const uint32_t a[4] = {pack_bf16(f0[0], f0[1]),
                                       pack_bf16(f1[0], f1[1]),
                                       pack_bf16(f0[2], f0[3]),
                                       pack_bf16(f1[2], f1[3])};
#pragma unroll
                for (int n = 0; n < NT; ++n)
                  mma16816(c[hq][n], a, hq ? xv[n].z : xv[n].x,
                           hq ? xv[n].w : xv[n].y);
              }
            }
          }
          gemv_scales<FMT>(sl[d], srows, i + D, n_local, s_lo, t, K,
                           g_magic);
        }
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[0][n][i] += c[1][n][i];

  // the cluster's partial sums into rank 0, in the order of the ranks
  if (kc > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();                      // every warp's x reads are done
    float* red = reinterpret_cast<float*>(xs);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[((warp * NT + n) * 4 + i) * 32 + lane] = c[0][n][i];
    cluster.sync();
    if (kr == 0) {
      for (int r = 1; r < kc; ++r) {
        const float* other = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            c[0][n][i] += other[((warp * NT + n) * 4 + i) * 32 + lane];
      }
    }
    cluster.sync();                       // the ranks' shared memory stays
    if (kr != 0) return;                  // until rank 0 has read it
  }
  // value i of n-tile n: row r0 + 8 (i / 2), token 8 n + 2 t + i % 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = r0 + 8 * h;
    if (o >= O) continue;
    const float rs = FMT == E4M3 ? __ldg(sc + o) : 1.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = 8 * n + 2 * t + j;
        if (m < M)
          y[(size_t)m * O + o] = __float2bfloat16(c[0][n][2 * h + j] * rs);
      }
  }
}

// The GEMV's grid, from host shapes only (never a tensor's values, so the
// launch can be captured in a CUDA graph): a block takes rw = min(8, row
// tiles) row tiles (each staged x feeds 16 rw rows), and the cluster splits
// K into kc ranges, doubling kc (to 8) while the warps stay within one wave
// of 16 an SM, and further (to 16, H100's non-portable cluster size) until
// a block's x range fits in gemv_x_max.
struct GemvPlan {
  int rw, kc, steps_pb;
};

template <int FMT>
GemvPlan gemv_plan(int E, int M, int K, int O, int sms) {
  const int mt = M <= 8 ? 8 : M <= 16 ? 16 : 32;
  const int steps = (K + STEP_K<FMT> - 1) / STEP_K<FMT>;
  const int tiles = (O + 15) / 16;
  const int rw = min(GEMV_MAX_WARPS, tiles);
  const long long warps = (long long)E * ((tiles + rw - 1) / rw) * rw;
  auto x_bytes = [&](int kc) {
    return (long long)((steps + kc - 1) / kc) * STEP_K<FMT> * mt * 2;
  };
  int kc = 1;
  while (2 * kc <= GEMV_MAX_CLUSTER && 2 * kc <= steps
         && ((2 * kc <= 8 && warps * 2 * kc <= 16LL * sms)
             || x_bytes(kc) > gemv_x_max(mt / 8)))
    kc *= 2;
  return {rw, kc, (steps + kc - 1) / kc};
}

// Dynamic shared memory of a plan: its x range (or the cluster's partial
// sums if larger), then each warp's weight ring.
template <int FMT, int NT>
int gemv_x_bytes(const GemvPlan& p) {
  const int xb = p.steps_pb * STEP_K<FMT> * NT * 8 * 2;
  const int red = p.kc > 1 ? p.rw * NT * 4 * 32 * 4 : 0;
  const int b = xb > red ? xb : red;
  return (b + 127) / 128 * 128;
}

template <int FMT, int NT>
int gemv_smem(const GemvPlan& p) {
  return gemv_x_bytes<FMT, NT>(p) + p.rw * GEMV_RING;
}

// The SM count of the current device.
inline int device_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Whether a block's x range under plan p fits its shared memory.
template <int FMT, int NT>
bool gemv_fits(const GemvPlan& p) {
  return gemv_x_bytes<FMT, NT>(p) <= gemv_x_max(NT);
}

template <int FMT, int NT>
cudaError_t launch_gemv(const GemvPlan& p, const __nv_bfloat16* x,
                        const uint8_t* qw, const float* sc, const float* zp,
                        __nv_bfloat16* y, int E, long long xse, int M, int K,
                        int O, int g, cudaStream_t st) {
  const int smem = gemv_smem<FMT, NT>(p);
  cudaError_t err = cudaFuncSetAttribute(
      gemv_kernel<FMT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMV_SMEM_MAX);
  if (err == cudaSuccess && p.kc > 8)
    err = cudaFuncSetAttribute(gemv_kernel<FMT, NT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  const int tiles = (O + 15) / 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + p.rw - 1) / p.rw * p.kc, E);
  cfg.blockDim = dim3(32 * p.rw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.kc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const uint32_t g_magic = (uint32_t)((0x100000000ULL + g - 1) / g);
  return cudaLaunchKernelEx(&cfg, gemv_kernel<FMT, NT>, x, qw, sc, zp, y,
                            xse, M, K, O, g, g_magic, p.kc, p.steps_pb,
                            gemv_x_bytes<FMT, NT>(p));
}

// The GEMV's resources on this card for M rows (its n-tile tier) and its
// plan for (E, M, K, O): info = {registers a thread, local (spill) bytes a
// thread, dynamic shared bytes a block, blocks per SM at the plan's block
// size and shared memory, rw (row tiles a block), kc (blocks a cluster
// along K)}.
template <int FMT>
int gemv_info(int E, int M, int K, int O, int* info) {
  cudaFuncAttributes a;
  int blocks = 0;
  const GemvPlan p = gemv_plan<FMT>(E, M, K, O, device_sms());
  const void* fn = M <= 8    ? (const void*)gemv_kernel<FMT, 1>
                   : M <= 16 ? (const void*)gemv_kernel<FMT, 2>
                             : (const void*)gemv_kernel<FMT, 4>;
  const int smem = M <= 8    ? gemv_smem<FMT, 1>(p)
                   : M <= 16 ? gemv_smem<FMT, 2>(p)
                             : gemv_smem<FMT, 4>(p);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMV_SMEM_MAX);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        32 * p.rw, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  info[4] = p.rw;
  info[5] = p.kc;
  return 0;
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
  // M <= 32: the GEMV, unless a block's x range would not fit even split
  // over a cluster of 16 (K past ~32k at M = 32); the GEMM body takes any M
  if (M <= 32) {
    const GemvPlan p = gemv_plan<FMT>(E, M, K, O, device_sms());
    if (M <= 8 && gemv_fits<FMT, 1>(p))
      return (int)launch_gemv<FMT, 1>(p, x, qw, sc, zp, y, E, xse, M, K, O, g,
                                      st);
    if (M > 8 && M <= 16 && gemv_fits<FMT, 2>(p))
      return (int)launch_gemv<FMT, 2>(p, x, qw, sc, zp, y, E, xse, M, K, O, g,
                                      st);
    if (M > 16 && gemv_fits<FMT, 4>(p))
      return (int)launch_gemv<FMT, 4>(p, x, qw, sc, zp, y, E, xse, M, K, O, g,
                                      st);
  }
  int smem = 0;
  const cudaError_t err = gemm_smem<FMT>(&smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, E);
  gemm_kernel<FMT><<<grid, GEMM_THREADS, smem, st>>>(x, qw, sc, zp, y, xse,
                                                      M, K, O, g);
  return (int)cudaGetLastError();
}

}  // namespace w4a16
