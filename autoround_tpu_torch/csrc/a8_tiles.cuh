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
// the tensor cores (wgmma m64n128k32 s8, GEMM body, M > 32; mma.sync
// m16n8k32 s8, GEMV body, M <= 32).  The W8A8 kernels keep one int32 sum
// over the whole K and apply `float(acc) * xs * ws` in that order.  The
// W4A8 kernels turn each nibble into a signed int8 `code - 8` and feed it
// to the same product, close every group of g columns by `accf +=
// float(acc) * s_g` (separate multiply and add, no FMA: the plain
// version's fp32 operations in its order) and end with `* xs`, so the
// fp32 result is the plain version's bit for bit; a GEMV whose K is split
// over a cluster adds its ranks' fp32 partial sums (each a whole number of
// groups) in rank order, the only difference from that order.
//
// Layouts: xi (M, K) int8 row-major is the A operand of the GEMM; Wi (O, K)
// int8 row-major is its B operand as it lies (both K-major, which is all
// 8-bit wgmma takes); the int4 words are those of the W4A16 kernels (word w
// of a row holds columns 8w..8w+7, column 8w+j in nibble j), so one packed
// copy of the weights serves A16 and A8.  The GEMV swaps the operands (the
// weights are the A of its mma.sync, see below).
//
// What bounds them on an H100: at decode (M <= 32) the weight stream (1 or
// 0.5 byte a weight against 2*M operations), which the GEMV keeps in
// flight with a cp.async ring a warp and, where the row tiles alone give
// the card too few warps, a split of K over a thread-block cluster; the
// products run on the tensor cores and the int4 codes cost the CUDA cores
// under one integer operation each.  At prefill the int8 tensor
// cores (1979 TOP/s dense) and, for W4A8, the group close: 4 operations
// per output a group of 128 columns, which at the tensor cores' rate would
// take every issue slot of the SM.  The GEMM body carries over the A16
// GEMM's shape (w4a16_tiles.cuh): a ring of k-steps of 128 int8 columns
// (one 128-byte swizzled row) filled by TMA copies on mbarriers,
// asynchronous wgmma read from shared memory through descriptors, one
// block barrier a k-step with two steps of products in flight across it.
// W8A8 feeds the weight tile to wgmma as it lands; W4A8 turns the packed
// words into s8 once a k-step, block-wide, while the step's products run,
// and folds each group while the next group's products run (see Gemm and
// gemm_kernel below).
// The ragged M and O edges are masked (zero-filled tiles, guarded stores).
// Needs K % 32 == 0 (W4: g % 32 == 0 and K % g == 0); a k-step past K in
// 32-column pieces is neither loaded nor multiplied.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "sm90_ptx.cuh"

namespace a8 {

namespace cg = cooperative_groups;

using namespace ptx;

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
//
// M <= 32: products on mma.sync.m16n8k32 with the operands swapped.  The
// weights are A (16 output rows x 32 k), the activation codes B (32 k x 8
// tokens, s8), so M <= 8 is one n-tile, M <= 16 two and M <= 32 four.  Each
// mma takes one aligned 32-column chunk of K: lane (g, t) feeds 8 columns
// 8t .. 8t + 7 of it, four as k 4t .. 4t + 3 (a[0] row g, a[1] row g + 8,
// b0 token g) and four as k 16 + 4t .. (a[2], a[3], b1).  W8A8: the first
// four columns, then the last four, s8 x s8.  W4A8: the even columns, then
// the odd ones -- a word's even and odd nibbles are its codes 0..15 as
// bytes after one mask (and a shift), u8 x s8 -- and a second mma of the
// constant -8 (s8) with the same B adds -8 sum(x), so the int32 sum is
// that of (code - 8) x.  A W4A8 group (g % 32 == 0) is whole after g / 32
// chunks, its int32 sum exact, and it is closed there by `accf = accf +
// float(acc) * s_g` (separate multiply and add, the plain version's
// operations in its order); W8A8 keeps one int32 sum over its range of K.
//
// A block of rw warps (blockDim.x / 32, rw <= 8) owns 16 rw output rows,
// warp w row tile w, over one range of K: its rank kr in a thread-block
// cluster of kc blocks along K (blockIdx.x % kc).  The block stages its
// range of the codes of x once, in fragment order: the 32 codes of token
// 8 nt + g of chunk c lie at byte (c NT + nt) 256 + 32 g (W4A8: each lane's
// 8 columns even ones first), so a lane's b0, b1 are one 8-byte read and a
// warp's B operands 256 contiguous bytes.  Each warp streams its 16 rows
// through a ring of GEMV_SLOTS slots of 16 rows x SEG bytes by cp.async,
// one slot ahead, with one warp barrier a slot and no block barrier in the
// loop; W4A8 copies the scales of the groups a slot touches beside its
// weights, so the group close reads them from shared memory.  A 16-byte
// unit u of row r of a slot lies at unit u ^ (r % 8) (W4A8: a lane reads
// word t of a unit, rows g = 0..7 in distinct banks) or u ^ 2 (r % 4)
// (W8A8: 8 bytes at 8 t of a 32-byte chunk, a half warp's four rows in
// distinct banks).  With kc > 1 a rank's range is a whole number of
// groups (W4A8) and rank 0 adds the cluster's partial sums (int32; W4A8
// fp32) through distributed shared memory in the order of the ranks: no
// workspace, no atomics, two launches give the same bits.
//
// What bounds it (H100, decode shapes of llama3-8b): at lm_head and gate_up
// (kc = 1) the weight stream, at 2.3-2.9 TB/s; at qkv, o_proj and down_proj
// (K split over 4-8 ranks) fixed costs of a few microseconds a launch --
// the x staging, one slot of latency after another, the cluster's
// reduction -- which the dp4a parent, one short block per 4 rows with all
// its loads in flight at once, did not pay: at M = 1 the parent stays
// ahead (PERF.md).  Deeper rings, wider slots, 4-warp blocks, other splits
// of K (across a block's warps too) and a quantizer fused into the staging
// were each no faster on the card.

constexpr int GEMV_MAX_WARPS = 8;
constexpr int GEMV_MAX_CLUSTER = 16;      // beyond 8: a non-portable size
constexpr int GEMV_SLOTS = 2;             // a warp's ring
constexpr int SEG = 128;                  // bytes of a weight row a slot holds
constexpr int SLOT_W = 16 * SEG;          // a slot's weight bytes
// weight bytes of a 32-column chunk of a row, chunks a slot holds, bytes
// of a slot (W4A8: and the scales of the at most SLOT_CHUNKS groups its
// chunks touch, [group][16 rows] fp32)
template <bool W4>
constexpr int CHUNK_B = W4 ? 16 : 32;
template <bool W4>
constexpr int SLOT_CHUNKS = SEG / CHUNK_B<W4>;
template <bool W4>
constexpr int SLOT_BYTES = SLOT_W + (W4 ? SLOT_CHUNKS<true> * 16 * 4 : 0);
template <bool W4>
constexpr int GEMV_RING = GEMV_SLOTS * SLOT_BYTES<W4>;
// x a block may stage, and blocks an SM: one n-tile (M <= 8) keeps three
// blocks of 8 warps, more n-tiles two (x up to 64 KB)
constexpr int gemv_x_max(int nt) { return nt == 1 ? 32 << 10 : 64 << 10; }
constexpr int gemv_min_blocks(int nt) { return nt == 1 ? 3 : 2; }
template <bool W4>
constexpr int gemv_smem_max(int nt) {
  return gemv_x_max(nt) + GEMV_MAX_WARPS * GEMV_RING<W4>;
}
// warps an SM below which the plan splits K further (up to 8 ranks)
constexpr int GEMV_WARPS_PER_SM = 16;

// byte offset of 16-byte unit u of row r in a slot
template <bool W4>
__device__ __forceinline__ int slot_off(int r, int u) {
  return r * SEG + ((u ^ (W4 ? (r & 7) : ((r & 3) << 1))) << 4);
}

// A lane's part of copying one slot of the warp's 16 weight rows (SEG bytes
// of each) into shared memory: each copy instruction of the warp reads
// whole SEG-byte row segments.  Everything but the segment is fixed for the
// lane, so it is worked out once.
template <bool W4>
struct GemvCopy {
  static constexpr int PER_ROW = SEG / 16;
  static constexpr int N = 16 * PER_ROW / 32;        // copies a lane
  const uint8_t* src[N];   // the lane's row at the range's first byte
  int off[N];              // its place in a slot
  bool row_ok[N];
  int col;                 // its byte within a segment

  __device__ __forceinline__ GemvCopy(const uint8_t* w0, size_t rb, int rows,
                                      int lane) {
    col = (lane % PER_ROW) * 16;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int r = (32 * j + lane) / PER_ROW;
      row_ok[j] = r < rows;
      src[j] = w0 + (row_ok[j] ? (size_t)r * rb : 0) + col;
      off[j] = slot_off<W4>(r, lane % PER_ROW);
    }
  }

  // segment `st` of the range into `slot`; rows past O and bytes past the
  // range (n_bytes) are zeros
  __device__ __forceinline__ void copy(unsigned char* slot, int st,
                                       int n_bytes) const {
    const bool in = st * SEG + col < n_bytes;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool ok = in && row_ok[j];
      cp_async<16>(slot + off[j], ok ? src[j] + (size_t)st * SEG : src[j], ok);
    }
  }
};

// W4A8: the scales of the groups that chunks c0 .. c1 - 1 (global) touch,
// for the warp's 16 rows from row0, into ss[group - c0 / gc][row] (zeros
// past O).  c / gc is c g_magic >> 32 with g_magic = ceil(2^32 / gc) (2^32
// at gc = 1, hence 64 bits): exact for c gc < 2^32.
__device__ __forceinline__ void gemv_scales(float* ss, const float* sc,
                                            int row0, int O, int ng, int c0,
                                            int c1, uint64_t g_magic,
                                            int lane) {
  const int gi0 = (int)((uint64_t)c0 * g_magic >> 32);
  const int cnt = (int)((uint64_t)(c1 - 1) * g_magic >> 32) - gi0 + 1;
  for (int i = lane; i < 16 * cnt; i += 32) {
    const int r = i % 16, j = i / 16;
    const bool ok = row0 + r < O;
    cp_async<4>(ss + i, ok ? sc + (size_t)(row0 + r) * ng + gi0 + j : sc, ok);
  }
}

// W4A8 group close: accf = accf + float(a0 + a1) * s (the row's scale), and
// the group's sums back to zero.  Value i of an n-tile is row g (i < 2) or
// g + 8.
template <int NT>
__device__ __forceinline__ void close_group(float (&accf)[NT][4],
                                            int (&acc)[2][NT][4], float s0,
                                            float s1) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = acc[0][n][i] + acc[1][n][i];
      acc[0][n][i] = acc[1][n][i] = 0;
      accf[n][i] = __fadd_rn(accf[n][i],
                             __fmul_rn(__int2float_rn(v), i < 2 ? s0 : s1));
    }
}

// xi (M, K) int8 codes and xs (M,) scales of quantize_rows; w: Wi (O, K)
// int8 (W8A8) or the packed words (O, K / 8) int32 (W4A8); sc: ws (O,) or
// the scales (O, K / g); gc = g / 32 (W4A8); a rank takes cpb chunks from
// kr cpb; x_bytes: the shared bytes before the rings.
template <bool W4, int NT>
__global__ void __launch_bounds__(GEMV_MAX_WARPS * 32, gemv_min_blocks(NT))
gemv_kernel(const int8_t* __restrict__ xi, const float* __restrict__ xs,
            const uint8_t* __restrict__ w, const float* __restrict__ sc,
            __nv_bfloat16* __restrict__ y, float* __restrict__ y32, int M,
            int K, int O, int gc, uint64_t g_magic, int kc, int cpb,
            int x_bytes) {
  constexpr int SC = SLOT_CHUNKS<W4>, CB = CHUNK_B<W4>;
  extern __shared__ __align__(128) unsigned char a8_gemv_smem[];
  unsigned char* xsm = a8_gemv_smem;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int n_warps = blockDim.x / 32;
  unsigned char* ring = a8_gemv_smem + x_bytes + warp * GEMV_RING<W4>;
  const int kr = blockIdx.x % kc;
  const int row0 = ((blockIdx.x / kc) * n_warps + warp) * 16;
  const int n_chunks = K / 32;
  const int c_lo = kr * cpb;
  const int n_local = max(0, min(n_chunks - c_lo, cpb));
  const int n_slots = (n_local + SC - 1) / SC;
  const size_t rb = (size_t)n_chunks * CB;
  const int ng = W4 ? n_chunks / gc : 1;
  const GemvCopy<W4> wcopy(w + (size_t)min(row0, O - 1) * rb
                               + (size_t)c_lo * CB,
                           rb, min(16, O - row0), lane);
  const int n_bytes = n_local * CB;

  auto issue = [&](int st) {
    unsigned char* slot = ring + (st % GEMV_SLOTS) * SLOT_BYTES<W4>;
    wcopy.copy(slot, st, n_bytes);
    if constexpr (W4)
      gemv_scales(reinterpret_cast<float*>(slot + SLOT_W), sc, row0, O, ng,
                  c_lo + st * SC, c_lo + min(n_local, st * SC + SC), g_magic,
                  lane);
  };
#pragma unroll
  for (int st = 0; st < GEMV_SLOTS - 1; ++st) {
    if (st < n_slots) issue(st);
    cp_commit();
  }
  // x, while the ring fills: 16-byte piece p of token m's chunk c (lanes
  // 2p, 2p + 1 of the token's row g = m % 8); sixteen consecutive threads
  // write a chunk's 256 contiguous bytes; tokens past M are zeros.  W4A8
  // stores a lane's 8 columns as the even ones, then the odd ones: the k
  // order of its A, the even and the odd nibbles of a word.
  const int pieces = NT * 8 * n_local * 2;
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    const int p = i & 1, m = (i >> 1) % (NT * 8), c = (i >> 1) / (NT * 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M)
      v = __ldg(reinterpret_cast<const uint4*>(
          xi + (size_t)m * K + (size_t)(c_lo + c) * 32 + 16 * p));
    if constexpr (W4)
      v = make_uint4(__byte_perm(v.x, v.y, 0x6420),
                     __byte_perm(v.x, v.y, 0x7531),
                     __byte_perm(v.z, v.w, 0x6420),
                     __byte_perm(v.z, v.w, 0x7531));
    *reinterpret_cast<uint4*>(xsm + (c * NT + m / 8) * 256 + 32 * (m % 8)
                              + 16 * p) = v;
  }

  int acc[2][NT][4];
  float accf[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[0][n][i] = acc[1][n][i] = 0;
      accf[n][i] = 0.f;
    }
  __syncthreads();                        // x is staged

  int gcnt = 0;                           // W4A8: chunks into the open group
  const uint32_t MINUS8[4] = {0xF8F8F8F8u, 0xF8F8F8F8u, 0xF8F8F8F8u,
                              0xF8F8F8F8u};
  for (int st = 0; st < n_slots; ++st) {
    cp_wait<GEMV_SLOTS - 2>();            // slot st landed (this lane's)
    __syncwarp();                         // (every lane's), slot st - 1 read
    if (st + GEMV_SLOTS - 1 < n_slots) issue(st + GEMV_SLOTS - 1);
    cp_commit();
    const unsigned char* slot = ring + (st % GEMV_SLOTS) * SLOT_BYTES<W4>;
    const float* ss = reinterpret_cast<const float*>(slot + SLOT_W);
    int j = 0;                            // W4A8: the slot's open group
#pragma unroll
    for (int q = 0; q < SC; ++q) {
      const int c = st * SC + q;
      if (c < n_local) {
        uint32_t a[4];
        if constexpr (W4) {               // codes 0..15, even / odd
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
              slot + slot_off<true>(gq, q) + 4 * t);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
              slot + slot_off<true>(gq + 8, q) + 4 * t);
          a[0] = w0 & 0x0F0F0F0Fu;
          a[1] = w1 & 0x0F0F0F0Fu;
          a[2] = (w0 >> 4) & 0x0F0F0F0Fu;
          a[3] = (w1 >> 4) & 0x0F0F0F0Fu;
        } else {
          const int u = 2 * q + (t >> 1), b = 8 * (t & 1);
          const uint2 r0 = *reinterpret_cast<const uint2*>(
              slot + slot_off<false>(gq, u) + b);
          const uint2 r1 = *reinterpret_cast<const uint2*>(
              slot + slot_off<false>(gq + 8, u) + b);
          a[0] = r0.x;
          a[2] = r0.y;
          a[1] = r1.x;
          a[3] = r1.y;
        }
        const uint2* xb =
            reinterpret_cast<const uint2*>(xsm + c * NT * 256) + lane;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 bv = xb[n * 32];
          if constexpr (W4) {             // sum (code - 8) x: code x, - 8 x
            mma_u8s8(acc[q & 1][n], a, bv.x, bv.y);
            mma_s8(acc[q & 1][n], MINUS8, bv.x, bv.y);
          } else {
            mma_s8(acc[q & 1][n], a, bv.x, bv.y);
          }
        }
        if constexpr (W4) {
          if (++gcnt == gc) {             // the group closes here
            close_group<NT>(accf, acc, ss[16 * j + gq], ss[16 * j + gq + 8]);
            gcnt = 0;
            ++j;
          }
        }
      }
    }
  }
  cp_wait<0>();
  if constexpr (!W4) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][n][i] += acc[1][n][i];
  }

  // the cluster's partial sums into rank 0, in the order of the ranks
  if (kc > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();                      // every warp's x reads are done
    uint32_t* red = reinterpret_cast<uint32_t*>(xsm);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[((warp * NT + n) * 4 + i) * 32 + lane] =
            W4 ? __float_as_uint(accf[n][i]) : (uint32_t)acc[0][n][i];
    cluster.sync();
    if (kr == 0) {
      // RB ranks' values are read together (one remote round trip), then
      // added in rank order
      constexpr int RB = NT == 1 ? 4 : 2;
      for (int r0 = 1; r0 < kc; r0 += RB) {
        uint32_t v[RB][NT][4];
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          if (r0 + b < kc) {
            const uint32_t* other = cluster.map_shared_rank(red, r0 + b);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[b][n][i] = other[((warp * NT + n) * 4 + i) * 32 + lane];
          }
        }
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          if (r0 + b < kc) {
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if constexpr (W4)
                  accf[n][i] = __fadd_rn(accf[n][i],
                                         __uint_as_float(v[b][n][i]));
                else acc[0][n][i] += (int)v[b][n][i];
              }
          }
        }
      }
    }
    cluster.sync();                       // the ranks' shared memory stays
    if (kr != 0) return;                  // until rank 0 has read it
  }
  // value i of n-tile n: row row0 + g + 8 (i / 2), token 8 n + 2 t + i % 2;
  // W8A8 float(acc) * xs * ws, W4A8 accf * xs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = row0 + gq + 8 * h;
    if (o >= O) continue;
    const float wso = W4 ? 1.f : __ldg(sc + o);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * n + 2 * t + e, i = 2 * h + e;
        if (m >= M) continue;
        const float f =
            W4 ? __fmul_rn(accf[n][i], __ldg(xs + m))
               : __fmul_rn(__fmul_rn(__int2float_rn(acc[0][n][i]),
                                     __ldg(xs + m)), wso);
        if (y32) y32[(size_t)m * O + o] = f;
        else y[(size_t)m * O + o] = __float2bfloat16(f);
      }
  }
}

// The GEMV's grid, from host shapes only (never a tensor's values, so the
// launch can be captured in a CUDA graph): a block takes rw = min(8, row
// tiles) row tiles (each staged x feeds 16 rw rows), and the cluster splits
// K into kc ranges of whole units (W4A8: a group of g / 32 chunks; W8A8: a
// chunk), doubling kc (to 8) while the warps stay below GEMV_WARPS_PER_SM
// an SM, and further (to 16, H100's non-portable cluster size) until a
// block's x range fits in gemv_x_max.
struct GemvPlan {
  int rw, kc, cpb;           // cpb: chunks of K a rank
};

inline GemvPlan gemv_plan(int M, int K, int O, int unit, int sms) {
  const int nt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
  const int units = K / 32 / unit;
  const int tiles = (O + 15) / 16;
  const int rw = min(GEMV_MAX_WARPS, tiles);
  const long long warps = (long long)((tiles + rw - 1) / rw) * rw;
  auto x_bytes = [&](int kc) {
    return (long long)((units + kc - 1) / kc) * unit * nt * 256;
  };
  int kc = 1;
  while (2 * kc <= GEMV_MAX_CLUSTER && 2 * kc <= units
         && ((2 * kc <= 8 && warps * 2 * kc <= GEMV_WARPS_PER_SM * sms)
             || x_bytes(kc) > gemv_x_max(nt)))
    kc *= 2;
  return {rw, kc, (units + kc - 1) / kc * unit};
}

// Dynamic shared memory of a plan: its x range (or the cluster's partial
// sums if larger), then each warp's ring.
template <int NT>
int gemv_x_bytes(const GemvPlan& p) {
  const int xb = p.cpb * NT * 256;
  const int red = p.kc > 1 ? p.rw * NT * 4 * 32 * 4 : 0;
  const int b = xb > red ? xb : red;
  return (b + 127) / 128 * 128;
}

template <bool W4, int NT>
int gemv_smem(const GemvPlan& p) {
  return gemv_x_bytes<NT>(p) + p.rw * GEMV_RING<W4>;
}

// The SM count of the current device.
inline int device_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

inline int gemv_unit(bool w4, int g) { return w4 ? g / 32 : 1; }

template <bool W4, int NT>
cudaError_t launch_gemv(const GemvPlan& p, const int8_t* xi, const float* xs,
                        const void* w, const float* sc, __nv_bfloat16* y,
                        float* y32, int M, int K, int O, int g,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gemv_kernel<W4, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gemv_smem_max<W4>(NT));
  if (err == cudaSuccess && p.kc > 8)
    err = cudaFuncSetAttribute(gemv_kernel<W4, NT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  const int tiles = (O + 15) / 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + p.rw - 1) / p.rw * p.kc);
  cfg.blockDim = dim3(32 * p.rw);
  cfg.dynamicSmemBytes = gemv_smem<W4, NT>(p);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.kc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemv_kernel<W4, NT>, xi, xs,
                            static_cast<const uint8_t*>(w), sc, y, y32, M, K,
                            O, W4 ? g / 32 : 0,
                            W4 ? (0x100000000ULL + g / 32 - 1) / (g / 32)
                               : 0ULL,
                            p.kc, p.cpb, gemv_x_bytes<NT>(p));
}

// The GEMV body (M <= 32) if its x range fits: returns -1 where it does not
// (the GEMM body takes the shape), else the launch's cudaError_t.
template <bool W4>
int try_gemv(const int8_t* xi, const float* xs, const void* w,
             const float* sc, __nv_bfloat16* y, float* y32, int M, int K,
             int O, int g, cudaStream_t st) {
  const GemvPlan p = gemv_plan(M, K, O, gemv_unit(W4, g), device_sms());
  if (M <= 8 && gemv_x_bytes<1>(p) <= gemv_x_max(1))
    return (int)launch_gemv<W4, 1>(p, xi, xs, w, sc, y, y32, M, K, O, g, st);
  if (M > 8 && M <= 16 && gemv_x_bytes<2>(p) <= gemv_x_max(2))
    return (int)launch_gemv<W4, 2>(p, xi, xs, w, sc, y, y32, M, K, O, g, st);
  if (M > 16 && M <= 32 && gemv_x_bytes<4>(p) <= gemv_x_max(4))
    return (int)launch_gemv<W4, 4>(p, xi, xs, w, sc, y, y32, M, K, O, g, st);
  return -1;
}

// The GEMV's resources on this card for M rows (its n-tile tier) and its
// plan for (M, K, O, g): info = {registers a thread, local (spill) bytes a
// thread, dynamic shared bytes a block, blocks per SM at the plan's block
// size and shared memory, rw (row tiles a block), kc (blocks a cluster
// along K)}.
template <bool W4>
int gemv_info(int M, int K, int O, int g, int* info) {
  if (M <= 0 || M > 32 || K <= 0 || K % 32 || O <= 0
      || (W4 && (g <= 0 || g % 32 || K % g)))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  int blocks = 0;
  const GemvPlan p = gemv_plan(M, K, O, gemv_unit(W4, g), device_sms());
  const void* fn = M <= 8    ? (const void*)gemv_kernel<W4, 1>
                   : M <= 16 ? (const void*)gemv_kernel<W4, 2>
                             : (const void*)gemv_kernel<W4, 4>;
  const int smem = M <= 8    ? gemv_smem<W4, 1>(p)
                   : M <= 16 ? gemv_smem<W4, 2>(p)
                             : gemv_smem<W4, 4>(p);
  const int nt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, gemv_smem_max<W4>(nt));
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

// ------------------------------------------------------------------ GEMM

constexpr int BK = 128;         // int8 columns a k-step: one 128-byte row
constexpr int BN = 128;
constexpr int GROUP_M = 16;     // m-tiles a band of blocks shares

// Tile shapes.  Each warpgroup (4 warps) owns 64 rows x all 128 columns of
// the block's tile: 64 int32 accumulators a thread.
//  * W8A8: 256 x 128, four warpgroups (512 threads, at most 128 registers
//    a thread); the weight tile goes from the ring to wgmma as it lies.
//    A ring of 4 slots, copies 2 steps ahead.
//  * W4A8: 128 x 128, two warpgroups (256 threads): a thread holds the
//    group's int32 sums and the fp32 sum of the closed groups (64 + 64
//    registers, beside addresses: more than 128).  A slot holds the
//    packed words and the scales of the groups the step touches (at most
//    BK / 32); the words become s8 once a k-step, block-wide, into one of
//    three swizzled tiles.  A thread closes a group for 32 output columns,
//    so its scales are 32 values a group: they are read from the slot at
//    the group close (no global load there), not held in registers a step
//    ahead beside the 192 accumulators.  A ring of 5 slots, copies 3 steps
//    ahead (one step's slot is read by the dequantization a step before
//    its products).
// The activation and weight tiles (and the W4A8 scales at g = 128) arrive
// by TMA: one thread issues the tensor copies of a step, the 128-byte
// swizzle is the copy's own, boxes past M, O or K read as zeros, and the
// bytes complete on the slot's mbarrier.  Per-thread cp.async copies (the
// scales at any other g) take issue slots and registers from the threads
// that run the products and the group close.
template <bool W4>
struct Gemm {
  static constexpr int BM = W4 ? 128 : 256;
  static constexpr int THREADS = BM * 2;            // 128 per warpgroup
  static constexpr int STAGES = W4 ? 5 : 4;
  static constexpr int AHEAD = STAGES - 2;          // copies this far ahead
  static constexpr int W_ROW = W4 ? BK / 2 : BK;    // weight bytes a row
  static constexpr int NGS = BK / 32;               // groups a step touches
  static constexpr int w_off = BM * BK;
  static constexpr int s_off = w_off + BN * W_ROW;
  static constexpr int slot = s_off + (W4 ? NGS * BN * 4 : 0);
  static_assert(slot % 1024 == 0, "tiles start on 1 KB (wgmma swizzle)");
  static constexpr int tx_bytes = BM * BK + BN * W_ROW;   // TMA tile bytes
  static constexpr int NB = 3;                      // W4A8: s8 weight tiles
  static constexpr int bar_off = STAGES * slot + (W4 ? NB * BN * BK : 0);
  static constexpr int smem = bar_off + 8 * STAGES + 1024;
};

// d (64 x 128 int32 of this warpgroup) = (scale_d ? d : 0) + A (64 x 32
// s8) . B (32 x 128 s8), both read from shared memory through their
// descriptors (K-major, 128-byte swizzle); issued asynchronously, complete
// after wgmma_wait.  Integer sums are exact (|sum| < 2^31 for K < 2^17).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int* d, uint64_t da,
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// Fill ring slot `st` with k-step k0 (one thread): the activation codes
// (BM x BK, swizzled by the copy) and the weight tile (W8A8: BN x BK int8
// swizzled, as wgmma reads it; W4A8: BN rows of 64 bytes of packed words),
// both counted on the slot's barrier; with `tmS` (W4A8 at g = 128) also the
// step's group scale as part of a [BN][4] fp32 box: columns 4 (gi / 4) ..
// 4 (gi / 4) + 3 of the scales, gi = k0 / 128 (a box starts on 16 bytes).
template <bool W4>
__device__ __forceinline__ void tma_slot(unsigned char* st, uint64_t* bar,
                                         const CUtensorMap* tmA,
                                         const CUtensorMap* tmW,
                                         const CUtensorMap* tmS, int m0,
                                         int n0, int k0) {
  mbar_expect_tx(bar, Gemm<W4>::tx_bytes + (tmS ? BN * 16 : 0));
  tma_load_2d(st, tmA, k0, m0, bar);
  tma_load_2d(st + Gemm<W4>::w_off, tmW, W4 ? k0 / 2 : k0, n0, bar);
  if (tmS)
    tma_load_2d(st + Gemm<W4>::s_off, tmS, 16 * (k0 / BK / 4), n0, bar);
}

// W4A8 (every thread): the scales of the groups gi0 = k0 / g .. that k-step
// k0's columns touch, [j][BN] fp32 in the slot, by cp.async (zeros past O),
// then one commit group.
__device__ __forceinline__ void scale_slot(unsigned char* st, const float* sc,
                                           int n0, int k0, int K, int O,
                                           int g) {
  const int ng = K / g, gi0 = k0 / g;
  const int cnt = (min(k0 + BK, K) - 1) / g - gi0 + 1;
  float* Ss = reinterpret_cast<float*>(st + Gemm<true>::s_off);
  for (int i = threadIdx.x; i < cnt * BN; i += Gemm<true>::THREADS) {
    const int j = i / BN, r = i % BN;
    const bool ok = n0 + r < O;
    cp_async<4>(Ss + j * BN + r,
                ok ? sc + (size_t)(n0 + r) * ng + gi0 + j : sc, ok);
  }
  cp_commit();
}

// W4A8: the packed words of slot `st` as signed `code - 8` int8 into the
// swizzled tile Bs (BN x BK); thread (r, q) turns 64 columns of row r.
__device__ __forceinline__ void dequant_slot(const unsigned char* st,
                                             unsigned char* Bs) {
  const int r = threadIdx.x >> 1, q = threadIdx.x & 1;
  const uint4* src = reinterpret_cast<const uint4*>(
      st + Gemm<true>::w_off + r * Gemm<true>::W_ROW + 32 * q);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 wv = src[h];
    uint4 a, b;
    w4_to_s8(wv.x, a.x, a.y);
    w4_to_s8(wv.y, a.z, a.w);
    w4_to_s8(wv.z, b.x, b.y);
    w4_to_s8(wv.w, b.z, b.w);
    *reinterpret_cast<uint4*>(Bs + swz128(r, 4 * q + 2 * h)) = a;
    *reinterpret_cast<uint4*>(Bs + swz128(r, 4 * q + 2 * h + 1)) = b;
  }
}

// float(v) exactly for |v| < 2^22: the bits of 1.5 * 2^23 plus v are the
// float 1.5 * 2^23 + v (its ulp is 1), and the subtraction is exact: an
// integer add and a float subtract in place of a conversion instruction.
__device__ __forceinline__ float small_int_to_float(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.0f;
}

// W4A8 group close: accf += float(acc) * s_g (separate multiply and add,
// the plain version's fp32 operations in its order).  Value 4j + c of a
// lane is column 8j + 2t + c % 2 of the tile; the scale of column n is
// Sg[n * SST] (SST 1: the cp.async [j][BN] layout; 4: the TMA [BN][4] box).
// SMALL: |acc| < 2^22, as a group of at most 4096 columns guarantees
// (|code - 8| <= 8, |q8(x)| <= 127).
template <bool SMALL, int SST>
__device__ __forceinline__ void fold_group(float* accf, const int* acc,
                                           const float* Sg, int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float s[2];
    if constexpr (SST == 1) {
      const float2 v = *reinterpret_cast<const float2*>(Sg + 8 * j + 2 * t);
      s[0] = v.x;
      s[1] = v.y;
    } else {
      s[0] = Sg[(8 * j + 2 * t) * SST];
      s[1] = Sg[(8 * j + 2 * t + 1) * SST];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = acc[4 * j + c];
      const float f = SMALL ? small_int_to_float(v) : __int2float_rn(v);
      accf[4 * j + c] = __fadd_rn(accf[4 * j + c], __fmul_rn(f, s[c & 1]));
    }
  }
}

// The three GEMM bodies: W8A8; W4A8 at g = 128 (one group a k-step: the
// served g); W4A8 at any other g.
constexpr int W8 = 0, W4_G128 = 1, W4_ANY = 2;

// Tensor maps (bytes): tmA the activation codes (M, K); tmW Wi (O, K) for
// W8, the packed words (O, K / 2 bytes) for W4_*; tmS (W4_G128) the scales
// (O, 4 K / 128 bytes).  sc: ws (O,) for W8 (the epilogue), the scales (O,
// K / g) for W4_ANY (cp.async).  Blocks walk the (m-tile, n-tile) grid in
// bands of GROUP_M m-tiles, so the blocks resident at once share their
// weight tiles through L2.
//
// k-step ks multiplies slot ks's activations by its weight tile (W8: in the
// slot; W4: Bs[ks % NB], made from slot ks during step ks - 1, while step
// ks - 1's products run).  One barrier a step; two steps of products stay
// in flight across it.  A W4A8 group's int32 sums must be complete before
// they are folded into the fp32 sum:
//  * W4_G128: k-steps (groups) alternate between two int32 accumulator
//    sets; group j is folded while the products of group j + 1 run, so
//    the tensor cores do not drain at a group's end.  A group's first
//    product zeroes its set (scale-d 0).  The loop is unrolled by two
//    steps with no condition around a fold, so ptxas can see that the set
//    being folded has no product in flight (otherwise it serializes the
//    wgmma).
//  * W4_ANY (g = 32, 64, 96, 256, ..., K: groups may end inside a step or
//    span steps): one set, and each group waits for its products before
//    it folds.
template <int MODE>
__global__ void __launch_bounds__(Gemm<MODE != W8>::THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tmA,
            const __grid_constant__ CUtensorMap tmW,
            const __grid_constant__ CUtensorMap tmS,
            const float* __restrict__ xs, const float* __restrict__ sc,
            __nv_bfloat16* __restrict__ y, float* __restrict__ y32,
            int M, int K, int O, int g) {
  constexpr bool W4 = MODE != W8;
  using C = Gemm<W4>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Bs = smem + C::STAGES * C::slot;    // W4: s8 tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::bar_off);

  const int mt = (M + C::BM - 1) / C::BM, nt = (O + BN - 1) / BN;
  const long long pid = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const long long band = (long long)GROUP_M * nt;
  const int first_m = (int)(pid / band) * GROUP_M;
  const int gsz = min(mt - first_m, GROUP_M);
  const int local = (int)(pid % band);
  const int m0 = (first_m + local % gsz) * C::BM, n0 = (local / gsz) * BN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w4 = warp % 4;
  const int gq = lane >> 2, t = lane & 3;

  int acc[64];                                   // W4_G128: even steps
  int accB[MODE == W4_G128 ? 64 : 1];            // W4_G128: odd steps
  float accf[W4 ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
    if constexpr (MODE == W4_G128) accB[i] = 0;
    if constexpr (W4) accf[i] = 0.f;
  }

  const int nk = (K + BK - 1) / BK;
  // copies of k-step k: TMA tiles on bars[k % STAGES] (its fill k /
  // STAGES completes that barrier's phase of parity (k / STAGES) & 1); the
  // W4_G128 scales too, the W4_ANY scales as one cp.async group
  auto issue = [&](int k) {
    unsigned char* st = smem + (k % C::STAGES) * C::slot;
    if (threadIdx.x == 0)
      tma_slot<W4>(st, bars + k % C::STAGES, &tmA, &tmW,
                   MODE == W4_G128 ? &tmS : nullptr, m0, n0, k * BK);
    if constexpr (MODE == W4_ANY) scale_slot(st, sc, n0, k * BK, K, O, g);
  };
  auto landed = [&](int k) {
    mbar_wait(bars + k % C::STAGES, (k / C::STAGES) & 1);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(bars + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < C::AHEAD; ++s) {
    if (s < nk) issue(s);
    else if constexpr (MODE == W4_ANY) cp_commit();
  }
  if constexpr (W4) {
    landed(0);
    dequant_slot(smem, Bs);
  }

  // The top of step ks: wait for step ks - 2's products, for the scales
  // of the steps up to ks + 1 (W4_ANY), one barrier, the copies of step ks +
  // AHEAD into the slot step ks - 2 used, then wait for slot ks's tiles.
  // Returns step ks's slot.
  auto top = [&](int ks) -> const unsigned char* {
    wgmma_wait<1>();
    fence_acc(acc);
    if constexpr (MODE == W4_G128) fence_acc(accB);
    if constexpr (MODE == W4_ANY) cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    if (ks + C::AHEAD < nk) issue(ks + C::AHEAD);
    else if constexpr (MODE == W4_ANY) cp_commit();
    landed(ks);
    return smem + (ks % C::STAGES) * C::slot;
  };
  // W4: the next step's codes into their s8 tile while the products run
  auto dequant_next = [&](int ks) {
    if (ks + 1 < nk) {
      landed(ks + 1);
      dequant_slot(smem + ((ks + 1) % C::STAGES) * C::slot,
                   Bs + ((ks + 1) % C::NB) * BN * BK);
    }
  };
  auto a_tile = [&](const unsigned char* st) { return st + wg * 64 * BK; };
  auto b_tile = [&](const unsigned char* st, int ks) {
    return W4 ? Bs + (ks % C::NB) * BN * BK : st + C::w_off;
  };

  if constexpr (MODE == W8) {
    for (int ks = 0; ks < nk; ++ks) {
      const unsigned char* st = top(ks);
      const unsigned char* At = a_tile(st);
      const unsigned char* Bt = b_tile(st, ks);
      wgmma_fence();
      fence_acc(acc);
      if (ks * BK + BK <= K) {
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_m64n128k32_s8(acc, smem_desc(At + 32 * kk),
                              smem_desc(Bt + 32 * kk), 1);
      } else {                  // the K edge: only the 32-column pieces in K
        for (int kk = 0; ks * BK + 32 * kk < K; ++kk)
          wgmma_m64n128k32_s8(acc, smem_desc(At + 32 * kk),
                              smem_desc(Bt + 32 * kk), 1);
      }
      wgmma_commit();
      fence_acc(acc);
    }
  } else if constexpr (MODE == W4_G128) {
    // step ks is group ks; its scales sit in its own slot, which is
    // reloaded two steps later: after the fold
    auto step = [&](int* a, int ks) {
      const unsigned char* st = top(ks);
      const unsigned char* At = a_tile(st);
      const unsigned char* Bt = b_tile(st, ks);
      wgmma_fence();
      fence_acc(a);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_m64n128k32_s8(a, smem_desc(At + 32 * kk),
                            smem_desc(Bt + 32 * kk), kk == 0 ? 0 : 1);
      wgmma_commit();
      fence_acc(a);
      dequant_next(ks);
    };
    // step ks's scales: column ks % 4 of its slot's [BN][4] box
    auto scales = [&](int ks) {
      return reinterpret_cast<const float*>(
                 smem + (ks % C::STAGES) * C::slot + C::s_off) + ks % 4;
    };
    // fold step ks's set a: every product but the newest commit is done
    auto fold = [&](int* a, int ks) {
      wgmma_wait<1>();
      fence_acc(a);
      fold_group<true, 4>(accf, a, scales(ks), t);
    };
    step(acc, 0);
    int ks = 1;
    for (; ks + 1 < nk; ks += 2) {
      step(accB, ks);
      fold(acc, ks - 1);
      step(acc, ks + 1);
      fold(accB, ks);
    }
    if (ks < nk) {
      step(accB, ks);
      fold(acc, ks - 1);
      wgmma_wait<0>();
      fence_acc(accB);
      fold_group<true, 4>(accf, accB, scales(ks), t);
    } else {
      wgmma_wait<0>();
      fence_acc(acc);
      fold_group<true, 4>(accf, acc, scales(ks - 1), t);
    }
  } else {
    for (int ks = 0; ks < nk; ++ks) {
      const unsigned char* st = top(ks);
      const unsigned char* At = a_tile(st);
      const unsigned char* Bt = b_tile(st, ks);
      const float* Ss = reinterpret_cast<const float*>(st + C::s_off);
      const int k0 = ks * BK, gi0 = k0 / g;
      int pending = -1;           // a group closing at the step's end
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const int col = k0 + 32 * kk;
        if (col >= K) break;      // block-uniform: the K edge
        wgmma_m64n128k32_s8(acc, smem_desc(At + 32 * kk),
                            smem_desc(Bt + 32 * kk), col % g != 0);
        if ((col + 32) % g == 0) {          // the group closes here
          if (kk == BK / 32 - 1 || col + 32 >= K) {
            pending = col / g - gi0;
          } else {
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(acc);
            fold_group<false, 1>(accf, acc, Ss + (col / g - gi0) * BN, t);
            wgmma_fence();
          }
        }
      }
      wgmma_commit();
      fence_acc(acc);
      dequant_next(ks);
      if (pending >= 0) {
        wgmma_wait<0>();
        fence_acc(acc);
        fold_group<false, 1>(accf, acc, Ss + pending * BN, t);
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if constexpr (MODE == W4_ANY) cp_wait<0>();

  // epilogue from the registers: value 4j + c of a lane is row 16 w4 + gq
  // + 8 (c / 2), column 8j + 2t + c % 2 of its warpgroup's 64 x 128.
  // W8A8: float(acc) * xs * ws; W4A8: accf * xs.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wg * 64 + w4 * 16 + gq + 8 * r;
    if (m >= M) continue;
    const float xsm = xs[m];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float f[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        if constexpr (W4) f[e] = __fmul_rn(accf[i], xsm);
        else f[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), xsm),
                              n + e < O ? __ldg(sc + n + e) : 0.f);
      }
      const size_t o = (size_t)m * O + n;
      if (n + 1 < O && O % 2 == 0) {
        if (y32) *reinterpret_cast<float2*>(y32 + o) = make_float2(f[0], f[1]);
        else *reinterpret_cast<uint32_t*>(y + o) = pack_bf16(f[0], f[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= O) continue;
          if (y32) y32[o + e] = f[e];
          else y[o + e] = __float2bfloat16(f[e]);
        }
      }
    }
  }
}

// Dynamic shared memory of a GEMM body, set before each launch (above
// 48 KB it must be asked for).  Not cached in a function-local static: a
// template's static is one object across every library loaded in the
// process, so a second build of this header (another version, timed
// beside this one) would skip its own kernel's attribute.
template <int MODE>
cudaError_t gemm_smem(int* bytes) {
  *bytes = Gemm<MODE != W8>::smem;
  return cudaFuncSetAttribute(gemm_kernel<MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *bytes);
}

// A GEMM body's resources on this card: info = {registers a thread, local
// (spill) bytes a thread, dynamic shared bytes a block, blocks per SM}.
template <int MODE>
int gemm_info(int* info) {
  int smem = 0, blocks = 0;
  cudaFuncAttributes a;
  cudaError_t err = gemm_smem<MODE>(&smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, gemm_kernel<MODE>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gemm_kernel<MODE>, Gemm<MODE != W8>::THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return 0;
}

template <int MODE>
int launch_gemm(const int8_t* xi, const float* xs, const void* w,
                const float* sc, __nv_bfloat16* y, float* y32, int M, int K,
                int O, int g, cudaStream_t st) {
  constexpr bool W4 = MODE != W8;
  using C = Gemm<W4>;
  const EncodeTiledFn encode = encode_tiled();
  CUtensorMap tmA, tmW, tmS;
  if (encode == nullptr
      || !byte_map(encode, &tmA, xi, M, K, C::BM, BK, true)
      || !byte_map(encode, &tmW, w, O, W4 ? K / 2 : K, BN, C::W_ROW, !W4)
      || (MODE == W4_G128
          && !byte_map(encode, &tmS, sc, O, 4 * (K / g), BN, 16, false)))
    return (int)cudaErrorNotSupported;
  int smem = 0;
  const cudaError_t err = gemm_smem<MODE>(&smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((O + BN - 1) / BN, (M + C::BM - 1) / C::BM);
  gemm_kernel<MODE><<<grid, C::THREADS, smem, st>>>(
      tmA, tmW, MODE == W4_G128 ? tmS : tmA, xs, sc, y, y32, M, K, O, g);
  return 0;
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
  if (M <= 0 || O <= 0 || K <= 0 || K % 32
      || (M + Gemm<W4>::BM - 1) / Gemm<W4>::BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (W4 && (g <= 0 || g % 32 || K % g)) return (int)cudaErrorInvalidValue;
  launch_quantize_rows(x, xi_, xs_, M, K, st);
  const int8_t* xi = static_cast<const int8_t*>(xi_);
  const float* xs = static_cast<const float*>(xs_);
  const float* sc = static_cast<const float*>(sc_);
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(y_);
  float* y32 = static_cast<float*>(y32_);
  if (M <= 32) {                // the GEMV, where its x range fits
    const int err = try_gemv<W4>(xi, xs, w, sc, y, y32, M, K, O, g, st);
    if (err > 0) return err;
    if (err == 0) return (int)cudaGetLastError();
  }
  int err;
  if constexpr (!W4)
    err = launch_gemm<W8>(xi, xs, w, sc, y, y32, M, K, O, g, st);
  else if (g == BK && (K / g) % 4 == 0
           && reinterpret_cast<uintptr_t>(sc) % 16 == 0)   // TMA scales
    err = launch_gemm<W4_G128>(xi, xs, w, sc, y, y32, M, K, O, g, st);
  else
    err = launch_gemm<W4_ANY>(xi, xs, w, sc, y, y32, M, K, O, g, st);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace a8
