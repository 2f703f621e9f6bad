// Single-token attention over an int8 KV cache, bf16 query and output, in
// the flash-decoding form: the token axis is split over blocks, and a
// second kernel combines the splits.
//
// Replaces: autoround_tpu/ops/decode_attention.py, `decode_attention` ->
// `_decode_kernel` (the Pallas TPU kernel, which walks the cache in order
// on one core with its softmax state in scratch memory).
//
// What bounds it on an H100: each (sequence, kv head) reads its int8 K and
// V rows up to `pos` (2 * hd bytes per token) and does ~4 * G * hd
// operations per token with G <= 16 query heads: at most 32 operations a
// byte, so the cache stream from memory bounds it.  At decode batch sizes
// there are few (sequence, kv head) pairs (64 at B = 8, nkv = 8; 32 at
// G = 7) against 132 SMs, and one block each would wait on memory latency
// tile after tile: the card would not stream.
//
// Design:
//  * split_kernel, grid (B * nkv, S): block (b, h, s) takes the s-th of S
//    near-equal pieces of its token range [lo, hi], found on the device
//    from pos[b] (lo folds the sliding `window`, idx > pos - window, and
//    the `chunk` start, idx >= floor(pos / chunk) * chunk; hi = min(pos,
//    T - 1)); every piece but the last is a whole number of 64-token
//    tiles.  S comes from host-known shapes only (ops/decode_attention.py
//    `decode_splits`: about two waves of blocks over the SMs), so nothing
//    reads `pos` on the host and the launch stays capturable in a CUDA
//    graph.
//  * K and V tiles (64 tokens x hd int8, rows padded by 16 bytes so 8
//    lanes reading 8 rows hit 8 distinct bank groups) stream into a ring
//    of shared memory by 16-byte cp.async, two tiles ahead (hd 256: one
//    tile ahead, two slots, to keep two blocks on an SM), so the next
//    tiles' bytes are in flight while this one's scores, softmax and P.V
//    run.  Two block-wide barriers a tile: one when a tile has landed, one
//    between the softmax and P.V.
//  * scores and softmax: warp w takes query heads w, w + 8 (G > 8: GLM-4.5
//    has G = 12), one token a lane (two per tile), the whole K row against
//    the fp32 query row in shared memory; the K scale folds into the score
//    scale (sm_scale * k_scale), then the optional Gemma-style softcap; the
//    warp updates each of its heads' running max and sum by shuffles.
//    P.V: each thread owns 4 output columns for all G heads and one token
//    slice of the tile (V read 4 bytes a lane, conflict-free); the slices
//    meet in shared memory at the end.  Scores and P.V stay on the CUDA
//    cores: 32 operations a byte is far below the tensor cores' line.  A
//    thread holds 4 * G fp32 sums: above G = 12 the split kernel asks for
//    one block an SM (up to 255 registers a thread) instead of two, so
//    they do not spill.
//  * the block writes, for each of its G heads, a partial (m, l, acc[hd])
//    in fp32 to scratch the wrapper allocates; a split with no token (a
//    window or chunk shorter than the splits, or pos before its start)
//    writes m = -inf, l = 0 and no acc.
//  * combine_kernel, one block per (b, query head): m = max m_s; l and acc
//    sum the partials rescaled by exp(m_s - m) (weight 0 for an empty
//    split, no NaN); GPT-OSS `sinks` add exp(sink - m) to the denominator
//    only, once; l == 0 divides by 1; the V scale multiplies once.
// Numerics: the same fp32 operations as a single pass, but the sums over
// tokens run per split and then across splits, so the output is not
// bit-equal to a kernel that walks all tokens in one block; it stays within
// row 6's tolerance of the plain version.  The combine adds the splits in
// index order with no atomics: two launches give the same bits.
// One instance per (hd, G): hd in {64, 128, 256}, G in 1..16, so no query
// head is padded.  The masked value is -0.7 * FLT_MAX, as in the JAX kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

using namespace ptx;

constexpr int GMAX = 16;
constexpr int TILE = 64;
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

// 32-bit word u (a compile-time index after unrolling) of a 16-byte chunk
__device__ __forceinline__ uint32_t word(const uint4& w, int u) {
  return u == 0 ? w.x : u == 1 ? w.y : u == 2 ? w.z : w.w;
}

// the four int8 of u as fp32, exactly: (b ^ 0x80) is b + 128 unsigned, and
// 0x4B000000 | u is the float 2^23 + u; a byte permute and a subtraction in
// place of a shift, a mask and a conversion instruction (each K byte is
// converted once per query head)
__device__ __forceinline__ void i8x4_to_f32(uint32_t u, float* f) {
  const uint32_t x = u ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + i))
           - 8388736.0f;                              // 2^23 + 128
}

// Shared memory of one split block: the K/V ring, then the fp32 query rows,
// the tile's probabilities and the per-head softmax rescale.  The slices'
// P.V sums meet in `red`, which reuses the ring once it has drained.
template <int HD, int G>
struct Layout {
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  static constexpr int AHEAD = STAGES - 1;           // tiles in flight
  static constexpr int ROW = HD + 16;                // padded row bytes
  static constexpr int TILE_BYTES = TILE * ROW;
  static constexpr int TOK_GROUPS = NTHREADS / (HD / 4);  // P.V slices
  static constexpr int ring = STAGES * 2 * TILE_BYTES;
  static constexpr int red = TOK_GROUPS * G * HD * 4;
  static constexpr int qs_off = ring > red ? ring : red;
  static constexpr int ps_off = qs_off + G * HD * 4;
  static constexpr int alpha_off = ps_off + G * TILE * 4;
  static constexpr int ml_off = alpha_off + GMAX * 4;
  static constexpr int bytes = ml_off + 2 * GMAX * 4;
};

// the token range of split `split` of S for a slot at `pos` (empty when
// s_lo > s_hi)
__device__ __forceinline__ void split_range(int pos, int T, int window,
                                            int chunk, int S, int split,
                                            int& s_lo, int& s_hi) {
  const int hi = min(pos, T - 1);
  int lo = 0;
  if (window > 0) lo = max(lo, pos - window + 1);
  if (chunk > 0) lo = max(lo, (pos / chunk) * chunk);
  const int ntok = hi - lo + 1;
  if (ntok <= 0) {
    s_lo = 1;
    s_hi = 0;
    return;
  }
  const int per = ((ntok + S - 1) / S + TILE - 1) / TILE * TILE;
  s_lo = lo + split * per;
  s_hi = min(hi, s_lo + per - 1);
}

// Copy tile i (tokens t0 .. t0 + 63) of K and V into its ring slot; tokens
// past s_hi read nothing and leave zeros.
template <int HD, int G>
__device__ __forceinline__ void load_tile(unsigned char* smem,
                                          const int8_t* kb, const int8_t* vb,
                                          size_t row_stride, int t0, int s_hi,
                                          int i) {
  using L = Layout<HD, G>;
  constexpr int CH = HD / 16;
  unsigned char* ksl = smem + (i % L::STAGES) * 2 * L::TILE_BYTES;
  unsigned char* vsl = ksl + L::TILE_BYTES;
  for (int c = threadIdx.x; c < TILE * CH; c += NTHREADS) {
    const int j = c / CH, part = c % CH;
    const bool ok = t0 + j <= s_hi;
    const size_t off = ok ? (size_t)(t0 + j) * row_stride + part * 16 : 0;
    cp_async<16>(ksl + j * L::ROW + part * 16, kb + off, ok);
    cp_async<16>(vsl + j * L::ROW + part * 16, vb + off, ok);
  }
}

// (at least two blocks an SM up to G = 12: with that bound ptxas gives the
// G = 8 instances the registers they need instead of spilling a few bytes;
// one above it, where the 4 * G sums a thread holds need more)
constexpr int min_blocks(int g) { return g > 12 ? 1 : 2; }

template <int HD, int G>
__global__ void __launch_bounds__(NTHREADS, min_blocks(G))
split_kernel(const __nv_bfloat16* __restrict__ q,
             const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
             const int* __restrict__ pos_v, const float* __restrict__ ks,
             float2* __restrict__ part_ml, float* __restrict__ part_acc,
             int T, int nkv, float sm_scale, float softcap, int window,
             int chunk) {
  using L = Layout<HD, G>;
  constexpr int ROW = L::ROW;
  constexpr int TOK_GROUPS = L::TOK_GROUPS;
  constexpr int CH = HD / 16;                       // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::qs_off);      // [G][HD]
  float* ps = reinterpret_cast<float*>(smem + L::ps_off);      // [G][TILE]
  float* alpha_s = reinterpret_cast<float*>(smem + L::alpha_off);
  float* ml_s = reinterpret_cast<float*>(smem + L::ml_off);    // [G][2]
  float* red = reinterpret_cast<float*>(smem);   // [TOK_GROUPS][G][HD]

  const int bh = blockIdx.x, S = gridDim.y, split = blockIdx.y;
  const int b = bh / nkv, h = bh % nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nh = nkv * G;
  const size_t head0 = (size_t)b * nh + h * G;     // global index of head 0

  int s_lo, s_hi;
  split_range(pos_v[b], T, window, chunk, S, split, s_lo, s_hi);
  if (s_lo > s_hi) {
    if (threadIdx.x < G)
      part_ml[(head0 + threadIdx.x) * S + split] = make_float2(-INFINITY, 0.f);
    return;
  }

  const size_t row_stride = (size_t)nkv * HD;   // bytes between tokens
  const int8_t* kb = kc + (size_t)b * T * row_stride + (size_t)h * HD;
  const int8_t* vb = vc + (size_t)b * T * row_stride + (size_t)h * HD;
  const int ntiles = (s_hi - s_lo) / TILE + 1;

#pragma unroll
  for (int i = 0; i < L::AHEAD; ++i) {
    if (i < ntiles)
      load_tile<HD, G>(smem, kb, vb, row_stride, s_lo + i * TILE, s_hi, i);
    cp_commit();
  }

  for (int i = threadIdx.x; i < G * HD; i += NTHREADS)
    qs[i] = __bfloat162float(q[head0 * HD + i]);
  const float kscale = sm_scale * ks[h];

  // P.V ownership: 4 columns x all heads, one of TOK_GROUPS token slices
  const int d4 = (threadIdx.x % (HD / 4)) * 4;
  const int tg = threadIdx.x / (HD / 4);
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  // the running softmax state of the heads warp w scores: w + NWARP * hh
  constexpr int HPW = (G + NWARP - 1) / NWARP;
  float m_run[HPW], l_run[HPW];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    m_run[hh] = -INFINITY;
    l_run[hh] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = s_lo + it * TILE;
    cp_wait<L::AHEAD - 1>();
    __syncthreads();        // tile `it` landed; tile it - 1 fully consumed
    if (it + L::AHEAD < ntiles)
      load_tile<HD, G>(smem, kb, vb, row_stride, t0 + L::AHEAD * TILE, s_hi,
                       it + L::AHEAD);
    cp_commit();
    const unsigned char* ksl = smem + (it % L::STAGES) * 2 * L::TILE_BYTES;
    const unsigned char* vsl = ksl + L::TILE_BYTES;

    // scores and online softmax: warp w for heads w + NWARP * hh, tokens
    // lane, lane + 32
    static_assert(TILE == 64, "two tokens a lane");
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int g = warp + NWARP * hh;
      if (g >= G) break;
      const float* qg = qs + g * HD;
      // tokens lane and lane + 32: each query chunk is read once for both
      const unsigned char* kr0 = ksl + lane * ROW;
      const unsigned char* kr1 = kr0 + 32 * ROW;
      float d[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 2
      for (int c = 0; c < CH; ++c) {
        const uint4 w0 = *reinterpret_cast<const uint4*>(kr0 + 16 * c);
        const uint4 w1 = *reinterpret_cast<const uint4*>(kr1 + 16 * c);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qg + 16 * c + 4 * u);
          float k0[4], k1[4];
          i8x4_to_f32(word(w0, u), k0);
          i8x4_to_f32(word(w1, u), k1);
          d[0][0] = fmaf(qv.x, k0[0], d[0][0]);
          d[0][1] = fmaf(qv.y, k0[1], d[0][1]);
          d[0][0] = fmaf(qv.z, k0[2], d[0][0]);
          d[0][1] = fmaf(qv.w, k0[3], d[0][1]);
          d[1][0] = fmaf(qv.x, k1[0], d[1][0]);
          d[1][1] = fmaf(qv.y, k1[1], d[1][1]);
          d[1][0] = fmaf(qv.z, k1[2], d[1][0]);
          d[1][1] = fmaf(qv.w, k1[3], d[1][1]);
        }
      }
      float s[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float sc = (d[jj][0] + d[jj][1]) * kscale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        s[jj] = (t0 + lane + 32 * jj <= s_hi) ? sc : MASK_VALUE;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[hh], mx);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      ps[g * TILE + lane] = p0;
      ps[g * TILE + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run[hh] - m_new);
      l_run[hh] = alpha * l_run[hh] + sum;
      m_run[hh] = m_new;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();
    // P.V on this thread's columns and token slice
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= a;
    }
    for (int j = tg; j < TILE; j += TOK_GROUPS) {
      if (t0 + j > s_hi) break;
      float vf[4];
      i8x4_to_f32(*reinterpret_cast<const uint32_t*>(vsl + j * ROW + d4),
                  vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ps[g * TILE + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  cp_wait<0>();
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int g = warp + NWARP * hh;
      if (g < G) {
        ml_s[2 * g] = m_run[hh];
        ml_s[2 * g + 1] = l_run[hh];
      }
    }
  }
  __syncthreads();          // the ring is drained: `red` may reuse it
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(tg * G + g) * HD + d4 + e] = acc[g][e];
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += NTHREADS) {
    const int g = i / HD, d = i % HD;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < TOK_GROUPS; ++s) v += red[(s * G + g) * HD + d];
    part_acc[((head0 + g) * S + split) * HD + d] = v;
    if (d == 0)
      part_ml[(head0 + g) * S + split] =
          make_float2(ml_s[2 * g], ml_s[2 * g + 1]);
  }
}

// One block of HD threads per (b, query head): the S partials in index
// order, then the sinks, the l == 0 guard and the V scale.
template <int HD>
__global__ void __launch_bounds__(HD)
combine_kernel(const float2* __restrict__ part_ml,
               const float* __restrict__ part_acc,
               const float* __restrict__ vs, const float* __restrict__ sinks,
               __nv_bfloat16* __restrict__ out, int S, int nh, int G) {
  const size_t head = blockIdx.x;                   // b * nh + n
  const int n = (int)(head % nh);
  const int d = threadIdx.x;
  const float2* ml = part_ml + head * S;
  float m = -INFINITY;
  for (int s = 0; s < S; ++s) m = fmaxf(m, ml[s].x);
  float l = 0.f, v = 0.f;
  for (int s = 0; s < S; ++s) {
    const float2 p = ml[s];
    if (p.x == -INFINITY) continue;                 // an empty split
    const float w = expf(p.x - m);
    l += w * p.y;
    v += w * part_acc[(head * S + s) * HD + d];
  }
  if (sinks != nullptr) l += expf(sinks[n] - m);
  const float inv = (l == 0.f) ? 1.f : 1.f / l;
  out[head * HD + d] = __float2bfloat16(v * inv * vs[n / G]);
}

// Dynamic shared memory of a split kernel, set once per instance (above
// 48 KB it must be asked for; the static is this library's own: internal
// linkage).
template <int HD, int G>
cudaError_t split_smem(int* bytes) {
  *bytes = Layout<HD, G>::bytes;
  static const cudaError_t err = cudaFuncSetAttribute(
      split_kernel<HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<HD, G>::bytes);
  return err;
}

template <int HD, int G>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* ks, const void* vs, const void* sinks, void* out,
           int B, int T, int nkv, float sm_scale, float softcap, int window,
           int chunk, int S, void* partial, cudaStream_t st) {
  int smem = 0;
  const cudaError_t err = split_smem<HD, G>(&smem);
  if (err != cudaSuccess) return (int)err;
  const int nh = nkv * G;
  float2* part_ml = static_cast<float2*>(partial);
  float* part_acc = reinterpret_cast<float*>(part_ml + (size_t)B * nh * S);
  split_kernel<HD, G><<<dim3(B * nkv, S), NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int*>(pos),
      static_cast<const float*>(ks), part_ml, part_acc, T, nkv, sm_scale,
      softcap, window, chunk);
  combine_kernel<HD><<<B * nh, HD, 0, st>>>(
      part_ml, part_acc, static_cast<const float*>(vs),
      static_cast<const float*>(sinks), static_cast<__nv_bfloat16*>(out), S,
      nh, G);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_g(int G, const void* q, const void* k, const void* v,
             const void* pos, const void* ks, const void* vs,
             const void* sinks, void* out, int B, int T, int nkv,
             float sm_scale, float softcap, int window, int chunk, int S,
             void* partial, cudaStream_t st) {
#define DECODE_G(N) \
  case N: return launch<HD, N>(q, k, v, pos, ks, vs, sinks, out, B, T, nkv, \
                               sm_scale, softcap, window, chunk, S, partial, \
                               st)
  switch (G) {
    DECODE_G(1); DECODE_G(2); DECODE_G(3); DECODE_G(4);
    DECODE_G(5); DECODE_G(6); DECODE_G(7); DECODE_G(8);
    DECODE_G(9); DECODE_G(10); DECODE_G(11); DECODE_G(12);
    DECODE_G(13); DECODE_G(14); DECODE_G(15); DECODE_G(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_G
}

template <int HD, int G>
int info_of(int* info) {
  int smem = 0, blocks = 0;
  cudaFuncAttributes a;
  cudaError_t err = split_smem<HD, G>(&smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, split_kernel<HD, G>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, split_kernel<HD, G>, NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  err = cudaFuncGetAttributes(&a, combine_kernel<HD>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, combine_kernel<HD>, HD, 0);
  if (err != cudaSuccess) return (int)err;
  info[4] = a.numRegs;
  info[5] = (int)a.localSizeBytes;
  info[6] = 0;
  info[7] = blocks;
  return 0;
}

}  // namespace

// q (B, nh, hd) bf16; k/v cache (B, T, nkv, hd) int8; pos (B,) int32;
// k/v_scale (nkv,) fp32; sinks (nh,) fp32 or NULL; out (B, nh, hd) bf16.
// hd in {64, 128, 256}, G = nh / nkv in 1..16; window / chunk <= 0 mean
// "none".  `splits` >= 1 pieces of the token axis; `partial` is fp32
// scratch of B * nh * splits * (hd + 2) values.  Returns the cudaError_t
// of the launches (0 on success).
extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* pos,
                                     const void* k_scale,
                                     const void* v_scale, const void* sinks,
                                     void* out, int B, int T, int nh, int nkv,
                                     int hd, float sm_scale, float softcap,
                                     int window, int chunk, void* stream,
                                     int splits, void* partial) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nkv <= 0 || nh % nkv || nh / nkv > GMAX || splits < 1
      || splits > 65535 || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  const int G = nh / nkv;
  if (hd == 64)
    return launch_g<64>(G, q, k, v, pos, k_scale, v_scale, sinks, out, B, T,
                        nkv, sm_scale, softcap, window, chunk, splits,
                        partial, st);
  if (hd == 128)
    return launch_g<128>(G, q, k, v, pos, k_scale, v_scale, sinks, out, B,
                         T, nkv, sm_scale, softcap, window, chunk, splits,
                         partial, st);
  if (hd == 256)
    return launch_g<256>(G, q, k, v, pos, k_scale, v_scale, sinks, out, B,
                         T, nkv, sm_scale, softcap, window, chunk, splits,
                         partial, st);
  return (int)cudaErrorInvalidValue;
}

template <int HD>
int info_g(int G, int* info) {
#define INFO_G(N) \
  case N: return info_of<HD, N>(info)
  switch (G) {
    INFO_G(1); INFO_G(2); INFO_G(3); INFO_G(4);
    INFO_G(5); INFO_G(6); INFO_G(7); INFO_G(8);
    INFO_G(9); INFO_G(10); INFO_G(11); INFO_G(12);
    INFO_G(13); INFO_G(14); INFO_G(15); INFO_G(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef INFO_G
}

// Resources of the split kernel and the combine kernel at (hd, G), any
// instance: info = {registers a thread, spill bytes a thread, dynamic
// shared bytes, blocks per SM} of the split kernel, then the same four of
// the combine kernel.
extern "C" int decode_attention_info(int hd, int G, int* info) {
  if (hd == 64) return info_g<64>(G, info);
  if (hd == 128) return info_g<128>(G, info);
  if (hd == 256) return info_g<256>(G, info);
  return (int)cudaErrorInvalidValue;
}
