// Single-token attention over an int8 KV cache, bf16 query and output.
//
// Replaces: autoround_tpu/ops/decode_attention.py, `decode_attention` ->
// `_decode_kernel` (the Pallas TPU kernel).
//
// What bounds it on an H100: each (sequence, kv head) reads its int8 K and
// V rows up to `pos` (2 * hd bytes per token) and does ~4 * G * hd
// operations per token with G <= 8 query heads: a few operations per byte,
// so the cache stream from memory bounds it.
//
// Design: one block per (sequence b, kv head h) handles its G query heads
// and streams the cache only over [lo, min(pos[b], T-1)], where lo folds
// the sliding `window` (idx > pos - window) and the `chunk` start
// (idx >= floor(pos / chunk) * chunk).  Tokens go in tiles of 64 with an
// online softmax (fp32 m, l, acc):
//  * scores: warp per token, each lane reads 4 int8 of the 128-byte K row
//    (coalesced), dots them with the G fp32 query rows kept in shared
//    memory and reduces over the warp.  The K scale folds into the score
//    scale (sm_scale * k_scale[h]), then the optional Gemma-style softcap;
//  * softmax: warp g updates head g's running max and sum over the tile;
//  * P.V: each thread owns 4 output columns for all G heads and a slice of
//    the tile's tokens (int8 V rows read 4 bytes a lane, coalesced); the
//    V scale multiplies the output once in the epilogue.
// GPT-OSS `sinks` add exp(sink - m) to the denominator only.  The masked
// value is -0.7 * FLT_MAX, as in the JAX kernel.  `pos` is a per-slot
// device vector, so every slot streams exactly its own length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;
constexpr int GMAX = 8;
constexpr int TILE = 64;
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int TOK_GROUPS = NTHREADS / (HD / 4);   // 8 token slices in P.V
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

__device__ __forceinline__ void i8x4_to_f32(uint32_t u, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = (float)(int8_t)((u >> (8 * i)) & 0xFFu);
}

template <int G>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
              const int* __restrict__ pos_v, const float* __restrict__ ks,
              const float* __restrict__ vs, const float* __restrict__ sinks,
              __nv_bfloat16* __restrict__ out, int T, int nkv, float sm_scale,
              float softcap, int window, int chunk) {
  __shared__ float qs[G][HD];
  __shared__ float ps[G][TILE];
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  __shared__ float red[TOK_GROUPS][G][HD];

  const int b = blockIdx.x / nkv, h = blockIdx.x % nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nh = nkv * G;

  for (int i = threadIdx.x; i < G * HD; i += NTHREADS)
    qs[i / HD][i % HD] = __bfloat162float(
        q[((size_t)b * nh + h * G + i / HD) * HD + i % HD]);
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }

  const int pos = pos_v[b];
  const int hi = min(pos, T - 1);
  int lo = 0;
  if (window > 0) lo = max(lo, pos - window + 1);
  if (chunk > 0) lo = max(lo, (pos / chunk) * chunk);
  const float kscale = sm_scale * ks[h];
  const size_t row_stride = (size_t)nkv * HD;   // bytes between tokens
  const int8_t* kb = kc + (size_t)b * T * row_stride + (size_t)h * HD;
  const int8_t* vb = vc + (size_t)b * T * row_stride + (size_t)h * HD;

  // P.V ownership: 4 columns x all heads, one of TOK_GROUPS token slices
  const int d4 = (threadIdx.x % (HD / 4)) * 4;
  const int tg = threadIdx.x / (HD / 4);
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  __syncthreads();

  for (int t0 = lo; t0 <= hi; t0 += TILE) {
    // scores, one warp per token
    for (int j = warp; j < TILE; j += NWARP) {
      const int t = t0 + j;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      if (t <= hi) {
        float kf[4];
        i8x4_to_f32(__ldg(reinterpret_cast<const uint32_t*>(
                        kb + (size_t)t * row_stride + lane * 4)), kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[g] = fmaf(qs[g][lane * 4 + e],
                                                    kf[e], dot[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = dot[g];
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) {
          float s = v * kscale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          ps[g][j] = (t <= hi) ? s : MASK_VALUE;
        }
      }
    }
    __syncthreads();
    // online softmax over the tile, warp g for head g
    if (warp < G) {
      const int g = warp;
      const float s0 = ps[g][lane], s1 = ps[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ps[g][lane] = p0;
      ps[g][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
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
      const int t = t0 + j;
      if (t > hi) break;
      float vf[4];
      i8x4_to_f32(__ldg(reinterpret_cast<const uint32_t*>(
                      vb + (size_t)t * row_stride + d4)), vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ps[g][j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncthreads();                   // ps is rewritten by the next tile
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[tg][g][d4 + e] = acc[g][e];
  __syncthreads();
  const float vscale = vs[h];
  for (int i = threadIdx.x; i < G * HD; i += NTHREADS) {
    const int g = i / HD, d = i % HD;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < TOK_GROUPS; ++s) v += red[s][g][d];
    float l = l_s[g];
    if (sinks != nullptr) l += expf(sinks[h * G + g] - m_s[g]);
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
    out[((size_t)b * nh + h * G + g) * HD + d] =
        __float2bfloat16(v * inv * vscale);
  }
}

template <int G>
void launch(const void* q, const void* k, const void* v, const void* pos,
            const void* ks, const void* vs, const void* sinks, void* out,
            int B, int T, int nkv, float sm_scale, float softcap, int window,
            int chunk, cudaStream_t st) {
  decode_kernel<G><<<B * nkv, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int*>(pos),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const float*>(sinks), static_cast<__nv_bfloat16*>(out), T,
      nkv, sm_scale, softcap, window, chunk);
}

}  // namespace

// q (B, nh, 128) bf16; k/v cache (B, T, nkv, 128) int8; pos (B,) int32;
// k/v_scale (nkv,) fp32; sinks (nh,) fp32 or NULL; out (B, nh, 128) bf16.
// G = nh / nkv in {1, 2, 4, 8}; window / chunk <= 0 mean "none".
// Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* pos,
                                     const void* k_scale,
                                     const void* v_scale, const void* sinks,
                                     void* out, int B, int T, int nh, int nkv,
                                     int hd, float sm_scale, float softcap,
                                     int window, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != HD || nkv <= 0 || nh % nkv) return (int)cudaErrorInvalidValue;
  switch (nh / nkv) {
    case 1: launch<1>(q, k, v, pos, k_scale, v_scale, sinks, out, B, T, nkv,
                      sm_scale, softcap, window, chunk, st); break;
    case 2: launch<2>(q, k, v, pos, k_scale, v_scale, sinks, out, B, T, nkv,
                      sm_scale, softcap, window, chunk, st); break;
    case 4: launch<4>(q, k, v, pos, k_scale, v_scale, sinks, out, B, T, nkv,
                      sm_scale, softcap, window, chunk, st); break;
    case 8: launch<8>(q, k, v, pos, k_scale, v_scale, sinks, out, B, T, nkv,
                      sm_scale, softcap, window, chunk, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
