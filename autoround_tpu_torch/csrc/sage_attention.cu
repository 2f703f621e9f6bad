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
// (correctly rounded divisions, round half to even: the codes and scales
// are the plain version's bit for bit; the scale order is the
// reference's), the
// bottom-right causal mask (col <= row + T - S, masked value -0.7 *
// FLT_MAX), softmax in fp32, P rounded to bf16, P.V summed in fp32.
//
// What bounds it on an H100: at the prefill shapes (S = T = 512, D = 128,
// 32 heads, GQA 4) the bytes of q, k, v and the output (0.025 ms at 3.35
// TB/s) outweigh the operations (half of them int8 at 1979 TOP/s, half
// bf16 at 989 TFLOP/s); at S = 2048 the operations bound it.
//
// Design: two kernels, the port's own split of the TPU kernel's work.
//  * `quantize_keys_kernel` quantizes K once per call: int8 codes (B, Hkv,
//    T, D) and fp32 scales (B, Hkv, T) of k - k_mean, a warp per row (the
//    row's amax by shuffles), into a workspace the wrapper allocates.  The
//    TPU kernel (and this port before) quantized every K tile again in
//    every (q tile, query head) block: 32 times at S = T = 512, GQA 4.
//  * `sage_fwd_kernel` is row 1's register-resident FlashAttention-2 loop
//    (flash_attention.cu) with an int8 QK^T: one block per (q tile of 64
//    rows, head, batch), 4 warps of 16 query rows.  The block quantizes
//    its q tile once into shared memory (two lanes a row; codes swizzled
//    for ldmatrix); at
//    D = 128 the codes stay in registers as the s8 A fragments, at D = 256
//    they are re-read per tile (the 128 fp32 output values a lane holds
//    leave no room).  The int8 K tiles (half the bytes of bf16), their
//    scales and the bf16 V tiles run through a two-stage ring in dynamic
//    shared memory filled by cp.async.cg, one barrier a tile; 16-byte
//    chunks XOR-swizzled by row so ldmatrix of K (B of QK^T) and
//    ldmatrix.trans of V (B of P.V) are free of bank conflicts.  QK^T runs
//    on mma.sync.m16n8k32.s8 with the int32 scores in registers (their
//    accumulators start at a magic number's bits, so one subtraction turns
//    a sum into its exact fp32, not the quarter-rate I2F); they are
//    dequantized there in the reference's order, then put in log2 units
//    (one more fp32 product) for the online softmax on ex2.approx: row max
//    and row sum over the 4 lanes that share a row (shuffles).  Only the
//    diagonal tiles compute the mask; tiles wholly above the diagonal are
//    skipped (causal blocks start with the longest q tiles).  P is packed
//    from the score registers straight into bf16 A fragments (the C layout
//    of the s8 product is the A layout of m16n8k16), P.V runs on
//    mma.sync.m16n8k16 bf16 and O stays in registers, normalised once in
//    the epilogue (l == 0 guard as in the JAX kernel), which writes it
//    through shared memory with 16-byte stores.
// KV tile: 64 rows at D = 128 (73 KB of shared memory, two blocks per SM),
// 32 at D = 256 (97 KB, two blocks per SM); T % 64 == 0 means whole tiles.
// GQA reads KV head h / rep directly.

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

template <int D>
struct Cfg {
  static constexpr int BKV = D == 128 ? 64 : 32;      // kv rows per tile
  static constexpr bool Q_IN_REGS = D == 128;
  // O staging (bf16), q codes, two stages of K codes, of V, of K scales;
  // q scales
  static constexpr size_t o_off = 0;
  static constexpr size_t qi_off = o_off + (size_t)BQ * D * 2;
  static constexpr size_t k_off = qi_off + (size_t)BQ * D;
  static constexpr size_t v_off = k_off + 2 * (size_t)BKV * D;
  static constexpr size_t ks_off = v_off + 2 * (size_t)BKV * D * 2;
  static constexpr size_t qs_off = ks_off + 2 * (size_t)BKV * 4;
  static constexpr size_t bytes = qs_off + BQ * 4;
};

// byte offset of 16-byte chunk c of row r in a swizzled tile of RB-byte
// rows (RB >= 128)
template <int RB>
__device__ __forceinline__ int swz(int r, int c) {
  return r * RB + ((c ^ (r & 7)) << 4);
}

// int32 -> fp32 for |v| < 2^22 (a QK^T sum: |v| <= D * 127^2 < 2^22 for D
// <= 256), exactly as a conversion: v added to the bits of 1.5 * 2^23 is the
// float 1.5 * 2^23 + v.  The int32 accumulators start at those bits
// (I2F_BIAS), so the products add v to them and one subtraction is left,
// where I2F is a quarter-rate instruction.
constexpr int I2F_BIAS = 0x4B400000;
__device__ __forceinline__ float biased_i2f(int biased) {
  return __int_as_float(biased) - 12582912.0f;
}

// x / s rounded to nearest, exactly as an IEEE division, from r = RN(1 / s):
// q = RN(x r) is within an ulp of x / s, the residual x - s q is exact in
// one FMA, and RN(q + (x - s q) r) is the correctly rounded quotient
// (Markstein's theorem; no overflow or underflow for |x / s| <= 127 and s
// >= 1e-8 / 127).  Three FMA-pipe instructions where __fdiv_rn is a dozen.
__device__ __forceinline__ float div_rn(float x, float s, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, s, x), r, q);
}

// EPL = D / 32 bf16 of a row (this lane's: columns lane * EPL ..) as raw
// words, and as fp32.
template <int EPL>
struct RowPart {
  uint32_t w[EPL / 2];
};

template <int EPL>
__device__ __forceinline__ RowPart<EPL> load_row_part(const bf16* src) {
  RowPart<EPL> p;
  if constexpr (EPL == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    p.w[0] = u.x;
    p.w[1] = u.y;
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
    p.w[0] = u.x;
    p.w[1] = u.y;
    p.w[2] = u.z;
    p.w[3] = u.w;
  }
  return p;
}

template <int EPL>
__device__ __forceinline__ void to_f32(const RowPart<EPL>& p, float* f) {
#pragma unroll
  for (int i = 0; i < EPL / 2; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Quantize one row held across the warp (EPL fp32 values a lane): the
// row's scale max(amax, 1e-8) * fp32(1/127) (returned in every lane) and
// this lane's codes rint(x / scale), 4 a word.
template <int EPL>
__device__ __forceinline__ float quantize_row(const float* f, uint32_t* w) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(f[e]));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  const float r = __frcp_rn(s);
#pragma unroll
  for (int i = 0; i < EPL / 4; ++i) {
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = __float2int_rn(div_rn(f[4 * i + e], s, r));
      word |= (uint32_t)(c & 0xFF) << (8 * e);
    }
    w[i] = word;
  }
  return s;
}

// K codes and scales of k - k_mean, once per call: warp w of block
// (x, b * Hkv + hk) takes rows 64 x + 16 w .. + 15 of that (batch, kv head).
// Codes (B, Hkv, T, D) int8 as they lie, scales (B, Hkv, T) fp32.
template <int D>
__global__ void __launch_bounds__(NWARP * 32)
quantize_keys_kernel(const bf16* __restrict__ k,
                     const float* __restrict__ k_mean,
                     int8_t* __restrict__ ki, float* __restrict__ ks, int T) {
  constexpr int EPL = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t bh = blockIdx.y;
  const int r0 = blockIdx.x * BQ + warp * 16;
  float km[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) km[e] = __ldg(k_mean + bh * D + lane * EPL + e);
  RowPart<EPL> raw[16];
#pragma unroll
  for (int r = 0; r < 16; ++r)
    raw[r] = load_row_part<EPL>(k + (bh * T + r0 + r) * D + lane * EPL);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float f[EPL];
    to_f32<EPL>(raw[r], f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) f[e] = __fsub_rn(f[e], km[e]);
    uint32_t w[EPL / 4];
    const float s = quantize_row<EPL>(f, w);
    int8_t* dst = ki + (bh * T + r0 + r) * D + lane * EPL;
    if constexpr (EPL == 4)
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    if (lane == 0) ks[bh * T + r0 + r] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(NWARP * 32, 2)
sage_fwd_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ ki,
                const float* __restrict__ ks, const bf16* __restrict__ v,
                bf16* __restrict__ out, int H, int Hkv, int S, int T,
                int causal, float rsd) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV;
  constexpr int NT = BKV / 8;          // score n-tiles of a warp
  constexpr int EPL = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Os = reinterpret_cast<bf16*>(smem + C::o_off);
  unsigned char* Qi = smem + C::qi_off;
  unsigned char* Ks = smem + C::k_off;              // two stages
  bf16* Vs = reinterpret_cast<bf16*>(smem + C::v_off);  // two stages
  float* kss = reinterpret_cast<float*>(smem + C::ks_off);
  float* qss = reinterpret_cast<float*>(smem + C::qs_off);

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int ts_off = T - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;     // the warp's first query row

  const size_t bh = (size_t)b * Hkv + hk;
  const bf16* qg = q + (((size_t)b * H + h) * S + wrow) * D;
  const int8_t* kg = ki + bh * T * D;
  const float* ksg = ks + bh * T;
  const bf16* vg = v + bh * T * D;

  int n_tiles = T / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1 + ts_off) / BKV + 1);

  // one kv tile into stage st: K codes, V, K scales
  auto load_tiles = [&](int st, int tile) {
    const int8_t* kt = kg + (size_t)tile * BKV * D;
    const bf16* vt = vg + (size_t)tile * BKV * D;
    unsigned char* kd = Ks + st * BKV * D;
    unsigned char* vd =
        reinterpret_cast<unsigned char*>(Vs + st * BKV * D);
    for (int i = threadIdx.x; i < BKV * D / 16; i += NWARP * 32) {
      const int r = i / (D / 16), c = i % (D / 16);
      cp_async<16>(kd + swz<D>(r, c), kt + (size_t)r * D + c * 16);
    }
    for (int i = threadIdx.x; i < BKV * D / 8; i += NWARP * 32) {
      const int r = i / (D / 8), c = i % (D / 8);
      cp_async<16>(vd + swz<2 * D>(r, c), vt + (size_t)r * D + c * 8);
    }
    if (threadIdx.x < BKV / 4)
      cp_async<16>(kss + st * BKV + 4 * threadIdx.x,
                   ksg + (size_t)tile * BKV + 4 * threadIdx.x);
  };
  load_tiles(0, 0);
  cp_commit();

  // the warp's 16 q rows, quantized once (their codes swizzled for
  // ldmatrix, their scales beside them): lanes 2r and 2r + 1 take the two
  // halves of row r (one shuffle for the row's amax)
  {
    constexpr int HC = D / 16;         // 8-value pieces of a half row
    const int row = warp * 16 + lane / 2, half = lane % 2;
    const uint4* src =
        reinterpret_cast<const uint4*>(qg + (size_t)(lane / 2) * D) + half * HC;
    uint4 raw[HC];
#pragma unroll
    for (int j = 0; j < HC; ++j) raw[j] = __ldg(src + j);
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
    const float rs = __frcp_rn(s);
#pragma unroll
    for (int j = 0; j < HC; j += 2) {  // 16 codes: one 16-byte chunk
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw[j + u / 2]);
        const float2 f0 = __bfloat1622float2(h2[2 * (u % 2)]);
        const float2 f1 = __bfloat1622float2(h2[2 * (u % 2) + 1]);
        const float f[4] = {f0.x, f0.y, f1.x, f1.y};
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          word |= (uint32_t)(__float2int_rn(div_rn(f[e], s, rs)) & 0xFF)
                  << (8 * e);
        w[u] = word;
      }
      *reinterpret_cast<uint4*>(Qi + swz<D>(row, half * HC / 2 + j / 2)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (half == 0) qss[row] = s;
  }
  __syncwarp();
  const float qs_r[2] = {qss[warp * 16 + g], qss[warp * 16 + g + 8]};

  uint32_t qf[C::Q_IN_REGS ? D / 32 : 1][4];
  if constexpr (C::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      ldsm_x4(qf[kk],
              Qi + swz<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
  }
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
    if (it + 1 < n_tiles) load_tiles(st ^ 1, it + 1);
    cp_commit();
    const int kv0 = it * BKV;
    // this warp's rows see no column of this tile
    if (causal && kv0 > wrow + 15 + ts_off) continue;

    // S (16 x BKV) = Qi_w . Ki^T in int32, in registers
    const unsigned char* Kt = Ks + st * BKV * D;
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = I2F_BIAS;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t a[4];
      if constexpr (C::Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, Qi + swz<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                kk * 2 + ((lane >> 3) & 1)));
        mma_s8(acc[2 * np], a, bk[0], bk[1]);
        mma_s8(acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // dequantize in the reference's order, then log2 units; the mask only
    // in diagonal tiles
    const float* kst = kss + st * BKV;
    const bool diag = causal && kv0 + BKV - 1 > wrow + ts_off;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 kc = *reinterpret_cast<const float2*>(kst + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = __fmul_rn(
            __fmul_rn(__fmul_rn(biased_i2f(acc[j][e]), qs_r[e >> 1]),
                      (e & 1) ? kc.y : kc.x),
            rsd);
        float x = sc * LOG2E;
        if (diag) {
          const int col = kv0 + 8 * j + 2 * t + (e & 1);
          const int row = wrow + g + 8 * (e >> 1);
          if (col > row + ts_off) x = MASK_VALUE;
        }
        s[j][e] = x;
      }
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
    const unsigned char* Vt =
        reinterpret_cast<const unsigned char*>(Vs + st * BKV * D);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + swz<2 * D>(kk * 16 + (lane & 15),
                                      dp * 2 + (lane >> 4)));
        mma16816(o[2 * dp], a, bv[0], bv[1]);
        mma16816(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

  // epilogue: the quad's partial sums, normalise, O through the warp's own
  // rows of the staging tile, 16-byte stores
  cp_wait<0>();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = (l[r] == 0.f) ? 1.f : 1.f / l[r];
  }
  unsigned char* Ob = reinterpret_cast<unsigned char*>(Os);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(Ob + swz<2 * D>(row, j) + 4 * t) =
          pack_bf16(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
    }
  __syncwarp();
  constexpr int CH = D / 8;
  bf16* og = out + (((size_t)b * H + h) * S + wrow) * D;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(og + (size_t)r * D + c * 8) =
        *reinterpret_cast<const uint4*>(Ob + swz<2 * D>(warp * 16 + r, c));
  }
}

template <int D>
cudaError_t fwd_attr() {
  return cudaFuncSetAttribute(sage_fwd_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Cfg<D>::bytes);
}

template <int D>
int launch(const void* q, const void* ki, const void* ks, const void* v,
           void* out, int B, int H, int Hkv, int S, int T, int causal,
           float rsd, cudaStream_t stream) {
  const cudaError_t err = fwd_attr<D>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BQ, H, B);
  sage_fwd_kernel<D><<<grid, NWARP * 32, Cfg<D>::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(ki),
      static_cast<const float*>(ks), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, Hkv, S, T, causal, rsd);
  return (int)cudaGetLastError();
}

template <int D>
int info_of(int which, int* out) {
  cudaFuncAttributes a;
  int blocks = 0, smem = 0;
  cudaError_t err = cudaSuccess;
  if (which == 0) {
    smem = (int)Cfg<D>::bytes;
    err = fwd_attr<D>();
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, sage_fwd_kernel<D>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sage_fwd_kernel<D>, NWARP * 32, smem);
  } else {
    err = cudaFuncGetAttributes(&a, quantize_keys_kernel<D>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, quantize_keys_kernel<D>, NWARP * 32, 0);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

}  // namespace

// k (B,Hkv,T,D) bf16 contiguous, k_mean (B,Hkv,D) fp32 -> ki (B,Hkv,T,D)
// int8 codes and ks (B,Hkv,T) fp32 scales of k - k_mean (int8_rows with the
// reciprocal 1/127).  T % 64 == 0, D in {128, 256}.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sage_quantize_keys(const void* k, const void* k_mean, void* ki,
                                  void* ks, int B, int Hkv, int T, int D,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hkv <= 0 || T <= 0 || T % BQ || (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(T / BQ, B * Hkv);
  if (D == 128)
    quantize_keys_kernel<128><<<grid, NWARP * 32, 0, st>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(k_mean),
        static_cast<int8_t*>(ki), static_cast<float*>(ks), T);
  else if (D == 256)
    quantize_keys_kernel<256><<<grid, NWARP * 32, 0, st>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(k_mean),
        static_cast<int8_t*>(ki), static_cast<float*>(ks), T);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q (B,H,S,D) bf16, ki (B,Hkv,T,D) int8 and ks (B,Hkv,T) fp32 from
// sage_quantize_keys, v (B,Hkv,T,D) bf16, all contiguous; out (B,H,S,D)
// bf16.  S % 64 == 0, T % 64 == 0, D in {128, 256}, H % Hkv == 0, T >= S
// when causal; rsd = fp32(1 / sqrt(D)).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int sage_attention_fwd(const void* q, const void* ki,
                                  const void* ks, const void* v, void* out,
                                  int B, int H, int Hkv, int S, int T, int D,
                                  int causal, float rsd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || S % BQ || T <= 0
      || T % BQ || (causal && T < S) || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return launch<128>(q, ki, ks, v, out, B, H, Hkv, S, T, causal, rsd, st);
  if (D == 256)
    return launch<256>(q, ki, ks, v, out, B, H, Hkv, S, T, causal, rsd, st);
  return (int)cudaErrorInvalidValue;
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the
// attention kernel (which 0) or the key pre-pass (which 1) at D = 128 or
// 256, into info[0..3].  Returns a cudaError_t.
extern "C" int sage_attention_info(int D, int which, int* info) {
  if (D == 128) return info_of<128>(which, info);
  if (D == 256) return info_of<256>(which, info);
  return (int)cudaErrorInvalidValue;
}
