// Flash attention backward: dQ and dK/dV, bf16 in/out, fp32 accumulation.
//
// Replaces: autoround_tpu/ops/flash_attention.py, `_flash_bwd` ->
// `_bwd_dq_kernel` (the dQ kernel below) and `_bwd_dkv_kernel` (the dK/dV
// kernel), the two Pallas TPU backward passes, and the XLA sum over the GQA
// group that follows the second.
//
// Both recompute the probabilities from the forward's log-sum-exp:
//   S = Q.K^T * scale (masked),  P = exp(S - lse),
//   dP = dO.V^T,  dS = P * (dP - delta) * scale,  delta = rowsum(dO * O),
//   dQ = sum_kv dS.K,   dV = sum_q P^T.dO,   dK = sum_q dS^T.Q,
// with P and dS rounded to bf16 before the products that consume them, as
// the TPU kernels round them, and every sum in fp32.  delta (B, H, S) fp32
// comes from the caller.  P is 2^x of the score in log2 units (ex2.approx);
// a masked score gives P = 0, as exp(-0.7 * FLT_MAX - lse) does.
//
// What bounds them on an H100: at the tuning shape (S = T = 512, D = 128,
// 32 heads over 8 KV heads) dQ is 3 and dK/dV 4 matrix products per 64 x
// 64 score tile, against tiles that are read once from memory (a K/V tile
// serves every q tile of its group's heads from L2): several hundred
// operations per byte, so the tensor cores bound both.  The two kernels
// stay two, as the two pallas_calls are, so that every output element has
// one writer and two runs give the same bits: the dQ kernel recomputes S
// and dP, 7 products in all against the 5 of FlashAttention-3's backward,
// which adds dQ with atomics in an order that changes from run to run.
//
// Design: FlashAttention-3's backward form on wgmma, without its atomic dQ.
//  * A warpgroup (4 warps) owns 64 rows of its block's tile.  The score
//    tiles S = Q.K^T and dP = dO.V^T (dK/dV: S^T = K.Q^T and dP^T = V.dO^T,
//    computed directly) run as wgmma m64n64k16 with both operands read
//    from shared memory (K-major) and the fp32 accumulators in registers.
//    P and dS are formed in those registers and packed into bf16 A
//    fragments (the accumulator layout of an m64nN product is the register
//    A layout of the next), so no score tile goes through shared memory.
//    dQ += dS.K, dV += P^T.dO and dK += dS^T.Q run as wgmma m64n128k16
//    with A in registers and B read MN-major (smem_desc_mn) from the same
//    swizzled K, dO and Q tiles the scores read K-major: one copy of a tile
//    serves both kinds of product.
//  * Tiles arrive by TMA (128-byte swizzle, 64-column boxes: a D = 128 row
//    is two boxes) into a ring of two slots completing on mbarriers: one
//    thread issues the copies of tile t + 2 once every warpgroup is done
//    with tile t (one block barrier a tile), so each copy overlaps a tile
//    of products; two blocks share an SM at D = 128 and overlap each
//    other's products and elementwise steps.
//  * dQ: one block per (q tile of 64 rows, head, batch).  Q and dO are
//    loaded once; K and V tiles run through the ring up to the diagonal.
//  * dK/dV: one block per (kv tile of 64 rows, KV head, batch).  K and V
//    are loaded once; Q, dO, lse and delta tiles run through the ring over
//    the `rep` query heads of the group and the q tiles from the diagonal
//    down, so the group sum happens in the fp32 accumulators (64 x D each
//    for dK and dV, in registers for the whole loop) and dK, dV (B, Hkv, T,
//    D) are written once.
//  * Causal (bottom-right): tiles past the diagonal are skipped and only
//    the diagonal tile computes the mask.  Blocks start longest first: the
//    q tiles with the most kv tiles, the kv tiles with the most q tiles (at
//    S = T = 512 a causal kv tile walks 4 x 8 down to 4 x 1 tiles; the 512
//    dK/dV blocks fill the 264 places of 132 SMs about twice, the 2048 dQ
//    blocks 7.8 times).
//  * D = 256 runs two warpgroups over the same 64 rows.  Each owns 128
//    columns of the outputs and sums its half of D into the scores; the
//    halves are added through 32 KB of shared memory (warpgroup 1 hands its
//    partial S and dP over, warpgroup 0 adds its own and hands the sums
//    back, so both hold the same bits) and each forms P and dS for the
//    whole tile: at D = 256 the fp32 scores do go through shared memory.
//  * The epilogue converts the fp32 accumulators to bf16 once, through a
//    staging tile in shared memory, and writes 16-byte stores.
// Resources (sm_90a, as the card reports them: chip_smoke.py's build report,
// flash_attention_bwd_info): D = 128, one warpgroup (128 threads): dQ 155
// registers and 97 KB of shared memory, dK/dV 239 registers (the 64 x 128
// dK and dV accumulators) and 98 KB, two blocks per SM; D = 256, two
// warpgroups: dQ 170 registers and 225 KB, dK/dV 254 and 226 KB, one block
// per SM; no spills.
// Was: WMMA 16x16x16 with every score tile through shared memory, single-
// buffered tiles copied through registers, two barriers a tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

using namespace ptx;

typedef __nv_bfloat16 bf16;

constexpr int BT = 64;              // rows of every q / kv tile (wgmma M)
constexpr int DW = 128;             // output columns of one warpgroup
constexpr int BOX = BT * 128;       // one TMA box: 64 rows x 64 bf16
constexpr int STAGES = 2;           // ring slots
constexpr int OST = 2 * DW + 16;    // byte row stride of a staging tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int NWG = D / DW;             // warpgroups a block
  static constexpr int THREADS = 128 * NWG;
  static constexpr int NBOX = D / 64;            // boxes across a tile row
  static constexpr int TILE = NBOX * BOX;        // one 64 x D tile
  static constexpr int KW = D / NWG / 16;        // k-steps of a score share
  static constexpr int XCH = NWG > 1 ? 2 * 32 * 128 * 4 : 0;
  // shared memory: two resident tiles | ring of two-tile slots | lse and
  // delta of the slots (dK/dV) | exchange of the halves (D = 256) |
  // barriers (the ring's, then the resident tiles')
  static constexpr int ring = 2 * TILE;
  static constexpr int vec = ring + STAGES * 2 * TILE;
  __host__ __device__ static constexpr int xch(bool kv) {
    return vec + (kv ? STAGES * 2 * BT * 4 : 0);
  }
  __host__ __device__ static constexpr int bar(bool kv) {
    return xch(kv) + XCH;
  }
  __host__ __device__ static constexpr int smem(bool kv) {
    return bar(kv) + 8 * (STAGES + 1) + 1024;   // + alignment to 1 KB
  }
  static_assert(NWG * 2 * BT * OST <= STAGES * 2 * TILE,
                "the epilogue stages through the ring");
};

// the block's dynamic shared memory from its first 1 KB boundary (the
// 128-byte swizzle repeats every 1 KB)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// s (64 x 64 fp32) = A . B^T over this warpgroup's share of D: A and B
// 64-row tiles of D columns in swizzled boxes.  Issued, not waited for.
template <int D>
__device__ __forceinline__ void scores(float* s, const unsigned char* A,
                                       const unsigned char* B, int wg) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::KW; ++kk) {
    const int off = (wg * (C::NBOX / C::NWG) + kk / 4) * BOX + (kk % 4) * 32;
    wgmma_m64n64k16_ss(s, smem_desc(A + off), smem_desc(B + off), kk > 0);
  }
}

// acc (64 x DW) += A (64 x 64: four k-steps of register fragments) .
// B[:, wg DW : (wg + 1) DW], B a 64-row tile read MN-major.  Issued, not
// waited for.
__device__ __forceinline__ void accumulate(float* acc, const uint32_t* a,
                                           const unsigned char* B, int wg) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_m64n128k16_rs(acc, a + 4 * kk,
                        smem_desc_mn(B + 2 * wg * BOX + kk * 2048, BOX), 1);
}

// D = 256: add the two warpgroups' halves of s and dp (thread i of either
// warpgroup holds the same elements).  Warpgroup 1 hands its halves over,
// warpgroup 0 adds its own first and hands the sums back.
__device__ __forceinline__ void sum_halves(float* s, float* dp, float4* x,
                                           int wg, int i) {
  if (wg == 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x[k * 128 + i] = make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2],
                                   s[4 * k + 3]);
      x[(8 + k) * 128 + i] = make_float4(dp[4 * k], dp[4 * k + 1],
                                         dp[4 * k + 2], dp[4 * k + 3]);
    }
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float* v = k < 8 ? s + 4 * k : dp + 4 * (k - 8);
      const float4 o = x[k * 128 + i];
      v[0] += o.x;
      v[1] += o.y;
      v[2] += o.z;
      v[3] += o.w;
      x[k * 128 + i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float* v = k < 8 ? s + 4 * k : dp + 4 * (k - 8);
      const float4 o = x[k * 128 + i];
      v[0] = o.x;
      v[1] = o.y;
      v[2] = o.z;
      v[3] = o.w;
    }
  }
}

// A warpgroup's 64 x DW accumulators as bf16 into its staging tile (row
// stride OST bytes: the 4-byte stores of a warp hit 32 banks); thread i of
// the warpgroup holds value 4j + c at row 16 (i / 32) + (i % 32) / 4 + 8
// (c / 2), column 8j + 2 (i % 4) + c % 2.
__device__ __forceinline__ void stage(unsigned char* stg, const float* acc,
                                      int i) {
  const int r0 = 16 * (i / 32) + (i % 32) / 4, c0 = 2 * (i % 4);
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(stg + (r0 + 8 * r) * OST + (8 * j + c0) * 2) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

// a staging tile to global rows of stride ld elements, 16 bytes a store
__device__ __forceinline__ void copy_out(bf16* dst, const unsigned char* stg,
                                         int ld, int i) {
  for (int k = i; k < BT * DW / 8; k += 128) {
    const int r = k / (DW / 8), c = k % (DW / 8);
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + 8 * c) =
        *reinterpret_cast<const uint4*>(stg + r * OST + 16 * c);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const __grid_constant__ CUtensorMap tmdO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Hkv, int S, int T, int causal,
                    float sm_scale) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + C::TILE;
  unsigned char* ring = smem + C::ring;
  float4* xch = reinterpret_cast<float4*>(smem + C::xch(false));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::bar(false));

  const int bh = blockIdx.x;                     // b * H + h
  const int qt = gridDim.y - 1 - blockIdx.y;     // longest q tiles first
  const int bhk = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = qt * BT, ts_off = T - S;
  int n_tiles = T / BT;
  if (causal) n_tiles = min(n_tiles, (q0 + BT - 1 + ts_off) / BT + 1);
  const int wg = threadIdx.x / 128, i = threadIdx.x % 128;
  const int r0 = 16 * (i / 32) + (i % 32) / 4, c0 = 2 * (i % 4);

  // K and V tile t into slot t % STAGES (its fill t / STAGES completes that
  // barrier's phase of parity (t / STAGES) & 1)
  auto issue = [&](int t) {
    unsigned char* sl = ring + (t % STAGES) * 2 * C::TILE;
    uint64_t* bar = bars + t % STAGES;
    mbar_expect_tx(bar, 2 * C::TILE);
    const int row = bhk * T + t * BT;
#pragma unroll
    for (int c = 0; c < C::NBOX; ++c) {
      tma_load_2d(sl + c * BOX, &tmK, 64 * c, row, bar);
      tma_load_2d(sl + C::TILE + c * BOX, &tmV, 64 * c, row, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + s, 1);
    mbar_init_fence();
    mbar_expect_tx(bars + STAGES, 2 * C::TILE);
#pragma unroll
    for (int c = 0; c < C::NBOX; ++c) {
      tma_load_2d(Qs + c * BOX, &tmQ, 64 * c, bh * S + q0, bars + STAGES);
      tma_load_2d(dOs + c * BOX, &tmdO, 64 * c, bh * S + q0, bars + STAGES);
    }
    for (int s = 0; s < STAGES && s < n_tiles; ++s) issue(s);
  }
  __syncthreads();

  // this lane's rows r0 and r0 + 8: lse in log2 units, delta
  const float c2 = sm_scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t o = (size_t)bh * S + q0 + r0 + 8 * r;
    lse2[r] = lse[o] * LOG2E;
    dl[r] = delta[o];
  }
  float acc[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = 0.f;
  mbar_wait(bars + STAGES, 0);

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(bars + t % STAGES, (t / STAGES) & 1);
    const unsigned char* Ks = ring + (t % STAGES) * 2 * C::TILE;
    const unsigned char* Vs = Ks + C::TILE;
    float s[32], dp[32];
    wgmma_fence();
    scores<D>(s, Qs, Ks, wg);
    scores<D>(dp, dOs, Vs, wg);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<32>(s);
    fence_acc<32>(dp);
    if constexpr (C::NWG > 1) sum_halves(s, dp, xch, wg, i);

    // P and dS in registers; value v = 4j + c is row r0 + 8 (c / 2),
    // column 8j + c0 + c % 2, and values 2e, 2e + 1 make A register e
    const int kv0 = t * BT;
    const bool diag = causal && kv0 + BT - 1 > q0 + ts_off;
    uint32_t ds[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float d2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 2 * e + h, r = (v % 4) / 2;
        float p = ex2(fmaf(s[v], c2, -lse2[r]));
        if (diag && kv0 + 8 * (v / 4) + c0 + h > q0 + r0 + 8 * r + ts_off)
          p = 0.f;
        d2[h] = p * (dp[v] - dl[r]) * sm_scale;
      }
      ds[e] = pack_bf16(d2[0], d2[1]);
    }
    wgmma_fence();
    accumulate(acc, ds, Ks, wg);                 // dQ += dS . K
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc<16>(ds);
    __syncthreads();                 // every warpgroup is done with slot t
    if (threadIdx.x == 0 && t + STAGES < n_tiles) issue(t + STAGES);
  }

  unsigned char* stg = ring + wg * BT * OST;     // the ring is free now
  stage(stg, acc, i);
  __syncthreads();
  copy_out(dq + ((size_t)bh * S + q0) * D + wg * DW, stg, D, i);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tmQ,
                     const __grid_constant__ CUtensorMap tmK,
                     const __grid_constant__ CUtensorMap tmV,
                     const __grid_constant__ CUtensorMap tmdO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Hkv, int S, int T,
                     int causal, float sm_scale) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + C::TILE;
  unsigned char* ring = smem + C::ring;
  float* vec = reinterpret_cast<float*>(smem + C::vec);
  float4* xch = reinterpret_cast<float4*>(smem + C::xch(true));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::bar(true));

  const int bhk = blockIdx.x;                    // b * Hkv + kv head
  const int kt = blockIdx.y;                     // causal: longest first
  const int rep = H / Hkv, b = bhk / Hkv, hk = bhk % Hkv;
  const int kv0 = kt * BT, ts_off = T - S;
  // first q tile with a row that sees this kv tile (bottom-right diagonal)
  int qt0 = 0;
  if (causal) {
    const int lo = kv0 - ts_off - (BT - 1);
    qt0 = lo <= 0 ? 0 : (lo + BT - 1) / BT;
  }
  const int nq = S / BT - qt0, steps = rep * nq;
  const int wg = threadIdx.x / 128, i = threadIdx.x % 128;
  const int r0 = 16 * (i / 32) + (i % 32) / 4, c0 = 2 * (i % 4);

  // step n: query head hk * rep + n / nq, q tile qt0 + n % nq; its Q, dO,
  // lse and delta into slot n % STAGES
  auto issue = [&](int n) {
    unsigned char* sl = ring + (n % STAGES) * 2 * C::TILE;
    float* vs = vec + (n % STAGES) * 2 * BT;
    uint64_t* bar = bars + n % STAGES;
    const int row = (b * H + hk * rep + n / nq) * S + (qt0 + n % nq) * BT;
    mbar_expect_tx(bar, 2 * C::TILE + 2 * BT * 4);
#pragma unroll
    for (int c = 0; c < C::NBOX; ++c) {
      tma_load_2d(sl + c * BOX, &tmQ, 64 * c, row, bar);
      tma_load_2d(sl + C::TILE + c * BOX, &tmdO, 64 * c, row, bar);
    }
    bulk_load(vs, lse + row, BT * 4, bar);
    bulk_load(vs + BT, delta + row, BT * 4, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + s, 1);
    mbar_init_fence();
    mbar_expect_tx(bars + STAGES, 2 * C::TILE);
#pragma unroll
    for (int c = 0; c < C::NBOX; ++c) {
      tma_load_2d(Ks + c * BOX, &tmK, 64 * c, bhk * T + kv0, bars + STAGES);
      tma_load_2d(Vs + c * BOX, &tmV, 64 * c, bhk * T + kv0, bars + STAGES);
    }
    for (int s = 0; s < STAGES && s < steps; ++s) issue(s);
  }
  __syncthreads();

  const float c2 = sm_scale * LOG2E;
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    dk_acc[k] = 0.f;
    dv_acc[k] = 0.f;
  }
  mbar_wait(bars + STAGES, 0);

  for (int n = 0; n < steps; ++n) {
    mbar_wait(bars + n % STAGES, (n / STAGES) & 1);
    const unsigned char* Qs = ring + (n % STAGES) * 2 * C::TILE;
    const unsigned char* dOs = Qs + C::TILE;
    const float* lse_s = vec + (n % STAGES) * 2 * BT;
    const float* dl_s = lse_s + BT;
    float st[32], dpt[32];
    wgmma_fence();
    scores<D>(st, Ks, Qs, wg);                   // S^T = K . Q^T
    scores<D>(dpt, Vs, dOs, wg);                 // dP^T = V . dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<32>(st);
    fence_acc<32>(dpt);
    if constexpr (C::NWG > 1) sum_halves(st, dpt, xch, wg, i);

    // P^T and dS^T in registers: value v = 4j + c is kv row r0 + 8 (c / 2),
    // q column 8j + c0 + c % 2
    const int q0 = (qt0 + n % nq) * BT;
    const bool diag = causal && kv0 + BT - 1 > q0 + ts_off;
    uint32_t pt[16], dst[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float p2[2], d2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 2 * e + h, r = (v % 4) / 2;
        const int col = 8 * (v / 4) + c0 + h;
        float p = ex2(fmaf(st[v], c2, -lse_s[col] * LOG2E));
        if (diag && kv0 + r0 + 8 * r > q0 + col + ts_off) p = 0.f;
        p2[h] = p;
        d2[h] = p * (dpt[v] - dl_s[col]) * sm_scale;
      }
      pt[e] = pack_bf16(p2[0], p2[1]);
      dst[e] = pack_bf16(d2[0], d2[1]);
    }
    wgmma_fence();
    accumulate(dv_acc, pt, dOs, wg);             // dV += P^T . dO
    accumulate(dk_acc, dst, Qs, wg);             // dK += dS^T . Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    fence_acc<16>(pt);
    fence_acc<16>(dst);
    __syncthreads();                 // every warpgroup is done with slot n
    if (threadIdx.x == 0 && n + STAGES < steps) issue(n + STAGES);
  }

  unsigned char* stg = ring + wg * 2 * BT * OST;   // the ring is free now
  stage(stg, dk_acc, i);
  stage(stg + BT * OST, dv_acc, i);
  __syncthreads();
  const size_t o = ((size_t)bhk * T + kv0) * D + wg * DW;
  copy_out(dk + o, stg, D, i);
  copy_out(dv + o, stg + BT * OST, D, i);
}

// The four tensor maps (q and dO as (B*H*S, D), k and v as (B*Hkv*T, D)
// bf16, 64-row boxes) and the kernel's dynamic shared memory, which is set
// before every launch (above 48 KB it must be asked for; not cached in a
// function-local static: a template's static is one object across every
// library loaded in the process).
template <int D>
int prepare(const void* kernel, int smem, const void* q, const void* k,
            const void* v, const void* dO, int B, int H, int Hkv, int S,
            int T, CUtensorMap* maps) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr
      || !bf16_map(encode, maps + 0, q, (long long)B * H * S, D, BT)
      || !bf16_map(encode, maps + 1, k, (long long)B * Hkv * T, D, BT)
      || !bf16_map(encode, maps + 2, v, (long long)B * Hkv * T, D, BT)
      || !bf16_map(encode, maps + 3, dO, (long long)B * H * S, D, BT))
    return (int)cudaErrorNotSupported;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Hkv, int S, int T, int causal, float sm_scale,
              cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap m[4];
  const int err = prepare<D>((const void*)flash_bwd_dq_kernel<D>,
                             C::smem(false), q, k, v, dO, B, H, Hkv, S, T, m);
  if (err) return err;
  dim3 grid(B * H, S / BT);
  flash_bwd_dq_kernel<D><<<grid, C::THREADS, C::smem(false), stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Hkv, S,
      T, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Hkv, int S, int T, int causal, float sm_scale,
               cudaStream_t stream) {
  using C = Cfg<D>;
  // lse and delta rows arrive by bulk copies: 16-byte aligned
  if (reinterpret_cast<uintptr_t>(lse) % 16
      || reinterpret_cast<uintptr_t>(delta) % 16)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap m[4];
  const int err = prepare<D>((const void*)flash_bwd_dkv_kernel<D>,
                             C::smem(true), q, k, v, dO, B, H, Hkv, S, T, m);
  if (err) return err;
  dim3 grid(B * Hkv, T / BT);
  flash_bwd_dkv_kernel<D><<<grid, C::THREADS, C::smem(true), stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hkv, S, T, causal, sm_scale);
  return (int)cudaGetLastError();
}

// registers, spill bytes, dynamic shared bytes and blocks per SM of a kernel
int kernel_info(const void* kernel, int threads, int smem, int* out) {
  int blocks = 0;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

// ------------------------------------------------------------------ probes
// The two products the kernels above are built from, each alone, for the
// card tests (one warpgroup; tiles by TMA through bf16_map):
//  mode 0: c (64 x 64 fp32) = a (64 x 128) . b (64 x 128)^T, both operands
//          K-major in shared memory (smem_desc: the score tiles);
//  mode 1: c (64 x 128 fp32) = a (64 x 64) . b[:, 64 box0 : 64 box0 + 128],
//          a held in registers as A fragments, b (64 x 64 nbox) read
//          MN-major (smem_desc_mn: the accumulating products).
__global__ void __launch_bounds__(128)
probe_kernel(const __grid_constant__ CUtensorMap tmA,
             const __grid_constant__ CUtensorMap tmB,
             const bf16* __restrict__ a, float* __restrict__ c, int mode,
             int nbox, int box0) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* As = smem;
  unsigned char* Bs = smem + 2 * BOX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + nbox * BOX);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, (mode == 0 ? 2 + nbox : nbox) * BOX);
    if (mode == 0)
      for (int k = 0; k < 2; ++k) tma_load_2d(As + k * BOX, &tmA, 64 * k, 0, bar);
    for (int k = 0; k < nbox; ++k) tma_load_2d(Bs + k * BOX, &tmB, 64 * k, 0, bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  const int i = threadIdx.x;
  const int r0 = 16 * (i / 32) + (i % 32) / 4, c0 = 2 * (i % 4);
  if (mode == 0) {
    float d[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma_m64n64k16_ss(d, smem_desc(As + off), smem_desc(Bs + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<32>(d);
#pragma unroll
    for (int v = 0; v < 32; ++v)
      c[(r0 + 8 * ((v % 4) / 2)) * 64 + 8 * (v / 4) + c0 + v % 2] = d[v];
  } else {
    // register e = 4 kk + q: row r0 + 8 (q % 2), columns 16 kk + c0 + 8 (q / 2)
    uint32_t af[16];
#pragma unroll
    for (int e = 0; e < 16; ++e)
      af[e] = *reinterpret_cast<const uint32_t*>(
          a + (r0 + 8 * (e % 2)) * 64 + 16 * (e / 4) + c0 + 8 * ((e % 4) / 2));
    float d[64];
#pragma unroll
    for (int v = 0; v < 64; ++v) d[v] = 0.f;
    wgmma_fence();
    accumulate(d, af, Bs + box0 * BOX, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    fence_acc<16>(af);
#pragma unroll
    for (int v = 0; v < 64; ++v)
      c[(r0 + 8 * ((v % 4) / 2)) * 128 + 8 * (v / 4) + c0 + v % 2] = d[v];
  }
}

}  // namespace

// q, dO (B,H,S,D), k/v (B,Hkv,T,D) bf16 contiguous; lse, delta (B,H,S)
// fp32; dq (B,H,S,D) bf16.  S % 64 == 0, T % 64 == 0, D in {128, 256},
// H % Hkv == 0, T >= S when causal.  Returns the launch's cudaError_t.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int Hkv, int S,
                                      int T, int D, int causal,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dq<128>(q, k, v, dO, lse, delta, dq, B, H, Hkv, S, T,
                          causal, sm_scale, st);
  if (D == 256)
    return launch_dq<256>(q, k, v, dO, lse, delta, dq, B, H, Hkv, S, T,
                          causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// Same inputs; dk, dv (B,Hkv,T,D) bf16, already summed over each KV head's
// group of query heads.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dO,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Hkv, int S, int T, int D,
                                       int causal, float sm_scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv, S, T,
                           causal, sm_scale, st);
  if (D == 256)
    return launch_dkv<256>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv, S, T,
                           causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// Registers, spill bytes, dynamic shared bytes and blocks per SM of the dQ
// (kernel 0) or dK/dV (kernel 1) instance at D = 128 or 256 into
// info[0..3].  Returns a cudaError_t.
extern "C" int flash_attention_bwd_info(int D, int kernel, int* info) {
  if (D == 128 && kernel == 0)
    return kernel_info((const void*)flash_bwd_dq_kernel<128>,
                       Cfg<128>::THREADS, Cfg<128>::smem(false), info);
  if (D == 128 && kernel == 1)
    return kernel_info((const void*)flash_bwd_dkv_kernel<128>,
                       Cfg<128>::THREADS, Cfg<128>::smem(true), info);
  if (D == 256 && kernel == 0)
    return kernel_info((const void*)flash_bwd_dq_kernel<256>,
                       Cfg<256>::THREADS, Cfg<256>::smem(false), info);
  if (D == 256 && kernel == 1)
    return kernel_info((const void*)flash_bwd_dkv_kernel<256>,
                       Cfg<256>::THREADS, Cfg<256>::smem(true), info);
  return (int)cudaErrorInvalidValue;
}

// The probes above: a, b bf16 contiguous on the card (mode 0: a and b 64 x
// 128; mode 1: a 64 x 64, b 64 x 64 nbox with nbox in 2..4 and box0 + 2 <=
// nbox), c fp32 (mode 0: 64 x 64; mode 1: 64 x 128).  Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_probe(int mode, const void* a,
                                         const void* b, void* c, int nbox,
                                         int box0, void* stream) {
  if ((mode != 0 && mode != 1) || nbox < 2 || nbox > 4
      || (mode == 0 && nbox != 2) || box0 < 0 || box0 + 2 > nbox)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  CUtensorMap tmA, tmB;
  if (encode == nullptr || !bf16_map(encode, &tmB, b, BT, 64 * nbox, BT)
      || (mode == 0 && !bf16_map(encode, &tmA, a, BT, 128, BT)))
    return (int)cudaErrorNotSupported;
  if (mode == 1) tmA = tmB;                      // not read
  const int smem = (2 + nbox) * BOX + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tmA, tmB, static_cast<const bf16*>(a), static_cast<float*>(c), mode,
      nbox, box0);
  return (int)cudaGetLastError();
}
