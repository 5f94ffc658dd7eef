// Flash attention backward for Hopper (sm_90a), fp32 and bf16, D <= 128.
//
// Replaces the Pallas kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel` in
// open_pandora_tpu/ops/flash_attention.py (reached through `_bwd`, the
// custom VJP of `flash_attention`). Same function and the same two-kernel
// design: p is recomputed from q, k and the forward's log-sum-exp, never
// stored; dp = do v^T, ds = p (dp - di) scale with di = rowsum(o do)
// (computed by the caller, in fp32, as the JAX package does in XLA);
// dv = p^T do and dk = ds^T q in a kernel whose block owns a key tile and
// loops over query tiles; dq = ds k in a kernel whose block owns a query
// tile and loops over key tiles. No atomics; each output is rounded once.
//
// Layout: q and do (B, N, H, D), k and v (B, M, H, D) read through their
// batch, sequence and head strides (head dim contiguous); lse and di
// contiguous (B, H, N) fp32; dq, dk, dv written contiguous.
//
// What bounds it on the card: the products, 14 N M D operations per (b, h)
// over both kernels (dkv: S^T, dP^T, dV, dK; dq: S, dP, dQ; bf16 runs them
// as 20 with the split operands of Precision below, fp32 as 42 TF32
// operations in split TF32), against 989 TFLOP/s of bf16 tensor cores (fp32:
// 495 of TF32, 165 split); the bytes (q, k, v, do, the statistics and the
// three gradients once each) are one to two orders of magnitude below that
// at the UNet's shapes. The bf16 design puts every product on wgmma:
//   - dkv (`flash_bwd_dkv_tc_kernel`): two warpgroups, 64 keys each, hold
//     their K and V rows resident in 128-byte-swizzled shared memory while
//     (q, do) tiles of 64 rows and their lse and di stream through a
//     two-stage cp.async ring. Per q tile each warpgroup issues
//     S^T = K q^T and dP^T = V do^T as wgmma with both operands K-major in
//     shared memory, computes P^T = exp2(S^T scale log2 e - lse log2 e)
//     and dS^T = P^T (dP^T - di) scale on the accumulator fragments, packs
//     both to bf16 as wgmma's register A operand (the forward's identity:
//     the accumulator of two n8 tiles is the A fragment of one k16 chunk)
//     and issues dV += P^T do and dK += dS^T q with do and q read MN-major
//     from the same swizzled tiles (each product twice, see Precision).
//     dK and dV stay in fp32 registers for the whole loop. (Keeping the dV
//     and dK products in flight into the next tile's issue, with a third
//     stage, ran slower on the card: ptxas serializes them, C7515.)
//   - dq (`flash_bwd_dq_tc_kernel`): two warpgroups, 64 q rows each, hold
//     q and do resident; K and V tiles of 64 keys stream through the ring;
//     S = q K^T and dP = do V^T as ss products, dS in registers, then
//     dQ += dS K with K MN-major (twice, see Precision).
// fp32 keeps the same two kernels and loops on mma.sync m16n8k8 in split
// TF32 (common.cuh), every one of the five products
// (`flash_bwd_dkv_f32_kernel`, `flash_bwd_dq_f32_kernel`): four warps of
// 16 resident rows (dkv: K and V; dq: q and do) and a two-stage ring of 64
// streamed rows at D <= 64 (32 at D <= 128, so that the fp32 tiles fit two
// blocks an SM); P^T, dS^T and dS stay in accumulator fragments and feed
// the next product as its A operand in the accumulator's column order, so
// do, q and K are read straight from their row-major tiles, with no
// transposed copy (wgmma's tf32 form would want them K-major).
// What was hard, and the answer:
//   - Masking, as the forward masks: keys at or past M weigh exactly 0;
//     with `causal`, key col > row + (M - N) scores kMaskValue. A row with
//     no visible key (causal N > M) has LSE = kMaskValue and attends
//     uniformly (exp(kMaskValue - kMaskValue) = 1 per key). In the exp2
//     domain kMaskValue log2 e overflows to -inf, so a masked score's p is
//     written directly: 1 where the row's scaled LSE is -inf, else 0. Tiles
//     wholly above the diagonal are skipped only where every row keeps a
//     key (M >= N), where that is exact. q rows past N are zero-filled in
//     q and do (and their lse and di read 0), so they add nothing.
//   - Head widths off 16 or 64: D in (64, 128] takes the DMAX = 128 tile;
//     with D % 16 == 8 the k16 chunk past D is zeroed once in every tile
//     (`sw128_zero_tail`), since the copies never write it and the S and dP
//     products read it. Columns past D of the MN-major operands only feed
//     accumulator columns that are never stored.
//   - Precision: p and ds are fp32 where they are formed (ds from the fp32
//     p, as the Pallas kernels keep both in fp32 for their dots). Rounded
//     to bf16 once as the A operand of their products, as SDPA's backward
//     does, they put dq, dk and dv at 0.5-1.35 of the phase-3 bound
//     (`2 max|plain_bf16 - ref32| + 1e-2 mean|ref32|`; 1.35 for dq at
//     (2,1000,4,128) causal). So each is split into bf16 hi + lo parts
//     (`pack_a`) and each of the three products runs once per part: about
//     16 bits of p and ds reach the fp32 accumulators, for 7 products per
//     tile pair where one rounding would take 5.
//   - Registers: at DMAX = 128 a dkv thread holds 64 + 64 dK and dV
//     accumulators beside 32 + 32 of S^T and dP^T and the 64 words of the
//     split A operands. One block of two warpgroups per SM, whose launch
//     bound lets ptxas use 255: it takes 245-250 with no spill (181-182 at
//     DMAX = 64; the dq kernel 144-162; the build's ptxas log).
//   - fp32 precision: the tensor core rounds toward zero as it
//     accumulates, so dK, dV (over every q tile) and dQ (over every key
//     tile) chained through one accumulator drifted tens of times further
//     from the float64 result than an fp32 sum; each streamed tile's
//     products go to a fresh partial, added on the CUDA cores (`acc_pv`),
//     and S and dP sum 64 head columns at a time the same way
//     (`scores_3xtf32`).
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

// -- bf16: wgmma ------------------------------------------------------------

struct TcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;  // (B, H, N)
  const float* di;   // (B, H, N)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int N, M, H, D;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, dsb, dsn, dsh;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// Shared-memory plan of both kernels: two resident tiles of kRes = 128
// rows (dkv: K and V; dq: q and do), kStages ring stages, each of two
// streamed tiles of kStr = 64 rows (dkv: q and do; dq: K and V), then for
// dkv each stage's 64 lse and 64 di values. Every tile is laid out in
// 64-column blocks of 128-byte-swizzled rows, 1024-byte aligned. Two
// stages: tile it + 1 is copied while tile it is multiplied.
template <int DMAX>
struct BwdTc {
  static_assert(DMAX == 64 || DMAX == 128, "wgmma backward: DMAX 64 or 128");
  static constexpr int kRes = 64 * kWgGroups;  // resident rows per block
  static constexpr int kStr = 64;              // streamed rows per tile
  static constexpr int NCB = DMAX / 64;        // 64-column swizzle blocks
  static constexpr int RB = kRes * 128;        // bytes of a resident block
  static constexpr int SB = kStr * 128;        // bytes of a streamed block
  static constexpr int kStages = 2;
  static constexpr int kStage = 2 * NCB * SB;  // 1024-byte multiple
  static constexpr size_t smem_bytes =
      1024 + static_cast<size_t>(2 * NCB * RB + kStages * kStage +
                                 kStages * 2 * kStr * 4);

  unsigned char* r0;  // K (dkv) or q (dq)
  unsigned char* r1;  // V (dkv) or do (dq)
  unsigned char* ring;

  __device__ static BwdTc carve(unsigned char* smem, int D) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    BwdTc t;
    t.r0 = smem + ((1024 - (a & 1023)) & 1023);
    t.r1 = t.r0 + NCB * RB;
    t.ring = t.r1 + NCB * RB;
    sw128_zero_tail<kRes, kWgThreads>(t.r0, D);
    sw128_zero_tail<kRes, kWgThreads>(t.r1, D);
    for (int st = 0; st < kStages; ++st) {
      sw128_zero_tail<kStr, kWgThreads>(t.s0(st), D);
      sw128_zero_tail<kStr, kWgThreads>(t.s1(st), D);
    }
    return t;
  }
  __device__ unsigned char* s0(int st) const { return ring + st * kStage; }
  __device__ unsigned char* s1(int st) const {
    return ring + st * kStage + NCB * SB;
  }
  __device__ float* stats(int st) const {  // lse [0, 64), di [64, 128)
    return reinterpret_cast<float*>(ring + kStages * kStage) + st * 2 * kStr;
  }
};

// acc = a (the warpgroup's 64 rows, K-major) b^T (64 rows, K-major) over
// the head dim, both from swizzled tiles whose column blocks are a_block
// and b_block bytes apart.
template <int DMAX>
__device__ __forceinline__ void ss_product(float (&acc)[32],
                                           const unsigned char* a,
                                           int a_block,
                                           const unsigned char* b,
                                           int b_block, int D) {
#pragma unroll
  for (int kc = 0; kc < DMAX / 16; ++kc) {
    if (kc * 16 >= D) break;
    const int off = (kc & 3) * 32;  // k16 step inside a 128-byte row
    wgmma_ss_n64(acc, sw128_desc(a + (kc >> 2) * a_block + off, 16, 1024),
                 sw128_desc(b + (kc >> 2) * b_block + off, 16, 1024), kc);
  }
}

// acc += a (64 x 64 in registers, bf16 A fragments of four k16 chunks)
// b (64 rows of a 64-row swizzled tile, read MN-major over DMAX columns).
template <int DMAX>
__device__ __forceinline__ void rs_product(float (&acc)[DMAX / 2],
                                           const uint32_t (&a)[4][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint64_t db = sw128_desc(b + kc * 16 * 128, BwdTc<DMAX>::SB, 1024);
    if constexpr (DMAX == 64)
      wgmma_rs_n64(acc, a[kc], db);
    else
      wgmma_rs_n128(acc, a[kc], db);
  }
}

// The A fragments of a 64 x 64 accumulator as two bf16 parts, hi = s
// rounded to bf16 and lo = s - hi rounded to bf16: hi + lo carries about
// 16 bits of s, so a product run once with each part adds s's rounding to
// the result only at the 2^-17 level.
__device__ __forceinline__ void pack_a(uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float x0 = s[8 * kc + 2 * w];
      const float x1 = s[8 * kc + 2 * w + 1];
      hi[kc][w] = pack_bf16(x0, x1);
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi[kc][w]));
      lo[kc][w] = pack_bf16(x0 - h.x, x1 - h.y);
    }
    reg_fence(hi[kc]);
    reg_fence(lo[kc]);
  }
}

// p of one score: exp2(s scale log2 e - lse log2 e), or for a masked score
// (`masked`) 1 where the row has no visible key (its lse2 is -inf) and 0
// elsewhere.
__device__ __forceinline__ float tc_p(float s, float scale_log2, float lse2,
                                      bool masked) {
  if (masked) return lse2 == -INFINITY ? 1.f : 0.f;
  return ex2(fmaf(s, scale_log2, -lse2));
}

// Write a warp's rows of a (rows, DMAX) accumulator as bf16 rows of D
// (rows at or past `valid` skipped). row0: the first row of the warp.
template <int DMAX>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride,
                                           const float (&acc)[DMAX / 2],
                                           int row0, int valid, int D) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D)
        Elem<bf16>::store2(out + r * row_stride + col, acc[4 * j + 2 * hh],
                           acc[4 * j + 2 * hh + 1]);
    }
  }
}

// dk, dv of 128 keys: grid (key tiles, H, B), q tiles inner.
template <int DMAX, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_tc_kernel(const TcArgs a) {
  using L = BwdTc<DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const L tile = L::carve(smem, a.D);
  const int k0 = blockIdx.x * L::kRes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  const int t = threadIdx.x & 3;
  const int key = k0 + warp * 16 + ((threadIdx.x & 31) >> 2);  // row g
  const int q_offset = kCausal ? a.M - a.N : 0;
  const int D = a.D;

  const int kvalid = min(L::kRes, a.M - k0);
  sw128_load_rows<L::kRes, DMAX, kWgThreads>(
      tile.r0, a.k + b * a.ksb + k0 * a.ksn + h * a.ksh, a.ksn, kvalid, D);
  sw128_load_rows<L::kRes, DMAX, kWgThreads>(
      tile.r1, a.v + b * a.vsb + k0 * a.vsn + h * a.vsh, a.vsn, kvalid, D);
  cp_async_commit();

  const bf16* qb = a.q + b * a.qsb + h * a.qsh;
  const bf16* db = a.dout + b * a.dsb + h * a.dsh;
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.N;
  // q tiles wholly above the diagonal see none of these keys; skipping them
  // is exact when every row keeps a key (M >= N)
  int q_begin = 0;
  if (kCausal && q_offset >= 0)
    q_begin = max(0, k0 - q_offset) / L::kStr * L::kStr;
  const int ntiles = (a.N - q_begin + L::kStr - 1) / L::kStr;
  auto issue = [&](int it) {
    const int q0 = q_begin + it * L::kStr;
    const int valid = min(L::kStr, a.N - q0);
    const int st = it % L::kStages;
    sw128_load_rows<L::kStr, DMAX, kWgThreads>(tile.s0(st), qb + q0 * a.qsn,
                                               a.qsn, valid, D);
    sw128_load_rows<L::kStr, DMAX, kWgThreads>(tile.s1(st), db + q0 * a.dsn,
                                               a.dsn, valid, D);
    if (threadIdx.x < 2 * L::kStr) {
      const int r = threadIdx.x % L::kStr;
      const float* src = threadIdx.x < L::kStr ? a.lse : a.di;
      cp_async4(tile.stats(st) + threadIdx.x,
                src + stat + q0 + (r < valid ? r : 0), r < valid);
    }
    cp_async_commit();
  };

  float dk[DMAX / 2], dv[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) dk[i] = dv[i] = 0.f;
  const unsigned char* kw = tile.r0 + wg * 64 * 128;
  const unsigned char* vw = tile.r1 + wg * 64 * 128;
  // keys past M, or a causal diagonal, in this warpgroup's 64 keys
  const bool edge = k0 + wg * 64 + 64 > a.M;
  if (ntiles > 0) issue(0);
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // tile it (and K, V) landed; tile it - 1's stage free
    if (it + 1 < ntiles) issue(it + 1);
    const int st = it % L::kStages;
    const int q0 = q_begin + it * L::kStr;
    const unsigned char* qs = tile.s0(st);
    const unsigned char* dos = tile.s1(st);
    const float* lse = tile.stats(st);
    const float* di = lse + L::kStr;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
    ss_product<DMAX>(s, kw, L::RB, qs, L::SB, D);
    ss_product<DMAX>(dp, vw, L::RB, dos, L::SB, D);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // P^T and dS^T: row key (+ 8), column q0 + 8 j + 2 t (+ 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(di + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = ((e & 1) ? l.y : l.x) * kLog2e;
        const float dd = (e & 1) ? d.y : d.x;
        bool masked = false, past = false;
        if (kCausal || edge) {
          const int kr = key + 8 * (e >> 1);
          past = kr >= a.M;
          masked = kCausal && (kr > q0 + 8 * j + 2 * t + (e & 1) +
                                                q_offset);
        }
        const float p =
            past ? 0.f : tc_p(s[4 * j + e], a.scale_log2, lse2, masked);
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dd) * a.scale;
      }
    }
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    pack_a(p_hi, p_lo, s);
    pack_a(ds_hi, ds_lo, dp);
    reg_fence(dv);
    reg_fence(dk);
    wgmma_fence();
    rs_product<DMAX>(dv, p_hi, dos);
    rs_product<DMAX>(dv, p_lo, dos);
    rs_product<DMAX>(dk, ds_hi, qs);
    rs_product<DMAX>(dk, ds_lo, qs);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dv);
    reg_fence(dk);
  }

  const long long row_stride = static_cast<long long>(a.H) * D;
  const long long off = (static_cast<long long>(b) * a.M + k0) * row_stride +
                        static_cast<long long>(h) * D;
  store_rows<DMAX>(a.dk + off, row_stride, dk, warp * 16, kvalid, D);
  store_rows<DMAX>(a.dv + off, row_stride, dv, warp * 16, kvalid, D);
}

// dq of 128 q rows: grid (q tiles, H, B), key tiles inner.
template <int DMAX, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_tc_kernel(const TcArgs a) {
  using L = BwdTc<DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const L tile = L::carve(smem, a.D);
  const int q0 = blockIdx.x * L::kRes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  const int t = threadIdx.x & 3;
  const int row = q0 + warp * 16 + ((threadIdx.x & 31) >> 2);  // row g
  const int q_offset = kCausal ? a.M - a.N : 0;
  const int D = a.D;

  const int qvalid = min(L::kRes, a.N - q0);
  sw128_load_rows<L::kRes, DMAX, kWgThreads>(
      tile.r0, a.q + b * a.qsb + q0 * a.qsn + h * a.qsh, a.qsn, qvalid, D);
  sw128_load_rows<L::kRes, DMAX, kWgThreads>(
      tile.r1, a.dout + b * a.dsb + q0 * a.dsn + h * a.dsh, a.dsn, qvalid,
      D);
  cp_async_commit();
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.N;
  float lse2[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    lse2[hh] = r < a.N ? a.lse[stat + r] * kLog2e : 0.f;
    dd[hh] = r < a.N ? a.di[stat + r] : 0.f;
  }

  const bf16* kb = a.k + b * a.ksb + h * a.ksh;
  const bf16* vb = a.v + b * a.vsb + h * a.vsh;
  // key tiles wholly above the diagonal: exact to skip when M >= N
  int kv_end = a.M;
  if (kCausal && q_offset >= 0) kv_end = min(a.M, q0 + L::kRes + q_offset);
  const int ntiles = (kv_end + L::kStr - 1) / L::kStr;
  auto issue = [&](int it) {
    const int c0 = it * L::kStr;
    const int valid = min(L::kStr, a.M - c0);
    const int st = it % L::kStages;
    sw128_load_rows<L::kStr, DMAX, kWgThreads>(tile.s0(st), kb + c0 * a.ksn,
                                               a.ksn, valid, D);
    sw128_load_rows<L::kStr, DMAX, kWgThreads>(tile.s1(st), vb + c0 * a.vsn,
                                               a.vsn, valid, D);
    cp_async_commit();
  };

  float dq[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) dq[i] = 0.f;
  const unsigned char* qw = tile.r0 + wg * 64 * 128;
  const unsigned char* dw = tile.r1 + wg * 64 * 128;
  issue(0);
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // tile it (and q, do) landed; tile it - 1's stage free
    if (it + 1 < ntiles) issue(it + 1);
    const int st = it % L::kStages;
    const int c0 = it * L::kStr;
    const unsigned char* ks = tile.s0(st);
    const unsigned char* vs = tile.s1(st);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
    ss_product<DMAX>(s, qw, L::RB, ks, L::SB, D);
    ss_product<DMAX>(dp, dw, L::RB, vs, L::SB, D);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // dS: row (+ 8), key column c0 + 8 j + 2 t (+ 1)
    const bool edge = c0 + L::kStr > a.M;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        bool masked = false, past = false;
        if (kCausal || edge) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          past = col >= a.M;
          masked = kCausal && col > row + 8 * hh + q_offset;
        }
        const float p =
            past ? 0.f : tc_p(s[4 * j + e], a.scale_log2, lse2[hh], masked);
        dp[4 * j + e] = p * (dp[4 * j + e] - dd[hh]) * a.scale;
      }
    uint32_t hi[4][4], lo[4][4];
    pack_a(hi, lo, dp);
    reg_fence(dq);
    wgmma_fence();
    rs_product<DMAX>(dq, hi, ks);
    rs_product<DMAX>(dq, lo, ks);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dq);
  }

  const long long row_stride = static_cast<long long>(a.H) * D;
  store_rows<DMAX>(a.dq + (static_cast<long long>(b) * a.N + q0) *
                              row_stride + static_cast<long long>(h) * D,
                   row_stride, dq, warp * 16, qvalid, D);
}

template <int DMAX, bool kCausal>
cudaError_t launch_tc(const TcArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = BwdTc<DMAX>::smem_bytes;
  constexpr int rows = BwdTc<DMAX>::kRes;
  auto dkv = flash_bwd_dkv_tc_kernel<DMAX, kCausal>;
  auto dqk = flash_bwd_dq_tc_kernel<DMAX, kCausal>;
  cudaError_t err = allow_smem(dkv, smem);
  if (err == cudaSuccess) err = allow_smem(dqk, smem);
  if (err != cudaSuccess) return err;
  dkv<<<dim3((a.M + rows - 1) / rows, a.H, B), kWgThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((a.N + rows - 1) / rows, a.H, B), kWgThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t dispatch_tc(const TcArgs& a, int B, cudaStream_t stream) {
  return a.D <= 64 ? launch_tc<64, kCausal>(a, B, stream)
                   : launch_tc<128, kCausal>(a, B, stream);
}

// -- fp32: split-TF32 tiles on mma.sync ---------------------------------------

struct F32BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;  // (B, H, N)
  const float* di;   // (B, H, N)
  float* dq;
  float* dk;
  float* dv;
  int N, M, H, D;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, dsb, dsn, dsh;
  float scale;
  float scale_log2;  // scale * log2(e)
  bool vec;          // every row 16-byte aligned: 16-byte copies
};

// Both kernels: four warps of 16 resident rows each (dkv: 64 keys of K and
// V; dq: 64 rows of q and do), and a two-stage cp.async ring of streamed
// tiles of BS rows (dkv: q and do with their lse and di; dq: K and V), all
// fp32 at pitch LD. BS is 64 at D <= 64 (two blocks share an SM) and 32 at
// D <= 128.
template <int DMAX>
struct F32Bwd {
  static constexpr int kThreads = 128;
  static constexpr int kRes = 64;
  static constexpr int BS = DMAX <= 64 ? 64 : 32;
  static constexpr int LD = DMAX + 4;
  static constexpr int NT = BS / 8;    // n8 tiles of a streamed tile
  static constexpr int DT = DMAX / 8;  // k8 chunks / n8 tiles of the head
  static constexpr int STAGE = 2 * BS * LD + 2 * BS;  // floats: 2 tiles, stats
  static constexpr size_t smem_bytes =
      (static_cast<size_t>(2 * kRes * LD) + 2 * STAGE) * sizeof(float);
};

// Write a warp's rows g and g + 8 (at row0 + g, skipped at or past
// `valid`) of a (16, D) accumulator as fp32 rows of D.
template <int DT>
__device__ __forceinline__ void f32_store_rows(float* out,
                                               long long row_stride,
                                               const float (&acc)[DT][4],
                                               int row0, int valid, int D) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D)
        Elem<float>::store2(out + r * row_stride + col, acc[j][2 * hh],
                            acc[j][2 * hh + 1]);
    }
  }
}

// dk, dv of 64 keys: grid (key tiles, H, B), q tiles inner. Per q tile a
// warp forms S^T = K q^T and dP^T = V do^T for its 16 keys, P^T and dS^T
// on the accumulator fragments, then dV += P^T do and dK += dS^T q.
template <int DMAX, bool kCausal, bool kFull>
__global__ void __launch_bounds__(F32Bwd<DMAX>::kThreads)
flash_bwd_dkv_f32_kernel(const F32BwdArgs a) {
  using L = F32Bwd<DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + L::kRes * L::LD;
  float* ring = sv + L::kRes * L::LD;  // stage s: q, do, lse, di
  const int k0 = blockIdx.x * L::kRes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x & 3;
  const int key = k0 + warp * 16 + ((threadIdx.x & 31) >> 2);  // row g
  const int q_offset = kCausal ? a.M - a.N : 0;
  const int D = kFull ? DMAX : a.D;  // kFull: D == DMAX, the checks fold

  const int kvalid = min(L::kRes, a.M - k0);
  f32_load_rows<L::kRes, DMAX, L::kThreads>(
      sk, L::LD, a.k + b * a.ksb + k0 * a.ksn + h * a.ksh, a.ksn, kvalid, D,
      a.vec);
  f32_load_rows<L::kRes, DMAX, L::kThreads>(
      sv, L::LD, a.v + b * a.vsb + k0 * a.vsn + h * a.vsh, a.vsn, kvalid, D,
      a.vec);

  const float* qb = a.q + b * a.qsb + h * a.qsh;
  const float* db = a.dout + b * a.dsb + h * a.dsh;
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.N;
  // q tiles wholly above the diagonal see none of these keys; skipping them
  // is exact when every row keeps a key (M >= N)
  int q_begin = 0;
  if (kCausal && q_offset >= 0) q_begin = max(0, k0 - q_offset) / L::BS * L::BS;
  const int ntiles = (a.N - q_begin + L::BS - 1) / L::BS;
  auto issue = [&](int it) {
    const int q0 = q_begin + it * L::BS;
    const int valid = min(L::BS, a.N - q0);
    float* st = ring + (it & 1) * L::STAGE;
    f32_load_rows<L::BS, DMAX, L::kThreads>(st, L::LD, qb + q0 * a.qsn,
                                            a.qsn, valid, D, a.vec);
    f32_load_rows<L::BS, DMAX, L::kThreads>(st + L::BS * L::LD, L::LD,
                                            db + q0 * a.dsn, a.dsn, valid, D,
                                            a.vec);
    if (threadIdx.x < 2 * L::BS) {
      const int r = threadIdx.x % L::BS;
      const float* src = threadIdx.x < L::BS ? a.lse : a.di;
      cp_async4(st + 2 * L::BS * L::LD + threadIdx.x,
                src + stat + q0 + (r < valid ? r : 0), r < valid);
    }
    cp_async_commit();
  };

  float dk[1][L::DT][4], dv[1][L::DT][4];
#pragma unroll
  for (int j = 0; j < L::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[0][j][e] = dv[0][j][e] = 0.f;
  const float* kw = sk + warp * 16 * L::LD;
  const float* vw = sv + warp * 16 * L::LD;
  // keys past M, or a causal diagonal, in this warp's 16 keys
  const bool edge = k0 + warp * 16 + 16 > a.M;
  if (ntiles > 0) issue(0);  // one group with K and V
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and K, V) landed; tile it - 1's stage free
    if (it + 1 < ntiles) issue(it + 1);
    const int q0 = q_begin + it * L::BS;
    const float* qs = ring + (it & 1) * L::STAGE;
    const float* dos = qs + L::BS * L::LD;
    const float* lse = dos + L::BS * L::LD;
    const float* di = lse + L::BS;

    float s[1][L::NT][4], dp[1][L::NT][4];
    scores_3xtf32<1, L::NT, L::DT>(s, kw, qs, L::LD, D);
    scores_3xtf32<1, L::NT, L::DT>(dp, vw, dos, L::LD, D);
    // P^T and dS^T: row key (+ 8), column q0 + 8 j + 2 t (+ 1)
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(di + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = ((e & 1) ? l2.y : l2.x) * kLog2e;
        const float dd = (e & 1) ? d2.y : d2.x;
        bool masked = false, past = false;
        if (kCausal || edge) {
          const int kr = key + 8 * (e >> 1);
          past = kr >= a.M;
          masked = kCausal && (kr > q0 + 8 * j + 2 * t + (e & 1) + q_offset);
        }
        const float p =
            past ? 0.f : tc_p(s[0][j][e], a.scale_log2, lse2, masked);
        s[0][j][e] = p;
        dp[0][j][e] = p * (dp[0][j][e] - dd) * a.scale;
      }
    }
    acc_pv<1, L::NT, L::DT>(dv, s, dos, L::LD, D);
    acc_pv<1, L::NT, L::DT>(dk, dp, qs, L::LD, D);
  }

  const long long row_stride = static_cast<long long>(a.H) * D;
  const long long off = (static_cast<long long>(b) * a.M + k0) * row_stride +
                        static_cast<long long>(h) * D;
  f32_store_rows<L::DT>(a.dk + off, row_stride, dk[0], warp * 16, kvalid, D);
  f32_store_rows<L::DT>(a.dv + off, row_stride, dv[0], warp * 16, kvalid, D);
}

// dq of 64 q rows: grid (q tiles, H, B), key tiles inner. Per key tile a
// warp forms S = q K^T and dP = do V^T for its 16 rows, dS on the
// accumulator fragments, then dQ += dS K.
template <int DMAX, bool kCausal, bool kFull>
__global__ void __launch_bounds__(F32Bwd<DMAX>::kThreads)
flash_bwd_dq_f32_kernel(const F32BwdArgs a) {
  using L = F32Bwd<DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + L::kRes * L::LD;
  float* ring = sdo + L::kRes * L::LD;  // stage s: K, V
  const int q0 = blockIdx.x * L::kRes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x & 3;
  const int row = q0 + warp * 16 + ((threadIdx.x & 31) >> 2);  // row g
  const int q_offset = kCausal ? a.M - a.N : 0;
  const int D = kFull ? DMAX : a.D;  // kFull: D == DMAX, the checks fold

  const int qvalid = min(L::kRes, a.N - q0);
  f32_load_rows<L::kRes, DMAX, L::kThreads>(
      sq, L::LD, a.q + b * a.qsb + q0 * a.qsn + h * a.qsh, a.qsn, qvalid, D,
      a.vec);
  f32_load_rows<L::kRes, DMAX, L::kThreads>(
      sdo, L::LD, a.dout + b * a.dsb + q0 * a.dsn + h * a.dsh, a.dsn, qvalid,
      D, a.vec);
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.N;
  float lse2[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    lse2[hh] = r < a.N ? a.lse[stat + r] * kLog2e : 0.f;
    dd[hh] = r < a.N ? a.di[stat + r] : 0.f;
  }

  const float* kb = a.k + b * a.ksb + h * a.ksh;
  const float* vb = a.v + b * a.vsb + h * a.vsh;
  // key tiles wholly above the diagonal: exact to skip when M >= N
  int kv_end = a.M;
  if (kCausal && q_offset >= 0) kv_end = min(a.M, q0 + L::kRes + q_offset);
  const int ntiles = (kv_end + L::BS - 1) / L::BS;
  auto issue = [&](int it) {
    const int c0 = it * L::BS;
    const int valid = min(L::BS, a.M - c0);
    float* st = ring + (it & 1) * L::STAGE;
    f32_load_rows<L::BS, DMAX, L::kThreads>(st, L::LD, kb + c0 * a.ksn,
                                            a.ksn, valid, D, a.vec);
    f32_load_rows<L::BS, DMAX, L::kThreads>(st + L::BS * L::LD, L::LD,
                                            vb + c0 * a.vsn, a.vsn, valid, D,
                                            a.vec);
    cp_async_commit();
  };

  float dq[1][L::DT][4];
#pragma unroll
  for (int j = 0; j < L::DT; ++j)
    dq[0][j][0] = dq[0][j][1] = dq[0][j][2] = dq[0][j][3] = 0.f;
  const float* qw = sq + warp * 16 * L::LD;
  const float* dw = sdo + warp * 16 * L::LD;
  issue(0);  // one group with q and do
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and q, do) landed; tile it - 1's stage free
    if (it + 1 < ntiles) issue(it + 1);
    const int c0 = it * L::BS;
    const float* ks = ring + (it & 1) * L::STAGE;
    const float* vs = ks + L::BS * L::LD;

    float s[1][L::NT][4], dp[1][L::NT][4];
    scores_3xtf32<1, L::NT, L::DT>(s, qw, ks, L::LD, D);
    scores_3xtf32<1, L::NT, L::DT>(dp, dw, vs, L::LD, D);
    // dS: row (+ 8), key column c0 + 8 j + 2 t (+ 1)
    const bool edge = c0 + L::BS > a.M;
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        bool masked = false, past = false;
        if (kCausal || edge) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          past = col >= a.M;
          masked = kCausal && col > row + 8 * hh + q_offset;
        }
        const float p =
            past ? 0.f : tc_p(s[0][j][e], a.scale_log2, lse2[hh], masked);
        dp[0][j][e] = p * (dp[0][j][e] - dd[hh]) * a.scale;
      }
    acc_pv<1, L::NT, L::DT>(dq, dp, ks, L::LD, D);
  }

  const long long row_stride = static_cast<long long>(a.H) * D;
  f32_store_rows<L::DT>(a.dq + (static_cast<long long>(b) * a.N + q0) *
                                   row_stride + static_cast<long long>(h) * D,
                        row_stride, dq[0], warp * 16, qvalid, D);
}

template <int DMAX, bool kCausal, bool kFull>
cudaError_t launch_f32(const F32BwdArgs& a, int B, cudaStream_t stream) {
  using L = F32Bwd<DMAX>;
  auto dkv = flash_bwd_dkv_f32_kernel<DMAX, kCausal, kFull>;
  auto dqk = flash_bwd_dq_f32_kernel<DMAX, kCausal, kFull>;
  cudaError_t err = allow_smem(dkv, L::smem_bytes);
  if (err == cudaSuccess) err = allow_smem(dqk, L::smem_bytes);
  if (err != cudaSuccess) return err;
  dkv<<<dim3((a.M + L::kRes - 1) / L::kRes, a.H, B), L::kThreads,
        L::smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((a.N + L::kRes - 1) / L::kRes, a.H, B), L::kThreads,
        L::smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The kernels at DMAX, their kFull instances where D == DMAX.
template <bool kCausal>
cudaError_t dispatch_f32(const F32BwdArgs& a, int B, cudaStream_t stream) {
  if (a.D <= 64)
    return a.D == 64 ? launch_f32<64, kCausal, true>(a, B, stream)
                     : launch_f32<64, kCausal, false>(a, B, stream);
  return a.D == 128 ? launch_f32<128, kCausal, true>(a, B, stream)
                    : launch_f32<128, kCausal, false>(a, B, stream);
}

}  // namespace
}  // namespace pandora

// C interface. Strides in elements: {batch, seq, head} of q, k, v and do in
// that order; for bf16 every pointer and stride must give 16-byte aligned
// rows (cp.async). lse and di are contiguous (B, H, N) fp32; dq (B, N, H,
// D), dk and dv (B, M, H, D) are written contiguous. Launches the dkv
// kernel, then the dq kernel, on `stream`; returns cudaGetLastError() (0 on
// success). D must be a multiple of 8 up to 128, else
// cudaErrorInvalidValue.
extern "C" int pandora_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, void* dk, void* dv, int B,
    int N, int M, int H, int D, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long d_sb, long long d_sn,
    long long d_sh, float scale, int causal, int dtype, void* stream) {
  using namespace pandora;
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const TcArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v),
                   static_cast<const bf16*>(dout),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(di), static_cast<bf16*>(dq),
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, M, H,
                   D, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                   d_sb, d_sn, d_sh, scale, scale * kLog2e};
    return static_cast<int>(causal ? dispatch_tc<true>(a, B, s)
                                   : dispatch_tc<false>(a, B, s));
  }
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  const void* const ptrs[4] = {q, k, v, dout};
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                            v_sb, v_sn, v_sh, d_sb, d_sn, d_sh};
  const F32BwdArgs a{static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dout),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(di), static_cast<float*>(dq),
                     static_cast<float*>(dk), static_cast<float*>(dv), N, M,
                     H, D, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn,
                     v_sh, d_sb, d_sn, d_sh, scale, scale * kLog2e,
                     rows_aligned16(ptrs, st, 4)};
  return static_cast<int>(causal ? dispatch_f32<true>(a, B, s)
                                 : dispatch_f32<false>(a, B, s));
}
