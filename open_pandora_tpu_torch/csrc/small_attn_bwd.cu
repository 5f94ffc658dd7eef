// Backward of attention over tiny sequences (N, M <= 32) and a huge
// batch x heads, for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the Pallas kernel `_bwd_kernel` in
// open_pandora_tpu/ops/small_attention.py (reached through `_run_bwd`, the
// custom VJP of `small_attention`): the gradient of the UNet's temporal
// self-attention at t = 16 in training. Same function, all in fp32 after
// the load: recompute p = softmax(q k^T scale), then dv = p^T do,
// dp = do v^T, ds = p (dp - rowsum(dp p)) scale, dq = ds k, dk = ds^T q.
//
// Layout as the forward (small_attn_fwd.cu): q, do (B, N, H, D) and k, v
// (B, M, H, D) read through their batch, sequence and head strides (head
// dim contiguous); dq (B, N, H, D), dk and dv (B, M, H, D) written
// contiguous. One warp owns one (b, h) pair.
//
// What bounds it on the card: reading q, k, v, do and writing dq, dk, dv
// once; five tiny products per pair take a tenth of that time or less on
// the tensor cores (bf16; fp32 as split TF32). So:
// - bf16, D % 8 == 0, 16-byte aligned rows (`small_attn_bwd_tc_kernel`,
//   the main path): the warp copies q, do, k and v with 16-byte cp.async
//   pieces (rows past N or M zero-filled) into bf16 shared memory at a
//   pitch of 16 ceil(D / 16) + 8 elements (`ldmatrix` without bank
//   conflicts). Per 16 query rows, S = q k^T and dP = do v^T are mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate, exact products); p (softmax on the
//   fragments: quad shuffles, exp2 with scale log2 e folded in, one
//   reciprocal per row, 0 for a key at or past M), rowsum(dp p) and ds stay
//   fp32 and go to a few hundred bytes of shared memory as bf16 hi =
//   bf16(x) and lo = bf16(x - hi) parts: the TPU kernel never rounds p or
//   ds, so every product that takes them runs once per part. Then dv =
//   p^T do, dq = ds k and dk = ds^T q, each from `ldmatrix` (`.trans` for
//   the transposed operands), each staged as bf16 in a slot its inputs no
//   longer need (dv in v's, dq in do's, dk in k's) and written in 16-byte
//   pieces. Rows at or past N are computed on zeros: their do is zero, so
//   they add nothing to dk or dv, and they are never stored.
// - fp32, every shape (`small_attn_bwd_f32_kernel`: the fp32 training
//   step, the narrow model): the same phases in split TF32 (common.cuh).
//   q, do, k and v go to fp32 shared memory by cp.async (16-byte pieces
//   where D % 4 == 0 and every pointer and stride gives 16-byte rows, else
//   4-byte ones; rows past N or M and the k8 tail zero-filled) at a pitch
//   of 8 ceil(D / 8) + 4 floats; every product is three TF32 mma.sync
//   m16n8k8 products of split operands accumulated in fp32 in two chains
//   (the big term hi hi alone, as in the forward), S and dP over at most
//   64 values of D a chain. p and ds stay fp32: they go
//   to shared memory transposed (keys as rows, at a pitch of 8 mod 16
//   floats) and enter dv = p^T do, dq = ds k and dk = ds^T q as A
//   fragments read in the k-slot order that `ldb_kmajor` reads B in
//   (`lda_pairs`, `lda_trans_pairs`), split like any operand; the outputs
//   are staged in fp32 as in bf16 and leave in 16-byte pieces where
//   aligned. About 20 KB per warp at N = M = 16 and D = 64, 78 KB at
//   N = M = 32 and D = 128; the warps a block follow that size
//   (`warps_per_block`).
// - bf16 with D % 8 != 0 or rows off 16-byte alignment
//   (`small_attn_bwd_kernel`, chosen by shape in the launcher): fp32
//   shared memory at an odd pitch, lane n computes row n of p, dp and ds,
//   the lanes run across D for the three products.
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 4;
constexpr int kMaxSeq = 32;
constexpr size_t kSmemLimit = 227 * 1024;

__host__ __device__ size_t warp_floats(int N, int M, int D) {
  return static_cast<size_t>(2 * N + 2 * M) * (D + 1) +
         static_cast<size_t>(2 * N) * (M + 1);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
small_attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout, bf16* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int BH,
                      int H, int N, int M, int D,
                      long long qsb, long long qsn, long long qsh,
                      long long ksb, long long ksn, long long ksh,
                      long long vsb, long long vsn, long long vsh,
                      long long dsb, long long dsn, long long dsh,
                      float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ld = D + 1;  // odd pitch: lanes reading different rows hit
                         // different banks
  const int ldp = M + 1;
  float* sQ = smem + warp * warp_floats(N, M, D);
  float* sG = sQ + N * ld;   // do
  float* sK = sG + N * ld;
  float* sV = sK + M * ld;
  float* sP = sV + M * ld;
  float* sS = sP + N * ldp;  // ds

  const int bh = blockIdx.x * (blockDim.x / 32) + warp;
  if (bh >= BH) return;  // warps only synchronise among their own lanes
  const int b = bh / H;
  const int h = bh - b * H;

  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* gp = dout + b * dsb + h * dsh;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
  for (int n = 0; n < N; ++n)
    for (int d = lane; d < D; d += 32) {
      sQ[n * ld + d] = Elem<bf16>::to_float(qp[n * qsn + d]);
      sG[n * ld + d] = Elem<bf16>::to_float(gp[n * dsn + d]);
    }
  for (int m = 0; m < M; ++m)
    for (int d = lane; d < D; d += 32) {
      sK[m * ld + d] = Elem<bf16>::to_float(kp[m * ksn + d]);
      sV[m * ld + d] = Elem<bf16>::to_float(vp[m * vsn + d]);
    }
  __syncwarp();

  // lane n: row n of p (softmax of the scaled scores), dp and ds
  if (lane < N) {
    float p[kMaxSeq];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSeq; ++j) {
      if (j < M) {
        float acc = 0.f;
        for (int d = 0; d < D; ++d)
          acc = fmaf(sQ[lane * ld + d], sK[j * ld + d], acc);
        p[j] = acc * scale;
        mx = fmaxf(mx, p[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSeq; ++j) {
      if (j < M) {
        p[j] = expf(p[j] - mx);
        sum += p[j];
      }
    }
    float dp[kMaxSeq];
    float rs = 0.f;  // rowsum(dp * p)
#pragma unroll
    for (int j = 0; j < kMaxSeq; ++j) {
      if (j < M) {
        p[j] = p[j] / sum;
        float acc = 0.f;
        for (int d = 0; d < D; ++d)
          acc = fmaf(sG[lane * ld + d], sV[j * ld + d], acc);
        dp[j] = acc;
        rs = fmaf(acc, p[j], rs);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxSeq; ++j) {
      if (j < M) {
        sP[lane * ldp + j] = p[j];
        sS[lane * ldp + j] = p[j] * (dp[j] - rs) * scale;
      }
    }
  }
  __syncwarp();

  // lanes across d: dq = ds k, then dk = ds^T q and dv = p^T do
  const long long osn = static_cast<long long>(H) * D;
  bf16* dqp = dq + (static_cast<long long>(b) * N * H + h) * D;
  for (int n = 0; n < N; ++n)
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < M; ++j) acc = fmaf(sS[n * ldp + j], sK[j * ld + d], acc);
      dqp[n * osn + d] = Elem<bf16>::from_float(acc);
    }
  bf16* dkp = dk + (static_cast<long long>(b) * M * H + h) * D;
  bf16* dvp = dv + (static_cast<long long>(b) * M * H + h) * D;
  for (int m = 0; m < M; ++m)
    for (int d = lane; d < D; d += 32) {
      float ak = 0.f, av = 0.f;
      for (int n = 0; n < N; ++n) {
        ak = fmaf(sS[n * ldp + m], sQ[n * ld + d], ak);
        av = fmaf(sP[n * ldp + m], sG[n * ld + d], av);
      }
      dkp[m * osn + d] = Elem<bf16>::from_float(ak);
      dvp[m * osn + d] = Elem<bf16>::from_float(av);
    }
}

// Bytes of shared memory per warp of the tensor-core kernel: q and do (NP
// rows), k and v (MP rows) as warp tiles, and the hi and lo parts of p and
// ds, (NP, MP + 8) each; NP and MP the lengths rounded up to 16.
size_t tc_warp_bytes(int N, int M, int D) {
  const int NP = (N + 15) / 16 * 16, MP = (M + 15) / 16 * 16;
  return (static_cast<size_t>(2 * NP + 2 * MP) * warp_tile_ld((D + 15) / 16) +
          static_cast<size_t>(4 * NP) * (MP + 8)) *
         sizeof(bf16);
}

// One warp per (b, h) pair, KT = ceil(D / 16); bf16, D % 8 == 0, rows
// 16-byte aligned.
template <int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
small_attn_bwd_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout, bf16* __restrict__ dq,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int BH,
                         int H, int N, int M, int D, long long qsb,
                         long long qsn, long long qsh, long long ksb,
                         long long ksn, long long ksh, long long vsb,
                         long long vsn, long long vsh, long long dsb,
                         long long dsn, long long dsh, float scale,
                         float scale_log2) {
  constexpr int LD = warp_tile_ld(KT);
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int NP = (N + 15) & ~15, MP = (M + 15) & ~15;
  const int LP = MP + 8;  // pitch of the p and ds parts
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem) +
             warp * ((2 * NP + 2 * MP) * LD + 4 * NP * LP);
  bf16* sG = sQ + NP * LD;  // do
  bf16* sK = sG + NP * LD;
  bf16* sV = sK + MP * LD;
  bf16* sPh = sV + MP * LD;
  bf16* sPl = sPh + NP * LP;
  bf16* sSh = sPl + NP * LP;  // ds
  bf16* sSl = sSh + NP * LP;

  const int bh = blockIdx.x * (blockDim.x / 32) + warp;
  if (bh >= BH) return;  // warps only synchronise among their own lanes
  const int b = bh / H;
  const int h = bh - b * H;
  warp_load_rows16(sQ, LD, q + b * qsb + h * qsh, qsn, N, NP, D, lane);
  warp_load_rows16(sG, LD, dout + b * dsb + h * dsh, dsn, N, NP, D, lane);
  warp_load_rows16(sK, LD, k + b * ksb + h * ksh, ksn, M, MP, D, lane);
  warp_load_rows16(sV, LD, v + b * vsb + h * vsh, vsn, M, MP, D, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  // per 16 query rows: p, dp, rowsum(dp p) and ds in fp32 on the fragments
  // (e = 0, 1 row g, e = 2, 3 row g + 8; key 8 j + 2 t + (e & 1)); their
  // hi and lo parts to shared memory
  for (int r0 = 0; r0 < NP; r0 += 16) {
    float p[4][4], dp[4][4];
    warp_scores<KT>(p, sQ + r0 * LD, sK, MP, lane);
    warp_scores<KT>(dp, sG + r0 * LD, sV, MP, lane);
    warp_softmax(p, M, scale_log2, lane);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e >> 1] = fmaf(dp[j][e], p[j][e], rs[e >> 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (8 * j >= MP) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float p0 = p[j][2 * hh], p1 = p[j][2 * hh + 1];
        const float d0 = p0 * (dp[j][2 * hh] - rs[hh]) * scale;
        const float d1 = p1 * (dp[j][2 * hh + 1] - rs[hh]) * scale;
        const int at = (r0 + g + 8 * hh) * LP + 8 * j + 2 * t;
        uint32_t hi, lo;
        split_bf16(hi, lo, p0, p1);
        *reinterpret_cast<uint32_t*>(sPh + at) = hi;
        *reinterpret_cast<uint32_t*>(sPl + at) = lo;
        split_bf16(hi, lo, d0, d1);
        *reinterpret_cast<uint32_t*>(sSh + at) = hi;
        *reinterpret_cast<uint32_t*>(sSl + at) = lo;
      }
    }
  }
  __syncwarp();

  const long long osn = static_cast<long long>(H) * D;
  float acc[2 * KT][4];
  // the A fragment of part^T (part: queries x keys) for keys m0.. as the
  // m16 rows and queries kq.. as the k16 columns
  auto at_frag = [&](uint32_t(&r)[4], const bf16* part, int kq, int m0) {
    ldsm_x4<true>(r, part + (kq + ((lane >> 4) & 1) * 8 + (lane & 7)) * LP +
                         m0 + ((lane >> 3) & 1) * 8);
  };

  // dv = p^T do, staged in v's rows
  for (int m0 = 0; m0 < MP; m0 += 16) {
    zero_acc<KT>(acc);
    for (int kq = 0; kq < NP; kq += 16) {
      uint32_t hi[4], lo[4];
      at_frag(hi, sPh, kq, m0);
      at_frag(lo, sPl, kq, m0);
      warp_mma_split<KT>(acc, hi, lo, sG + kq * LD, lane);
    }
    warp_stage<KT>(sV + m0 * LD, acc, lane);
  }
  __syncwarp();
  warp_store_rows16(dv + (static_cast<long long>(b) * M * H + h) * D, osn,
                    sV, LD, M, D, lane);

  // dq = ds k, staged in do's rows
  for (int r0 = 0; r0 < NP; r0 += 16) {
    zero_acc<KT>(acc);
    for (int kk = 0; kk < MP; kk += 16) {
      uint32_t hi[4], lo[4];
      const int at = (r0 + (lane & 15)) * LP + kk + (lane >> 4) * 8;
      ldsm_x4(hi, sSh + at);
      ldsm_x4(lo, sSl + at);
      warp_mma_split<KT>(acc, hi, lo, sK + kk * LD, lane);
    }
    warp_stage<KT>(sG + r0 * LD, acc, lane);
  }
  __syncwarp();
  warp_store_rows16(dq + (static_cast<long long>(b) * N * H + h) * D, osn,
                    sG, LD, N, D, lane);

  // dk = ds^T q, staged in k's rows
  for (int m0 = 0; m0 < MP; m0 += 16) {
    zero_acc<KT>(acc);
    for (int kq = 0; kq < NP; kq += 16) {
      uint32_t hi[4], lo[4];
      at_frag(hi, sSh, kq, m0);
      at_frag(lo, sSl, kq, m0);
      warp_mma_split<KT>(acc, hi, lo, sQ + kq * LD, lane);
    }
    warp_stage<KT>(sK + m0 * LD, acc, lane);
  }
  __syncwarp();
  warp_store_rows16(dk + (static_cast<long long>(b) * M * H + h) * D, osn,
                    sK, LD, M, D, lane);
}

// Floats of shared memory per warp of the fp32 kernel: q and do (NP rows),
// k and v (MP rows) at pitch f32_tile_ld(D), then p^T and ds^T (MP rows at
// pitch NP + 8); NP and MP the lengths rounded up to 16.
__host__ __device__ size_t f32_warp_floats(int N, int M, int D) {
  const int NP = (N + 15) / 16 * 16, MP = (M + 15) / 16 * 16;
  return static_cast<size_t>(2 * NP + 2 * MP) * f32_tile_ld(D) +
         static_cast<size_t>(2 * MP) * (NP + 8);
}

// fp32, D <= DMAX (32, 64 or 128; arrays sized by DMAX, loops cut at D):
// one warp per (b, h) pair, split TF32. vec_in: q, k, v and do rows
// 16-byte aligned and D % 4 == 0; vec_out: the same of dq, dk and dv.
template <int DMAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
small_attn_bwd_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, int BH, int H, int N, int M,
                          int D, long long qsb, long long qsn, long long qsh,
                          long long ksb, long long ksn, long long ksh,
                          long long vsb, long long vsn, long long vsh,
                          long long dsb, long long dsn, long long dsh,
                          float scale, float scale_log2, bool vec_in,
                          bool vec_out) {
  constexpr int DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int NP = (N + 15) & ~15, MP = (M + 15) & ~15;
  const int LD = f32_tile_ld(D);
  const int LP = NP + 8;  // pitch of p^T and ds^T
  float* sQ = reinterpret_cast<float*>(f32_smem) +
              warp * f32_warp_floats(N, M, D);
  float* sG = sQ + NP * LD;  // do
  float* sK = sG + NP * LD;
  float* sV = sK + MP * LD;
  float* sPT = sV + MP * LD;
  float* sST = sPT + MP * LP;  // ds^T

  const int bh = blockIdx.x * (blockDim.x / 32) + warp;
  if (bh >= BH) return;  // warps only synchronise among their own lanes
  const int b = bh / H;
  const int h = bh - b * H;
  warp_load_rows_f32(sQ, LD, q + b * qsb + h * qsh, qsn, N, NP, D, vec_in,
                     lane);
  warp_load_rows_f32(sG, LD, dout + b * dsb + h * dsh, dsn, N, NP, D, vec_in,
                     lane);
  warp_load_rows_f32(sK, LD, k + b * ksb + h * ksh, ksn, M, MP, D, vec_in,
                     lane);
  warp_load_rows_f32(sV, LD, v + b * vsb + h * vsh, vsn, M, MP, D, vec_in,
                     lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  // per 16 query rows: p, dp, rowsum(dp p) and ds in fp32 on the fragments
  // (e = 0, 1 row g, e = 2, 3 row g + 8; key 8 j + 2 t + (e & 1)), then p
  // and ds transposed to shared memory
  for (int r0 = 0; r0 < NP; r0 += 16) {
    float p[4][4], dp[4][4];
    warp_scores_f32<DT>(p, sQ + r0 * LD, sK, LD, MP, D);
    warp_scores_f32<DT>(dp, sG + r0 * LD, sV, LD, MP, D);
    warp_softmax(p, M, scale_log2, lane);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e >> 1] = fmaf(dp[j][e], p[j][e], rs[e >> 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (8 * j >= MP) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = p[j][e];
        const int at = (8 * j + 2 * t + (e & 1)) * LP + r0 + g + 8 * (e >> 1);
        sPT[at] = pe;
        sST[at] = pe * (dp[j][e] - rs[e >> 1]) * scale;
      }
    }
  }
  __syncwarp();

  const long long osn = static_cast<long long>(H) * D;
  // dv = p^T do, staged in v's rows
  for (int m0 = 0; m0 < MP; m0 += 16)
    warp_product_f32<DT>(
        sV + m0 * LD, LD,
        [&](int kc) { return lda_pairs(sPT + m0 * LP + kc * 8, LP); }, sG,
        LD, NP, D);
  __syncwarp();
  warp_store_rows_f32(dv + (static_cast<long long>(b) * M * H + h) * D, osn,
                      sV, LD, M, D, vec_out, lane);

  // dq = ds k, staged in do's rows
  for (int r0 = 0; r0 < NP; r0 += 16)
    warp_product_f32<DT>(
        sG + r0 * LD, LD,
        [&](int kc) { return lda_trans_pairs(sST + kc * 8 * LP + r0, LP); },
        sK, LD, MP, D);
  __syncwarp();
  warp_store_rows_f32(dq + (static_cast<long long>(b) * N * H + h) * D, osn,
                      sG, LD, N, D, vec_out, lane);

  // dk = ds^T q, staged in k's rows
  for (int m0 = 0; m0 < MP; m0 += 16)
    warp_product_f32<DT>(
        sK + m0 * LD, LD,
        [&](int kc) { return lda_pairs(sST + m0 * LP + kc * 8, LP); }, sQ,
        LD, NP, D);
  __syncwarp();
  warp_store_rows_f32(dk + (static_cast<long long>(b) * M * H + h) * D, osn,
                      sK, LD, M, D, vec_out, lane);
}

cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          const void* dout, void* dq, void* dk, void* dv,
                          int B, int N, int M, int H, int D,
                          const long long* st, float scale,
                          cudaStream_t stream) {
  const int BH = B * H;
  const size_t per_warp = warp_floats(N, M, D) * sizeof(float);
  const int warps = static_cast<int>(
      kSmemLimit / per_warp < kMaxWarps ? kSmemLimit / per_warp : kMaxWarps);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  auto kernel = small_attn_bwd_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (BH + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      BH, H, N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv, int B,
                       int N, int M, int H, int D, const long long* st,
                       float scale, bool vec_in, bool vec_out,
                       cudaStream_t stream) {
  const int BH = B * H;
  const size_t per_warp = f32_warp_floats(N, M, D) * sizeof(float);
  const int warps = warps_per_block(per_warp, kMaxWarps);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  cudaError_t err = allow_smem_once<&small_attn_bwd_f32_kernel<DMAX>>();
  if (err != cudaSuccess) return err;
  const int blocks = (BH + warps - 1) / warps;
  small_attn_bwd_f32_kernel<DMAX><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), BH, H, N, M, D, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      scale * 1.4426950408889634f, vec_in, vec_out);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, void* dq, void* dk, void* dv, int B,
                      int N, int M, int H, int D, const long long* st,
                      float scale, cudaStream_t stream) {
  const int BH = B * H;
  const size_t per_warp = tc_warp_bytes(N, M, D);
  const int warps = static_cast<int>(
      kSmemLimit / per_warp < kMaxWarps ? kSmemLimit / per_warp : kMaxWarps);
  const size_t smem = warps * per_warp;
  auto kernel = small_attn_bwd_tc_kernel<KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (BH + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      BH, H, N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pandora

// C interface; strides in elements, {batch, seq, head} of q, k, v and do in
// that order. N, M <= 32 and D <= 128, else cudaErrorInvalidValue. fp32
// runs the split-TF32 kernel at every shape; bf16 with D % 8 == 0 and
// 16-byte aligned rows the tensor-core kernel, any other bf16 shape the
// scalar one.
extern "C" int pandora_small_attn_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int B, int N, int M, int H, int D, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long d_sb, long long d_sn, long long d_sh, float scale, int dtype,
    void* stream) {
  using namespace pandora;
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || N > kMaxSeq ||
      M > kMaxSeq || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                            v_sb, v_sn, v_sh, d_sb, d_sn, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const ptrs[7] = {q, k, v, dout, dq, dk, dv};
  cudaError_t err;
  if (dtype == kBFloat16 && D % 8 == 0 && rows_aligned16(ptrs, st)) {
    switch ((D + 15) / 16) {
#define PANDORA_SMALL_BWD_TC(KT)                                         \
  case KT:                                                               \
    err = launch_tc<KT>(q, k, v, dout, dq, dk, dv, B, N, M, H, D, st,    \
                        scale, s);                                       \
    break;
      PANDORA_SMALL_BWD_TC(1)
      PANDORA_SMALL_BWD_TC(2)
      PANDORA_SMALL_BWD_TC(3)
      PANDORA_SMALL_BWD_TC(4)
      PANDORA_SMALL_BWD_TC(5)
      PANDORA_SMALL_BWD_TC(6)
      PANDORA_SMALL_BWD_TC(7)
      PANDORA_SMALL_BWD_TC(8)
#undef PANDORA_SMALL_BWD_TC
      default:
        err = cudaErrorInvalidValue;
    }
  } else if (dtype == kFloat32) {
    const void* const in[4] = {q, k, v, dout};
    const void* const out[3] = {dq, dk, dv};
    const long long none[1] = {0};
    const bool vec_in = D % 4 == 0 && rows_aligned16(in, st, 4);
    const bool vec_out = D % 4 == 0 && rows_aligned16(out, none, 4);
    err = D <= 32   ? launch_f32<32>(q, k, v, dout, dq, dk, dv, B, N, M, H,
                                     D, st, scale, vec_in, vec_out, s)
          : D <= 64 ? launch_f32<64>(q, k, v, dout, dq, dk, dv, B, N, M, H,
                                     D, st, scale, vec_in, vec_out, s)
                    : launch_f32<128>(q, k, v, dout, dq, dk, dv, B, N, M, H,
                                      D, st, scale, vec_in, vec_out, s);
  } else if (dtype == kBFloat16) {
    err = launch_scalar(q, k, v, dout, dq, dk, dv, B, N, M, H, D, st, scale,
                        s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
