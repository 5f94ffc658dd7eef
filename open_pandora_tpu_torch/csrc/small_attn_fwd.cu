// Attention over tiny sequences (N, M <= 32) and a huge batch x heads, for
// Hopper (sm_90a), bf16 and fp32.
//
// Replaces the Pallas kernel `_fwd_kernel` in
// open_pandora_tpu/ops/small_attention.py (reached through `_run_fwd` and
// `small_attention`): the UNet's temporal self-attention at t = 16, run over
// every spatial position of every frame stack (B = b*h*w up to 5120 rows,
// 5 to 20 heads). Math in fp32 after the load: s = q k^T, p = softmax(s
// scale), normalised, then o = p v with p in fp32.
//
// Layout: q (B, N, H, D), k and v (B, M, H, D), read through their batch,
// sequence and head strides (the head dim is contiguous); o contiguous
// (B, N, H, D). The TPU version transposes everything to (N, D, H*B) so the
// batch fills its 128-lane vregs; here one warp owns one (b, h) pair.
//
// What bounds it on the card: reading q, k, v and writing o once. The
// arithmetic, 4 N M D per pair, takes a tenth of the memory time or less
// on the tensor cores (bf16; fp32 as split TF32, at a third of the TF32
// rate). So the design is about bytes in flight and instructions per
// byte:
// - bf16, D % 8 == 0, 16-byte aligned rows (`small_attn_fwd_tc_kernel`,
//   the main path): the warp copies its q, k and v with 16-byte cp.async
//   pieces (eight lanes per 128-byte row at D = 64; rows past N or M
//   zero-filled) into bf16 shared memory at a pitch of 16 ceil(D / 16) + 8
//   elements, so `ldmatrix` is free of bank conflicts, about 7 KB per warp
//   at N = M = 16 and D = 64. Per 16 query rows, S = q k^T is mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate: exact products); the softmax runs
//   on the accumulator fragments (quad shuffles for the row max and sum,
//   exp2 with scale log2 e folded in, one reciprocal per row; a key at or
//   past M weighs exactly 0); p, never rounded as a whole, enters o = p v
//   straight from those fragments as two bf16 A operands, hi = bf16(p) and
//   lo = bf16(p - hi), v as B through `ldmatrix.trans`. o is staged as
//   bf16 in the rows of q it replaces and leaves in 16-byte pieces.
// - fp32, every shape (`small_attn_fwd_f32_kernel`: the fp32 training
//   step, an fp32 clip, the narrow model): the same warp-owned structure in
//   split TF32 (common.cuh). q, k and v go to fp32 shared memory by
//   cp.async, 16-byte pieces where D % 4 == 0 and every pointer and stride
//   gives 16-byte rows, else 4-byte ones (rows past N or M and the k8 tail
//   past D zero-filled by the copy), at a pitch of 8 ceil(D / 8) + 4
//   floats, so every fragment load is free of bank conflicts: about 13 KB
//   per warp at N = M = 16 and D = 64, the warps a block chosen by that
//   size (`warps_per_block`). Per 16 query rows, S = q k^T is three TF32
//   mma.sync m16n8k8 products of split operands (hi = x rounded to TF32,
//   lo = x - hi rounded), accumulated in fp32: the big term hi hi in a
//   chain of its own, the two small terms in another, each chain over at
//   most 64 values of D, the chains added on the CUDA cores (the tensor
//   core truncates its sum at every mma.sync, so fewer truncations in the
//   big chain keep o within 8 times the fp32 plain version's distance from
//   float64); the bf16 kernel's softmax on the fragments;
//   p stays fp32 and enters o = p v from the accumulator fragments
//   (`acc_a`, v's rows read in the same k-slot order), split like any
//   operand. o is staged in fp32 in the rows of q it replaces and leaves
//   in 16-byte pieces where aligned.
// - bf16 with D % 8 != 0 or rows off 16-byte alignment
//   (`small_attn_fwd_kernel`, chosen by shape in the launcher): fp32
//   shared memory at an odd pitch, lane n computes score row n and its
//   softmax, the lanes run across D for the product with v.
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kMaxSeq = 32;

__global__ void __launch_bounds__(kWarps * 32)
small_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int BH,
                      int H, int N, int M, int D, long long qsb,
                      long long qsn, long long qsh, long long ksb,
                      long long ksn, long long ksh, long long vsb,
                      long long vsn, long long vsh, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ld = D + 1;  // odd pitch: lanes reading different rows hit
                         // different banks
  const int ldp = M + 1;
  const int per_warp = (N + 2 * M) * ld + N * ldp;
  float* sQ = smem + warp * per_warp;
  float* sK = sQ + N * ld;
  float* sV = sK + M * ld;
  float* sP = sV + M * ld;

  const int bh = blockIdx.x * kWarps + warp;
  if (bh >= BH) return;  // warps only synchronise among their own lanes
  const int b = bh / H;
  const int h = bh - b * H;

  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
  for (int n = 0; n < N; ++n)
    for (int d = lane; d < D; d += 32)
      sQ[n * ld + d] = Elem<bf16>::to_float(qp[n * qsn + d]);
  for (int m = 0; m < M; ++m)
    for (int d = lane; d < D; d += 32) {
      sK[m * ld + d] = Elem<bf16>::to_float(kp[m * ksn + d]);
      sV[m * ld + d] = Elem<bf16>::to_float(vp[m * vsn + d]);
    }
  __syncwarp();

  // lane i computes row i of the scores and its softmax
  if (lane < N) {
    float s[kMaxSeq];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSeq; ++j) {
      if (j < M) {
        float acc = 0.f;
        for (int d = 0; d < D; ++d)
          acc = fmaf(sQ[lane * ld + d], sK[j * ld + d], acc);
        s[j] = acc * scale;
        mx = fmaxf(mx, s[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSeq; ++j) {
      if (j < M) {
        s[j] = expf(s[j] - mx);
        sum += s[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxSeq; ++j)
      if (j < M) sP[lane * ldp + j] = s[j] / sum;
  }
  __syncwarp();

  // o[n, d] = sum_j p[n, j] v[j, d], lanes across d
  bf16* op = o + (static_cast<long long>(b) * N * H + h) * D;
  const long long osn = static_cast<long long>(H) * D;
  for (int n = 0; n < N; ++n)
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < M; ++j) acc = fmaf(sP[n * ldp + j], sV[j * ld + d], acc);
      op[n * osn + d] = Elem<bf16>::from_float(acc);
    }
}

// Bytes of shared memory per warp of the tensor-core kernel: q (NP rows),
// k and v (MP rows each), NP and MP the lengths rounded up to 16.
size_t tc_warp_bytes(int N, int M, int D) {
  const int NP = (N + 15) / 16 * 16, MP = (M + 15) / 16 * 16;
  return static_cast<size_t>(NP + 2 * MP) * warp_tile_ld((D + 15) / 16) *
         sizeof(bf16);
}

// One warp per (b, h) pair, KT = ceil(D / 16); bf16, D % 8 == 0, rows
// 16-byte aligned.
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
small_attn_fwd_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int BH, int H, int N, int M, int D, long long qsb,
                         long long qsn, long long qsh, long long ksb,
                         long long ksn, long long ksh, long long vsb,
                         long long vsn, long long vsh, float scale_log2) {
  constexpr int LD = warp_tile_ld(KT);
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int NP = (N + 15) & ~15, MP = (M + 15) & ~15;
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem) + warp * (NP + 2 * MP) * LD;
  bf16* sK = sQ + NP * LD;
  bf16* sV = sK + MP * LD;

  const int bh = blockIdx.x * kWarps + warp;
  if (bh >= BH) return;  // warps only synchronise among their own lanes
  const int b = bh / H;
  const int h = bh - b * H;
  warp_load_rows16(sQ, LD, q + b * qsb + h * qsh, qsn, N, NP, D, lane);
  warp_load_rows16(sK, LD, k + b * ksb + h * ksh, ksn, M, MP, D, lane);
  warp_load_rows16(sV, LD, v + b * vsb + h * vsh, vsn, M, MP, D, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  for (int r0 = 0; r0 < NP; r0 += 16) {
    float p[4][4];
    warp_scores<KT>(p, sQ + r0 * LD, sK, MP, lane);
    warp_softmax(p, M, scale_log2, lane);
    // o = p v: the p fragments of key tiles 2 kk and 2 kk + 1 are the A
    // fragment of k16 step kk, split into hi and lo
    float acc[2 * KT][4];
    zero_acc<KT>(acc);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (kk * 16 >= MP) break;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float* pj = p[2 * kk + (w >> 1)];
        split_bf16(hi[w], lo[w], pj[2 * (w & 1)], pj[2 * (w & 1) + 1]);
      }
      warp_mma_split<KT>(acc, hi, lo, sV + kk * 16 * LD, lane);
    }
    __syncwarp();  // o replaces the rows of q this tile has read
    warp_stage<KT>(sQ + r0 * LD, acc, lane);
  }
  __syncwarp();
  warp_store_rows16(o + (static_cast<long long>(b) * N * H + h) * D,
                    static_cast<long long>(H) * D, sQ, LD, N, D, lane);
}

// fp32, D <= DMAX (32, 64 or 128; arrays sized by DMAX, loops cut at D):
// one warp per (b, h) pair, split TF32. vec_in: q, k and v rows 16-byte
// aligned and D % 4 == 0; vec_out: the same of o.
template <int DMAX>
__global__ void __launch_bounds__(kWarps * 32)
small_attn_fwd_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int BH, int H, int N, int M, int D, long long qsb,
                          long long qsn, long long qsh, long long ksb,
                          long long ksn, long long ksh, long long vsb,
                          long long vsn, long long vsh, float scale_log2,
                          bool vec_in, bool vec_out) {
  constexpr int DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int NP = (N + 15) & ~15, MP = (M + 15) & ~15;
  const int LD = f32_tile_ld(D);
  float* sQ = reinterpret_cast<float*>(f32_smem) + warp * (NP + 2 * MP) * LD;
  float* sK = sQ + NP * LD;
  float* sV = sK + MP * LD;

  const int bh = blockIdx.x * (blockDim.x / 32) + warp;
  if (bh >= BH) return;  // warps only synchronise among their own lanes
  const int b = bh / H;
  const int h = bh - b * H;
  warp_load_rows_f32(sQ, LD, q + b * qsb + h * qsh, qsn, N, NP, D, vec_in,
                     lane);
  warp_load_rows_f32(sK, LD, k + b * ksb + h * ksh, ksn, M, MP, D, vec_in,
                     lane);
  warp_load_rows_f32(sV, LD, v + b * vsb + h * vsh, vsn, M, MP, D, vec_in,
                     lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  for (int r0 = 0; r0 < NP; r0 += 16) {
    float p[4][4];
    warp_scores_f32<DT>(p, sQ + r0 * LD, sK, LD, MP, D);
    warp_softmax(p, M, scale_log2, lane);
    __syncwarp();  // o replaces the rows of q this tile has read
    // o = p v: the p fragments of key tile kc are the A fragment of k8
    // step kc
    warp_product_f32<DT>(sQ + r0 * LD, LD,
                         [&](int kc) { return acc_a(p[kc]); }, sV, LD, MP,
                         D);
  }
  __syncwarp();
  warp_store_rows_f32(o + (static_cast<long long>(b) * N * H + h) * D,
                      static_cast<long long>(H) * D, sQ, LD, N, D, vec_out,
                      lane);
}

cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          void* o, int B, int N, int M, int H, int D,
                          const long long* st, float scale,
                          cudaStream_t stream) {
  const int BH = B * H;
  const size_t smem = static_cast<size_t>(kWarps) *
                      ((N + 2 * M) * (D + 1) + N * (M + 1)) * sizeof(float);
  auto kernel = small_attn_fwd_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (BH + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), BH, H, N, M, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int N, int M, int H, int D, const long long* st,
                       float scale, bool vec_in, bool vec_out,
                       cudaStream_t stream) {
  const int BH = B * H;
  const int NP = (N + 15) / 16 * 16, MP = (M + 15) / 16 * 16;
  const size_t per_warp =
      static_cast<size_t>(NP + 2 * MP) * f32_tile_ld(D) * sizeof(float);
  const int warps = warps_per_block(per_warp, kWarps);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  cudaError_t err = allow_smem_once<&small_attn_fwd_f32_kernel<DMAX>>();
  if (err != cudaSuccess) return err;
  const int blocks = (BH + warps - 1) / warps;
  small_attn_fwd_f32_kernel<DMAX><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, H, N, M, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f, vec_in, vec_out);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int N, int M, int H, int D, const long long* st,
                      float scale, cudaStream_t stream) {
  const int BH = B * H;
  const size_t smem = kWarps * tc_warp_bytes(N, M, D);
  auto kernel = small_attn_fwd_tc_kernel<KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (BH + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), BH, H, N, M, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pandora

// C interface; strides in elements as in pandora_flash_fwd. N, M <= 32 and
// D <= 128, else cudaErrorInvalidValue. fp32 runs the split-TF32 kernel at
// every shape; bf16 with D % 8 == 0 and 16-byte aligned rows the
// tensor-core kernel, any other bf16 shape the scalar one.
extern "C" int pandora_small_attn_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int N,
                                      int M, int H, int D, long long q_sb,
                                      long long q_sn, long long q_sh,
                                      long long k_sb, long long k_sn,
                                      long long k_sh, long long v_sb,
                                      long long v_sn, long long v_sh,
                                      float scale, int dtype, void* stream) {
  using namespace pandora;
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || N > kMaxSeq ||
      M > kMaxSeq || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const ptrs[4] = {q, k, v, o};
  cudaError_t err;
  if (dtype == kBFloat16 && D % 8 == 0 && rows_aligned16(ptrs, st)) {
    switch ((D + 15) / 16) {
#define PANDORA_SMALL_FWD_TC(KT)                                  \
  case KT:                                                        \
    err = launch_tc<KT>(q, k, v, o, B, N, M, H, D, st, scale, s); \
    break;
      PANDORA_SMALL_FWD_TC(1)
      PANDORA_SMALL_FWD_TC(2)
      PANDORA_SMALL_FWD_TC(3)
      PANDORA_SMALL_FWD_TC(4)
      PANDORA_SMALL_FWD_TC(5)
      PANDORA_SMALL_FWD_TC(6)
      PANDORA_SMALL_FWD_TC(7)
      PANDORA_SMALL_FWD_TC(8)
#undef PANDORA_SMALL_FWD_TC
      default:
        err = cudaErrorInvalidValue;
    }
  } else if (dtype == kFloat32) {
    const void* const in[3] = {q, k, v};
    const void* const out[1] = {o};
    const long long none[1] = {0};
    const bool vec_in = D % 4 == 0 && rows_aligned16(in, st, 4);
    const bool vec_out = D % 4 == 0 && rows_aligned16(out, none, 4);
    err = D <= 32   ? launch_f32<32>(q, k, v, o, B, N, M, H, D, st, scale,
                                     vec_in, vec_out, s)
          : D <= 64 ? launch_f32<64>(q, k, v, o, B, N, M, H, D, st, scale,
                                     vec_in, vec_out, s)
                    : launch_f32<128>(q, k, v, o, B, N, M, H, D, st, scale,
                                      vec_in, vec_out, s);
  } else if (dtype == kBFloat16) {
    err = launch_scalar(q, k, v, o, B, N, M, H, D, st, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
