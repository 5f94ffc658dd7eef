// Flash attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas kernels `_fwd_kernel_single` and `_fwd_kernel` in
// open_pandora_tpu/ops/flash_attention.py (reached through `_fwd` and
// `flash_attention`). Same function: softmax(q k^T * scale) v with fp32
// statistics, an optional causal mask aligned to the end of the key axis
// (col <= row + M - N), the ragged key edge masked, and the per-row
// log-sum-exp written beside the output for a later backward kernel.
//
// Layout: q (B, N, H, D), k and v (B, M, H, D), read through their batch,
// sequence and head strides (the head dim is contiguous), so the
// projections feed the kernel without the (B, H, N, D) transposes the TPU
// version needs for its tiling. o is written contiguous (B, N, H, D), the
// LSE contiguous (B, H, N).
//
// What bounds it on the card: this first version does its products with
// scalar fp32 FMAs on the CUDA cores (no tensor cores), so at the UNet
// shapes it is bound by shared-memory bandwidth feeding those FMAs, far
// below the bf16 tensor-core rate. The design keeps what matters for
// correctness and memory: one block owns 64 query rows of one (b, h) and
// loops over key tiles with an online softmax, so the (N, M) score matrix
// never leaves the chip; each thread keeps a 4-row register tile of the
// output accumulator; shared-memory rows are padded by one 32-bit word so
// the column-strided reads are free of bank conflicts. At D = 512 (the VAE's
// single head) the key tile shrinks so q, k and v tiles fit in the 227 KB
// of opt-in dynamic shared memory. Moving the two products to mma/wgmma is
// the next step for speed. The key-tile loop is `attn_stream` in
// common.cuh, shared with the packed attention kernel.
#include "common.cuh"

namespace pandora {
namespace {

constexpr int kBQ = kAttnBQ;

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kAttnThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int N, int M, int H, int D,
                 long long qsb, long long qsn, long long qsh,
                 long long ksb, long long ksn, long long ksh,
                 long long vsb, long long vsn, long long vsh,
                 float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnSmem<T> sm = AttnSmem<T>::template carve<BK>(smem, D);
  constexpr int kNJ = DMAX / 32;    // output column pairs per thread

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q_offset = causal ? (M - N) : 0;

  load_rows(sm.q, sm.ld, q + b * qsb + q0 * qsn + h * qsh, qsn,
            min(kBQ, N - q0), kBQ, D);

  // Key tiles wholly above the diagonal contribute nothing. Skipping them is
  // exact only when every row keeps at least one key (M >= N).
  int kv_end = M;
  if (causal && q_offset >= 0) kv_end = min(M, q0 + kBQ + q_offset);

  float acc[4][kNJ][2];
  attn_stream<T, DMAX, BK>(sm, acc, k + b * ksb + h * ksh, ksn,
                           v + b * vsb + h * vsh, vsn, M, D, q0, kv_end,
                           scale, causal, q_offset);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= N) continue;
    const float l = sm.l[r];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    T* orow = o + ((static_cast<long long>(b) * N + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = 2 * (tx + 16 * j);
      if (col < D)
        Elem<T>::store2(orow + col, acc[i][j][0] * inv, acc[i][j][1] * inv);
    }
  }
  if (tid < kBQ && q0 + tid < N)
    lse[(static_cast<long long>(b) * H + h) * N + q0 + tid] =
        sm.m[tid] + logf(fmaxf(sm.l[tid], 1e-37f));
}

template <typename T, int DMAX, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int N, int M, int H, int D,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<T, BK>(D);
  auto kernel = flash_fwd_kernel<T, DMAX, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      N, M, H, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T, bool kIsFloat>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int N, int M, int H, int D,
                       const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  // key tile: 64 rows for narrow heads, fewer as the head widens so the
  // q/k/v tiles stay inside the opt-in shared memory
  if (D <= 64)
    return launch<T, 64, 64>(q, k, v, o, lse, B, N, M, H, D, st, scale,
                             causal, stream);
  if (D <= 128)
    return launch<T, 128, 64>(q, k, v, o, lse, B, N, M, H, D, st, scale,
                              causal, stream);
  if (D <= 256)
    return launch<T, 256, 32>(q, k, v, o, lse, B, N, M, H, D, st, scale,
                              causal, stream);
  return launch<T, 512, kIsFloat ? 16 : 32>(q, k, v, o, lse, B, N, M, H, D,
                                            st, scale, causal, stream);
}

}  // namespace
}  // namespace pandora

// C interface. Strides are in elements: q_st = {batch, seq, head} stride of
// q, likewise k_st and v_st. Returns cudaGetLastError() after the launch
// (0 on success); an unsupported shape returns cudaErrorInvalidValue.
extern "C" int pandora_flash_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int N, int M,
                                 int H, int D, long long q_sb, long long q_sn,
                                 long long q_sh, long long k_sb,
                                 long long k_sn, long long k_sh,
                                 long long v_sb, long long v_sn,
                                 long long v_sh, float scale, int causal,
                                 int dtype, void* stream) {
  using namespace pandora;
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || D > 512 ||
      D % 8 != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch_d<float, true>(q, k, v, o, lse, B, N, M, H, D, st, scale,
                                  causal, s);
  else if (dtype == kBFloat16)
    err = dispatch_d<__nv_bfloat16, false>(q, k, v, o, lse, B, N, M, H, D,
                                           st, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
