// Attention over tiny sequences (N, M <= 32) and a huge batch x heads, for
// Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas kernel `_fwd_kernel` in
// open_pandora_tpu/ops/small_attention.py (reached through `_run_fwd` and
// `small_attention`): the UNet's temporal self-attention at t = 16, run over
// every spatial position of every frame stack (B = b*h*w up to 5120 rows,
// 5 to 20 heads). Math in fp32: scores, softmax and the product with v.
//
// Layout: q (B, N, H, D), k and v (B, M, H, D), read through their batch,
// sequence and head strides (the head dim is contiguous); o contiguous
// (B, N, H, D). The TPU version transposes everything to (N, D, H*B) so the
// batch fills its 128-lane vregs; here one warp owns one (b, h) pair and
// reads its rows directly, 32 lanes across the contiguous head dim.
//
// What bounds it on the card: the arithmetic is tiny (2*N*M*D per pair for
// each product), so the kernel is bound by reading q, k, v and writing o
// once from device memory. The design reads each element exactly once
// (coalesced along D), keeps the (N, M) scores and probabilities in shared
// memory and registers, and never writes them to device memory; four warps
// per block keep enough pairs in flight to cover memory latency.
#include "common.cuh"

namespace pandora {
namespace {

constexpr int kWarps = 4;
constexpr int kMaxSeq = 32;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
small_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int BH,
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

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  for (int n = 0; n < N; ++n)
    for (int d = lane; d < D; d += 32)
      sQ[n * ld + d] = Elem<T>::to_float(qp[n * qsn + d]);
  for (int m = 0; m < M; ++m)
    for (int d = lane; d < D; d += 32) {
      sK[m * ld + d] = Elem<T>::to_float(kp[m * ksn + d]);
      sV[m * ld + d] = Elem<T>::to_float(vp[m * vsn + d]);
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
  T* op = o + (static_cast<long long>(b) * N * H + h) * D;
  const long long osn = static_cast<long long>(H) * D;
  for (int n = 0; n < N; ++n)
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < M; ++j) acc = fmaf(sP[n * ldp + j], sV[j * ld + d], acc);
      op[n * osn + d] = Elem<T>::from_float(acc);
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int N, int M, int H, int D, const long long* st,
                   float scale, cudaStream_t stream) {
  const int BH = B * H;
  const size_t smem = static_cast<size_t>(kWarps) *
                      ((N + 2 * M) * (D + 1) + N * (M + 1)) * sizeof(float);
  auto kernel = small_attn_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (BH + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), BH, H, N, M, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pandora

// C interface; strides in elements as in pandora_flash_fwd. N, M <= 32 and
// D <= 128, else cudaErrorInvalidValue.
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
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch<float>(q, k, v, o, B, N, M, H, D, st, scale, s);
  else if (dtype == kBFloat16)
    err = launch<__nv_bfloat16>(q, k, v, o, B, N, M, H, D, st, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
