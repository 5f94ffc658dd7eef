// Backward of attention over tiny sequences (N, M <= 32) and a huge
// batch x heads, for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas kernel `_bwd_kernel` in
// open_pandora_tpu/ops/small_attention.py (reached through `_run_bwd`, the
// custom VJP of `small_attention`): the gradient of the UNet's temporal
// self-attention at t = 16 in training. Same function, all in fp32:
// recompute p = softmax(q k^T scale), then dv = p^T do, dp = do v^T,
// ds = p (dp - rowsum(dp p)) scale, dq = ds k, dk = ds^T q.
//
// Layout as the forward (small_attn_fwd.cu): q, do (B, N, H, D) and k, v
// (B, M, H, D) read through their batch, sequence and head strides (head
// dim contiguous); dq (B, N, H, D), dk and dv (B, M, H, D) written
// contiguous. One warp owns one (b, h) pair.
//
// What bounds it on the card: its arithmetic is five tiny products per
// pair, so it is bound by reading q, k, v, do and writing dq, dk, dv once.
// Each element is read once (coalesced along D) into fp32 shared memory;
// the (N, M) p and ds stay in shared memory and never reach device memory.
// Lane n computes row n of the scores, the softmax and ds (both row sums
// are in the lane's registers); then the lanes run across D for the three
// products. Shared memory per warp is (2N + 2M)(D + 1) + 2N(M + 1) floats,
// so a block takes up to four warps, fewer at the widest shapes.
#include "common.cuh"

namespace pandora {
namespace {

constexpr int kMaxWarps = 4;
constexpr int kMaxSeq = 32;
constexpr size_t kSmemLimit = 227 * 1024;

__host__ __device__ size_t warp_floats(int N, int M, int D) {
  return static_cast<size_t>(2 * N + 2 * M) * (D + 1) +
         static_cast<size_t>(2 * N) * (M + 1);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
small_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      T* __restrict__ dq, T* __restrict__ dk,
                      T* __restrict__ dv, int BH, int H, int N, int M, int D,
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

  const T* qp = q + b * qsb + h * qsh;
  const T* gp = dout + b * dsb + h * dsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  for (int n = 0; n < N; ++n)
    for (int d = lane; d < D; d += 32) {
      sQ[n * ld + d] = Elem<T>::to_float(qp[n * qsn + d]);
      sG[n * ld + d] = Elem<T>::to_float(gp[n * dsn + d]);
    }
  for (int m = 0; m < M; ++m)
    for (int d = lane; d < D; d += 32) {
      sK[m * ld + d] = Elem<T>::to_float(kp[m * ksn + d]);
      sV[m * ld + d] = Elem<T>::to_float(vp[m * vsn + d]);
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
  T* dqp = dq + (static_cast<long long>(b) * N * H + h) * D;
  for (int n = 0; n < N; ++n)
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < M; ++j) acc = fmaf(sS[n * ldp + j], sK[j * ld + d], acc);
      dqp[n * osn + d] = Elem<T>::from_float(acc);
    }
  T* dkp = dk + (static_cast<long long>(b) * M * H + h) * D;
  T* dvp = dv + (static_cast<long long>(b) * M * H + h) * D;
  for (int m = 0; m < M; ++m)
    for (int d = lane; d < D; d += 32) {
      float ak = 0.f, av = 0.f;
      for (int n = 0; n < N; ++n) {
        ak = fmaf(sS[n * ldp + m], sQ[n * ld + d], ak);
        av = fmaf(sP[n * ldp + m], sG[n * ld + d], av);
      }
      dkp[m * osn + d] = Elem<T>::from_float(ak);
      dvp[m * osn + d] = Elem<T>::from_float(av);
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv, int B,
                   int N, int M, int H, int D, const long long* st,
                   float scale, cudaStream_t stream) {
  const int BH = B * H;
  const size_t per_warp = warp_floats(N, M, D) * sizeof(float);
  const int warps = static_cast<int>(
      kSmemLimit / per_warp < kMaxWarps ? kSmemLimit / per_warp : kMaxWarps);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  auto kernel = small_attn_bwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (BH + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), BH, H,
      N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pandora

// C interface; strides in elements, {batch, seq, head} of q, k, v and do in
// that order. N, M <= 32 and D <= 128, else cudaErrorInvalidValue.
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
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch<float>(q, k, v, dout, dq, dk, dv, B, N, M, H, D, st, scale,
                        s);
  else if (dtype == kBFloat16)
    err = launch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, B, N, M, H, D, st,
                                scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
