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
// tile and loops over key tiles. Every product is in fp32 from the inputs
// as stored (p is not rounded to the element type, as in the Pallas
// kernels); outputs are rounded once. Masking as in the forward: keys at or
// past M weigh exactly 0; with `causal`, key col > row + (M - N) scores
// kMaskValue, so a row with no visible key attends uniformly, as the
// forward made it.
//
// Layout: q and do (B, N, H, D), k and v (B, M, H, D) read through their
// batch, sequence and head strides (head dim contiguous); lse and di
// contiguous (B, H, N) fp32; dq, dk, dv written contiguous.
//
// What bounds it on the card: like the forward, this first version runs
// its five products per tile pair as scalar fp32 FMAs on the CUDA cores,
// fed from shared memory, far below the bf16 tensor-core rate the bound
// assumes. A block keeps its own tile's accumulators (dk and dv, or dq) in
// registers across the whole loop, so nothing is accumulated in device
// memory and no atomics are needed; the (64 x 64) p and ds tiles live in
// shared memory only. Rows are padded by one 32-bit word (conflict-free
// column reads, as in common.cuh). Causal key tiles wholly above the
// diagonal are skipped where that is exact (M >= N). Moving the products
// to mma.sync / wgmma is the next step for speed.
#include "common.cuh"

namespace pandora {
namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kLdS = kBK + 1;    // pitch of the fp32 p / ds tiles

template <typename T>
struct BwdSmem {
  T* q;        // (kBQ, ld)
  T* dout;     // (kBQ, ld)
  T* k;        // (kBK, ld)
  T* v;        // (kBK, ld)
  float* p;    // (kBQ, kLdS): p[row][key]
  float* ds;   // (kBQ, kLdS)
  float* lse;  // (kBQ)
  float* di;   // (kBQ)
  int ld;

  __device__ static BwdSmem carve(unsigned char* smem, int D) {
    BwdSmem t;
    t.ld = D + 2;
    t.q = reinterpret_cast<T*>(smem);
    t.dout = t.q + kBQ * t.ld;
    t.k = t.dout + kBQ * t.ld;
    t.v = t.k + kBK * t.ld;
    t.p = reinterpret_cast<float*>(t.v + kBK * t.ld);
    t.ds = t.p + kBQ * kLdS;
    t.lse = t.ds + kBQ * kLdS;
    t.di = t.lse + kBQ;
    return t;
  }
};

template <typename T>
size_t bwd_smem_bytes(int D) {
  return static_cast<size_t>(2 * kBQ + 2 * kBK) * (D + 2) * sizeof(T) +
         static_cast<size_t>(2 * kBQ * kLdS + 2 * kBQ) * sizeof(float);
}

// Load the q and do rows [q0, q0 + kBQ) and their lse and di into shared
// memory; rows at or past N are zero (and weigh nothing: see p_ds_tile).
template <typename T>
__device__ __forceinline__ void load_q_tile(
    const BwdSmem<T>& sm, const T* q, long long qsn, const T* dout,
    long long dsn, const float* lse, const float* di, int q0, int N,
    int D) {
  const int valid = min(kBQ, N - q0);
  load_rows(sm.q, sm.ld, q + q0 * qsn, qsn, valid, kBQ, D);
  load_rows(sm.dout, sm.ld, dout + q0 * dsn, dsn, valid, kBQ, D);
  const int tid = threadIdx.x;
  if (tid < kBQ) {
    sm.lse[tid] = tid < valid ? lse[q0 + tid] : 0.f;
    sm.di[tid] = tid < valid ? di[q0 + tid] : 0.f;
  }
}

// p and ds of the (q tile, k tile) pair into sm.p / sm.ds. Thread (ty, tx)
// computes rows ty + 16 i and key columns tx + 16 j (i, j < 4).
template <typename T>
__device__ __forceinline__ void p_ds_tile(const BwdSmem<T>& sm, int D,
                                          int q0, int k0, int N, int M,
                                          float scale, int causal,
                                          int q_offset) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int ld = sm.ld;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; d += 2) {
    float2 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Elem<T>::load2(sm.q + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Elem<T>::load2(sm.k + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = fmaf(a[i].y, b[j].y, fmaf(a[i].x, b[j].x, s[i][j]));
  }
  for (int d = 0; d < D; d += 2) {
    float2 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = Elem<T>::load2(sm.dout + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Elem<T>::load2(sm.v + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dp[i][j] = fmaf(a[i].y, b[j].y, fmaf(a[i].x, b[j].x, dp[i][j]));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    const float lse = sm.lse[r];
    const float di = sm.di[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      float p = 0.f;
      if (row < N && col < M) {
        float x = s[i][j] * scale;
        if (causal && col > row + q_offset) x = kMaskValue;
        p = expf(x - lse);
      }
      sm.p[r * kLdS + c] = p;
      sm.ds[r * kLdS + c] = p * (dp[i][j] - di) * scale;
    }
  }
}

// dk, dv of one key tile: grid (key tiles, H, B), query tiles inner.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int N, int M, int H, int D,
                     long long qsb, long long qsn, long long qsh,
                     long long ksb, long long ksn, long long ksh,
                     long long vsb, long long vsn, long long vsh,
                     long long dsb, long long dsn, long long dsh, float scale,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<T> sm = BwdSmem<T>::carve(smem, D);
  constexpr int kNJ = DMAX / 32;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int ld = sm.ld;
  const int q_offset = causal ? (M - N) : 0;

  load_rows(sm.k, ld, k + b * ksb + k0 * ksn + h * ksh, ksn,
            min(kBK, M - k0), kBK, D);
  load_rows(sm.v, ld, v + b * vsb + k0 * vsn + h * vsh, vsn,
            min(kBK, M - k0), kBK, D);
  const T* qb = q + b * qsb + h * qsh;
  const T* db = dout + b * dsb + h * dsh;
  const long long stat = (static_cast<long long>(b) * H + h) * N;

  float acc_k[4][kNJ][2], acc_v[4][kNJ][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      acc_k[i][j][0] = acc_k[i][j][1] = acc_v[i][j][0] = acc_v[i][j][1] = 0.f;

  // query tiles wholly above the diagonal see none of these keys; skipping
  // them is exact when every row keeps a key (M >= N)
  int q_begin = 0;
  if (causal && q_offset >= 0) q_begin = max(0, k0 - q_offset) / kBQ * kBQ;
  for (int q0 = q_begin; q0 < N; q0 += kBQ) {
    __syncthreads();  // the last tile's readers are done
    load_q_tile(sm, qb, qsn, db, dsn, lse + stat, di + stat, q0, N, D);
    __syncthreads();
    p_ds_tile(sm, D, q0, k0, N, M, scale, causal, q_offset);
    __syncthreads();
    const int rows = min(kBQ, N - q0);
    for (int r = 0; r < rows; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sm.p[r * kLdS + ty + 16 * i];
        ds[i] = sm.ds[r * kLdS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int col = 2 * (tx + 16 * j);
        if (col < D) {
          const float2 g = Elem<T>::load2(sm.dout + r * ld + col);
          const float2 x = Elem<T>::load2(sm.q + r * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j][0] = fmaf(p[i], g.x, acc_v[i][j][0]);
            acc_v[i][j][1] = fmaf(p[i], g.y, acc_v[i][j][1]);
            acc_k[i][j][0] = fmaf(ds[i], x.x, acc_k[i][j][0]);
            acc_k[i][j][1] = fmaf(ds[i], x.y, acc_k[i][j][1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= M) continue;
    const long long off = ((static_cast<long long>(b) * M + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = 2 * (tx + 16 * j);
      if (col < D) {
        Elem<T>::store2(dk + off + col, acc_k[i][j][0], acc_k[i][j][1]);
        Elem<T>::store2(dv + off + col, acc_v[i][j][0], acc_v[i][j][1]);
      }
    }
  }
}

// dq of one query tile: grid (query tiles, H, B), key tiles inner.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int N,
                    int M, int H, int D, long long qsb, long long qsn,
                    long long qsh, long long ksb, long long ksn,
                    long long ksh, long long vsb, long long vsn,
                    long long vsh, long long dsb, long long dsn,
                    long long dsh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<T> sm = BwdSmem<T>::carve(smem, D);
  constexpr int kNJ = DMAX / 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int ld = sm.ld;
  const int q_offset = causal ? (M - N) : 0;
  const long long stat = (static_cast<long long>(b) * H + h) * N;

  load_q_tile(sm, q + b * qsb + h * qsh, qsn, dout + b * dsb + h * dsh, dsn,
              lse + stat, di + stat, q0, N, D);
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  float acc[4][kNJ][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;

  // key tiles wholly above the diagonal: exact to skip when M >= N
  int kv_end = M;
  if (causal && q_offset >= 0) kv_end = min(M, q0 + kBQ + q_offset);
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    const int kvalid = min(kBK, M - k0);
    __syncthreads();
    load_rows(sm.k, ld, kb + k0 * ksn, ksn, kvalid, kBK, D);
    load_rows(sm.v, ld, vb + k0 * vsn, vsn, kvalid, kBK, D);
    __syncthreads();
    p_ds_tile(sm, D, q0, k0, N, M, scale, causal, q_offset);
    __syncthreads();
    for (int c = 0; c < kvalid; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sm.ds[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int col = 2 * (tx + 16 * j);
        if (col < D) {
          const float2 x = Elem<T>::load2(sm.k + c * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j][0] = fmaf(ds[i], x.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(ds[i], x.y, acc[i][j][1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= N) continue;
    const long long off = ((static_cast<long long>(b) * N + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = 2 * (tx + 16 * j);
      if (col < D) Elem<T>::store2(dq + off + col, acc[i][j][0], acc[i][j][1]);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* di,
                   void* dq, void* dk, void* dv, int B, int N, int M, int H,
                   int D, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(D);
  auto dkv = flash_bwd_dkv_kernel<T, DMAX>;
  auto dqk = flash_bwd_dq_kernel<T, DMAX>;
  cudaError_t err = allow_smem(dkv, smem);
  if (err == cudaSuccess) err = allow_smem(dqk, smem);
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dp = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* ip = static_cast<const float*>(di);
  dkv<<<dim3((M + kBK - 1) / kBK, H, B), kThreads, smem, stream>>>(
      qp, kp, vp, dp, lp, ip, static_cast<T*>(dk), static_cast<T*>(dv), N,
      M, H, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((N + kBQ - 1) / kBQ, H, B), kThreads, smem, stream>>>(
      qp, kp, vp, dp, lp, ip, static_cast<T*>(dq), N, M, H, D, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dq, void* dk, void* dv, int B, int N, int M,
                       int H, int D, const long long* st, float scale,
                       int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, D,
                         st, scale, causal, stream);
  return launch<T, 128>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, D,
                        st, scale, causal, stream);
}

}  // namespace
}  // namespace pandora

// C interface. Strides in elements: {batch, seq, head} of q, k, v and do in
// that order. lse and di are contiguous (B, H, N) fp32; dq (B, N, H, D), dk
// and dv (B, M, H, D) are written contiguous. Launches the dkv kernel, then
// the dq kernel, on `stream`; returns cudaGetLastError() (0 on success). D
// must be a multiple of 8 up to 128, else cudaErrorInvalidValue.
extern "C" int pandora_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, void* dk, void* dv, int B,
    int N, int M, int H, int D, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long d_sb, long long d_sn,
    long long d_sh, float scale, int causal, int dtype, void* stream) {
  using namespace pandora;
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                            v_sb, v_sn, v_sh, d_sb, d_sn, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch_d<float>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, D,
                            st, scale, causal, s);
  else if (dtype == kBFloat16)
    err = dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, di, dq, dk, dv, B, N,
                                    M, H, D, st, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
