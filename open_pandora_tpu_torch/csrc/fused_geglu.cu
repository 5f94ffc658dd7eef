// Fused GEGLU feed-forward with its LayerNorm and residual, for Hopper
// (sm_90a):
//     out = x + W2 (v * gelu(g)) + b2,   [v | g] = LN(x) W1 + b1
// over the rows of x (R, c); W1 (c, 2 inner) with the value columns first,
// W2 (inner, c), as the JAX package lays them out.
//
// Replaces the Pallas kernel `_kernel` of open_pandora_tpu/ops/fused_geglu.py
// (reached through `_forward` <- `fused_geglu_ff`). Same casts as the TPU
// kernel: LN with fp32 statistics, cast to the element type; v and g
// accumulated in fp32 plus their fp32 biases; v * gelu(g) in fp32, cast to
// the element type; the down-projection accumulated in fp32 plus b2 plus the
// residual in fp32; one cast at the end. gelu is the exact erf form (erff):
// the TPU kernel approximates erf only because Mosaic has no erf lowering,
// and the function it stands for (`geglu_ff_xla`) is exact.
//
// What bounds it on the card: the three products, 24 R c^2 operations at
// inner = 4c, against 4 R c bytes of x and out (bf16), so it is
// compute-bound; the products run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate). A block owns BR rows (64, 32 or 16, the most that fit
// shared memory beside the gated rows): it normalises them into shared
// memory, then walks `inner` 64 columns at a time (each warp 8 value and the
// same 8 gate columns, over c in 32-wide chunks), writing v * gelu(g) for
// all BR x inner into shared memory (about 160 KB), then computes the
// output 64 columns at a time over inner with the accumulator in registers
// and adds b2 and x on the way out. The weights stream through a
// double-buffered shared tile filled from registers (transposed on the way,
// since the products want k-contiguous columns); every block re-reads them
// from L2. fp32 takes a scalar-FMA kernel with 8-row blocks.
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kKC = 32;          // k per chunk
constexpr int kLdW = kKC + 8;    // shared pitch of the weight tile
constexpr int kNT1 = 64;         // inner columns per phase-1 tile
constexpr int kNT2 = 64;         // output columns per phase-2 tile
constexpr size_t kSmemLimit = 232448;

struct Args {
  const void* x;
  const void* ln_w;
  const void* ln_b;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  void* out;
  int R, c, inner;
  float eps;
};

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g / 1.41421356237309515f));
}

// LN of rows [r0, r0 + BR) into dst (pitch ld), one warp per row; rows past
// R are zero.
template <typename T>
__device__ void layer_norm_rows(const Args& a, int r0, int BR, T* dst,
                                int ld) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* x = static_cast<const T*>(a.x);
  const T* gw = static_cast<const T*>(a.ln_w);
  const T* gb = static_cast<const T*>(a.ln_b);
  for (int r = warp; r < BR; r += kThreads / 32) {
    T* d = dst + static_cast<long long>(r) * ld;
    if (r0 + r >= a.R) {
      for (int i = lane; i < a.c; i += 32) d[i] = Elem<T>::from_float(0.f);
      continue;
    }
    const T* src = x + static_cast<long long>(r0 + r) * a.c;
    float sum = 0.f;
    for (int i = lane; i < a.c; i += 32) sum += Elem<T>::to_float(src[i]);
    const float mu = warp_sum(sum) / a.c;
    float sq = 0.f;
    for (int i = lane; i < a.c; i += 32) {
      const float dv = Elem<T>::to_float(src[i]) - mu;
      sq += dv * dv;
    }
    const float inv = rsqrtf(warp_sum(sq) / a.c + a.eps);
    for (int i = lane; i < a.c; i += 32) {
      const float n = (Elem<T>::to_float(src[i]) - mu) * inv;
      d[i] = Elem<T>::from_float(n * Elem<T>::to_float(gw[i]) +
                                 Elem<T>::to_float(gb[i]));
    }
  }
}

// Store the eight bf16 values of v (consecutive columns n .. n + 7 of one k
// row) transposed: dst[(n + e) * kLdW + kk].
__device__ __forceinline__ void stash_t(bf16* dst, int n, int kk,
                                        const uint4& v) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[(n + i) * kLdW + kk] = e[i];
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
fused_geglu_bf16_kernel(const Args a) {
  constexpr int BR = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c;
  const int inner = a.inner;
  const int ldx = c + 8;
  const int ldg = inner + 8;
  bf16* sXn = reinterpret_cast<bf16*>(smem);       // (BR, ldx)
  bf16* sG = sXn + BR * ldx;                       // (BR, ldg)
  bf16* sW = sG + BR * ldg;                        // 2 x (128, kLdW)
  constexpr int kStage = 128 * kLdW;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r0 = blockIdx.x * BR;
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* b1 = static_cast<const bf16*>(a.b1);
  const bf16* b2 = static_cast<const bf16*>(a.b2);

  layer_norm_rows<bf16>(a, r0, BR, sXn, ldx);
  __syncthreads();

  // -- phase 1: v * gelu(g) for all BR x inner into sG ----------------------
  // chunk k0 of tile j0: w1[k0 + kk][j0 + n] (value, n < 64) and
  // w1[k0 + kk][inner + j0 + n - 64] (gate), as sW[n][kk]
  const long long ld1 = 2LL * inner;
  for (int j0 = 0; j0 < inner; j0 += kNT1) {
    uint4 rw[2];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + kThreads * i;  // 32 k rows x 16 pieces
        const int kk = idx / 16;
        const int n = (idx % 16) * 8;
        const int col = n < 64 ? j0 + n : inner + j0 + n - 64;
        rw[i] = *reinterpret_cast<const uint4*>(w1 + (k0 + kk) * ld1 + col);
      }
    };
    auto stash = [&](int s) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + kThreads * i;
        stash_t(sW + s * kStage, (idx % 16) * 8, idx / 16, rw[i]);
      }
    };
    float av[MT][4], ag[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[i][e] = ag[i][e] = 0.f;
    const int nk = c / kKC;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc & 1;
      if (kc + 1 < nk) fetch((kc + 1) * kKC);
      const bf16* Ws = sW + s * kStage;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        const bf16* vp = Ws + (warp * 8 + g) * kLdW + kk + tig * 2;
        const bf16* gp = vp + 64 * kLdW;
        const uint32_t bv[2] = {ld32(vp), ld32(vp + 8)};
        const uint32_t bg[2] = {ld32(gp), ld32(gp + 8)};
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const bf16* ap = sXn + (i * 16 + g) * ldx + kc * kKC + kk + tig * 2;
          const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * ldx), ld32(ap + 8),
                                  ld32(ap + 8 * ldx + 8)};
          mma_bf16(av[i], af, bv);
          mma_bf16(ag[i], af, bg);
        }
      }
      if (kc + 1 < nk) stash(s ^ 1);
      __syncthreads();
    }
    const int j = j0 + warp * 8 + tig * 2;
    const float2 bvv = Elem<bf16>::load2(b1 + j);
    const float2 bgg = Elem<bf16>::load2(b1 + inner + j);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i * 16 + g + 8 * half;
        const float v0 = av[i][2 * half] + bvv.x;
        const float v1 = av[i][2 * half + 1] + bvv.y;
        const float g0 = ag[i][2 * half] + bgg.x;
        const float g1 = ag[i][2 * half + 1] + bgg.y;
        Elem<bf16>::store2(sG + r * ldg + j, v0 * gelu_erf(g0),
                           v1 * gelu_erf(g1));
      }
  }
  __syncthreads();

  // -- phase 2: out = sG W2 + b2 + x, 64 output columns at a time -----------
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* out = static_cast<bf16*>(a.out);
  for (int n0 = 0; n0 < c; n0 += kNT2) {
    uint4 rw;
    const int kk_l = tid / 8;          // 32 k rows x 8 pieces
    const int n_l = (tid % 8) * 8;
    auto fetch = [&](int k0) {
      rw = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n_l < c)  // c % 8 == 0: a piece is whole or absent
        rw = *reinterpret_cast<const uint4*>(
            w2 + static_cast<long long>(k0 + kk_l) * c + n0 + n_l);
    };
    float acc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const int nk = inner / kKC;
    fetch(0);
    stash_t(sW, n_l, kk_l, rw);
    __syncthreads();
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc & 1;
      if (kc + 1 < nk) fetch((kc + 1) * kKC);
      const bf16* Ws = sW + s * kStage;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        const bf16* bp = Ws + (warp * 8 + g) * kLdW + kk + tig * 2;
        const uint32_t bfrag[2] = {ld32(bp), ld32(bp + 8)};
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const bf16* ap = sG + (i * 16 + g) * ldg + kc * kKC + kk + tig * 2;
          const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * ldg), ld32(ap + 8),
                                  ld32(ap + 8 * ldg + 8)};
          mma_bf16(acc[i], af, bfrag);
        }
      }
      if (kc + 1 < nk) stash_t(sW + (s ^ 1) * kStage, n_l, kk_l, rw);
      __syncthreads();
    }
    const int col = n0 + warp * 8 + tig * 2;
    if (col < c) {
      const float2 bb = Elem<bf16>::load2(b2 + col);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + i * 16 + g + 8 * half;
          if (r >= a.R) continue;
          const long long off = static_cast<long long>(r) * c + col;
          const float2 xr = Elem<bf16>::load2(x + off);
          Elem<bf16>::store2(out + off, acc[i][2 * half] + bb.x + xr.x,
                             acc[i][2 * half + 1] + bb.y + xr.y);
        }
    }
  }
}

// fp32 on scalar FMAs: a block owns kFR rows; phase 1 gives each thread
// inner columns (coalesced reads of W1's rows), phase 2 output columns.
constexpr int kFR = 8;

__global__ void __launch_bounds__(kThreads)
fused_geglu_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c;
  const int inner = a.inner;
  float* sXn = reinterpret_cast<float*>(smem);   // (kFR, c)
  float* sG = sXn + kFR * c;                     // (kFR, inner)
  const int r0 = blockIdx.x * kFR;
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  const float* b1 = static_cast<const float*>(a.b1);
  const float* b2 = static_cast<const float*>(a.b2);
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);

  layer_norm_rows<float>(a, r0, kFR, sXn, c);
  __syncthreads();
  const long long ld1 = 2LL * inner;
  for (int j = threadIdx.x; j < inner; j += kThreads) {
    float v[kFR] = {}, gt[kFR] = {};
    for (int k = 0; k < c; ++k) {
      const float wv = w1[k * ld1 + j];
      const float wg = w1[k * ld1 + inner + j];
#pragma unroll
      for (int r = 0; r < kFR; ++r) {
        v[r] = fmaf(sXn[r * c + k], wv, v[r]);
        gt[r] = fmaf(sXn[r * c + k], wg, gt[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kFR; ++r)
      sG[r * inner + j] = (v[r] + b1[j]) * gelu_erf(gt[r] + b1[inner + j]);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < c; n += kThreads) {
    float acc[kFR] = {};
    for (int k = 0; k < inner; ++k) {
      const float wv = w2[static_cast<long long>(k) * c + n];
#pragma unroll
      for (int r = 0; r < kFR; ++r) acc[r] = fmaf(sG[r * inner + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kFR; ++r) {
      if (r0 + r >= a.R) break;
      const long long off = static_cast<long long>(r0 + r) * c + n;
      out[off] = acc[r] + b2[n] + x[off];
    }
  }
}

size_t bf16_smem(int br, int c, int inner) {
  return (static_cast<size_t>(br) * (c + 8) +
          static_cast<size_t>(br) * (inner + 8) + 2 * 128 * kLdW) *
         sizeof(bf16);
}

template <int MT>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const size_t smem = bf16_smem(16 * MT, a.c, a.inner);
  auto kernel = fused_geglu_bf16_kernel<MT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.R + 16 * MT - 1) / (16 * MT);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pandora

// C interface. x and out (R, c), ln_w, ln_b, b2 (c,), w1 (c, 2 inner), b1
// (2 inner,), w2 (inner, c), all contiguous in the element type (dtype
// code 0 fp32, 1 bf16), 16-byte aligned. c % 32 == 0 and inner % 64 == 0;
// the rows of a block (bf16: 16 at least) must fit shared memory beside
// their gated rows, which holds up to c = 1280 at inner = 4c. Returns
// cudaGetLastError() after the launch (0 on success); an unsupported shape
// returns cudaErrorInvalidValue.
extern "C" int pandora_fused_geglu(const void* x, const void* ln_w,
                                   const void* ln_b, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, int R, int c,
                                   int inner, float eps, int dtype,
                                   void* stream) {
  using namespace pandora;
  if ((dtype != kFloat32 && dtype != kBFloat16) || R <= 0 || c <= 0 ||
      inner <= 0 || c % kKC != 0 || inner % kNT1 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.out = out;
  a.R = R;
  a.c = c;
  a.inner = inner;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    const size_t smem = static_cast<size_t>(kFR) * (c + inner) * sizeof(float);
    if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = allow_smem(fused_geglu_f32_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_geglu_f32_kernel<<<(R + kFR - 1) / kFR, kThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (bf16_smem(64, c, inner) <= kSmemLimit)
    return static_cast<int>(launch_bf16<4>(a, s));
  if (bf16_smem(32, c, inner) <= kSmemLimit)
    return static_cast<int>(launch_bf16<2>(a, s));
  if (bf16_smem(16, c, inner) <= kSmemLimit)
    return static_cast<int>(launch_bf16<1>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
