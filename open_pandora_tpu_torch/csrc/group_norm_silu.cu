// GroupNorm (+ affine, + optional SiLU) over channel-last (N, L, C) bf16
// slabs for Hopper (sm_90a): statistics per sample and group over all L
// rows and the group's C / G channels, in fp32.
//
// Replaces the Pallas kernel `_kernel` in open_pandora_tpu/ops/fused_norms.py
// (reached through `_fused_forward` from `fused_group_norm_silu`): every
// GroupNorm of the UNet (ResBlocks, temporal conv blocks, transformer
// pre-norms, the output norm) and of the VAE. It also serves the large
// slabs that the TPU version sends to its two-pass streaming kernels
// (`_stats_kernel`, `_apply_kernel`) or to an XLA rewrite, because the card
// has no per-block residency limit to route around.
//
// What bounds it on the card: memory. At best the slab is read twice and
// written once in bf16 (about 6 bytes per element), and the arithmetic is a
// few FLOP per element. A sample's slab is far too large for one block
// (8 x 21M elements per VAE decode chunk) and N is 2 to 32, so one block
// per sample could not fill the 132 SMs. So the kernel runs as two passes
// over (split, sample) blocks, each split a range of rows:
//   1. stats: each thread reads rows of 8 channels with 16-byte loads and
//      keeps per-channel Welford moments (count, mean, M2); the block folds
//      them into per-group partials with Chan's formula and writes them to
//      a small fp32 scratch (N, S, G, 3) that the wrapper allocates.
//   2. apply: each block merges the S partials of its sample's groups (Chan
//      again), folds mean, 1/sd and the affine into one scale and shift per
//      channel, and streams its rows: x * scale + shift, SiLU, bf16 out,
//      16 bytes per thread per access.
// The centred moments avoid the E[x^2] - mu^2 form of the TPU kernel, which
// cancels badly in fp32 over slabs of millions of elements.
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStatsThreads = 1024;  // C up to 8192

struct Moments {
  float n, mean, m2;
};

// Chan et al.: the moments of the union of two disjoint sets.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float fb = b.n / n;
  return {n, a.mean + d * fb, a.m2 + b.m2 + d * d * a.n * fb};
}

__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o{__shfl_xor_sync(0xffffffffu, m.n, off),
                    __shfl_xor_sync(0xffffffffu, m.mean, off),
                    __shfl_xor_sync(0xffffffffu, m.m2, off)};
    m = merge(m, o);
  }
  return m;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Pass 1. Threads are (row lane ry < Rt, 8-channel column vc < C / 8):
// 256 threads, or one per column where C / 8 is larger.
__global__ void __launch_bounds__(kMaxStatsThreads)
gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part, int L,
                int C, int G, int rows_per_split) {
  extern __shared__ float sm[];
  const int VC = C / 8;
  const int Rt = blockDim.x / VC;
  float* smean = sm;             // (Rt, C)
  float* sm2 = smean + Rt * C;   // (Rt, C)
  float* scnt = sm2 + Rt * C;    // (Rt)
  const int n = blockIdx.y;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int vc = tid % VC;
  const int ry = tid / VC;
  const int r0 = s * rows_per_split;
  const int r1 = min(L, r0 + rows_per_split);

  if (ry < Rt) {
    float mean[8], m2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) mean[j] = m2[j] = 0.f;
    float cnt = 0.f;
    const bf16* base = x + static_cast<long long>(n) * L * C + vc * 8;
    for (int r = r0 + ry; r < r1; r += Rt) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(base +
                                              static_cast<long long>(r) * C),
              v);
      cnt += 1.f;
      const float inv = 1.f / cnt;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[j] - mean[j];
        mean[j] = fmaf(d, inv, mean[j]);
        m2[j] = fmaf(d, v[j] - mean[j], m2[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      smean[ry * C + vc * 8 + j] = mean[j];
      sm2[ry * C + vc * 8 + j] = m2[j];
    }
    if (vc == 0) scnt[ry] = cnt;
  }
  __syncthreads();

  const int cg = C / G;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int grp = warp; grp < G; grp += blockDim.x / 32) {
    Moments m{0.f, 0.f, 0.f};
    for (int e = lane; e < Rt * cg; e += 32) {
      const int r = e / cg;
      const int ch = grp * cg + (e - r * cg);
      m = merge(m, {scnt[r], smean[r * C + ch], sm2[r * C + ch]});
    }
    m = warp_merge(m);
    if (lane == 0) {
      float* p = part + ((static_cast<long long>(n) * gridDim.x + s) * G +
                         grp) * 3;
      p[0] = m.n;
      p[1] = m.mean;
      p[2] = m.m2;
    }
  }
}

// Pass 2.
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, const float* __restrict__ part,
                bf16* __restrict__ out, int L, int C, int G,
                int rows_per_split, float eps, int silu) {
  extern __shared__ float sm[];
  float* sk = sm;         // per-channel scale
  float* sb = sk + C;     // per-channel shift
  float* smu = sb + C;    // per-group mean
  float* sinv = smu + G;  // per-group 1 / sd
  const int n = blockIdx.y;
  const int s = blockIdx.x;
  const int S = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int grp = warp; grp < G; grp += kWarps) {
    Moments m{0.f, 0.f, 0.f};
    for (int e = lane; e < S; e += 32) {
      const float* p =
          part + ((static_cast<long long>(n) * S + e) * G + grp) * 3;
      m = merge(m, {p[0], p[1], p[2]});
    }
    m = warp_merge(m);
    if (lane == 0) {
      smu[grp] = m.mean;
      sinv[grp] = 1.f / sqrtf(m.m2 / m.n + eps);
    }
  }
  __syncthreads();
  const int cg = C / G;
  for (int ch = tid; ch < C; ch += kThreads) {
    const int grp = ch / cg;
    const float k = __bfloat162float(w[ch]) * sinv[grp];
    sk[ch] = k;
    sb[ch] = __bfloat162float(bias[ch]) - smu[grp] * k;
  }
  __syncthreads();

  const int VC = C / 8;
  const int r0 = s * rows_per_split;
  const int r1 = min(L, r0 + rows_per_split);
  const long long base = (static_cast<long long>(n) * L + r0) * C;
  const int nvec = max(0, r1 - r0) * VC;
  for (int idx = tid; idx < nvec; idx += kThreads) {
    const int vc = idx % VC;
    const long long off = base + static_cast<long long>(idx / VC) * C + vc * 8;
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(x + off), v);
    uint4 packed;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float y0 = fmaf(v[2 * i], sk[vc * 8 + 2 * i], sb[vc * 8 + 2 * i]);
      float y1 = fmaf(v[2 * i + 1], sk[vc * 8 + 2 * i + 1],
                      sb[vc * 8 + 2 * i + 1]);
      if (silu) {
        y0 = y0 / (1.f + expf(-y0));
        y1 = y1 / (1.f + expf(-y1));
      }
      h[i] = __floats2bfloat162_rn(y0, y1);
    }
    *reinterpret_cast<uint4*>(out + off) = packed;
  }
}

}  // namespace
}  // namespace pandora

// C interface. x, out: contiguous (N, L, C) bf16, 16-byte aligned; w, bias:
// (C,) bf16; part: fp32 scratch of N * S * G * 3 elements. The rows of a
// sample are cut into S splits of rows_per_split rows (the last may be
// shorter); both passes run on an (S, N) grid. C % 8 == 0, C <= 8192,
// C % G == 0. Returns the first CUDA error of the two launches (0 on
// success); an unsupported shape returns cudaErrorInvalidValue.
extern "C" int pandora_group_norm_silu(const void* x, const void* w,
                                       const void* bias, void* part,
                                       void* out, int N, int L, int C, int G,
                                       int S, int rows_per_split, float eps,
                                       int silu, int dtype, void* stream) {
  using namespace pandora;
  if (dtype != kBFloat16 || N <= 0 || L <= 0 || C <= 0 || C % 8 != 0 ||
      C > 8 * kMaxStatsThreads || G <= 0 || C % G != 0 || S <= 0 ||
      rows_per_split <= 0 || static_cast<long long>(S) * rows_per_split < L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int VC = C / 8;
  const int stats_threads = VC <= kThreads ? kThreads : (VC + 31) / 32 * 32;
  const int Rt = stats_threads / VC;
  const size_t stats_smem = (2 * static_cast<size_t>(Rt) * C + Rt) *
                            sizeof(float);
  const size_t apply_smem = (2 * static_cast<size_t>(C) + 2 * G) *
                            sizeof(float);
  cudaError_t err = allow_smem(gn_stats_kernel, stats_smem);
  if (err == cudaSuccess) err = allow_smem(gn_apply_kernel, apply_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S, N);
  gn_stats_kernel<<<grid, stats_threads, stats_smem, st>>>(
      static_cast<const bf16*>(x), static_cast<float*>(part), L, C, G,
      rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_apply_kernel<<<grid, kThreads, apply_smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<const float*>(part),
      static_cast<bf16*>(out), L, C, G, rows_per_split, eps, silu);
  return static_cast<int>(cudaGetLastError());
}
