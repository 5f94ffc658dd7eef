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
// What bounds it on the card: memory. The function reads the slab once and
// writes it once (4 bytes per element in bf16) with a few FLOP per element;
// a sample's statistics need all of its rows before its first output, so a
// design that reads the slab from device memory twice can come no closer
// than 1.5x that bound. The UNet's slabs are small (0.1-5 MB per sample of
// N = 32, 166 calls per CFG eval), so fixed costs count: launches, the wait
// for the statistics, the merge of partial moments, and per-element
// arithmetic on the way in.
//
// The centred moments avoid the E[x^2] - mu^2 form of the TPU kernel, which
// cancels badly in fp32 over slabs of millions of elements: every block
// computes exact moments of its own rows about their mean, and blocks merge
// with Chan's formula. Two launches; the wrapper's launch plan
// (ops/fused_norms.py `launch_plan`) sets their geometry:
//   pass 1  one wave of (split, sample) blocks fold their rows straight from
//           device memory, four rows (eight where C <= 256) and their
//           16-byte loads in flight per thread, each batch folded exactly
//           and merged with Chan's formula (one division a batch); the last
//           block of each sample (an atomic ticket) merges the blocks'
//           moments once and writes the per-channel scale and shift.
//   pass 2  streams the rows on a finer grid whose first blocks read, for
//           every pass-1 block, the rows it read last, while L2 may still
//           hold them.
// A one-launch design, thread-block clusters that hold a sample in shared
// memory and swap their moments through distributed shared memory, did not
// beat the two passes at the small samples it can hold and lost at larger
// ones (PERF.md, section 6).
// SiLU is x * rcp.approx(1 + ex2.approx(-x log2 e)).
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 1024;  // C up to 8192: one 8-channel column each
// Blocks of up to 384 threads (C <= 3072: every slab of the models) run
// kernels compiled for two blocks a multiprocessor (85 registers a thread),
// so pass 1's one wave of blocks is resident at once; wider ones for 64.
constexpr int kNarrowThreads = 384;

template <int kMaxT>
constexpr int kMinBlocks = kMaxT <= kNarrowThreads ? 2 : 1;

constexpr int kBatch = 4;  // rows (and 16-byte loads) in flight per thread

struct Moments {
  float n, mean, m2;
};

// The moments of the union of disjoint parts part(0 .. count), count <=
// 32 kMaxParts (Chan et al.'s formula for many parts at once), over a
// warp: each lane loads its parts first (all loads in flight), then the
// parts' counts and count-weighted means are summed, then their M2 plus
// count times squared deviation from the union's mean. Two plain warp sums,
// one division; a part with n = 0 (mean 0) adds nothing.
constexpr int kMaxParts = 8;

template <typename Part>
__device__ __forceinline__ Moments warp_combine(int count, Part part) {
  const int lane = threadIdx.x % 32;
  Moments p[kMaxParts];
#pragma unroll
  for (int u = 0; u < kMaxParts; ++u)
    p[u] = lane + 32 * u < count ? part(lane + 32 * u)
                                 : Moments{0.f, 0.f, 0.f};
  float n = 0.f, s = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxParts; ++u) {
    n += p[u].n;
    s = fmaf(p[u].n, p[u].mean, s);
  }
  n = warp_sum(n);
  const float mean = n > 0.f ? warp_sum(s) / n : 0.f;
  float m2 = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxParts; ++u) {
    const float d = p[u].mean - mean;
    m2 += fmaf(p[u].n * d, d, p[u].m2);
  }
  return {n, mean, warp_sum(m2)};
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

// A thread's moments of its 8 channels.
struct Acc8 {
  float n;
  float mean[8], m2[8];
};

// Fold the batch raw[0 .. nb) (nb rows of this thread's 8 channels, as
// loaded) into a: its exact mean and squared deviations (each row unpacked
// twice rather than held as floats), merged with Chan's formula.
template <int NB>
__device__ __forceinline__ void fold_batch(Acc8& a, const uint4 (&raw)[NB],
                                          int nb) {
  float bm[8], bm2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bm[j] = bm2[j] = 0.f;
#pragma unroll
  for (int u = 0; u < NB; ++u)
    if (u < nb) {
      float v[8];
      unpack8(raw[u], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) bm[j] += v[j];
    }
  const float inv_nb = 1.f / nb;
#pragma unroll
  for (int j = 0; j < 8; ++j) bm[j] *= inv_nb;
#pragma unroll
  for (int u = 0; u < NB; ++u)
    if (u < nb) {
      float v[8];
      unpack8(raw[u], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[j] - bm[j];
        bm2[j] = fmaf(d, d, bm2[j]);
      }
    }
  const float nn = a.n + nb;
  const float fb = nb / nn;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = bm[j] - a.mean[j];
    a.mean[j] = fmaf(d, fb, a.mean[j]);
    a.m2[j] += bm2[j] + d * d * a.n * fb;
  }
  a.n = nn;
}

// Fold rows rb, rb + step, ... (< re) of the (rows, C) slab at `base` into
// a: whole batches of KB rows with all their 16-byte loads issued before the
// first is used, then the remaining rows as one short batch.
template <int KB>
__device__ __forceinline__ void fold_rows(Acc8& a, const bf16* base, int C,
                                         int rb, int re, int step) {
  const long long stride = static_cast<long long>(step) * C;
  const bf16* p = base + static_cast<long long>(rb) * C;
  int r = rb;
  for (; r + (KB - 1) * step < re; r += KB * step) {
    uint4 raw[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u)
      raw[u] = *reinterpret_cast<const uint4*>(p + u * stride);
    p += KB * stride;
    fold_batch<KB>(a, raw, KB);
  }
  if (r < re) {
    uint4 raw[KB];
    int nb = 0;
#pragma unroll
    for (int u = 0; u < KB; ++u)
      if (r + u * step < re) {
        raw[u] = *reinterpret_cast<const uint4*>(p + u * stride);
        ++nb;
      }
    fold_batch<KB>(a, raw, nb);
  }
}

// The block's per-thread moments -> per-group moments out[grp].
// Threads are (row lane ry < Rt, 8-channel column vc); scratch holds
// Rt * (2 C + 1) floats.
__device__ __forceinline__ void block_group_moments(const Acc8& a, int C,
                                                    int G, float* scratch,
                                                    Moments* out) {
  const int VC = C / 8;
  const int Rt = blockDim.x / VC;
  const int tid = threadIdx.x;
  const int vc = tid % VC;
  const int ry = tid / VC;
  float* smean = scratch;
  float* sm2 = smean + Rt * C;
  float* scnt = sm2 + Rt * C;
  if (ry < Rt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      smean[ry * C + vc * 8 + j] = a.mean[j];
      sm2[ry * C + vc * 8 + j] = a.m2[j];
    }
    if (vc == 0) scnt[ry] = a.n;
  }
  __syncthreads();
  const int cg_ = C / G;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int grp = warp; grp < G; grp += blockDim.x / 32) {
    const Moments m = warp_combine(Rt * cg_, [&](int e) {
      const int r = e / cg_;
      const int ch = grp * cg_ + (e - r * cg_);
      return Moments{scnt[r], smean[r * C + ch], sm2[r * C + ch]};
    });
    if (lane == 0) out[grp] = m;
  }
}

__device__ __forceinline__ float silu(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + ex2(-kLog2e * y)));
  return y * r;
}

// Rows [0, rows) of the (rows, C) slab at `src`:
// y = x * scale + shift (+ SiLU) to `dst`, kBatch 16-byte pieces in flight
// per thread.
__device__ __forceinline__ void apply_rows(const bf16* src, bf16* dst,
                                           int rows, int C, const float* sk,
                                           const float* sb, int silu_on) {
  const int VC = C / 8;
  const int total = rows * VC;
  const int T = blockDim.x;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * T) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * T;
      if (idx < total) {
        const int r = idx / VC;
        raw[u] = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(r) * C + (idx - r * VC) * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * T;
      if (idx >= total) break;
      const int r = idx / VC;
      const int c0 = (idx - r * VC) * 8;
      float v[8];
      unpack8(raw[u], v);
      const float4 k0 = *reinterpret_cast<const float4*>(sk + c0);
      const float4 k1 = *reinterpret_cast<const float4*>(sk + c0 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + c0 + 4);
      const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 packed;
      uint32_t* h = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float y0 = fmaf(v[2 * i], kk[2 * i], bb[2 * i]);
        float y1 = fmaf(v[2 * i + 1], kk[2 * i + 1], bb[2 * i + 1]);
        if (silu_on) {
          y0 = silu(y0);
          y1 = silu(y1);
        }
        h[i] = pack_bf16(y0, y1);
      }
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * C + c0) =
          packed;
    }
  }
}

// Per-channel scale and shift from per-group mean and 1 / sd.
__device__ __forceinline__ void fold_affine(const bf16* w, const bf16* bias,
                                            const float* smu,
                                            const float* sinv, int C, int G,
                                            float* sk, float* sb) {
  const int cg_ = C / G;
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    const int grp = ch / cg_;
    const float k = __bfloat162float(w[ch]) * sinv[grp];
    sk[ch] = k;
    sb[ch] = __bfloat162float(bias[ch]) - smu[grp] * k;
  }
}

// Pass 1. Grid (S, N): block s of sample n folds rows
// [s per, (s + 1) per) straight from device memory (fold_rows) and writes
// their group moments to part (N, S, G); the last block of the sample to
// finish (ticket[n], zero before the launch) merges the S partials with
// Chan's formula and writes ss (N, C, 2): scale and shift per channel.
template <int kMaxT, int KB>
__global__ void __launch_bounds__(kMaxT, kMinBlocks<kMaxT>)
gn_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, Moments* __restrict__ part,
                float* __restrict__ ss, int* __restrict__ ticket, int L,
                int C, int G, int per, float eps) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  const int n = blockIdx.y;
  const int s = blockIdx.x;
  const int S = gridDim.x;
  const int Rt = blockDim.x / (C / 8);
  const int tid = threadIdx.x;
  const int r0 = min(L, s * per);
  const int rows = min(L, r0 + per) - r0;
  {
    Acc8 acc;
    acc.n = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc.mean[j] = acc.m2[j] = 0.f;
    const int VC = C / 8;
    if (tid / VC < Rt)
      fold_rows<KB>(acc,
                x + (static_cast<long long>(n) * L + r0) * C + (tid % VC) * 8,
                C, tid / VC, rows, Rt);
    block_group_moments(acc, C, G, sm,
                        part + (static_cast<long long>(n) * S + s) * G);
  }

  __syncthreads();
  if (tid == 0) {
    // release: the block's moments (written before the barrier) visible
    // with the ticket; acquire: the last block sees every block's
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(ticket + n)
                 : "memory");
    last = prev == S - 1;
  }
  __syncthreads();
  if (!last) return;
  float* smu = sm;
  float* sinv = smu + G;
  float* sk = sinv + G;
  float* sb = sk + C;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const Moments* all = part + static_cast<long long>(n) * S * G;
  for (int grp = warp; grp < G; grp += blockDim.x / 32) {
    const Moments m = warp_combine(S, [&](int e) {
      const float* p = reinterpret_cast<const float*>(all + e * G + grp);
      return Moments{__ldcg(p), __ldcg(p + 1), __ldcg(p + 2)};
    });
    if (lane == 0) {
      smu[grp] = m.mean;
      sinv[grp] = 1.f / sqrtf(m.m2 / m.n + eps);
    }
  }
  __syncthreads();
  fold_affine(w, bias, smu, sinv, C, G, sk, sb);
  __syncthreads();
  for (int ch = tid; ch < C; ch += blockDim.x) {
    ss[(static_cast<long long>(n) * C + ch) * 2] = sk[ch];
    ss[(static_cast<long long>(n) * C + ch) * 2 + 1] = sb[ch];
  }
}

// Pass 2. Grid (S N, Q): pass 1's block (s, n) rows cut
// into Q chunks of `cper` rows; block (j, y) takes chunk Q - 1 - y of pass
// 1's block j (s = j % S, n = j / S), so the first blocks scheduled read the
// rows every pass-1 block read last, which L2 may still hold.
template <int kMaxT>
__global__ void __launch_bounds__(kMaxT, kMinBlocks<kMaxT>)
gn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ ss,
                bf16* __restrict__ out, int L, int C, int S, int per,
                int cper, int silu_on) {
  extern __shared__ __align__(16) float sm[];
  float* sk = sm;
  float* sb = sk + C;
  const int n = blockIdx.x / S;
  const int s = blockIdx.x - n * S;
  const int q = gridDim.y - 1 - blockIdx.y;
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    const float* v = ss + (static_cast<long long>(n) * C + ch) * 2;
    sk[ch] = v[0];
    sb[ch] = v[1];
  }
  __syncthreads();
  const int r0 = min(L, s * per + q * cper);
  const int r1 = min(min(L, (s + 1) * per), r0 + cper);
  const long long off = (static_cast<long long>(n) * L + r0) * C;
  apply_rows(x + off, out + off, max(0, r1 - r0), C, sk, sb, silu_on);
}

// Shared memory of a pass-1 block: the block merge's per-thread moments,
// or (the sample's last block) mean and 1 / sd, scale and shift.
size_t stats_smem_bytes(size_t Rt, int C, int G) {
  const size_t merge = Rt * (2 * C + 1);
  const size_t last = 2 * static_cast<size_t>(G) + 2 * C;
  return (merge > last ? merge : last) * sizeof(float);
}

}  // namespace
}  // namespace pandora

// C interface. x, out: contiguous (N, L, C) bf16, 16-byte aligned; w, bias:
// (C,) bf16. C % 8 == 0, C <= 8192, C % G == 0; `threads` (a multiple of
// 32, at most 1024) holds at least C / 8 threads, one per 8-channel column,
// and at most 256 (row lane, channel) pairs a group. Pass 1 runs on grid
// (splits, N), splits * per >= L, splits <= 256; pass 2 on grid
// (splits N, chunks), each pass-1 block's rows in `chunks` chunks of
// chunk_rows, chunks * chunk_rows >= per. scratch: 16-byte aligned, at
// least N * splits * G * 3 + N * C * 2 floats and then N ints (the
// tickets, zeroed here on the stream before pass 1).
// Returns the first CUDA error of the launches (0 on success); an
// unsupported shape or plan returns cudaErrorInvalidValue.
extern "C" int pandora_group_norm_silu(
    const void* x, const void* w, const void* bias, void* scratch, void* out,
    int N, int L, int C, int G, int per, int threads, int splits,
    int chunk_rows, int chunks, float eps, int silu, int dtype,
    void* stream) {
  using namespace pandora;
  if (dtype != kBFloat16 || N <= 0 || L <= 0 || C <= 0 || C % 8 != 0 ||
      C > 8 * kMaxThreads || G <= 0 || C % G != 0 || per <= 0 ||
      threads % 32 != 0 || threads > kMaxThreads || threads < C / 8 ||
      splits <= 0 || static_cast<long long>(splits) * per < L ||
      chunks <= 0 || chunk_rows <= 0 ||
      static_cast<long long>(chunks) * chunk_rows < per)
    return static_cast<int>(cudaErrorInvalidValue);
  // warp_combine takes at most 32 kMaxParts parts: a block's row lanes
  // times a group's channels, and pass 1's blocks of a sample
  if (threads / (C / 8) * (C / G) > 32 * kMaxParts ||
      splits > 32 * kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = threads <= kNarrowThreads;
  const size_t Rt_ = static_cast<size_t>(threads / (C / 8));
  const size_t stats_smem = stats_smem_bytes(Rt_, C, G);
  const size_t apply_smem = 2 * static_cast<size_t>(C) * sizeof(float);
  // eight rows in flight where a row is short (C <= 256: the VAE), four
  // elsewhere, where more cost registers and bought nothing
  auto stats = C <= 256 ? (narrow ? gn_stats_kernel<kNarrowThreads, 8>
                                  : gn_stats_kernel<kMaxThreads, 8>)
                        : (narrow ? gn_stats_kernel<kNarrowThreads, 4>
                                  : gn_stats_kernel<kMaxThreads, 4>);
  auto apply = narrow ? gn_apply_kernel<kNarrowThreads>
                      : gn_apply_kernel<kMaxThreads>;
  cudaError_t err = allow_smem(stats, stats_smem);
  if (err == cudaSuccess) err = allow_smem(apply, apply_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Moments* part = static_cast<Moments*>(scratch);
  float* ss = reinterpret_cast<float*>(part +
                                       static_cast<long long>(N) * splits * G);
  int* ticket = reinterpret_cast<int*>(ss + static_cast<long long>(N) * C * 2);
  err = cudaMemsetAsync(ticket, 0, static_cast<size_t>(N) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, N);
  stats<<<grid, threads, stats_smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), part, ss, ticket, L, C, G, per, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply<<<dim3(splits * N, chunks), threads, apply_smem, st>>>(
      static_cast<const bf16*>(x), ss, static_cast<bf16*>(out), L, C, splits,
      per, chunk_rows, silu);
  return static_cast<int>(cudaGetLastError());
}
