// Flash attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas kernels `_fwd_kernel_single` (:64) and `_fwd_kernel`
// (:92) in open_pandora_tpu/ops/flash_attention.py (reached through `_fwd`
// and `flash_attention`). Same function: softmax(q k^T * scale) v with fp32
// statistics, an optional causal mask aligned to the end of the key axis
// (col <= row + M - N), the ragged key edge masked, and the per-row
// natural-log log-sum-exp written beside the output for the backward kernel
// (flash_bwd.cu).
//
// Layout: q (B, N, H, D), k and v (B, M, H, D), read through their batch,
// sequence and head strides (the head dim is contiguous), so the
// projections feed the kernel without the (B, H, N, D) transposes the TPU
// version needs for its tiling. o is written contiguous (B, N, H, D), the
// LSE contiguous (B, H, N).
//
// What bounds it on the card: the two products, 4 N M D operations per
// (b, h), against 989 TFLOP/s of bf16 tensor cores; the bytes (q, k, v and
// o once each) are two orders of magnitude below that at every UNet and VAE
// shape. The design, bf16:
//   - D <= 128: `WgTile` (common.cuh), the packed kernel's tile: wgmma for
//     both products from 128-byte-swizzled shared memory, S and p in
//     registers, the online softmax on the accumulator fragments, K/V
//     through a two-stage cp.async ring.
//   - 128 < D <= 512 (the VAE's single head of 512): `flash_fwd_wide_kernel`
//     below, on mma.sync: one warp's 16 x 512 fp32 accumulator would not
//     fit its registers, so 16 warps split the 32-row q tile in two and the
//     head dim in eight slices; the partial scores meet in shared memory,
//     where p (bf16) and the per-row rescale are shared.
// Key tiles wholly above a causal diagonal are skipped when every row keeps
// a key (M >= N). fp32 runs `attn_stream` on the CUDA cores (scalar FMAs;
// no TF32), as the narrow model's 1e-4 card-against-CPU check needs.
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

// -- fp32: attn_stream ---------------------------------------------------------

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
  constexpr int kBQ = kAttnBQ;

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

template <int DMAX, int BK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int N, int M, int H, int D,
                       const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<float, BK>(D);
  auto kernel = flash_fwd_kernel<float, DMAX, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kAttnBQ - 1) / kAttnBQ, H, B);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), N, M, H, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

// -- bf16: the tensor-core tiles ---------------------------------------------

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  int N, M, H, D;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh;
  float scale_log2;  // scale * log2(e)
};

// Key tiles up to kv_end: all of M, or with a causal mask and M >= N only
// those that reach a row of the q tile [q0, q0 + bq).
template <bool kCausal>
__device__ __forceinline__ int causal_kv_end(const Args& a, int q0, int bq) {
  const int q_offset = a.M - a.N;
  return kCausal && q_offset >= 0 ? min(a.M, q0 + bq + q_offset) : a.M;
}

template <int DMAX, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, kWgMinBlocks<DMAX>)
flash_fwd_tc_kernel(const Args a) {
  using Tile = WgTile<DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile tile = Tile::carve(smem, a.D);
  const int q0 = blockIdx.x * Tile::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  tile.load_q(a.q + b * a.qsb + q0 * a.qsn + h * a.qsh, a.qsn,
              min(Tile::BQ, a.N - q0), a.D);
  float acc[Tile::DT][4], m[2], l[2];
  tile.template stream<kCausal>(
      acc, m, l, a.k + b * a.ksb + h * a.ksh, a.ksn,
      a.v + b * a.vsb + h * a.vsh, a.vsn, a.M, a.D, q0,
      causal_kv_end<kCausal>(a, q0, Tile::BQ), a.scale_log2,
      kCausal ? a.M - a.N : 0);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row >= a.N) continue;
    const float inv = l[hh] == 0.f ? 1.f : 1.f / l[hh];
    bf16* orow =
        a.o + ((static_cast<long long>(b) * a.N + row) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < Tile::DT; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < a.D)
        Elem<bf16>::store2(orow + col, acc[j][2 * hh] * inv,
                           acc[j][2 * hh + 1] * inv);
    }
    if (t == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.N + row] =
          tc_lse(m[hh], l[hh]);
  }
}

// The wide tile, 128 < D <= DMAX <= 512. 16 warps: warp w owns m16 row
// tile w / 8 of the 32-row q tile and the column slice [s SLICE,
// (s + 1) SLICE), s = w % 8, of q (its A fragments in registers) and of the
// output. Per 32-key tile: each warp's partial scores of its 16 rows over
// its slice go to shared memory (fp32); all 512 threads sum the 8 slices,
// 16 lanes per row mask them and run the online softmax (four shuffles),
// and leave p (bf16) and the row's rescale in shared memory; then every
// warp multiplies its rows of p by its slice of v. Sixteen warps, each with
// half the products of one warp over all 32 rows, hide the latency between
// the three phases. K/V: the same two-stage cp.async ring.
constexpr int kWideWarps = 16;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideSlices = 8;

// Copy rows [0, ROWS) of D <= DMAX bf16 into shared memory (pitch ld) in
// 16-byte pieces through cp.async, zero-filling rows at or past `valid`.
// D % 8 == 0, src and the row stride 16-byte aligned.
template <int ROWS, int DMAX>
__device__ __forceinline__ void load_rows16(bf16* dst, int ld, const bf16* src,
                                            long long row_stride, int valid,
                                            int D) {
  constexpr int kPieces = DMAX / 8;
  for (int idx = threadIdx.x; idx < ROWS * kPieces; idx += kWideThreads) {
    const int r = idx / kPieces;
    const int c = idx % kPieces * 8;
    if (c >= D) continue;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c, src + (ok ? r * row_stride + c : 0), ok);
  }
}

// Zero columns [D, 16 ceil(D / 16)) of `rows` rows: the k16 tail of a head
// width with D % 16 == 8. The copies never write there.
__device__ __forceinline__ void zero_tail(bf16* dst, int ld, int rows,
                                          int D) {
  if (D % 16 == 0) return;
  for (int r = threadIdx.x; r < rows; r += kWideThreads)
    *reinterpret_cast<uint4*>(dst + r * ld + D) = make_uint4(0, 0, 0, 0);
}

template <int DMAX>
struct WideTile {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int LD = DMAX + 8;               // 16 bytes of padding
  static constexpr int SLICE = DMAX / kWideSlices;  // columns per warp
  static constexpr int SKC = SLICE / 16;            // k16 chunks per slice
  static constexpr int SDT = SLICE / 8;             // n8 output tiles
  static constexpr int LDS = BK + 8;  // partial scores: 2 wavefronts a store
  static constexpr int LDP = BK + 8;  // p: 80-byte rows, ldmatrix conflict-free
  static constexpr size_t smem_bytes =
      static_cast<size_t>(BQ + 4 * BK) * LD * sizeof(bf16) +
      static_cast<size_t>(kWideSlices) * BQ * LDS * sizeof(float) +
      static_cast<size_t>(BQ) * LDP * sizeof(bf16) + 3 * BQ * sizeof(float);
};

template <int DMAX, bool kCausal>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide_kernel(const Args a) {
  using W = WideTile<DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + W::BQ * W::LD;  // two stages
  bf16* sv = sk + 2 * W::BK * W::LD;
  float* sp = reinterpret_cast<float*>(sv + 2 * W::BK * W::LD);
  bf16* sprob = reinterpret_cast<bf16*>(sp + kWideSlices * W::BQ * W::LDS);
  float* salpha = reinterpret_cast<float*>(sprob + W::BQ * W::LDP);
  float* sl = salpha + W::BQ;
  float* sm = sl + W::BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * W::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.D;
  const int M = a.M;
  const int r0 = (warp / kWideSlices) * 16;  // the warp's m16 row tile
  const int slice = warp % kWideSlices;
  const int c0 = slice * W::SLICE;
  const bool active = c0 < D;
  const int nw = min(kWideSlices, (D + W::SLICE - 1) / W::SLICE);
  const int q_offset = kCausal ? M - a.N : 0;

  zero_tail(sq, W::LD, W::BQ + 4 * W::BK, D);
  load_rows16<W::BQ, DMAX>(sq, W::LD,
                           a.q + b * a.qsb + q0 * a.qsn + h * a.qsh, a.qsn,
                           min(W::BQ, a.N - q0), D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[W::SKC][4];
  if (active) {
#pragma unroll
    for (int kc = 0; kc < W::SKC; ++kc)
      if (c0 + kc * 16 < D)
        ldsm_x4(qf[kc], sq + (r0 + (lane & 15)) * W::LD + c0 + kc * 16 +
                            (lane >> 4) * 8);
  }

  // softmax role: row sr, columns sc, sc + 1 of each key tile
  const int sr = tid >> 4;
  const int sc = (tid & 15) * 2;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[W::SDT][4];
#pragma unroll
  for (int j = 0; j < W::SDT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const bf16* kp = a.k + b * a.ksb + h * a.ksh;
  const bf16* vp = a.v + b * a.vsb + h * a.vsh;
  const int kv_end = causal_kv_end<kCausal>(a, q0, W::BQ);
  const int ntiles = (kv_end + W::BK - 1) / W::BK;
  auto issue = [&](int it) {
    const int k0 = it * W::BK;
    const int valid = min(W::BK, M - k0);
    load_rows16<W::BK, DMAX>(sk + (it & 1) * W::BK * W::LD, W::LD,
                             kp + k0 * a.ksn, a.ksn, valid, D);
    load_rows16<W::BK, DMAX>(sv + (it & 1) * W::BK * W::LD, W::LD,
                             vp + k0 * a.vsn, a.vsn, valid, D);
    cp_async_commit();
  };
  issue(0);
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; tile it - 1's stage is free
    if (it + 1 < ntiles) issue(it + 1);
    const bf16* ks = sk + (it & 1) * W::BK * W::LD;
    const bf16* vs = sv + (it & 1) * W::BK * W::LD;
    const int k0 = it * W::BK;

    // partial scores of the warp's 16 rows against the 32 keys
    if (active) {
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < W::SKC; ++kc) {
        if (c0 + kc * 16 >= D) break;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bb[4];
          ldsm_x4(bb, ks + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * W::LD +
                          c0 + kc * 16 + ((lane >> 3) & 1) * 8);
          const uint32_t b0[2] = {bb[0], bb[1]};
          const uint32_t b1[2] = {bb[2], bb[3]};
          mma_bf16(s[2 * jp], qf[kc], b0);
          mma_bf16(s[2 * jp + 1], qf[kc], b1);
        }
      }
      float* mine = sp + slice * W::BQ * W::LDS;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              mine + (r0 + g + 8 * hh) * W::LDS + j * 8 + 2 * t) =
              make_float2(s[j][2 * hh], s[j][2 * hh + 1]);
    }
    __syncthreads();

    // sum the partials, mask, online softmax; p and the rescale to shared
    {
      float x[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWideSlices; ++w) {
        if (w >= nw) break;
        const float2 v2 = *reinterpret_cast<const float2*>(
            sp + (w * W::BQ + sr) * W::LDS + sc);
        x[0] += v2.x;
        x[1] += v2.y;
      }
      const int row = q0 + sr;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = k0 + sc + i;
        x[i] *= a.scale_log2;
        if (col >= M)
          x[i] = -INFINITY;
        else if (kCausal && col > row + q_offset)
          x[i] = kMaskValue;
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);  // finite: col k0 < M
      const float alpha = ex2(m_run - m_new);
      m_run = m_new;
      const float p0 = ex2(x[0] - m_new);
      const float p1 = ex2(x[1] - m_new);
      float sum = p0 + p1;  // fp32, before the rounding for p v
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run = alpha * l_run + sum;
      *reinterpret_cast<uint32_t*>(sprob + sr * W::LDP + sc) =
          pack_bf16(p0, p1);
      if ((tid & 15) == 0) salpha[sr] = alpha;
    }
    __syncthreads();

    // acc = alpha acc + p v over the warp's rows and column slice
    if (active) {
      const float a0 = salpha[r0 + g];
      const float a1 = salpha[r0 + g + 8];
#pragma unroll
      for (int j = 0; j < W::SDT; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
      }
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t pa[4];
        ldsm_x4(pa, sprob + (r0 + (lane & 15)) * W::LDP + kc * 16 +
                        (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < W::SDT / 2; ++dp) {
          if (c0 + dp * 16 >= D) break;
          uint32_t bb[4];
          ldsm_x4<true>(bb, vs + (kc * 16 + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * W::LD +
                                c0 + dp * 16 + (lane >> 4) * 8);
          const uint32_t b0[2] = {bb[0], bb[1]};
          const uint32_t b1[2] = {bb[2], bb[3]};
          mma_bf16(acc[2 * dp], pa, b0);
          mma_bf16(acc[2 * dp + 1], pa, b1);
        }
      }
    }
  }

  if ((tid & 15) == 0) {
    sl[sr] = l_run;
    sm[sr] = m_run;
    if (q0 + sr < a.N)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.N + q0 + sr] =
          tc_lse(m_run, l_run);
  }
  __syncthreads();
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    const int row = q0 + r;
    if (row >= a.N) continue;
    const float lv = sl[r];
    const float inv = lv == 0.f ? 1.f : 1.f / lv;
    bf16* orow = a.o + ((static_cast<long long>(b) * a.N + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < W::SDT; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col < D)
        Elem<bf16>::store2(orow + col, acc[j][2 * hh] * inv,
                           acc[j][2 * hh + 1] * inv);
    }
  }
}

template <typename K>
cudaError_t launch_bf16(K* kernel, size_t smem, int bq, int threads,
                        const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + bq - 1) / bq, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t dispatch_bf16(const Args& a, int B, cudaStream_t s) {
  const int D = a.D;
  if (D <= 64)
    return launch_bf16(flash_fwd_tc_kernel<64, kCausal>,
                       WgTile<64>::smem_bytes, WgTile<64>::BQ, kWgThreads, a,
                       B, s);
  if (D <= 128)
    return launch_bf16(flash_fwd_tc_kernel<128, kCausal>,
                       WgTile<128>::smem_bytes, WgTile<128>::BQ, kWgThreads,
                       a, B, s);
  if (D <= 256)
    return launch_bf16(flash_fwd_wide_kernel<256, kCausal>,
                       WideTile<256>::smem_bytes, WideTile<256>::BQ,
                       kWideThreads, a, B, s);
  return launch_bf16(flash_fwd_wide_kernel<512, kCausal>,
                     WideTile<512>::smem_bytes, WideTile<512>::BQ,
                     kWideThreads, a, B, s);
}

}  // namespace
}  // namespace pandora

// C interface. Strides are in elements: q_st = {batch, seq, head} stride of
// q, likewise k_st and v_st; for bf16 every pointer and stride must give
// 16-byte aligned rows (cp.async). Returns cudaGetLastError() after the
// launch (0 on success); an unsupported shape returns cudaErrorInvalidValue.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(o),
                 static_cast<float*>(lse), N, M, H, D, q_sb, q_sn, q_sh,
                 k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, scale * kLog2e};
    return static_cast<int>(causal ? dispatch_bf16<true>(a, B, s)
                                   : dispatch_bf16<false>(a, B, s));
  }
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh};
  cudaError_t err;
  // key tile: 64 rows for narrow heads, fewer as the head widens so the
  // q/k/v tiles stay inside the opt-in shared memory
  if (D <= 64)
    err = launch_f32<64, 64>(q, k, v, o, lse, B, N, M, H, D, st, scale,
                             causal, s);
  else if (D <= 128)
    err = launch_f32<128, 64>(q, k, v, o, lse, B, N, M, H, D, st, scale,
                              causal, s);
  else if (D <= 256)
    err = launch_f32<256, 32>(q, k, v, o, lse, B, N, M, H, D, st, scale,
                              causal, s);
  else
    err = launch_f32<512, 16>(q, k, v, o, lse, B, N, M, H, D, st, scale,
                              causal, s);
  return static_cast<int>(err);
}
