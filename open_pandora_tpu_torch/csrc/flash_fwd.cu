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
// (b, h), against 989 TFLOP/s of bf16 tensor cores, and for fp32 against
// the split-TF32 rate (495 TFLOP/s of TF32, three products for each: 165);
// the bytes (q, k, v and o once each) are one to two orders of magnitude
// below that at every UNet and VAE shape. The design, bf16:
//   - D <= 128: `WgTile` (common.cuh), the packed kernel's tile: wgmma for
//     both products from 128-byte-swizzled shared memory, S and p in
//     registers, the online softmax on the accumulator fragments, K/V
//     through a two-stage cp.async ring.
//   - 128 < D <= 512 (the VAE's single head of 512): `flash_fwd_wide_kernel`
//     below, on mma.sync: one warp's 16 x 512 fp32 accumulator would not
//     fit its registers, so 16 warps split the 32-row q tile in two and the
//     head dim in eight slices; the partial scores meet in shared memory,
//     where p (bf16) and the per-row rescale are shared.
// fp32 runs every product on the tensor cores as split TF32 (common.cuh:
// each operand as a TF32 hi part and the TF32 rounding of its remainder,
// three mma.sync m16n8k8 products per product, fp32 accumulation, fresh
// partials added on the CUDA cores), which keeps fp32-grade error at up to
// a third of the card's mma.sync TF32 rate:
//   - D <= 128: `flash_fwd_f32_kernel`, four warps of two (D <= 64) or one
//     m16 row tiles over a two-stage ring of K/V tiles; S, the softmax (the
//     bf16 tile's `tc_softmax`) and p stay in accumulator fragments, and p
//     feeds p v as the A operand with its k slots taken in the
//     accumulator's column order (no shuffles; v's B rows in the same
//     order).
//   - 128 < D <= 512: `flash_fwd_f32_wide_kernel`, the wide tile's split of
//     the head dim over 16 warps, in fp32, over 16-key tiles (each fp32
//     tile is twice the bf16 bytes).
//   The tiles stay fp32 in shared memory (a row pitch of D + 4 floats makes
//   every fragment load conflict-free) and are split in registers as they
//   are loaded; rows come in by 16-byte cp.async where every pointer and
//   stride allows it, else by 4-byte copies. A kFull instance (D equal to
//   the tile's DMAX) folds every check against D.
// Key tiles wholly above a causal diagonal are skipped when every row keeps
// a key (M >= N).
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

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
__device__ __forceinline__ int causal_kv_end(int N, int M, int q0, int bq) {
  const int q_offset = M - N;
  return kCausal && q_offset >= 0 ? min(M, q0 + bq + q_offset) : M;
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
      causal_kv_end<kCausal>(a.N, a.M, q0, Tile::BQ), a.scale_log2,
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
  const int kv_end = causal_kv_end<kCausal>(a.N, a.M, q0, W::BQ);
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

// -- fp32: split-TF32 tiles on mma.sync ---------------------------------------

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int N, M, H, D;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh;
  float scale_log2;  // scale * log2(e)
  bool vec;          // every row 16-byte aligned: 16-byte copies
};

// Write rows g and g + 8 of a warp's unnormalised (16, D) accumulator,
// divided by the quad-reduced row sums l, and their natural-log LSE. rbase:
// the sequence index of row g; c0: the first column of acc.
template <int DT>
__device__ __forceinline__ void store_o_f32(const F32Args& a, int b, int h,
                                            int rbase, int c0,
                                            const float (&acc)[DT][4],
                                            const float (&l)[2],
                                            const float (&m)[2],
                                            bool write_lse) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rbase + 8 * hh;
    if (row >= a.N) continue;
    const float inv = l[hh] == 0.f ? 1.f : 1.f / l[hh];
    float* orow =
        a.o + ((static_cast<long long>(b) * a.N + row) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col < a.D)
        Elem<float>::store2(orow + col, acc[j][2 * hh] * inv,
                            acc[j][2 * hh + 1] * inv);
    }
    if (write_lse && t == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.N + row] =
          tc_lse(m[hh], l[hh]);
  }
}

// D <= DMAX <= 128. Four warps of MT m16 row tiles each (the block's q
// tile is 64 MT rows); K and V tiles of BK keys stream through a two-stage
// cp.async ring. Per key tile a warp forms S = q k^T (A from the q tile, B
// from the k tile, split as they are loaded) in accumulator fragments, runs
// the online softmax on them (`tc_softmax`, the bf16 tile's) and adds p v
// with A taken straight from the p fragments (`acc_a`) and B from the v
// tile (`ldb_kmajor`), through a fresh partial per key tile (`acc_pv`). At
// D <= 64 a warp holds two row tiles, so that every split k or v fragment
// feeds two products, over 64-key tiles (245 registers, one block an SM:
// faster than one row tile with two or three blocks an SM, or 32-key
// tiles); at D <= 128, one row tile and 32-key tiles (two blocks an SM).
template <int DMAX>
struct F32Tile {
  static constexpr int kThreads = 128;
  static constexpr int MT = DMAX <= 64 ? 2 : 1;  // m16 tiles a warp
  static constexpr int BQ = 64 * MT;
  static constexpr int BK = DMAX <= 64 ? 64 : 32;
  static constexpr int LD = DMAX + 4;
  static constexpr int NT = BK / 8;    // n8 tiles of a key tile
  static constexpr int DT = DMAX / 8;  // k8 chunks / n8 tiles of the head
  // q, then two stages of k and v
  static constexpr size_t smem_bytes =
      static_cast<size_t>(BQ + 4 * BK) * LD * sizeof(float);
};

template <int DMAX, bool kCausal, bool kFull>
__global__ void __launch_bounds__(F32Tile<DMAX>::kThreads)
flash_fwd_f32_kernel(const F32Args a) {
  using T = F32Tile<DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + T::BQ * T::LD;  // stage s: k at sk + 2 s BK LD, v after
  const int q0 = blockIdx.x * T::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x & 31) >> 2;
  const int D = kFull ? DMAX : a.D;  // kFull: D == DMAX, the checks fold
  const int M = a.M;
  const float* kp = a.k + b * a.ksb + h * a.ksh;
  const float* vp = a.v + b * a.vsb + h * a.vsh;

  f32_load_rows<T::BQ, DMAX, T::kThreads>(
      sq, T::LD, a.q + b * a.qsb + q0 * a.qsn + h * a.qsh, a.qsn,
      min(T::BQ, a.N - q0), D, a.vec);
  const int kv_end = causal_kv_end<kCausal>(a.N, M, q0, T::BQ);
  const int ntiles = (kv_end + T::BK - 1) / T::BK;
  auto issue = [&](int it) {
    const int k0 = it * T::BK;
    const int valid = min(T::BK, M - k0);
    float* st = sk + (it & 1) * 2 * T::BK * T::LD;
    f32_load_rows<T::BK, DMAX, T::kThreads>(st, T::LD, kp + k0 * a.ksn,
                                            a.ksn, valid, D, a.vec);
    f32_load_rows<T::BK, DMAX, T::kThreads>(st + T::BK * T::LD, T::LD,
                                            vp + k0 * a.vsn, a.vsn, valid, D,
                                            a.vec);
    cp_async_commit();
  };

  float acc[T::MT][T::DT][4], m[T::MT][2], l[T::MT][2];
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < T::DT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  issue(0);  // one group with q
  const int row0 = q0 + warp * 16 * T::MT;  // the warp's first row
  const float* qw = sq + (row0 - q0) * T::LD;
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and q) landed; tile it - 1's stage is free
    if (it + 1 < ntiles) issue(it + 1);
    const float* ks = sk + (it & 1) * 2 * T::BK * T::LD;
    const float* vs = ks + T::BK * T::LD;

    float s[T::MT][T::NT][4];
    scores_3xtf32<T::MT, T::NT, T::DT>(s, qw, ks, T::LD, D);
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
      tc_softmax<T::NT, T::DT, kCausal>(s[i], acc[i], m[i], l[i], it * T::BK,
                                        M, row0 + 16 * i + g,
                                        kCausal ? M - a.N : 0, a.scale_log2);
    acc_pv<T::MT, T::NT, T::DT>(acc, s, vs, T::LD, D);
  }
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[i][hh] += __shfl_xor_sync(0xffffffffu, l[i][hh], 1);
      l[i][hh] += __shfl_xor_sync(0xffffffffu, l[i][hh], 2);
    }
    store_o_f32<T::DT>(a, b, h, row0 + 16 * i + g, 0, acc[i], l[i], m[i],
                       true);
  }
}

// 128 < D <= DMAX <= 512 (the VAE's single head of 512): the bf16 wide
// tile's split of the head dim, in fp32, 16 warps over a 32-row q tile and
// 16-key tiles. The scores: warp w owns m16 row tile w / 8 and the column
// slice [s SLICE, (s + 1) SLICE), s = w % 8, of q, and writes its partial
// scores over its slice to shared memory. The softmax: all 512 threads
// sum the 8 slices, one score each, run the online softmax (16 lanes a
// row, four shuffles) and leave p (fp32) and the row's rescale in shared
// memory. p v: warp w owns half (w / 8) of slice s of the output, for both
// row tiles, so that every split v fragment feeds two row tiles. What the
// design answers:
//   - Shared memory (226 KB at DMAX = 512): q (66 KB) and a two-stage ring
//     of k and v tiles (132 KB), so that a tile's copy has the whole
//     previous tile to land; one slot each for k and v, beside q split
//     once into TF32 hi and lo tiles, left the copies half a tile and
//     was no faster.
//   - Registers: a 512-thread block has 128 a thread; q's fragments held
//     in registers spilled, and 8 warps of 32 rows (255 registers) left
//     too few warps to hide the latency of the phases.
//   - Latency: a warp's scores are two n8 tiles deep only, so the three
//     split products go to three accumulators (six chains of eight
//     mma.sync, not two of twenty-four), summed in fp32 at the end.
//   - A warp whose rows all keep their maximum skips the rescale of its
//     output.
// The tile moves about 260 KB through shared memory per 16-key tile (q
// read by every warp, k by two, the k and v copies), 2.7 times the narrow
// tile's bytes per operation; bulk copies (cp.async.bulk) of k and v ran
// no faster than 16-byte cp.async.
template <int DMAX>
struct F32Wide {
  static constexpr int BQ = 32;
  static constexpr int BK = 16;
  static constexpr int MT = BQ / 16;                // m16 row tiles
  static constexpr int SLICE = DMAX / kWideSlices;  // columns per warp
  static constexpr int SDT = SLICE / 8;  // k8 chunks / n8 tiles of a slice
  static constexpr int HDT = SDT / 2;    // n8 tiles of a half slice
  static constexpr int LD = DMAX + 4;
  static constexpr int LDS = BK + 8;  // partial scores: float2 stores
  static constexpr int LDP = BK + 8;  // p: float2 loads
  // q, two stages of k and v, the partial scores, p, the row statistics
  static constexpr size_t smem_bytes =
      (static_cast<size_t>(BQ + 4 * BK) * LD + kWideSlices * BQ * LDS +
       BQ * LDP + 3 * BQ) * sizeof(float);
};

template <int DMAX, bool kCausal, bool kFull>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_f32_wide_kernel(const F32Args a) {
  using W = F32Wide<DMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + W::BQ * W::LD;  // stage s: k at sk + 2 s BK LD, v after
  float* sp = sk + 4 * W::BK * W::LD;
  float* sprob = sp + kWideSlices * W::BQ * W::LDS;
  float* salpha = sprob + W::BQ * W::LDP;
  float* sl = salpha + W::BQ;
  float* sm = sl + W::BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int q0 = blockIdx.x * W::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = kFull ? DMAX : a.D;  // kFull: D == DMAX, the checks fold
  const int M = a.M;
  const int half = warp / kWideSlices;  // scores: the m16 row tile
  const int r0 = half * 16;
  const int slice = warp % kWideSlices;
  const int c0 = slice * W::SLICE;
  const bool active = c0 < D;
  const int dslice = min(W::SLICE, D - c0);  // the slice's columns
  const int ch = c0 + half * (W::SLICE / 2);  // p v: the half slice
  const int dhalf = min(W::SLICE / 2, D - ch);
  const bool active_pv = dhalf > 0;
  const int nw = min(kWideSlices, (D + W::SLICE - 1) / W::SLICE);
  const int q_offset = kCausal ? M - a.N : 0;
  const float* kp = a.k + b * a.ksb + h * a.ksh;
  const float* vp = a.v + b * a.vsb + h * a.vsh;
  const int kv_end = causal_kv_end<kCausal>(a.N, M, q0, W::BQ);
  const int ntiles = (kv_end + W::BK - 1) / W::BK;
  auto issue = [&](int it) {
    const int k0 = it * W::BK;
    const int valid = min(W::BK, M - k0);
    float* st = sk + (it & 1) * 2 * W::BK * W::LD;
    f32_load_rows<W::BK, DMAX, kWideThreads>(st, W::LD, kp + k0 * a.ksn,
                                             a.ksn, valid, D, a.vec);
    f32_load_rows<W::BK, DMAX, kWideThreads>(st + W::BK * W::LD, W::LD,
                                             vp + k0 * a.vsn, a.vsn, valid, D,
                                             a.vec);
    cp_async_commit();
  };

  f32_load_rows<W::BQ, DMAX, kWideThreads>(
      sq, W::LD, a.q + b * a.qsb + q0 * a.qsn + h * a.qsh, a.qsn,
      min(W::BQ, a.N - q0), D, a.vec);
  issue(0);  // one group with q

  // softmax role: row sr, column sc of each key tile
  const int sr = tid >> 4;
  const int sc = tid & 15;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[W::MT][W::HDT][4];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::HDT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it (and q) landed; tile it - 1's stage is free
    if (it + 1 < ntiles) issue(it + 1);
    const float* ks = sk + (it & 1) * 2 * W::BK * W::LD;
    const float* vs = ks + W::BK * W::LD;
    const int k0 = it * W::BK;

    // partial scores of the warp's 16 rows against the 16 keys over its
    // slice: lo_q hi_k, hi_q lo_k and hi_q hi_k in three accumulators
    if (active) {
      float s3[3][2][4];
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s3[u][j][0] = s3[u][j][1] = s3[u][j][2] = s3[u][j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < W::SDT; ++kc) {
        if (kc * 8 >= dslice) break;
        const FragA qa = lda_rows(sq + r0 * W::LD + c0 + kc * 8, W::LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const FragB kb =
              ldb_nmajor(ks + j * 8 * W::LD + c0 + kc * 8, W::LD);
          mma_tf32(s3[0][j], qa.lo, kb.hi);
          mma_tf32(s3[1][j], qa.hi, kb.lo);
          mma_tf32(s3[2][j], qa.hi, kb.hi);
        }
      }
      float* mine = sp + slice * W::BQ * W::LDS;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              mine + (r0 + g + 8 * hh) * W::LDS + j * 8 + 2 * t) =
              make_float2(s3[2][j][2 * hh] +
                              (s3[0][j][2 * hh] + s3[1][j][2 * hh]),
                          s3[2][j][2 * hh + 1] +
                              (s3[0][j][2 * hh + 1] + s3[1][j][2 * hh + 1]));
    }
    __syncthreads();

    // sum the partials, mask, online softmax; p and the rescale to shared
    {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kWideSlices; ++w) {
        if (w >= nw) break;
        x += sp[(w * W::BQ + sr) * W::LDS + sc];
      }
      const int col = k0 + sc;
      x *= a.scale_log2;
      if (col >= M)
        x = -INFINITY;
      else if (kCausal && col > q0 + sr + q_offset)
        x = kMaskValue;
      float mx = x;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);  // finite: col k0 < M
      const float alpha = ex2(m_run - m_new);
      m_run = m_new;
      const float p = ex2(x - m_new);
      float sum = p;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run = alpha * l_run + sum;
      sprob[sr * W::LDP + sc] = p;
      if (sc == 0) salpha[sr] = alpha;
    }
    __syncthreads();

    // acc = alpha acc + p v over both row tiles and the warp's half slice
    if (active_pv) {
      float al[W::MT][2];
      bool rescale = false;
#pragma unroll
      for (int i = 0; i < W::MT; ++i) {
        al[i][0] = salpha[16 * i + g];
        al[i][1] = salpha[16 * i + g + 8];
        rescale |= al[i][0] != 1.f || al[i][1] != 1.f;
      }
      if (__any_sync(0xffffffffu, rescale)) {
#pragma unroll
        for (int i = 0; i < W::MT; ++i)
#pragma unroll
          for (int j = 0; j < W::HDT; ++j) {
            acc[i][j][0] *= al[i][0];
            acc[i][j][1] *= al[i][0];
            acc[i][j][2] *= al[i][1];
            acc[i][j][3] *= al[i][1];
          }
      }
      // p in the accumulator layout of its two n8 key tiles
      float pf[W::MT][W::BK / 8][4];
#pragma unroll
      for (int i = 0; i < W::MT; ++i)
#pragma unroll
        for (int kc = 0; kc < W::BK / 8; ++kc) {
          const float2 pg = *reinterpret_cast<const float2*>(
              sprob + (16 * i + g) * W::LDP + kc * 8 + 2 * t);
          const float2 pg8 = *reinterpret_cast<const float2*>(
              sprob + (16 * i + g + 8) * W::LDP + kc * 8 + 2 * t);
          pf[i][kc][0] = pg.x;
          pf[i][kc][1] = pg.y;
          pf[i][kc][2] = pg8.x;
          pf[i][kc][3] = pg8.y;
        }
      acc_pv<W::MT, W::BK / 8, W::HDT>(acc, pf, vs + ch, W::LD, dhalf);
    }
  }

  if (sc == 0) {
    sl[sr] = l_run;
    sm[sr] = m_run;
    if (q0 + sr < a.N)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.N + q0 + sr] =
          tc_lse(m_run, l_run);
  }
  __syncthreads();
  if (!active_pv) return;
#pragma unroll
  for (int i = 0; i < W::MT; ++i) {
    const float l2[2] = {sl[16 * i + g], sl[16 * i + g + 8]};
    const float m2[2] = {sm[16 * i + g], sm[16 * i + g + 8]};
    store_o_f32<W::HDT>(a, b, h, q0 + 16 * i + g, ch, acc[i], l2, m2,
                        false);
  }
}

template <typename K>
cudaError_t launch_f32(K* kernel, size_t smem, int bq, int threads,
                       const F32Args& a, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + bq - 1) / bq, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The kernel at DMAX, its kFull instance where D == DMAX.
template <int DMAX, bool kCausal, bool kWide>
cudaError_t launch_f32_tile(const F32Args& a, int B, cudaStream_t s) {
  if constexpr (kWide) {
    using W = F32Wide<DMAX>;
    return a.D == DMAX
               ? launch_f32(flash_fwd_f32_wide_kernel<DMAX, kCausal, true>,
                            W::smem_bytes, W::BQ, kWideThreads, a, B, s)
               : launch_f32(flash_fwd_f32_wide_kernel<DMAX, kCausal, false>,
                            W::smem_bytes, W::BQ, kWideThreads, a, B, s);
  } else {
    using T = F32Tile<DMAX>;
    return a.D == DMAX
               ? launch_f32(flash_fwd_f32_kernel<DMAX, kCausal, true>,
                            T::smem_bytes, T::BQ, T::kThreads, a, B, s)
               : launch_f32(flash_fwd_f32_kernel<DMAX, kCausal, false>,
                            T::smem_bytes, T::BQ, T::kThreads, a, B, s);
  }
}

template <bool kCausal>
cudaError_t dispatch_f32(const F32Args& a, int B, cudaStream_t s) {
  const int D = a.D;
  if (D <= 64) return launch_f32_tile<64, kCausal, false>(a, B, s);
  if (D <= 128) return launch_f32_tile<128, kCausal, false>(a, B, s);
  if (D <= 256) return launch_f32_tile<256, kCausal, true>(a, B, s);
  return launch_f32_tile<512, kCausal, true>(a, B, s);
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
  const void* const ptrs[3] = {q, k, v};
  const long long st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh};
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  static_cast<float*>(lse), N, M, H, D, q_sb, q_sn, q_sh,
                  k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, scale * kLog2e,
                  rows_aligned16(ptrs, st, 4)};
  return static_cast<int>(causal ? dispatch_f32<true>(a, B, s)
                                 : dispatch_f32<false>(a, B, s));
}
