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
// residual in fp32; one cast at the end. gelu's erf: bf16 uses the TPU
// kernel's own approximation (below), fp32 the exact erff.
//
// What bounds it on the card: the two products, 24 R c^2 operations at
// inner = 4c, at 989 TFLOP/s of bf16 tensor cores (0.204 ms at R = 81920,
// c = 320); the bytes of x and out are a tenth of that. The TPU kernel's
// one-kernel structure, whose blocks re-read every weight for a few rows
// and keep all their gated rows on chip, lost to the library on both
// machines. bf16 runs three kernels instead:
//   geglu_ln_kernel   LN(x) into a bf16 workspace xn (R, c), one warp a row
//                     held in its registers: 4 R c bytes.
//   geglu_gemm_kernel<true, 256>   h = v * gelu(g) (R, inner, bf16): xn W1,
//                     tiles of 128 rows by 128 value columns and the same
//                     128 gate columns, one m64n256 accumulator per
//                     warpgroup (value in its first half, gate in its
//                     second), the GEGLU epilogue in fp32 on the
//                     accumulator.
//   geglu_gemm_kernel<false, BN>   out = x + h W2 + b2: tiles of 128 rows by
//                     BN = 256 output columns where c % 256 == 0, else 128
//                     (c = 320: three tiles, the last half past c, whose
//                     weight boxes the TMA fills with zeros).
// h is the same bf16 value the TPU kernel makes; its round trip through
// device memory, 16 R c bytes, is a little over half the product bound at
// 3.35 TB/s, and overlaps the products. Both GEMMs are one persistent,
// warp-specialised kernel: one producer thread streams, per tile, the A
// rows (128 x 64, K-major) and the B columns (64 x BN, MN-major: W1 and W2
// are row-major, so wgmma reads them transposed) by TMA into a ring of 3-6
// slots with mbarriers; two consumer warpgroups each multiply their 64 rows
// against the whole slot, keep one slot's products in flight while the
// next slot's wait, and release each slot as its products finish. The
// producer runs ahead across tiles, so the next tile's slots load during
// an epilogue. What the epilogue reads is requested before the products
// (the tile's biases; the residual rows, by cp.async into the warpgroup's
// output tile), and it writes the tile once to shared memory (16-byte
// chunks swizzled by row) and then to device memory in 16-byte pieces.
// setmaxnreg moves registers from the producer warpgroup to the consumers
// (232 each), whose 128 accumulators otherwise leave the GEGLU epilogue no
// room to overlap its gelus. The epilogue is not overlapped with the
// products: at c = 320 (five k64 slots a tile) it costs about as much as
// the products (PERF.md, section 6).
// fp32 takes a scalar-FMA kernel whose blocks hold 8, 4 or 2 rows and their
// gated rows in shared memory, with the exact erf.
#include "common.cuh"
#include "tma.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                   // the LN and fp32 kernels
constexpr int kMaxC = 4096;                     // bf16: the LN's registers
constexpr int kConsumers = 256;                 // two consumer warpgroups
constexpr int kGemmThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: 2 x 232 + 40 = 3 x 168, the share
// each of the 384 threads starts with
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kBM = 128;                       // rows of a tile
constexpr int kBK = 64;                        // depth of a ring slot
constexpr int kBox = 64 * 128;                 // a 64 x 64 bf16 TMA box
constexpr int kMaxStages = 8;
constexpr size_t kSmemLimit = 232448;

// gelu(g) = g (1 + erf(g / sqrt 2)) / 2 with the TPU kernel's own erf,
// Abramowitz and Stegun 7.1.26: erf(x) = sign(x) (1 - P(t) exp(-x^2)),
// t = 1 / (1 + p |x|), |error| <= 1.5e-7, far below the bf16 rounding of
// h. Written as relu(g) - |g| P(t) exp(-g^2 / 2) / 2 (the same function:
// g (1 + sign(g)) / 2 = relu(g)), with 1 / sqrt 2 and the 1 / 2 folded
// into p and P's coefficients, on a fast reciprocal and exp2: erff with an
// IEEE division per element was far slower in the up-projection's
// epilogue on the card.
__device__ __forceinline__ float gelu_erf(float g) {
  const float ag = fabsf(g);
  // p / sqrt 2, and A&S's a1..a5 halved
  const float t = __fdividef(1.f, fmaf(0.23164189715f, ag, 1.f));
  const float half_poly =
      ((((0.5307027145f * t - 0.7265760135f) * t + 0.7107068705f) * t -
        0.142248368f) * t + 0.127414796f) * t;
  // exp(-g^2 / 2) = 2^(-g^2 log2(e) / 2)
  const float e = ex2(g * g * (-0.5f * kLog2e));
  return fmaf(-ag * half_poly, e, fmaxf(g, 0.f));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// LN of each row of x into xn, one warp a row: fp32 mean and centred
// variance, (x - mu) * rsqrt(var + eps) * w + b in fp32, one cast. c % 8 ==
// 0 and c <= 256 P: lane l holds the row's 16-byte pieces l, l + 32, ... in
// registers, so x is read once.
template <int P>
__global__ void __launch_bounds__(kThreads)
geglu_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ b, bf16* __restrict__ xn, int R,
                int c, float eps) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const uint4* src =
      reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * c);
  uint4* dst = reinterpret_cast<uint4*>(xn + static_cast<long long>(row) * c);
  const int pieces = c / 8;
  uint4 raw[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (lane + 32 * i < pieces) raw[i] = src[lane + 32 * i];
  float v[8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (lane + 32 * i >= pieces) break;
    unpack8(raw[i], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  }
  const float mu = warp_sum(sum) / c;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (lane + 32 * i >= pieces) break;
    unpack8(raw[i], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq += (v[e] - mu) * (v[e] - mu);
  }
  const float inv = rsqrtf(warp_sum(sq) / c + eps);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = lane + 32 * i;
    if (p >= pieces) break;
    float gw[8], gb[8];
    unpack8(raw[i], v);
    unpack8(reinterpret_cast<const uint4*>(w)[p], gw);
    unpack8(reinterpret_cast<const uint4*>(b)[p], gb);
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ow[e] = pack_bf16((v[2 * e] - mu) * inv * gw[2 * e] + gb[2 * e],
                        (v[2 * e + 1] - mu) * inv * gw[2 * e + 1] +
                            gb[2 * e + 1]);
    dst[p] = o;
  }
}

template <int P>
cudaError_t launch_ln(const bf16* x, const bf16* w, const bf16* b, bf16* xn,
                      int R, int c, float eps, cudaStream_t stream) {
  geglu_ln_kernel<P><<<(R + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                       0, stream>>>(x, w, b, xn, R, c, eps);
  return cudaGetLastError();
}

cudaError_t dispatch_ln(const bf16* x, const bf16* w, const bf16* b,
                        bf16* xn, int R, int c, float eps,
                        cudaStream_t stream) {
  if (c <= 256) return launch_ln<1>(x, w, b, xn, R, c, eps, stream);
  if (c <= 512) return launch_ln<2>(x, w, b, xn, R, c, eps, stream);
  if (c <= 1024) return launch_ln<4>(x, w, b, xn, R, c, eps, stream);
  if (c <= 2048) return launch_ln<8>(x, w, b, xn, R, c, eps, stream);
  if (c <= kMaxC) return launch_ln<16>(x, w, b, xn, R, c, eps, stream);
  return cudaErrorInvalidValue;
}

struct GemmArgs {
  const bf16* bias;  // b1 (2 inner) or b2 (c)
  const bf16* x;     // the residual (R, c); the down-projection only
  bf16* out;         // h (R, inner) or out (R, c)
  int R, N, K;       // rows; output columns (inner or c); depth (c or inner)
  int tiles_n;       // column tiles of a row block
  int stages;
};

struct Maps {
  CUtensorMap a, b;  // xn or h (K-major boxes 64 x 128); W1 or W2 (64 x 64)
};

template <int BN>
__device__ __forceinline__ void mma_mn(float (&d)[BN / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (BN == 128)
    wgmma_ss_n128_mn(d, a, b, scale_d);
  else
    wgmma_ss_n256_mn(d, a, b, scale_d);
}

// Bytes of a warpgroup's output tile (64 rows of bf16) and of the block's
// small per-call data: the up-projection's tile biases (256 value and gate
// values per warpgroup), the down-projection's b2 (c values).
template <bool kGate, int BN>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * (kGate ? BN / 2 : BN) * 2;
}
__host__ __device__ inline size_t extra_bytes(bool gate, int c) {
  return gate ? 2 * 256 * 2 : (static_cast<size_t>(c) * 2 + 15) / 16 * 16;
}

// Byte offset of (row r, column col) in a warpgroup's output tile of
// `pitch` bytes a row: 16-byte chunk j of row r at chunk j ^ (r % 8), so
// the fragments' 4-byte writes and the rows' 16-byte reads are free of
// bank conflicts.
__device__ __forceinline__ int tile_at(int r, int col, int pitch) {
  return r * pitch + (((col >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// kGate: the up-projection with the GEGLU epilogue (BN = 128 value and 128
// gate columns, h out); else the down-projection with bias and residual
// (BN output columns). A ring slot holds the A rows (128 x 64, 16 KB) and
// BN / 64 boxes of B (64 k rows x 64 columns each, 8 KB).
template <bool kGate, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
geglu_gemm_kernel(const __grid_constant__ Maps maps, const GemmArgs a) {
  constexpr int kStage = kBM * 128 + BN * 128;
  constexpr int kCols = kGate ? BN / 2 : BN;  // output columns of a tile
  constexpr int kPitch = kCols * 2;           // bytes of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = a.stages;
  unsigned char* tiles = ring + S * kStage;  // the warpgroups' output tiles
  unsigned char* extra = tiles + 2 * tile_bytes<kGate, BN>();
  uint64_t* full = reinterpret_cast<uint64_t*>(extra +
                                               extra_bytes(kGate, a.N));
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int kch = (a.K + kBK - 1) / kBK;
  const int tiles_all = (a.R + kBM - 1) / kBM * a.tiles_n;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  if constexpr (!kGate)  // b2, once per block
    for (int i = tid; i < a.N; i += kGemmThreads)
      reinterpret_cast<bf16*>(extra)[i] = a.bias[i];
  __syncthreads();

  if (tid >= kConsumers) {
    // -- producer: one thread streams every tile's slots through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      int i = 0;
      for (int tile = blockIdx.x; tile < tiles_all; tile += gridDim.x) {
        const int m0 = tile / a.tiles_n * kBM;
        const int n0 = tile % a.tiles_n * kCols;
        for (int kc = 0; kc < kch; ++kc, ++i) {
          const int slot = i % S;
          if (i >= S) mbar_wait(&empty[slot], ((i / S) - 1) & 1);
          unsigned char* st = ring + slot * kStage;
          mbar_expect_tx(&full[slot], kStage);  // boxes past an edge count
          tma_load_2d(st, &maps.a, &full[slot], kc * kBK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            // the up-projection pairs value columns n0.. with gate columns
            // inner + n0..
            const int col = kGate && j >= BN / 128
                                ? a.N + n0 + 64 * (j - BN / 128)
                                : n0 + 64 * j;
            tma_load_2d(st + kBM * 128 + j * kBox, &maps.b, &full[slot], col,
                        kc * kBK);
          }
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup w multiplies rows 64 w.. of each tile ---------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int w = tid / 128;
  const int wt = tid % 128;
  const int warp = wt / 32;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  unsigned char* ot = tiles + w * tile_bytes<kGate, BN>();
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles_all; tile += gridDim.x) {
    const int m0 = tile / a.tiles_n * kBM;
    const int n0 = tile % a.tiles_n * kCols;
    const int r0 = m0 + 64 * w;  // the warpgroup's first row
    named_bar(2 + w, 128);       // the last tile's rows have left
    // what the epilogue reads, requested now so that it arrives during the
    // products: the up-projection's biases (thread wt: value pair wt or
    // gate pair wt - 64), the down-projection's residual rows
    uint32_t bias2 = 0;
    if constexpr (kGate) {
      bias2 = *reinterpret_cast<const uint32_t*>(
          a.bias + (wt < 64 ? n0 + 2 * wt : a.N + n0 + 2 * (wt - 64)));
    } else {
      for (int idx = wt; idx < 64 * kCols / 8; idx += 128) {
        const int r = idx / (kCols / 8);
        const int col = idx % (kCols / 8) * 8;
        const bool ok = r0 + r < a.R && n0 + col < a.N;
        cp_async16(ot + tile_at(r, col, kPitch),
                   a.x + (ok ? static_cast<long long>(r0 + r) * a.N + n0 +
                                   col
                             : 0),
                   ok);
      }
      cp_async_commit();
    }

    float acc[BN / 2];
    for (int kc = 0; kc < kch; ++kc, ++i) {
      const int slot = i % S;
      mbar_wait(&full[slot], (i / S) & 1);
      const unsigned char* as = ring + slot * kStage + w * 64 * 128;
      const unsigned char* bs = ring + slot * kStage + kBM * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma_mn<BN>(acc, sw128_desc(as + kk * 32, 16, 1024),
                   sw128_desc(bs + kk * 16 * 128, kBox, 1024),
                   kc > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slot's products are done
      if (kc > 0 && wt == 0) mbar_arrive(&empty[(i - 1) % S]);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (wt == 0) mbar_arrive(&empty[(i - 1) % S]);

    if constexpr (kGate) {
      // h = v * gelu(g) in fp32 from the two halves of the accumulator
      uint32_t* bias = reinterpret_cast<uint32_t*>(extra) + 128 * w;
      bias[wt] = bias2;
      named_bar(2 + w, 128);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bias[4 * j + t]));
        const float2 bg = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bias[64 + 4 * j + t]));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 4 * j + 2 * hh;
          const int f = 4 * (j + BN / 16) + 2 * hh;
          *reinterpret_cast<uint32_t*>(
              ot + tile_at(warp * 16 + g + 8 * hh, 8 * j + 2 * t, kPitch)) =
              pack_bf16((acc[e] + bv.x) * gelu_erf(acc[f] + bg.x),
                        (acc[e + 1] + bv.y) * gelu_erf(acc[f + 1] + bg.y));
        }
      }
    } else {
      // out = acc + b2 + x in fp32, one cast, in place of the residual
      const bf16* b2 = reinterpret_cast<const bf16*>(extra);
      cp_async_wait<0>();
      named_bar(2 + w, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (n0 + col >= a.N) continue;  // c % 8 == 0: pairs whole or absent
        const float2 bb = Elem<bf16>::load2(b2 + n0 + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t* p = reinterpret_cast<uint32_t*>(
              ot + tile_at(warp * 16 + g + 8 * hh, col, kPitch));
          const float2 xr =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
          *p = pack_bf16(acc[4 * j + 2 * hh] + bb.x + xr.x,
                         acc[4 * j + 2 * hh + 1] + bb.y + xr.y);
        }
      }
    }
    named_bar(2 + w, 128);
    // the tile's rows in 16-byte pieces
    for (int idx = wt; idx < 64 * kCols / 8; idx += 128) {
      const int r = idx / (kCols / 8);
      const int col = idx % (kCols / 8) * 8;
      if (r0 + r < a.R && n0 + col < a.N)
        *reinterpret_cast<uint4*>(a.out + static_cast<long long>(r0 + r) *
                                              a.N +
                                  n0 + col) =
            *reinterpret_cast<const uint4*>(ot + tile_at(r, col, kPitch));
    }
  }
}

template <bool kGate, int BN>
cudaError_t launch_gemm(const Maps& maps, GemmArgs g, int ctas,
                        cudaStream_t stream) {
  constexpr size_t kStage = kBM * 128 + BN * 128;
  const size_t fixed =
      1024 + 2 * tile_bytes<kGate, BN>() + extra_bytes(kGate, g.N);
  if (fixed >= kSmemLimit || ctas < 1) return cudaErrorInvalidValue;
  int stages = static_cast<int>((kSmemLimit - fixed) / (kStage + 16));
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) return cudaErrorInvalidValue;
  g.stages = stages;
  const size_t smem = fixed + stages * (kStage + 16);
  auto kernel = geglu_gemm_kernel<kGate, BN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kGemmThreads, smem, stream>>>(maps, g);
  return cudaGetLastError();
}

// fp32 on scalar FMAs: a block owns FR rows, their LN and gated rows in
// shared memory; phase 1 gives each thread inner columns (coalesced reads
// of W1's rows), phase 2 output columns.
struct Args {
  const float* x;
  const float* ln_w;
  const float* ln_b;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* out;
  int R, c, inner;
  float eps;
};

// The fp32 kernel's gelu: the exact erf form, as `geglu_ff_xla` computes it.
__device__ __forceinline__ float gelu_erf_exact(float g) {
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

template <int FR>
__global__ void __launch_bounds__(kThreads)
fused_geglu_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = a.c;
  const int inner = a.inner;
  float* sXn = reinterpret_cast<float*>(smem);   // (FR, c)
  float* sG = sXn + FR * c;                     // (FR, inner)
  const int r0 = blockIdx.x * FR;
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  const float* b1 = static_cast<const float*>(a.b1);
  const float* b2 = static_cast<const float*>(a.b2);
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);

  layer_norm_rows<float>(a, r0, FR, sXn, c);
  __syncthreads();
  const long long ld1 = 2LL * inner;
  for (int j = threadIdx.x; j < inner; j += kThreads) {
    float v[FR] = {}, gt[FR] = {};
    for (int k = 0; k < c; ++k) {
      const float wv = w1[k * ld1 + j];
      const float wg = w1[k * ld1 + inner + j];
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        v[r] = fmaf(sXn[r * c + k], wv, v[r]);
        gt[r] = fmaf(sXn[r * c + k], wg, gt[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < FR; ++r)
      sG[r * inner + j] = (v[r] + b1[j]) * gelu_erf_exact(gt[r] + b1[inner + j]);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < c; n += kThreads) {
    float acc[FR] = {};
    for (int k = 0; k < inner; ++k) {
      const float wv = w2[static_cast<long long>(k) * c + n];
#pragma unroll
      for (int r = 0; r < FR; ++r) acc[r] = fmaf(sG[r * inner + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      if (r0 + r >= a.R) break;
      const long long off = static_cast<long long>(r0 + r) * c + n;
      out[off] = acc[r] + b2[n] + x[off];
    }
  }
}

template <int FR>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(FR) * (a.c + a.inner) * 4;
  auto kernel = fused_geglu_f32_kernel<FR>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.R + FR - 1) / FR, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pandora

// C interface. x and out (R, c), ln_w, ln_b, b2 (c,), w1 (c, 2 inner), b1
// (2 inner,), w2 (inner, c), all contiguous in the element type (dtype
// code 0 fp32, 1 bf16), 16-byte aligned; c % 32 == 0. bf16 (inner % 128
// == 0) also takes the workspaces xn (R, c) and h (R, inner), contiguous
// and 16-byte aligned, the down-projection's tile width bn (128 or 256)
// and the persistent grids ctas_a and ctas_b of the two GEMMs
// (ops/fused_geglu.py `launch_plan`). fp32 takes rows_f32 rows a block (8,
// 4 or 2) and no workspace. Returns cudaGetLastError() after the last
// launch (0 on success); an unsupported shape or plan returns
// cudaErrorInvalidValue.
extern "C" int pandora_fused_geglu(const void* x, const void* ln_w,
                                   const void* ln_b, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, void* xn,
                                   void* h, int R, int c, int inner, int bn,
                                   int ctas_a, int ctas_b, int rows_f32,
                                   float eps, int dtype, void* stream) {
  using namespace pandora;
  if ((dtype != kFloat32 && dtype != kBFloat16) || R <= 0 || c <= 0 ||
      inner <= 0 || c % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    const Args a{static_cast<const float*>(x),  static_cast<const float*>(ln_w),
                 static_cast<const float*>(ln_b), static_cast<const float*>(w1),
                 static_cast<const float*>(b1), static_cast<const float*>(w2),
                 static_cast<const float*>(b2), static_cast<float*>(out),
                 R, c, inner, eps};
    if (static_cast<size_t>(rows_f32) * (c + inner) * 4 > kSmemLimit)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (rows_f32) {
      case 8: return static_cast<int>(launch_f32<8>(a, s));
      case 4: return static_cast<int>(launch_f32<4>(a, s));
      case 2: return static_cast<int>(launch_f32<2>(a, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const void* const ptrs[8] = {x, out, xn, h, w1, w2, ln_w, ln_b};
  const long long strides[1] = {c};
  if (inner % 128 != 0 || c > kMaxC || (bn != 128 && bn != 256) ||
      !rows_aligned16(ptrs, strides))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xnb = static_cast<bf16*>(xn);
  bf16* hb = static_cast<bf16*>(h);
  Maps up, down;
  if (!encode_bf16_2d(&up.a, xnb, R, c, c, 64, kBM) ||
      !encode_bf16_2d(&up.b, static_cast<const bf16*>(w1), c, 2LL * inner,
                      2LL * inner, 64, 64) ||
      !encode_bf16_2d(&down.a, hb, R, inner, inner, 64, kBM) ||
      !encode_bf16_2d(&down.b, static_cast<const bf16*>(w2), inner, c, c, 64,
                      64))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err =
      dispatch_ln(xb, static_cast<const bf16*>(ln_w),
                  static_cast<const bf16*>(ln_b), xnb, R, c, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GemmArgs ga{static_cast<const bf16*>(b1), nullptr, hb, R, inner, c,
                    inner / 128, 0};
  err = launch_gemm<true, 256>(up, ga, ctas_a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GemmArgs gb{static_cast<const bf16*>(b2), xb, static_cast<bf16*>(out),
                    R, c, inner, (c + bn - 1) / bn, 0};
  err = bn == 256 ? launch_gemm<false, 256>(down, gb, ctas_b, s)
                  : launch_gemm<false, 128>(down, gb, ctas_b, s);
  return static_cast<int>(err);
}
