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
//   geglu_ln_kernel<bf16>   LN(x) into a bf16 workspace xn (R, c), one
//                     warp a row held in its registers: 4 R c bytes.
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
//
// fp32 runs the same three stages in split TF32 on the tensor cores (each
// operand x = hi + lo, hi = x rounded to TF32, lo = x - hi rounded the same
// way, common.cuh's split_tf32; a b as lo hi + hi lo + hi hi, lo lo
// dropped), so its bound is the products at 495 / 3 TFLOP/s (1.22 ms at R =
// 81920, c = 320; the kernels reach 0.56-0.62 of it at the UNet's widths,
// PERF.md section 6):
//   geglu_ln_kernel<float>   LN(x) into an fp32 workspace xn (R, c).
//   geglu_tf32_kernel<true, 2 BV>   h = v * gelu(g) into an fp32 workspace
//                     h (R, inner): the very value the plain version makes,
//                     so no rounding is added; its round trip, 32 R c
//                     bytes, is about a fifth of the bound and overlaps
//                     the products.
//   geglu_tf32_kernel<false, BN>   out = x + h W2 + b2.
// The GEMM is conv3x3.cu's fp32 design on a plain A:
//   - Persistent and warp-specialised, 384 threads: one block a
//     multiprocessor walks tiles of 128 rows (two consumer warpgroups of 64)
//     by BN columns, in groups of 16 row tiles with the column tiles outer
//     in a group, so that the A rows and the weight columns the running
//     blocks share stay in L2. Thread 0 of a producer warpgroup streams
//     each 32-k piece by TMA: the A rows (128 x 32, 128-byte swizzle) into
//     a ring of four slots, the weight piece (32 k rows x BN columns, as W1
//     and W2 lie: MN-major as wgmma's B, which tf32 wgmma reads only
//     K-major) into one of three raw slots, two pieces ahead. The
//     warpgroup then transposes and splits each weight piece into K-major
//     hi and lo planes (the 128-byte swizzle of wgmma's descriptor) in one
//     of two split slots: once a block and piece, neither a copy of the
//     weights nor a split in every warp.
//   - The up-projection's tile pairs BV value columns with the same BV gate
//     columns (two tensor maps over W1's halves, so a ragged last tile
//     reads zeros, not the other half): value in the accumulator's first
//     half, gate in its second, so the epilogue gates in registers. BV = 80
//     where inner % 80 == 0, else 64 (m64n160 or m64n128: a piece's sum and
//     the tile's total both fit the consumers' 232 registers); the
//     down-projection's BN = 160 where c % 160 == 0, else 128, a ragged
//     last tile masked at the store.
//   - Consumers load A through ldmatrix (lane l gets fp32 word l % 4 of row
//     l / 4: the TF32 A fragment), split it in registers and run wgmma
//     m64nNk8 tf32 in the `rs` form; the next piece's A loads under the
//     products.
//   - Precision, as conv3x3.cu: each 32-k piece is one chain, the small
//     terms lo hi and hi lo first and hi hi on top, and the piece's sum
//     joins the tile's total on the CUDA cores, rounded to nearest (one
//     chain over a long k drifts toward zero: the tensor core truncates).
//   - Epilogues straight from the total's registers (a warp's float2
//     stores fill whole 32-byte sectors): gelu with the exact erff, its
//     argument g times 1 / sqrt 2 (no division); out = (total + b2) + x.
#include "common.cuh"
#include "tma.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                   // the LN kernel
constexpr int kMaxC = 4096;                     // the LN's registers
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

// 16 bytes of a row: 8 bf16 or 4 fp32 values, as floats.
template <typename T>
struct Piece16;

template <>
struct Piece16<bf16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& raw, float (&v)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                      pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
};

template <>
struct Piece16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& raw, float (&v)[4]) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// LN of each row of x into xn, one warp a row: fp32 mean and centred
// variance, (x - mu) * rsqrt(var + eps) * w + b in fp32, one cast. Rows of
// 16-byte pieces, at most 32 P of them: lane l holds the row's pieces l, l +
// 32, ... in registers, so x is read once.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
geglu_ln_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, T* __restrict__ xn, int R, int c,
                float eps) {
  using V = Piece16<T>;
  constexpr int E = V::kN;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const uint4* src =
      reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * c);
  uint4* dst = reinterpret_cast<uint4*>(xn + static_cast<long long>(row) * c);
  const int pieces = c / E;
  uint4 raw[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (lane + 32 * i < pieces) raw[i] = src[lane + 32 * i];
  float v[E];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (lane + 32 * i >= pieces) break;
    V::unpack(raw[i], v);
#pragma unroll
    for (int e = 0; e < E; ++e) sum += v[e];
  }
  const float mu = warp_sum(sum) / c;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (lane + 32 * i >= pieces) break;
    V::unpack(raw[i], v);
#pragma unroll
    for (int e = 0; e < E; ++e) sq += (v[e] - mu) * (v[e] - mu);
  }
  const float inv = rsqrtf(warp_sum(sq) / c + eps);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = lane + 32 * i;
    if (p >= pieces) break;
    float gw[E], gb[E], o[E];
    V::unpack(raw[i], v);
    V::unpack(reinterpret_cast<const uint4*>(w)[p], gw);
    V::unpack(reinterpret_cast<const uint4*>(b)[p], gb);
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = (v[e] - mu) * inv * gw[e] + gb[e];
    dst[p] = V::pack(o);
  }
}

template <typename T, int P>
cudaError_t launch_ln(const T* x, const T* w, const T* b, T* xn, int R,
                      int c, float eps, cudaStream_t stream) {
  geglu_ln_kernel<T, P><<<(R + kThreads / 32 - 1) / (kThreads / 32),
                          kThreads, 0, stream>>>(x, w, b, xn, R, c, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ln(const T* x, const T* w, const T* b, T* xn, int R,
                        int c, float eps, cudaStream_t stream) {
  const int bytes = c * static_cast<int>(sizeof(T));  // 512 P at most
  if (c > kMaxC) return cudaErrorInvalidValue;
  if (bytes <= 512) return launch_ln<T, 1>(x, w, b, xn, R, c, eps, stream);
  if (bytes <= 1024) return launch_ln<T, 2>(x, w, b, xn, R, c, eps, stream);
  if (bytes <= 2048) return launch_ln<T, 4>(x, w, b, xn, R, c, eps, stream);
  if (bytes <= 4096) return launch_ln<T, 8>(x, w, b, xn, R, c, eps, stream);
  if (bytes <= 8192) return launch_ln<T, 16>(x, w, b, xn, R, c, eps, stream);
  return launch_ln<T, 32>(x, w, b, xn, R, c, eps, stream);
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

// -- fp32: split TF32 on wgmma ---------------------------------------------

constexpr int kPieceF = 32;     // k values a piece: one 128-byte row of A
constexpr int kASlotsF = 4;     // A ring (TMA)
constexpr int kRawF = 3;        // raw weight slots (TMA)
constexpr int kSplitF = 2;      // split slots (hi and lo planes)
constexpr int kLeadF = 2;       // pieces the copies run ahead of the split
constexpr int kGroupRows = 16;  // row tiles a raster group

// Shared memory of the fp32 GEMM at tile width N: the A ring (128 rows of 32
// k), raw and split weight slots (N columns of 32 k: N 128 bytes each), the
// mbarriers, and room to align the ring to 1024 bytes.
template <int N>
struct TF32Plan {
  static constexpr int kA = kBM * kPieceF * 4;
  static constexpr int kW = N * kPieceF * 4;
  static constexpr size_t kSmem =
      1024 + kASlotsF * kA + (kRawF + 2 * kSplitF) * static_cast<size_t>(kW) +
      256;
};

struct TF32Args {
  const float* bias;  // b1 (2 inner) or b2 (c)
  const float* x;     // the residual (R, c); the down-projection only
  float* out;         // h (R, inner) or out (R, c)
  int R, N, K;        // rows; output columns (inner or c); depth (c or inner)
  int tiles_m, tiles_n;
};

struct TF32Maps {
  // a: xn or h (R, K) in boxes of 32 k x 128 rows, 128-byte swizzled; v:
  // W2, or W1's value half, and g: W1's gate half, in plain row-major boxes
  // of 32 k rows x the tile's columns of that half
  CUtensorMap a, v, g;
};

// gelu(g) with the exact erf, as the plain version's F.gelu computes it:
// g / 2 (1 + erf(g / sqrt 2)), the argument a product, not a division.
__device__ __forceinline__ float gelu_exact(float g) {
  return g * 0.5f * (1.f + erff(g * 0.70710678118654752f));
}

// The tile's total into its output: rows r and r + 8 of each warp's 16,
// columns col + 8 j and col + 8 j + 1 (the accumulator's layout).
// kGate: h = (v + b1) gelu(g + b1), value column n of the tile in total's
// first half, its gate column in the second; else out = (total + b2) + x.
// What a batch of column blocks reads (the biases, the residual) is loaded
// into `in` before any of its stores: a load after a store to a pointer
// that may alias waits for it, one round trip per load, which made the
// epilogue a large share of a tile on the card.
template <bool kGate, int BN>
__device__ __forceinline__ void tf32_epilogue(const TF32Args& a,
                                              const float (&total)[BN / 2],
                                              float (&in)[BN / 2], int r,
                                              int col) {
  constexpr int kJ = kGate ? BN / 16 : BN / 8;  // n8 column blocks out
  constexpr int kIn = kGate ? 4 : 6;            // inputs a block
  constexpr int kBatch = BN / 2 / kIn < kJ ? BN / 2 / kIn : kJ;
#pragma unroll
  for (int j0 = 0; j0 < kJ; j0 += kBatch) {
#pragma unroll
    for (int j = j0; j < j0 + kBatch && j < kJ; ++j) {
      const int n = col + 8 * j;
      const int q = kIn * (j - j0);
      if (n >= a.N) continue;  // N % 2 == 0: pairs whole or absent
      const float2 b = *reinterpret_cast<const float2*>(a.bias + n);
      in[q] = b.x;
      in[q + 1] = b.y;
      if constexpr (kGate) {
        const float2 bg = *reinterpret_cast<const float2*>(a.bias + a.N + n);
        in[q + 2] = bg.x;
        in[q + 3] = bg.y;
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (r + 8 * hh < a.R) {
            const float2 xr = *reinterpret_cast<const float2*>(
                a.x + static_cast<long long>(r + 8 * hh) * a.N + n);
            in[q + 2 + 2 * hh] = xr.x;
            in[q + 3 + 2 * hh] = xr.y;
          }
      }
    }
#pragma unroll
    for (int j = j0; j < j0 + kBatch && j < kJ; ++j) {
      const int n = col + 8 * j;
      const int q = kIn * (j - j0);
      if (n >= a.N) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r + 8 * hh;
        if (row >= a.R) continue;
        const int e = 4 * j + 2 * hh;
        float2 o;
        if constexpr (kGate) {
          const int f = e + BN / 4;  // the gate column, BN / 2 further
          o = make_float2(
              (total[e] + in[q]) * gelu_exact(total[f] + in[q + 2]),
              (total[e + 1] + in[q + 1]) *
                  gelu_exact(total[f + 1] + in[q + 3]));
        } else {
          o = make_float2(total[e] + in[q] + in[q + 2 + 2 * hh],
                          total[e + 1] + in[q + 1] + in[q + 3 + 2 * hh]);
        }
        *reinterpret_cast<float2*>(a.out + static_cast<long long>(row) * a.N +
                                   n) = o;
      }
    }
  }
}

// kGate: the up-projection, tiles of BN / 2 value and BN / 2 gate columns,
// h out; else the down-projection, tiles of BN output columns. Persistent:
// block b takes tiles b, b + gridDim.x, ...
template <bool kGate, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
geglu_tf32_kernel(const __grid_constant__ TF32Maps maps, const TF32Args a) {
  using P = TF32Plan<BN>;
  constexpr int kBW = kGate ? BN / 2 : BN;  // columns of a weight box
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* as =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // A ring
  unsigned char* raw = as + kASlotsF * P::kA;    // kRawF raw weight slots
  unsigned char* split = raw + kRawF * P::kW;    // kSplitF x (hi, lo)
  uint64_t* afull = reinterpret_cast<uint64_t*>(split + 2 * kSplitF * P::kW);
  uint64_t* aempty = afull + kASlotsF;    // A slot read by every consumer warp
  uint64_t* rawfull = aempty + kASlotsF;  // raw slot landed (TMA)
  uint64_t* full = rawfull + kRawF;       // split slot written
  uint64_t* empty = full + kSplitF;       // split slot read by every warp
  const int kpieces = a.K / kPieceF;
  const int tiles = a.tiles_m * a.tiles_n;
  const int bid = static_cast<int>(blockIdx.x);
  const int grid = static_cast<int>(gridDim.x);
  const int npieces = bid < tiles ? ((tiles - 1 - bid) / grid + 1) * kpieces
                                  : 0;
  // the first row and column of the block's tile number `it` (its tiles
  // bid, bid + grid, ...): groups of kGroupRows row tiles, the column tiles
  // outer within a group
  auto tile_origin = [&](int it, int& m0, int& n0) {
    const int tile = bid + it * grid;
    const int first = tile / (kGroupRows * a.tiles_n) * kGroupRows;
    const int rows = min(kGroupRows, a.tiles_m - first);
    const int local = tile - first * a.tiles_n;
    m0 = (first + local % rows) * kBM;
    n0 = local / rows * kBW;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kASlotsF; ++s) {
      mbar_init(&afull[s], 1);
      mbar_init(&aempty[s], 8);  // every consumer warp
    }
    for (int s = 0; s < kRawF; ++s) mbar_init(&rawfull[s], 1);
    for (int s = 0; s < kSplitF; ++s) {
      mbar_init(&full[s], 128);  // every producer thread
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // -- producer: thread 0 streams the A rows and the raw weight pieces,
    // kLeadF pieces ahead; the warpgroup splits each landed weight piece
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int t = threadIdx.x - kConsumers;
    int it = 0, kp = 0, m0 = 0, n0 = 0;  // thread 0: piece j's tile, k piece
    if (t == 0) tile_origin(0, m0, n0);
    for (int j = 0; j < npieces + kLeadF; ++j) {
      if (t == 0 && j < npieces) {
        const int k0 = kp * kPieceF;
        const int sa = j % kASlotsF;
        if (j >= kASlotsF) mbar_wait(&aempty[sa], (j / kASlotsF - 1) & 1);
        mbar_expect_tx(&afull[sa], P::kA);  // boxes past an edge count
        tma_load_2d(as + sa * P::kA, &maps.a, &afull[sa], k0, m0);
        unsigned char* rs = raw + j % kRawF * P::kW;
        mbar_expect_tx(&rawfull[j % kRawF], P::kW);
        tma_load_2d(rs, &maps.v, &rawfull[j % kRawF], n0, k0);
        if constexpr (kGate)
          tma_load_2d(rs + P::kW / 2, &maps.g, &rawfull[j % kRawF], n0, k0);
        if (++kp == kpieces) {
          kp = 0;
          tile_origin(++it, m0, n0);
        }
      }
      const int jj = j - kLeadF;  // the piece to split
      if (jj < 0) continue;
      const int s = jj % kSplitF;
      mbar_wait(&rawfull[jj % kRawF], (jj / kRawF) & 1);
      if (jj >= kSplitF) mbar_wait(&empty[s], (jj / kSplitF - 1) & 1);
      const float* src =
          reinterpret_cast<const float*>(raw + jj % kRawF * P::kW);
      unsigned char* hi = split + 2 * s * P::kW;
      // unit u = t + 128 m: column n = u % BN's k values 4 q .. 4 q + 3,
      // q = u / BN, read down the raw box's column (consecutive lanes on
      // consecutive columns) and written as the 16-byte chunk q of the
      // planes' row n, stored at q ^ (n % 8); n and q step along with m
      int n = t, q = 0;
#pragma unroll 2
      for (int m = 0; m < BN * 8 / 128; ++m) {
        const float* col =
            src + (n < kBW ? n : kPieceF * kBW + n - kBW) + 4 * q * kBW;
        uint4 h, l;
        split_tf32(col[0], h.x, l.x);
        split_tf32(col[kBW], h.y, l.y);
        split_tf32(col[2 * kBW], h.z, l.z);
        split_tf32(col[3 * kBW], h.w, l.w);
        const int off = n * 128 + ((q ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(hi + P::kW + off) = l;
        n += 128;
        if (n >= BN) {
          n -= BN;
          ++q;
        }
      }
      fence_async_shared();  // wgmma reads the split slot; the next TMA
                             // into the raw slot comes after these reads
      mbar_arrive(&full[s]);
      named_bar(2, 128);     // the raw slot is free for piece jj + kRawF
    }
    return;
  }

  // -- consumers: warpgroup w multiplies rows 64 w.. of each tile ---------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  // this lane's ldmatrix row of the tile, and its 4-k half of a k8 step
  const int lrow = warp * 16 + (lane & 15);
  const int khalf = lane >> 4;
  // A of piece i through ldmatrix (lane l gets fp32 word l % 4 of row l /
  // 4: the TF32 A fragment), then the slot is released
  auto load_a = [&](int i, uint32_t (&r)[4][4]) {
    const int sa = i % kASlotsF;
    mbar_wait(&afull[sa], (i / kASlotsF) & 1);
    const unsigned char* row = as + sa * P::kA + lrow * 128;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      ldsm_x4(r[kc], row + (((2 * kc + khalf) ^ (lrow & 7)) << 4));
    __syncwarp();
    if (lane == 0) mbar_arrive(&aempty[sa]);
  };

  float part[BN / 2], total[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) total[e] = 0.f;
  int it = 0, kp = 0;  // the tile (of the block's) and the k piece
  uint32_t nr[4][4];  // the next piece's A, loaded under the products
  if (npieces > 0) load_a(0, nr);
  for (int i = 0; i < npieces; ++i) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(__uint_as_float(nr[kc][e]), ah[kc][e], al[kc][e]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      reg_fence(ah[kc]);
      reg_fence(al[kc]);
    }
    const int s = i % kSplitF;
    mbar_wait(&full[s], (i / kSplitF) & 1);
    wgmma_fence();
    // one chain of 32 k values: the small terms lo hi and hi lo first, then
    // the big term hi hi on top of them; the chain's sum then joins the
    // total on the CUDA cores, rounded to nearest
    const unsigned char* wh = split + 2 * s * P::kW;
    const unsigned char* wl = wh + P::kW;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_tf32<BN>(part, al[kc], sw128_desc(wh + kc * 32, 16, 1024), kc);
      wgmma_tf32<BN>(part, ah[kc], sw128_desc(wl + kc * 32, 16, 1024), 1);
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_tf32<BN>(part, ah[kc], sw128_desc(wh + kc * 32, 16, 1024), 1);
    wgmma_commit();
    if (i + 1 < npieces) load_a(i + 1, nr);  // under the products
    wgmma_wait_all();
    reg_fence(part);
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) total[e] += part[e];
    if (++kp == kpieces) {  // the tile's last piece
      int m0, n0;
      tile_origin(it++, m0, n0);
      kp = 0;
      tf32_epilogue<kGate, BN>(a, total, part, m0 + warp * 16 + (lane >> 2),
                               n0 + 2 * (lane & 3));
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) total[e] = 0.f;
    }
  }
}

template <bool kGate, int BN>
cudaError_t launch_tf32(const TF32Maps& maps, const TF32Args& g, int ctas,
                        cudaStream_t stream) {
  constexpr size_t smem = TF32Plan<BN>::kSmem;
  static_assert(smem <= kSmemLimit, "shared memory");
  if (ctas < 1) return cudaErrorInvalidValue;
  auto kernel = geglu_tf32_kernel<kGate, BN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kGemmThreads, smem, stream>>>(maps, g);
  return cudaGetLastError();
}

// The fp32 tensor maps: A (rows, K) in swizzled boxes of 32 k x 128 rows; a
// weight's columns [0, cols) of its k rows, row stride ld floats, in plain
// boxes of bw columns x 32 k rows.
bool encode_a_f32(CUtensorMap* m, const float* p, long long rows,
                  long long K) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t str[1] = {static_cast<cuuint64_t>(K) * 4};
  const cuuint32_t box[2] = {kPieceF, kBM};
  return encode_f32(m, p, 2, dims, str, box);
}

bool encode_w_f32(CUtensorMap* m, const float* p, long long k,
                  long long cols, long long ld, int bw) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(k)};
  const cuuint64_t str[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bw), kPieceF};
  return encode_f32(m, p, 2, dims, str, box, false);
}

cudaError_t run_f32(const float* x, const float* ln_w, const float* ln_b,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, float* out, float* xn, float* h, int R,
                    int c, int inner, int bv, int bn, int ctas_a, int ctas_b,
                    float eps, cudaStream_t s) {
  const int tiles_m = (R + kBM - 1) / kBM;
  TF32Maps up, down;
  if (!encode_a_f32(&up.a, xn, R, c) ||
      !encode_w_f32(&up.v, w1, c, inner, 2LL * inner, bv) ||
      !encode_w_f32(&up.g, w1 + inner, c, inner, 2LL * inner, bv) ||
      !encode_a_f32(&down.a, h, R, inner) ||
      !encode_w_f32(&down.v, w2, inner, c, c, bn))
    return cudaErrorInvalidValue;
  down.g = down.v;
  cudaError_t err = dispatch_ln(x, ln_w, ln_b, xn, R, c, eps, s);
  if (err != cudaSuccess) return err;
  const TF32Args ga{b1, nullptr, h, R, inner, c, tiles_m,
                    (inner + bv - 1) / bv};
  err = bv == 80 ? launch_tf32<true, 160>(up, ga, ctas_a, s)
                 : launch_tf32<true, 128>(up, ga, ctas_a, s);
  if (err != cudaSuccess) return err;
  const TF32Args gb{b2, x, out, R, c, inner, tiles_m, (c + bn - 1) / bn};
  return bn == 160 ? launch_tf32<false, 160>(down, gb, ctas_b, s)
                   : launch_tf32<false, 128>(down, gb, ctas_b, s);
}

}  // namespace
}  // namespace pandora

// C interface. x and out (R, c), ln_w, ln_b, b2 (c,), w1 (c, 2 inner), b1
// (2 inner,), w2 (inner, c), all contiguous in the element type (dtype
// code 0 fp32, 1 bf16), 16-byte aligned; c % 32 == 0, c <= 4096; the
// workspaces xn (R, c) and h (R, inner), contiguous in the element type and
// 16-byte aligned; the persistent grids ctas_a and ctas_b of the two GEMMs
// and their tile widths (ops/fused_geglu.py `launch_plan`): bf16 (inner %
// 128 == 0) takes bv 128 value columns an up-projection tile and bn 128 or
// 256 output columns a down-projection tile, fp32 (inner % 32 == 0) bv 80
// or 64 and bn 160 or 128. Returns cudaGetLastError() after the last launch
// (0 on success); an unsupported shape or plan returns
// cudaErrorInvalidValue.
extern "C" int pandora_fused_geglu(const void* x, const void* ln_w,
                                   const void* ln_b, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, void* xn,
                                   void* h, int R, int c, int inner, int bv,
                                   int bn, int ctas_a, int ctas_b, float eps,
                                   int dtype, void* stream) {
  using namespace pandora;
  const void* const ptrs[10] = {x, ln_w, ln_b, w1, b1, w2, b2, out, xn, h};
  const long long strides[1] = {c};
  if ((dtype != kFloat32 && dtype != kBFloat16) || R <= 0 || c <= 0 ||
      inner <= 0 || c % 32 != 0 || c > kMaxC || !rows_aligned16(ptrs, strides))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (inner % 32 != 0 || (bv != 80 && bv != 64) || (bn != 160 && bn != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(run_f32(
        static_cast<const float*>(x), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out),
        static_cast<float*>(xn), static_cast<float*>(h), R, c, inner, bv, bn,
        ctas_a, ctas_b, eps, s));
  }
  if (inner % 128 != 0 || bv != 128 || (bn != 128 && bn != 256))
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
