// Fused temporal self-attention block for Hopper (sm_90a), bf16:
//     o = y + to_out(attn_t(LN(y)))
// LayerNorm, the q/k/v projections, self-attention over the t axis of every
// spatial position, the output projection with its bias and the residual
// add, in one kernel.
//
// Replaces the Pallas kernel `_kernel` in
// open_pandora_tpu/ops/fused_temporal.py (reached through
// `fused_temporal_self_attention` and `fused_temporal_self_attention_native`):
// attn1 and attn2 of the UNet's temporal transformers at 320 and 640
// channels and of init_attn (512), t = 16. Same casts as the TPU kernel: LN
// with fp32 statistics, cast to bf16; q, k, v accumulated in fp32, cast to
// bf16; fp32 scores, softmax normalised before the cast to bf16; P V in
// fp32, cast to bf16; the output projection in fp32 plus the bias plus the
// residual in fp32; one cast at the end.
//
// Layout: y is the UNet's native (b, t, hw, c) stream, read through its
// strides (a 3-D (B, t, c) stream is the case hw = 1), so neither entry of
// the TPU version needs the (b*hw, t, c) transpose. A block takes whole
// positions; its rows are position-major, each position's t rows
// contiguous. Weights are nn.Linear's (out, in) matrices read through their
// row stride.
//
// What bounds it on the card: the four c x c products, rows * c^2 * 8 FLOP
// (1.7 TFLOP per CFG eval at 320x512x16f over the 22 sites); the t x t
// attention is about 1% of the work. Two kernels; the wrapper picks one
// (ops/fused_temporal.py `tensor_core_route`) and the launcher refuses a
// shape the chosen kernel cannot run:
//   fused_temporal_tc_kernel  t = 16, head width 64, c <= 320 (128-row
//     blocks) or an even head count up to c = 640 (64-row blocks); every
//     site of the UNet's main path. Products on wgmma: the LN(y) tile and
//     the attention tile (R x c bf16 each, 128-byte swizzled in shared
//     memory) are the A operands; nn.Linear's rows are already the K-major
//     B operand and stream from L2 through a ring of 24 KB slots (a head's
//     q, k and v rows over a k64 chunk, or an NB-row block of Wo), loaded
//     by TMA from one producer thread and released by the consumers through
//     mbarriers, so the next slots are in flight while a head's product and
//     attention run. Two consumer warpgroups: at 128 rows each owns 64 rows
//     and both read every slot (each weight byte serves 128 rows); at 64
//     rows they split the heads and the out-projection's columns. q, k, v
//     come out of one m64n192 accumulator, and one warp's 16 rows are one
//     position's 16 time steps, so the attention runs in registers with no
//     block barrier: q's fragments become mma.sync A fragments, k's are
//     already the B fragments of q k^T, v's are transposed by movmatrix;
//     softmax on the fragments (exp2, one reciprocal a row), p rounded once
//     to bf16. The LN rows arrive as 16-byte cp.async pieces all in flight
//     at once (staged in the attention tile), one reciprocal a row. The
//     epilogue stages the residual in the dead LN tile, adds bias and
//     residual in fp32 and stores 16-byte pieces. Sharing each slot across
//     a cluster by TMA multicast lost to one CTA per slot in every main-path
//     shape, and the stream is not what bounds the kernel: its LN phase and
//     its out-projection epilogue are serial steps that leave the tensor
//     cores idle (PERF.md, section 6).
//   fused_temporal_kernel  every other shape (head widths 16 and 32 of the
//     narrow model, t != 16): warp-level mma.sync m16n8k16 on 32-wide k
//     chunks through a double-buffered cp.async ring, the t x t attention
//     as scalar fp32 code.
// The residual stream is read twice (LN and the epilogue, the second from
// L2) and written once.
#include "common.cuh"
#include "tma.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kKC = 32;        // k chunk of the weight stream
constexpr int kPad = 8;        // row padding of shared tiles (elements)
constexpr int kLdW = kKC + kPad;
constexpr int kMaxT = 32;
constexpr int kMaxC = 1024;

// Warp tiling of an (R x DH) product: R / 16 row strips, the DH columns
// split among the remaining warps.
template <int R, int DH>
struct Tiling {
  static constexpr int kStrips = R / 16;
  static constexpr int kColSplit = (kThreads / 32) / kStrips;
  static constexpr int kWarpCols = DH / kColSplit;
  static constexpr int kNT = kWarpCols / 8;  // n8 tiles per warp
  static_assert(kNT >= 1, "tile too narrow");
};

// acc[w] += A (R x K, shared, pitch lda) @ W_w^T for the warp's 16-row strip
// and its kWarpCols columns, where W_w (DH x K) are rows of weight w in
// device memory (row stride ws). The weights stream through sW, two stages
// of NW x DH x kLdW elements, 32 columns of k at a time.
template <int NW, int R, int DH>
__device__ __forceinline__ void project(
    const bf16* sA, int lda, const bf16* const (&w)[NW], long long ws, int K,
    bf16* sW, float (&acc)[NW][Tiling<R, DH>::kNT][4]) {
  using Tl = Tiling<R, DH>;
  constexpr int kStage = NW * DH * kLdW;
  constexpr int kPieces = NW * DH * (kKC / 8);  // 16-byte copies per chunk
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int strip = warp % Tl::kStrips;
  const int col0 = (warp / Tl::kStrips) * Tl::kWarpCols;
  const int nk = K / kKC;

  auto load = [&](int kc, int stage) {
    for (int idx = tid; idx < kPieces; idx += kThreads) {
      const int piece = idx % (kKC / 8);
      const int row = idx / (kKC / 8);  // w * DH + n
      const int wi = row / DH;
      const int n = row - wi * DH;
      cp_async16(sW + stage * kStage + row * kLdW + piece * 8,
                 w[wi] + n * ws + kc * kKC + piece * 8);
    }
  };

  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load(kc + 1, (kc + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* st = sW + (kc & 1) * kStage;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      const bf16* ap = sA + (strip * 16 + g) * lda + kc * kKC + kk + tig * 2;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * lda), ld32(ap + 8),
                             ld32(ap + 8 * lda + 8)};
#pragma unroll
      for (int wi = 0; wi < NW; ++wi)
#pragma unroll
        for (int nt = 0; nt < Tl::kNT; ++nt) {
          const bf16* bp =
              st + (wi * DH + col0 + nt * 8 + g) * kLdW + kk + tig * 2;
          const uint32_t bfrag[2] = {ld32(bp), ld32(bp + 8)};
          mma_bf16(acc[wi][nt], a, bfrag);
        }
    }
    __syncthreads();  // the stage is free for the load two chunks on
  }
}

struct Args {
  const bf16* y;
  const bf16* w[4];  // q, k, v, out: (out, in) matrices
  long long ws[4];   // their row strides
  const bf16* bo;
  const bf16* ln_w;
  const bf16* ln_b;
  bf16* o;
  int positions;  // b * hw
  int hw, t, c, heads;
  long long ysb, yst, ysp, osb, ost, osp;
  float scale, eps;
};

__device__ __forceinline__ long long row_offset(int P, int ti, int hw,
                                                long long sb, long long st,
                                                long long sp) {
  return (P / hw) * sb + ti * st + static_cast<long long>(P % hw) * sp;
}

template <int R, int DH>
__global__ void __launch_bounds__(kThreads, 1)
fused_temporal_kernel(const Args args) {
  using Tl = Tiling<R, DH>;
  constexpr int kLdH = DH + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = args.c;
  const int t = args.t;
  const int lda = c + kPad;
  bf16* sXn = reinterpret_cast<bf16*>(smem);  // LN(y), (R, lda)
  bf16* sAttn = sXn + R * lda;                // attention output, (R, lda)
  bf16* sQ = sAttn + R * lda;                 // one head's q, k, v
  bf16* sK = sQ + R * kLdH;
  bf16* sV = sK + R * kLdH;
  bf16* sW = sV + R * kLdH;                   // weight ring

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = R / t;                        // positions per block
  const int P0 = blockIdx.x * G;
  const int rows = G * t;                     // rows of whole positions

  // -- LayerNorm, one warp per row, fp32 statistics ------------------------
  for (int r = warp; r < R; r += kThreads / 32) {
    bf16* dst = sXn + r * lda;
    const int pl = r / t;
    const int P = P0 + pl;
    if (r >= rows || P >= args.positions) {
      for (int i = lane; i < c / 2; i += 32)
        reinterpret_cast<__nv_bfloat162*>(dst)[i] =
            __floats2bfloat162_rn(0.f, 0.f);
      continue;
    }
    const bf16* src = args.y + row_offset(P, r - pl * t, args.hw, args.ysb,
                                          args.yst, args.ysp);
    float2 v[kMaxC / 64];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 64; ++i) {
      const int pi = lane + 32 * i;
      v[i] = make_float2(0.f, 0.f);
      if (2 * pi < c) {
        v[i] = Elem<bf16>::load2(src + 2 * pi);
        sum += v[i].x + v[i].y;
      }
    }
    const float mean = warp_sum(sum) / c;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 64; ++i) {
      const int pi = lane + 32 * i;
      if (2 * pi < c) {
        const float dx = v[i].x - mean, dy = v[i].y - mean;
        sq += dx * dx + dy * dy;
      }
    }
    const float sd = sqrtf(warp_sum(sq) / c + args.eps);
#pragma unroll
    for (int i = 0; i < kMaxC / 64; ++i) {
      const int pi = lane + 32 * i;
      if (2 * pi < c) {
        const float2 gw = Elem<bf16>::load2(args.ln_w + 2 * pi);
        const float2 gb = Elem<bf16>::load2(args.ln_b + 2 * pi);
        Elem<bf16>::store2(dst + 2 * pi, (v[i].x - mean) / sd * gw.x + gb.x,
                           (v[i].y - mean) / sd * gw.y + gb.y);
      }
    }
  }
  __syncthreads();

  const int g = lane >> 2;
  const int tig = lane & 3;
  const int strip = warp % Tl::kStrips;
  const int col0 = (warp / Tl::kStrips) * Tl::kWarpCols;

  // -- per head: q, k, v projections, then attention over t ----------------
  for (int h = 0; h < args.heads; ++h) {
    float acc[3][Tl::kNT][4];
#pragma unroll
    for (int wi = 0; wi < 3; ++wi)
#pragma unroll
      for (int nt = 0; nt < Tl::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[wi][nt][e] = 0.f;
    const long long hrow = static_cast<long long>(h) * DH;
    const bf16* const wqkv[3] = {args.w[0] + hrow * args.ws[0],
                                 args.w[1] + hrow * args.ws[1],
                                 args.w[2] + hrow * args.ws[2]};
    // q, k and v share one row stride (checked by the wrapper)
    project<3, R, DH>(sXn, lda, wqkv, args.ws[0], c, sW, acc);
    bf16* const dsts[3] = {sQ, sK, sV};
#pragma unroll
    for (int wi = 0; wi < 3; ++wi)
#pragma unroll
      for (int nt = 0; nt < Tl::kNT; ++nt) {
        bf16* d = dsts[wi] + (strip * 16 + g) * kLdH + col0 + nt * 8 + tig * 2;
        Elem<bf16>::store2(d, acc[wi][nt][0], acc[wi][nt][1]);
        Elem<bf16>::store2(d + 8 * kLdH, acc[wi][nt][2], acc[wi][nt][3]);
      }
    __syncthreads();

    // four threads per row, each a quarter of the head's columns
    if (tid < R * 4) {
      constexpr int DQ = DH / 4;
      const int r = tid / 4;
      const int qd = (tid % 4) * DQ;
      const int pl = r / t;
      const bool valid = r < rows;
      const int kb = valid ? pl * t : 0;  // first key row of the position
      float qv[DQ];
#pragma unroll
      for (int i = 0; i < DQ; i += 2) {
        const float2 f = Elem<bf16>::load2(sQ + r * kLdH + qd + i);
        qv[i] = f.x;
        qv[i + 1] = f.y;
      }
      float s[kMaxT];
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        float acc_s = 0.f;
        if (j < t) {
          const bf16* kr = sK + (kb + j) * kLdH + qd;
#pragma unroll
          for (int i = 0; i < DQ; i += 2) {
            const float2 f = Elem<bf16>::load2(kr + i);
            acc_s = fmaf(qv[i + 1], f.y, fmaf(qv[i], f.x, acc_s));
          }
        }
        acc_s += __shfl_xor_sync(0xffffffffu, acc_s, 1);
        acc_s += __shfl_xor_sync(0xffffffffu, acc_s, 2);
        s[j] = acc_s * args.scale;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < t) mx = fmaxf(mx, s[j]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < t) {
          s[j] = expf(s[j] - mx);
          sum += s[j];
        }
      float o[DQ];
#pragma unroll
      for (int i = 0; i < DQ; ++i) o[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j)
        if (j < t) {
          // normalised, then rounded for the product with v
          const float p = Elem<bf16>::round(s[j] / sum);
          const bf16* vr = sV + (kb + j) * kLdH + qd;
#pragma unroll
          for (int i = 0; i < DQ; i += 2) {
            const float2 f = Elem<bf16>::load2(vr + i);
            o[i] = fmaf(p, f.x, o[i]);
            o[i + 1] = fmaf(p, f.y, o[i + 1]);
          }
        }
      bf16* dst = sAttn + r * lda + h * DH + qd;
#pragma unroll
      for (int i = 0; i < DQ; i += 2)
        Elem<bf16>::store2(dst + i, valid ? o[i] : 0.f,
                           valid ? o[i + 1] : 0.f);
    }
    __syncthreads();
  }

  // -- output projection + bias + residual, DH output columns at a time -----
  for (int j0 = 0; j0 < c; j0 += DH) {
    float acc[1][Tl::kNT][4];
#pragma unroll
    for (int nt = 0; nt < Tl::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.f;
    const bf16* const wo[1] = {args.w[3] + j0 * args.ws[3]};
    project<1, R, DH>(sAttn, lda, wo, args.ws[3], c, sW, acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = strip * 16 + g + 8 * half;
      const int pl = r / t;
      const int P = P0 + pl;
      if (r >= rows || P >= args.positions) continue;
      const int ti = r - pl * t;
      const bf16* yr = args.y + row_offset(P, ti, args.hw, args.ysb,
                                           args.yst, args.ysp);
      bf16* orow = args.o + row_offset(P, ti, args.hw, args.osb, args.ost,
                                       args.osp);
#pragma unroll
      for (int nt = 0; nt < Tl::kNT; ++nt) {
        const int col = j0 + col0 + nt * 8 + tig * 2;
        const float2 res = Elem<bf16>::load2(yr + col);
        const float2 bias = Elem<bf16>::load2(args.bo + col);
        Elem<bf16>::store2(orow + col,
                           res.x + (acc[0][nt][2 * half] + bias.x),
                           res.y + (acc[0][nt][2 * half + 1] + bias.y));
      }
    }
  }
}

template <int R, int DH>
size_t smem_bytes(int c) {
  return (2 * static_cast<size_t>(R) * (c + kPad) +
          3 * static_cast<size_t>(R) * (DH + kPad) +
          2 * 3 * static_cast<size_t>(DH) * kLdW) *
         sizeof(bf16);
}

constexpr size_t kSmemLimit = 232448;  // opt-in shared memory per block

template <int R, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<R, DH>(a.c);
  auto kernel = fused_temporal_kernel<R, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = R / a.t;
  const int blocks = (a.positions + G - 1) / G;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// 64-row tiles where they fit the shared memory, else 32 rows.
template <int DH>
cudaError_t dispatch_r(const Args& a, cudaStream_t stream) {
  if (smem_bytes<64, DH>(a.c) <= kSmemLimit) return launch<64, DH>(a, stream);
  if (smem_bytes<32, DH>(a.c) <= kSmemLimit) return launch<32, DH>(a, stream);
  return cudaErrorInvalidValue;
}

template <>
cudaError_t dispatch_r<16>(const Args& a, cudaStream_t stream) {
  // a 32-row tile leaves a 16-wide head too few columns per warp
  if (smem_bytes<64, 16>(a.c) <= kSmemLimit) return launch<64, 16>(a, stream);
  return cudaErrorInvalidValue;
}


// -- the tensor-core path: t = 16, dh = 64, c % 64 == 0 ---------------------

constexpr int kTcT = 16;                // time steps, one warp's 16 rows
constexpr int kTcConsumers = 256;       // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 128;  // and a producer warpgroup
constexpr int kTcSlot = 3 * 64 * 128;   // ring slot: q, k, v rows over k64
constexpr int kTcMinStages = 2;
constexpr int kTcMaxStages = 8;

// Tensor maps of the four weights: 128-byte swizzled boxes of 64 k columns,
// q, k, v by 64 rows, the out-projection's by NB rows.
struct TcMaps {
  CUtensorMap q, k, v, o;
};

struct TcArgs {
  const bf16* y;
  const bf16* bo;
  const bf16* ln_w;
  const bf16* ln_b;
  bf16* o;
  int positions, hw, c, stages;
  long long ysb, yst, ysp, osb, ost, osp;
  float scale_log2, eps;
};


__device__ __forceinline__ void unpack8_bf16(const uint4& raw,
                                             float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Byte offset of (row r, column col) in an R-row tile of 64-column blocks,
// each row 128 bytes with its 16-byte chunks swizzled (the layout the TMA
// writes and wgmma reads).
template <int R>
__device__ __forceinline__ uint32_t tile_off(int r, int col) {
  return (col >> 6) * (R * 128) + r * 128 +
         ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// The order in which the producer streams weight slots, and which consumer
// warpgroup takes each. Phase A: per head, the q, k, v rows over each k64
// chunk (one slot); RG = 2 (128 rows, each warpgroup 64 of them, every
// head) has both warpgroups take every slot; RG = 1 (64 rows) gives heads
// 2i to warpgroup 0 and 2i + 1 to warpgroup 1, their slots interleaved.
// Phase B: the out-projection's NB-row blocks of Wo over each k64 chunk;
// RG = 2: blocks 0 .. c / NB - 1 for both; RG = 1: warpgroup w's columns
// w c / 2 + [0, c / 2), NB at a time, interleaved.
template <int RG, int NB>
struct TcSched {
  int heads, nk;  // c / 64 each
  __device__ int a_items() const { return heads * nk; }
  __device__ int blocks() const {  // out-projection blocks per warpgroup
    return (RG == 2 ? heads * 64 : heads * 32) / NB;
  }
  __device__ int a_index(int h, int kc) const {
    if (RG == 2) return h * nk + kc;
    const int npair = min(2, heads - (h & ~1));
    return (h >> 1) * 2 * nk + kc * npair + (h & 1);
  }
  __device__ int b_index(int w, int bb, int kc) const {
    if (RG == 2) return a_items() + bb * nk + kc;
    return a_items() + bb * 2 * nk + kc * 2 + w;
  }
  __device__ int b_col(int w, int bb) const {
    return RG == 2 ? bb * NB : w * heads * 32 + bb * NB;
  }
};

template <int N>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[N / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, a, b, 1);
  else if constexpr (N == 160)
    wgmma_ss_n160(d, a, b, 1);
  else
    wgmma_ss_n192(d, a, b, 1);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// LayerNorm of the block's rows (fp32 statistics, centred variance) into
// the swizzled tile `ln`. The rows come in first as 16-byte cp.async pieces,
// all in flight at once, into `stage` (R x c, row-major; the attention
// tile, unused until then); then one warp per row reads them from shared
// memory. Rows past the last position are zero.
template <int R>
__device__ __forceinline__ void tc_layer_norm(const TcArgs& a,
                                              unsigned char* ln,
                                              unsigned char* stage, int P0) {
  constexpr int kMaxPieces = 3;  // c <= 768: 96 pieces of 8 over 32 lanes
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = a.c;
  const int pieces = c / 8;
  for (int idx = threadIdx.x; idx < R * pieces; idx += kTcConsumers) {
    const int r = idx / pieces;
    const int j = idx - r * pieces;
    const int P = P0 + r / kTcT;
    const bool ok = P < a.positions;
    cp_async16(stage + (r * pieces + j) * 16,
               a.y + (ok ? row_offset(P, r % kTcT, a.hw, a.ysb, a.yst,
                                      a.ysp) + 8 * j
                         : 0),
               ok);
  }
  cp_async_commit();
  float gw[kMaxPieces][8], gb[kMaxPieces][8];
#pragma unroll
  for (int u = 0; u < kMaxPieces; ++u) {
    const int j = lane + 32 * u;
    if (j < pieces) {
      unpack8_bf16(*reinterpret_cast<const uint4*>(a.ln_w + 8 * j), gw[u]);
      unpack8_bf16(*reinterpret_cast<const uint4*>(a.ln_b + 8 * j), gb[u]);
    }
  }
  cp_async_wait<0>();
  named_bar(1, kTcConsumers);
  // two rows a warp at a time: independent reductions overlap
  constexpr int kWarps = kTcConsumers / 32;
  for (int r0 = warp; r0 < R; r0 += 2 * kWarps) {
    float v[2][kMaxPieces][8];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int u = 0; u < kMaxPieces; ++u) {
        const int j = lane + 32 * u;
        if (j < pieces) {
          unpack8_bf16(*reinterpret_cast<const uint4*>(
                           stage + ((r0 + q * kWarps) * pieces + j) * 16),
                       v[q][u]);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[q] += v[q][u][e];
        }
      }
    float mean[2], sq[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 2; ++q) mean[q] = warp_sum(sum[q]) / c;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int u = 0; u < kMaxPieces; ++u)
        if (lane + 32 * u < pieces)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = v[q][u][e] - mean[q];
            sq[q] += d * d;
          }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = r0 + q * kWarps;
      const bool valid = P0 + r / kTcT < a.positions;
      // one reciprocal a row: a division per element would cost more than
      // the row's load
      const float rsd = 1.f / sqrtf(warp_sum(sq[q]) / c + a.eps);
#pragma unroll
      for (int u = 0; u < kMaxPieces; ++u) {
        const int j = lane + 32 * u;
        if (j >= pieces) continue;
        uint4 out = make_uint4(0, 0, 0, 0);
        if (valid) {
          uint32_t* o32 = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o32[e] = pack_bf16(
                (v[q][u][2 * e] - mean[q]) * rsd * gw[u][2 * e] +
                    gb[u][2 * e],
                (v[q][u][2 * e + 1] - mean[q]) * rsd * gw[u][2 * e + 1] +
                    gb[u][2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(ln + tile_off<R>(r, 8 * j)) = out;
      }
    }
  }
}

// Self-attention over the 16 rows of the warp (one position's time steps)
// from one head's q, k, v accumulators (acc: the m64n192 fragments, n8
// tiles 0-7 q, 8-15 k, 16-23 v), all in registers: q becomes the A
// fragments of q k^T, k's fragments are already its B fragments, v's are
// transposed with movmatrix into the B fragments of p v. q, k, v are
// rounded to bf16, the softmax is normalised in fp32 and p rounded once.
// The bf16 output goes to the swizzled tile `at` at rows r0 .., columns
// col0 ...
template <int R>
__device__ __forceinline__ void tc_attention(const float (&acc)[96],
                                             unsigned char* at, int r0,
                                             int col0, float scale_log2) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const float* q0 = acc + 4 * (2 * kc);
    const float* q1 = acc + 4 * (2 * kc + 1);
    const uint32_t qa[4] = {pack_bf16(q0[0], q0[1]), pack_bf16(q0[2], q0[3]),
                            pack_bf16(q1[0], q1[1]), pack_bf16(q1[2], q1[3])};
    const float* k0 = acc + 4 * (8 + 2 * kc);
    const float* k1 = acc + 4 * (8 + 2 * kc + 1);
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const uint32_t kb[2] = {pack_bf16(k0[2 * jn], k0[2 * jn + 1]),
                              pack_bf16(k1[2 * jn], k1[2 * jn + 1])};
      mma_bf16(s[jn], qa, kb);
    }
  }
  // softmax over the 16 keys of rows g (e = 0, 1) and g + 8 (e = 2, 3)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                     fmaxf(s[1][2 * h], s[1][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[jn][e] = ex2((s[jn][e] - mx) * scale_log2);
        sum += s[jn][e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[h] = __frcp_rn(sum);
  }
  const uint32_t pa[4] = {
      pack_bf16(s[0][0] * inv[0], s[0][1] * inv[0]),
      pack_bf16(s[0][2] * inv[1], s[0][3] * inv[1]),
      pack_bf16(s[1][0] * inv[0], s[1][1] * inv[0]),
      pack_bf16(s[1][2] * inv[1], s[1][3] * inv[1])};
#pragma unroll
  for (int jd = 0; jd < 8; ++jd) {
    const float* v = acc + 4 * (16 + jd);
    const uint32_t vb[2] = {movmatrix_trans(pack_bf16(v[0], v[1])),
                            movmatrix_trans(pack_bf16(v[2], v[3]))};
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(o, pa, vb);
    const int col = col0 + 8 * jd + 2 * t;
    *reinterpret_cast<uint32_t*>(at + tile_off<R>(r0 + g, col)) =
        pack_bf16(o[0], o[1]);
    *reinterpret_cast<uint32_t*>(at + tile_off<R>(r0 + g + 8, col)) =
        pack_bf16(o[2], o[3]);
  }
}


// One block of R = 64 RG rows (RG * 4 positions of 16 time steps). Shared
// memory: the LN(y) tile and the attention tile (R x c bf16 each, swizzled)
// and a ring of `stages` weight slots fed by TMA from one producer thread.
template <int RG, int NB>
__global__ void __launch_bounds__(kTcThreads, 1)
fused_temporal_tc_kernel(const __grid_constant__ TcMaps maps,
                         const TcArgs a) {
  constexpr int R = 64 * RG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* ln = smem_raw + ((1024 - (base & 1023)) & 1023);
  const int c = a.c;
  const int S = a.stages;
  unsigned char* at = ln + R * c * 2;
  unsigned char* ring = at + R * c * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kTcSlot);
  uint64_t* empty = full + S;
  const TcSched<RG, NB> sched{c / 64, c / 64};
  const int tid = threadIdx.x;
  const int P0 = blockIdx.x * (R / kTcT);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], RG == 2 ? 2 : 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // -- producer: one thread streams the weight slots through the ring --
    if (tid == kTcConsumers) {
      int i = 0;
      // rows [row0, row0 + rows) of each map over k64 chunk kc into the
      // next slot, 64 rows apart
      auto issue = [&](const CUtensorMap* const* mp, int nmaps, int rows,
                       int row0, int kc) {
        const int slot = i % S;
        if (i >= S) mbar_wait(&empty[slot], ((i / S) - 1) & 1);
        mbar_expect_tx(&full[slot], nmaps * rows * 128);
        for (int m = 0; m < nmaps; ++m)
          tma_load_2d(ring + slot * kTcSlot + m * 64 * 128, mp[m],
                      &full[slot], kc * 64, row0);
        ++i;
      };
      const CUtensorMap* const qkv[3] = {&maps.q, &maps.k, &maps.v};
      const CUtensorMap* const wo[1] = {&maps.o};
      const int heads = sched.heads, nk = sched.nk;
      for (int h0 = 0; h0 < heads; h0 += (RG == 2 ? 1 : 2)) {
        const int group = RG == 2 ? 1 : min(2, heads - h0);
        for (int kc = 0; kc < nk; ++kc)
          for (int j = 0; j < group; ++j) issue(qkv, 3, 64, (h0 + j) * 64, kc);
      }
      for (int bb = 0; bb < sched.blocks(); ++bb)
        for (int kc = 0; kc < nk; ++kc)
          for (int w = 0; w < (RG == 2 ? 1 : 2); ++w)
            issue(wo, 1, NB, sched.b_col(w, bb), kc);
    }
  } else {
    // -- consumers: LN, then per head q, k, v and the attention, then the
    //    out-projection with bias and residual --------------------------
    const int w = tid / 128;           // warpgroup
    const int ww = (tid % 128) / 32;   // warp within it
    const int lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int rowbase = RG == 2 ? 64 * w : 0;
    const int nk = sched.nk;
    auto release = [&](int slot) {
      if (tid % 128 == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_u32(&empty[slot]))
                     : "memory");
    };

    tc_layer_norm<R>(a, ln, at, P0);
    fence_async_shared();
    named_bar(1, kTcConsumers);

    for (int h = (RG == 2 ? 0 : w); h < sched.heads; h += (RG == 2 ? 1 : 2)) {
      float acc[96];
      zero(acc);
      for (int kc = 0; kc < nk; ++kc) {
        const int i = sched.a_index(h, kc);
        const int slot = i % S;
        mbar_wait(&full[slot], (i / S) & 1);
        const unsigned char* wb = ring + slot * kTcSlot;
        const unsigned char* ab = ln + kc * (R * 128) + rowbase * 128;
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n192(acc, sw128_desc(ab + kk * 32, 16, 1024),
                        sw128_desc(wb + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        release(slot);
      }
      tc_attention<R>(acc, at, rowbase + 16 * ww, h * 64, a.scale_log2);
    }
    fence_async_shared();
    if (RG == 2)
      named_bar(2 + w, 128);
    else
      named_bar(1, kTcConsumers);

    for (int bb = 0; bb < sched.blocks(); ++bb) {
      const int n0 = sched.b_col(w, bb);
      // the residual rows of this block's columns into the dead LN tile
      for (int idx = tid % 128; idx < 64 * (NB / 8); idx += 128) {
        const int r = rowbase + idx / (NB / 8);
        const int col = n0 + 8 * (idx % (NB / 8));
        const int P = P0 + r / kTcT;
        const bool ok = P < a.positions;
        cp_async16(ln + tile_off<R>(r, col),
                   a.y + (ok ? row_offset(P, r % kTcT, a.hw, a.ysb, a.yst,
                                          a.ysp) + col
                             : 0),
                   ok);
      }
      cp_async_commit();
      float acc[NB / 2];
      zero(acc);
      for (int kc = 0; kc < nk; ++kc) {
        const int i = sched.b_index(w, bb, kc);
        const int slot = i % S;
        mbar_wait(&full[slot], (i / S) & 1);
        const unsigned char* wb = ring + slot * kTcSlot;
        const unsigned char* ab = at + kc * (R * 128) + rowbase * 128;
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n<NB>(acc, sw128_desc(ab + kk * 32, 16, 1024),
                         sw128_desc(wb + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        release(slot);
      }
      cp_async_wait<0>();
      named_bar(2 + w, 128);
      // out = y + (acc + bias) in fp32, one cast, in place of the residual
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 bias = Elem<bf16>::load2(a.bo + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = rowbase + 16 * ww + g + 8 * hh;
          uint32_t* p = reinterpret_cast<uint32_t*>(ln + tile_off<R>(r, col));
          const float2 res = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p));
          *p = pack_bf16(res.x + (acc[4 * j + 2 * hh] + bias.x),
                         res.y + (acc[4 * j + 2 * hh + 1] + bias.y));
        }
      }
      named_bar(2 + w, 128);
      for (int idx = tid % 128; idx < 64 * (NB / 8); idx += 128) {
        const int r = rowbase + idx / (NB / 8);
        const int col = n0 + 8 * (idx % (NB / 8));
        const int P = P0 + r / kTcT;
        if (P >= a.positions) continue;
        *reinterpret_cast<uint4*>(
            a.o + row_offset(P, r % kTcT, a.hw, a.osb, a.ost, a.osp) + col) =
            *reinterpret_cast<const uint4*>(ln + tile_off<R>(r, col));
      }
    }
  }
}

// A (c x c) weight with row stride ws elements, in boxes of 64 columns by
// box_rows rows, 128-byte swizzled.
bool encode_weight(CUtensorMap* m, const bf16* w, long long ws, int c,
                   int box_rows) {
  return encode_bf16_2d(m, w, c, c, ws, 64, box_rows);
}

size_t tc_smem_bytes(int R, int c, int stages) {
  return 1024 + 2 * static_cast<size_t>(R) * c * 2 +
         static_cast<size_t>(stages) * (kTcSlot + 16);
}

template <int RG, int NB>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  constexpr int R = 64 * RG;
  TcMaps maps;
  if (!encode_weight(&maps.q, a.w[0], a.ws[0], a.c, 64) ||
      !encode_weight(&maps.k, a.w[1], a.ws[1], a.c, 64) ||
      !encode_weight(&maps.v, a.w[2], a.ws[2], a.c, 64) ||
      !encode_weight(&maps.o, a.w[3], a.ws[3], a.c, NB))
    return cudaErrorInvalidValue;
  TcArgs t;
  t.y = a.y;
  t.bo = a.bo;
  t.ln_w = a.ln_w;
  t.ln_b = a.ln_b;
  t.o = a.o;
  t.positions = a.positions;
  t.hw = a.hw;
  t.c = a.c;
  t.ysb = a.ysb;
  t.yst = a.yst;
  t.ysp = a.ysp;
  t.osb = a.osb;
  t.ost = a.ost;
  t.osp = a.osp;
  t.scale_log2 = a.scale * kLog2e;
  t.eps = a.eps;
  t.stages = static_cast<int>(
      (kSmemLimit - tc_smem_bytes(R, a.c, 0)) / (kTcSlot + 16));
  if (t.stages > kTcMaxStages) t.stages = kTcMaxStages;
  if (t.stages < kTcMinStages) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(R, a.c, t.stages);
  cudaError_t err = allow_smem_once<&fused_temporal_tc_kernel<RG, NB>>();
  if (err != cudaSuccess) return err;
  const int per = R / kTcT;
  fused_temporal_tc_kernel<RG, NB>
      <<<(a.positions + per - 1) / per, kTcThreads, smem, stream>>>(maps, t);
  return cudaGetLastError();
}

// The tensor-core kernel, for the shapes the wrapper routes to it
// (ops/fused_temporal.py `tensor_core_route`): t = 16, dh = 64, and a
// per-warpgroup out-projection width (c in 128-row blocks at c <= 320, else
// c / 2 in 64-row blocks with an even head count) that splits into equal
// blocks of 128, 160 or 192 columns, with the two tiles and two ring slots
// in shared memory; 16-byte aligned rows. Any other shape is refused.
cudaError_t dispatch_tc(const Args& a, cudaStream_t stream) {
  if (a.t != kTcT || a.c != 64 * a.heads) return cudaErrorInvalidValue;
  const int rg = a.c <= 320 ? 2 : 1;
  if (rg == 1 && a.heads % 2 != 0) return cudaErrorInvalidValue;
  const int width = rg == 2 ? a.c : a.c / 2;  // columns per warpgroup
  const int nb = (width + 191) / 192;
  const int NB = width / nb;
  if (width % nb != 0 || (NB != 128 && NB != 160 && NB != 192) ||
      tc_smem_bytes(64 * rg, a.c, kTcMinStages) > kSmemLimit)
    return cudaErrorInvalidValue;
  // 16-byte pieces of y, o, the LN affine (and TMA boxes of the weights)
  const void* const ptrs[5] = {a.y, a.o, a.ln_w, a.ln_b, a.w[0]};
  const long long strides[6] = {a.ysb, a.yst, a.ysp, a.osb, a.ost, a.osp};
  if (!rows_aligned16(ptrs, strides)) return cudaErrorInvalidValue;
  if (rg == 2) {
    switch (NB) {
      case 128: return launch_tc<2, 128>(a, stream);
      case 160: return launch_tc<2, 160>(a, stream);
      default: return launch_tc<2, 192>(a, stream);
    }
  }
  switch (NB) {
    case 128: return launch_tc<1, 128>(a, stream);
    case 160: return launch_tc<1, 160>(a, stream);
    default: return launch_tc<1, 192>(a, stream);
  }
}

}  // namespace
}  // namespace pandora

// C interface. y and o: (b, t, hw, c) through their strides {batch, t,
// position} in elements, c contiguous. wq, wk, wv, wo: (c, c) in nn.Linear's
// (out, in) layout with row strides wq_s (shared by q, k, v) and wo_s; bo,
// ln_w, ln_b: (c,). heads * dh = c with dh in {16, 32, 64}; t <= 32;
// c % 32 == 0 and c <= 1024. bf16 only (dtype code 1). route 1 runs the
// tensor-core kernel (dispatch_tc's shapes), route 0 the mma.sync kernel
// (every shape). Returns cudaGetLastError() after the launch (0 on
// success); an unsupported shape or route returns cudaErrorInvalidValue.
extern "C" int pandora_fused_temporal_attn(
    const void* y, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* bo, const void* ln_w, const void* ln_b,
    void* o, int b, int t, int hw, int c, int heads, int route,
    long long y_sb, long long y_st, long long y_sp, long long o_sb,
    long long o_st, long long o_sp, long long wq_s, long long wo_s,
    float scale, float eps, int dtype, void* stream) {
  using namespace pandora;
  if (dtype != kBFloat16 || b <= 0 || t <= 0 || t > kMaxT || hw <= 0 ||
      heads <= 0 || c <= 0 || c % heads != 0 || c % kKC != 0 || c > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.y = static_cast<const bf16*>(y);
  a.w[0] = static_cast<const bf16*>(wq);
  a.w[1] = static_cast<const bf16*>(wk);
  a.w[2] = static_cast<const bf16*>(wv);
  a.w[3] = static_cast<const bf16*>(wo);
  a.ws[0] = a.ws[1] = a.ws[2] = wq_s;
  a.ws[3] = wo_s;
  a.bo = static_cast<const bf16*>(bo);
  a.ln_w = static_cast<const bf16*>(ln_w);
  a.ln_b = static_cast<const bf16*>(ln_b);
  a.o = static_cast<bf16*>(o);
  a.positions = b * hw;
  a.hw = hw;
  a.t = t;
  a.c = c;
  a.heads = heads;
  a.ysb = y_sb;
  a.yst = y_st;
  a.ysp = y_sp;
  a.osb = o_sb;
  a.ost = o_st;
  a.osp = o_sp;
  a.scale = scale;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) return static_cast<int>(dispatch_tc(a, s));
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (c / heads) {
    case 16: err = dispatch_r<16>(a, s); break;
    case 32: err = dispatch_r<32>(a, s); break;
    case 64: err = dispatch_r<64>(a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
