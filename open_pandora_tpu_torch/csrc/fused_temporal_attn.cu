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
// the TPU version needs the (b*hw, t, c) transpose. A block takes G = R / t
// consecutive spatial positions (R = 64 rows: 4 positions at t = 16); its
// rows are position-major, so each position's t rows are contiguous in
// shared memory. Weights are nn.Linear's (out, in) matrices read through
// their row stride.
//
// What bounds it on the card: the four c x c products are nearly all of its
// work (rows * c^2 * 8 FLOP; 1.7 TFLOP per CFG eval at 320x512x16f over
// the 22 sites), so they run on the tensor cores with warp-level
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). Each block keeps LN(y) and
// the attention output (R x c bf16 each) in shared memory and streams the
// weights through a double-buffered cp.async ring in 32-wide k chunks: per
// head, the q, k, v column blocks (3 x dh rows of W); then the output
// projection dh columns at a time. The small t x t attention (about 1% of
// the FLOPs) runs as scalar fp32 code, four threads per row. The residual
// stream is read twice (LN and the epilogue, the second from L2) and
// written once. The weights are re-read from L2 by every block; wgmma and
// TMA with larger row tiles are for a later PR.
#include "common.cuh"

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

}  // namespace
}  // namespace pandora

// C interface. y and o: (b, t, hw, c) through their strides {batch, t,
// position} in elements, c contiguous. wq, wk, wv, wo: (c, c) in nn.Linear's
// (out, in) layout with row strides wq_s (shared by q, k, v) and wo_s; bo,
// ln_w, ln_b: (c,). heads * dh = c with dh in {16, 32, 64}; t <= 32;
// c % 32 == 0 and c <= 1024. bf16 only (dtype code 1). Returns
// cudaGetLastError() after the launch (0 on success); an unsupported shape
// returns cudaErrorInvalidValue.
extern "C" int pandora_fused_temporal_attn(
    const void* y, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* bo, const void* ln_w, const void* ln_b,
    void* o, int b, int t, int hw, int c, int heads, long long y_sb,
    long long y_st, long long y_sp, long long o_sb, long long o_st,
    long long o_sp, long long wq_s, long long wo_s, float scale, float eps,
    int dtype, void* stream) {
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
  cudaError_t err;
  switch (c / heads) {
    case 16: err = dispatch_r<16>(a, s); break;
    case 32: err = dispatch_r<32>(a, s); break;
    case 64: err = dispatch_r<64>(a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
