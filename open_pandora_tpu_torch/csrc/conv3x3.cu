// 3x3 stride-1 same-padding convolution over channel-last (B, H, W, C)
// input, as one implicit GEMM, for Hopper (sm_90a):
//     out = conv3x3(pro(x)) + bias [+ residual],  pro(x) = silu(x * a + s)
// with the prologue and the residual each optional (template flags).
//
// Replaces two Pallas kernels of open_pandora_tpu/ops/conv2d.py:
//   - `_kernel` (reached through `conv3x3_nhwc`): no prologue, no residual;
//     launched as pandora_conv3x3 so its launches count apart;
//   - `_fused_kernel` (reached through `conv3x3_fused`): the GroupNorm(+emb)
//     fold a, s (B, C) fp32 applied with SiLU on load, the ResBlock skip
//     added before the single store; launched as pandora_conv3x3_fused.
// Same arithmetic as the TPU kernels: the zero border lives in the
// activated domain (the prologue is applied to interior pixels only, so the
// image edge reads 0, not silu(s)); the prologue result is rounded to the
// element type before the product; products accumulate in fp32; the bias
// (fp32) and then the residual are added in fp32; one cast at the end. The
// TPU package splits the 960-channel 72x128 slab in two convolutions summed
// in bf16 because it does not fit VMEM whole; this kernel takes every C
// whole, so there it rounds once where the TPU rounds three times.
//
// GEMM view: M = B*H*W output pixels, N = Co, K = 9*C ordered (tap, channel)
// with tap = 3*ky + kx. The weight comes in that layout, (Co, 9*C) with K
// contiguous: the wrapper permutes the module's OIHW weight once. Since C is
// a multiple of 8, each 8-channel (16-byte) piece of a k chunk lies inside
// one tap, so a chunk may span taps (C = 8: four taps per 32-wide chunk) and
// the K tail is zero-filled.
//
// What bounds it on the card: the products (2 * M * Co * 9C operations;
// 5.3e12 per 320x512 CFG eval over the routed sites) far outweigh the bytes
// (x read once from device memory, out written once), so they run on the
// tensor cores with warp-level mma.sync m16n8k16 (bf16 in, fp32
// accumulate). A block owns 128 pixels x 128 (or 64, where Co is no
// multiple of 128) output channels and walks K in 32-wide chunks through a
// two-stage shared-memory ring filled from registers: the loads of chunk
// k + 1 are in flight while chunk k is multiplied, and the prologue is
// applied in registers after those products, before the shared-memory
// store. The halo is re-read from L2 by the nine taps rather than staged
// once, and the prologue is recomputed per tap and per output-channel tile;
// wgmma, TMA, a staged and activated halo tile and warp specialisation are
// for a later PR. fp32 input (the JAX route admits it) takes a scalar-FMA
// kernel.
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // output pixels per block (bf16 kernel)
constexpr int kBK = 32;        // k per chunk
constexpr int kLd = kBK + 8;   // shared row pitch (elements): 80 bytes

struct ConvArgs {
  const void* x;        // (B, H, W, C)
  const void* w;        // (Co, 9 C)
  const float* bias;    // (Co,)
  const float* scale;   // (B, C) or null
  const float* shift;   // (B, C) or null
  const void* res;      // (B, H, W, Co) or null
  void* out;            // (B, H, W, Co)
  int H, W, C, Co, K;   // K = 9 C
  long long M;          // B H W
};

// Pixel m = (b, y, x) of the output, decoded once per thread and row.
struct Pixel {
  long long m;
  int b, y, x;
  bool valid;
};

__device__ __forceinline__ Pixel decode(const ConvArgs& a, long long m) {
  Pixel p;
  p.valid = m < a.M;
  p.m = p.valid ? m : 0;
  const long long hw = static_cast<long long>(a.H) * a.W;
  p.b = static_cast<int>(p.m / hw);
  const int rem = static_cast<int>(p.m - p.b * hw);
  p.y = rem / a.W;
  p.x = rem - p.y * a.W;
  return p;
}

// silu(v * a + s) with the multiply and the add rounded apart, as the plain
// version and the TPU kernel compute it. The loader recomputes it for each
// of the nine taps and each output-channel tile, so the sigmoid takes the
// fast exp and divide (a few ulp of fp32, far below the bf16 rounding that
// follows); below -80 silu is under 1e-33 and reads 0.
__device__ __forceinline__ float prologue(float v, float a, float s) {
  const float t = __fadd_rn(__fmul_rn(v, a), s);
  return t < -80.f ? 0.f : __fdividef(t, 1.f + __expf(-t));
}

// Eight input channels of one tap for one output pixel, as loaded: `live`
// where they lie inside the image (only those take the prologue), `bc` the
// offset of their (batch, channel) in scale and shift.
struct APiece {
  uint4 v;
  long long bc;
  bool live;
};

// Channels [c, c + 8) of tap `k / C` for pixel p; zero outside the image and
// past K. The load is only issued here: its value is first used in
// `activate`, after the products of the chunk in flight.
__device__ __forceinline__ APiece load_a(const ConvArgs& a, const Pixel& p,
                                         int k) {
  APiece r;
  r.v = make_uint4(0u, 0u, 0u, 0u);
  r.live = false;
  r.bc = 0;
  if (!p.valid || k >= a.K) return r;
  const int tap = k / a.C;
  const int c = k - tap * a.C;
  const int dy = tap / 3 - 1;
  const int dx = tap - 3 * (tap / 3) - 1;
  const int yy = p.y + dy;
  const int xx = p.x + dx;
  if (yy < 0 || yy >= a.H || xx < 0 || xx >= a.W) return r;
  const long long off =
      (p.m + static_cast<long long>(dy) * a.W + dx) * a.C + c;
  r.v = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.x) + off);
  r.live = true;
  r.bc = static_cast<long long>(p.b) * a.C + c;
  return r;
}

// The prologue on a live piece, rounded to bf16; the zero border stays 0.
__device__ __forceinline__ uint4 activate(const ConvArgs& a, APiece r) {
  if (!r.live) return r.v;
  const float4 s0 = *reinterpret_cast<const float4*>(a.scale + r.bc);
  const float4 s1 = *reinterpret_cast<const float4*>(a.scale + r.bc + 4);
  const float4 h0 = *reinterpret_cast<const float4*>(a.shift + r.bc);
  const float4 h1 = *reinterpret_cast<const float4*>(a.shift + r.bc + 4);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float sh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  bf16* e = reinterpret_cast<bf16*>(&r.v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = __float2bfloat16(prologue(__bfloat162float(e[i]), sc[i], sh[i]));
  return r.v;
}

// Eight k values [k, k + 8) of weight row n; zero past Co and K.
__device__ __forceinline__ uint4 load_b(const ConvArgs& a, int n, int k) {
  if (n >= a.Co || k >= a.K) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(
      static_cast<const bf16*>(a.w) + static_cast<long long>(n) * a.K + k);
}

template <int BN, bool kPro, bool kRes>
__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const ConvArgs a) {
  constexpr int kWN = BN / 32;           // warps along N, 32 columns each
  constexpr int kWM = 8 / kWN;           // warps along M
  constexpr int kWarpRows = kBM / kWM;
  constexpr int kMT = kWarpRows / 16;    // m16 tiles per warp
  constexpr int kNT = 4;                 // n8 tiles per warp
  constexpr int kBRows = BN / 64;        // weight rows each thread loads
  __shared__ __align__(16) bf16 sA[2][kBM * kLd];
  __shared__ __align__(16) bf16 sB[2][BN * kLd];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp / kWN;
  const int wn = warp % kWN;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;

  // each thread stages rows tid / 4 (+ 64) of both tiles, k piece tid % 4
  const int row = tid / 4;
  const int kp = (tid % 4) * 8;
  const Pixel px[2] = {decode(a, m0 + row), decode(a, m0 + row + 64)};
  APiece ra[2];
  uint4 rb[kBRows];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) ra[i] = load_a(a, px[i], k0 + kp);
#pragma unroll
    for (int i = 0; i < kBRows; ++i) rb[i] = load_b(a, n0 + row + 64 * i,
                                                    k0 + kp);
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&sA[s][(row + 64 * i) * kLd + kp]) =
          kPro ? activate(a, ra[i]) : ra[i].v;
#pragma unroll
    for (int i = 0; i < kBRows; ++i)
      *reinterpret_cast<uint4*>(&sB[s][(row + 64 * i) * kLd + kp]) = rb[i];
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (a.K + kBK - 1) / kBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) fetch((kc + 1) * kBK);  // in flight during the products
    const bf16* As = sA[s];
    const bf16* Bs = sB[s];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const bf16* ap = As + (wm * kWarpRows + i * 16 + g) * kLd + kk + tig * 2;
        af[i][0] = ld32(ap);
        af[i][1] = ld32(ap + 8 * kLd);
        af[i][2] = ld32(ap + 8);
        af[i][3] = ld32(ap + 8 * kLd + 8);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const bf16* bp = Bs + (wn * 32 + j * 8 + g) * kLd + kk + tig * 2;
        const uint32_t bfrag[2] = {ld32(bp), ld32(bp + 8)};
#pragma unroll
        for (int i = 0; i < kMT; ++i) mma_bf16(acc[i][j], af[i], bfrag);
      }
    }
    if (kc + 1 < nk) stash(s ^ 1);  // stage s ^ 1 was last read at kc - 1
    __syncthreads();
  }

  // epilogue: + bias, + residual, in fp32; one cast
  bf16* out = static_cast<bf16*>(a.out);
  const bf16* res = static_cast<const bf16*>(a.res);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * kWarpRows + i * 16 + g + 8 * half;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn * 32 + j * 8 + tig * 2;
        if (col >= a.Co) continue;  // Co % 8 == 0: col + 1 < Co too
        float v0 = acc[i][j][2 * half] + a.bias[col];
        float v1 = acc[i][j][2 * half + 1] + a.bias[col + 1];
        if (kRes) {
          const float2 r = Elem<bf16>::load2(res + m * a.Co + col);
          v0 += r.x;
          v1 += r.y;
        }
        Elem<bf16>::store2(out + m * a.Co + col, v0, v1);
      }
    }
}

// fp32: the same function on scalar FMAs. A block owns 64 pixels x 64
// output channels; thread (ty, tx) of the 16 x 16 grid keeps pixels
// ty + 16 i and channels tx + 16 j.
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

template <bool kPro, bool kRes>
__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const ConvArgs a) {
  __shared__ float sA[kFK][kFM + 4];
  __shared__ float sB[kFK][kFN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFM;
  const int n0 = blockIdx.y * kFN;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + kThreads * i;
      const int r = idx % kFM;
      const int k = k0 + idx / kFM;
      const Pixel p = decode(a, m0 + r);
      float v = 0.f;
      if (p.valid && k < a.K) {
        const int tap = k / a.C;
        const int c = k - tap * a.C;
        const int dy = tap / 3 - 1;
        const int dx = tap - 3 * (tap / 3) - 1;
        if (p.y + dy >= 0 && p.y + dy < a.H && p.x + dx >= 0 &&
            p.x + dx < a.W) {
          v = x[(p.m + static_cast<long long>(dy) * a.W + dx) * a.C + c];
          if (kPro) {
            const long long bc = static_cast<long long>(p.b) * a.C + c;
            v = prologue(v, a.scale[bc], a.shift[bc]);
          }
        }
      }
      sA[idx / kFM][r] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + kThreads * i;
      const int kk = idx % kFK;
      const int n = idx / kFK;
      const int k = k0 + kk;
      sB[kk][n] = (n0 + n < a.Co && k < a.K)
                      ? w[static_cast<long long>(n0 + n) * a.K + k]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(a.out);
  const float* res = static_cast<const float*>(a.res);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= a.Co) continue;
      float v = acc[i][j] + a.bias[n];
      if (kRes) v += res[m * a.Co + n];
      out[m * a.Co + n] = v;
    }
  }
}

template <bool kPro, bool kRes>
cudaError_t launch(const ConvArgs& a, int dtype, cudaStream_t stream) {
  if (dtype == kFloat32) {
    const dim3 grid(static_cast<unsigned>((a.M + kFM - 1) / kFM),
                    (a.Co + kFN - 1) / kFN);
    conv3x3_f32_kernel<kPro, kRes><<<grid, kThreads, 0, stream>>>(a);
  } else if (a.Co % 128 == 0) {
    const dim3 grid(static_cast<unsigned>((a.M + kBM - 1) / kBM),
                    a.Co / 128);
    conv3x3_bf16_kernel<128, kPro, kRes><<<grid, kThreads, 0, stream>>>(a);
  } else {
    const dim3 grid(static_cast<unsigned>((a.M + kBM - 1) / kBM),
                    (a.Co + 63) / 64);
    conv3x3_bf16_kernel<64, kPro, kRes><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

int run(const void* x, const void* w, const void* bias, const void* scale,
        const void* shift, const void* res, void* out, int B, int H, int W,
        int C, int Co, int dtype, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  // C and Co multiples of 8 (16-byte pieces); the grid's x extent below
  // 2^31 and its y extent (Co / 64) within 65535
  if ((dtype != kFloat32 && dtype != kBFloat16) || B <= 0 || H <= 0 ||
      W <= 0 || C <= 0 || Co <= 0 || C % 8 != 0 || Co % 8 != 0 ||
      9LL * C > (1LL << 30) || (M + 63) / 64 >= (1LL << 31) ||
      (Co + 63) / 64 > 65535 || (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.res = res;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.K = 9 * C;
  a.M = M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (scale != nullptr)
    err = res != nullptr ? launch<true, true>(a, dtype, s)
                         : launch<true, false>(a, dtype, s);
  else
    err = res != nullptr ? launch<false, true>(a, dtype, s)
                         : launch<false, false>(a, dtype, s);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace pandora

// C interface. x (B, H, W, C) and out (B, H, W, Co) contiguous in the
// element type (dtype code 0 fp32, 1 bf16), 16-byte aligned; w (Co, 9 C)
// contiguous in the element type, k = (3 ky + kx) C + c; bias (Co,) fp32.
// C % 8 == 0 and Co % 8 == 0. Returns cudaGetLastError() after the launch (0
// on success); an unsupported shape returns cudaErrorInvalidValue.
extern "C" int pandora_conv3x3(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int C, int Co,
                               int dtype, void* stream) {
  return pandora::run(x, w, bias, nullptr, nullptr, nullptr, out, B, H, W, C,
                      Co, dtype, stream);
}

// The fused form: scale and shift (B, C) fp32, both or neither (null);
// residual (B, H, W, Co) contiguous in the element type, or null.
extern "C" int pandora_conv3x3_fused(const void* x, const void* w,
                                     const void* bias, const void* scale,
                                     const void* shift, const void* residual,
                                     void* out, int B, int H, int W, int C,
                                     int Co, int dtype, void* stream) {
  return pandora::run(x, w, bias, scale, shift, residual, out, B, H, W, C, Co,
                      dtype, stream);
}
