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
// Both launch the bf16 core, `conv3x3_wg_kernel`, or for fp32 input
// `conv3x3_tf32_kernel` (below). Same arithmetic as the TPU kernels: the
// zero border lives in the activated domain (the prologue is applied to
// interior pixels only, so the image edge reads 0, not silu(s)); the
// prologue result is rounded to the element type before the product;
// products accumulate in fp32; the bias (fp32) and then the residual are
// added in fp32; one cast at the end. The TPU package splits
// the 960-channel 72x128 slab in two convolutions summed in bf16 because it
// does not fit VMEM whole; this kernel takes every C whole, so there it
// rounds once where the TPU rounds three times.
//
// GEMM view: M = B*H*W output pixels, N = Co, K = 9*C ordered (tap,
// channel) with tap = 3*ky + kx. The weight comes in that layout, (Co, 9*C)
// with K contiguous (`pack_weight` permutes the module's weight once), so
// the weights of one (tap, 64-channel chunk) are 128 contiguous bytes of
// every output channel's row.
//
// What bounds it on the card: the products (2 * M * Co * 9C operations;
// 5.3e12 per 320x512 CFG eval over the routed sites) far outweigh the bytes
// (x read once from device memory, out written once), so they run on the
// tensor cores as wgmma. The bf16 design:
//   - Block tile: 128 output pixels, TH image rows x a TW-wide strip (2 x 64
//     or, where W < 64, 4 x 32), times BN = 160 output channels (Co = 320,
//     640, 1280 split evenly; 64 where Co is no multiple of 160). Two
//     warpgroups, 64 pixels each; the m64 x n160 fp32 accumulator stays in
//     registers.
//   - Activated halo, staged once per channel chunk: for each 64-channel
//     chunk the (TH + 2) x (TW + 2) halo goes to shared memory through
//     cp.async (pixels outside the image and channels past C zero-filled),
//     with the 16-byte chunk c of halo pixel p stored at c ^ (p % 8), into
//     one of two buffers, beside the chunk's scale and shift. With the
//     prologue, the threads then activate the interior pixels in place,
//     once per element per block (the border stays 0), before the chunk's
//     products. (Running that work in slices under the previous chunk's
//     products ran slower on the card. The sigmoid's form decides its
//     cost: as `__expf` and `__fdividef` the prologue added 0.39 ms to
//     the 0.50 of the conv alone at (32,40,64,320->320); as ex2 and
//     rcp.approx, 0.18 to 0.45; chip_smoke.py's check_conv.)
//   - Weights through a ring: each (tap, chunk) piece, BN rows of 128 bytes,
//     goes through a four-slot cp.async ring in the 128-byte swizzle that
//     wgmma's K-major B descriptor reads, two pieces ahead of the products;
//     a chunk's halo rides in the group of its first piece. One barrier per
//     piece; the products of piece i overlap the fragment loads of piece
//     i + 1 (wgmma.wait_group 1).
//   - A at a one-pixel shift: a tap's A rows are the halo pixels shifted by
//     (ky, kx), which no swizzled wgmma descriptor can address (its atoms
//     are 8 rows of 1024 aligned bytes). So A comes into registers through
//     ldmatrix at each tap's shift (the XOR swizzle keeps the eight rows of
//     each 8x8 matrix on distinct banks) and the product is wgmma's `rs`
//     form: A from registers, B from the descriptor.
//   - The store: the fp32 tile goes through shared memory, so that the
//     bias, the residual and the single cast run on whole 16-byte pieces of
//     output rows.
//   - Edge cases: below 64 channels (C = 8, the input conv) one halo chunk
//     holds every channel and the pieces are 64-wide k slices of the packed
//     weight spanning 64 / C taps, each lane's 8-k half reading its own
//     tap's shift (five k16 steps at C = 8 where a chunk per tap would take
//     nine); a C off 64 zero-fills its last chunk; h and w off the tile,
//     and Co off BN, are masked at the store. Every C is taken whole.
//
// fp32 input (the JAX route admits it in any dtype) takes
// `conv3x3_tf32_kernel`: the same tiles, halo and GEMM view on the tensor
// cores in split TF32 (each operand x = hi + lo, hi = x rounded to TF32,
// lo = x - hi rounded the same way, common.cuh's split_tf32; a b as lo hi +
// hi lo + hi hi, lo lo dropped), so its bound is the products at 495 / 3
// TFLOP/s. Its design:
//   - Warp-specialised, three warpgroups. A producer warpgroup streams each
//     (tap, 32-channel chunk) weight piece, BN rows of 128 bytes, by TMA
//     into one of three raw slots two pieces ahead, then splits it into a
//     hi and a lo plane in one of two split slots: once per block and
//     piece, where splitting B after each load would redo it in every
//     warp. It stages each chunk's halo by TMA (32 channels of (TH + 2) x
//     (TW + 2) pixels, 128-byte rows in the 128-byte swizzle, zero outside
//     the image and past C), issued during the chunk before, and applies
//     the prologue to the halo's interior in place, in four parts spread
//     over four pieces. mbarriers hand slots and halo buffers over;
//     setmaxnreg moves registers to the two consumer warpgroups.
//   - Each consumer warpgroup owns 64 pixels x BN = 160 output channels
//     (Co = 320, 640, 1280; 64 where Co is no multiple of 160). Its A comes
//     through ldmatrix at each tap's shift (lane l gets fp32 word l % 4 of
//     row l / 4: the TF32 A fragment), is split in registers, and the
//     products are wgmma m64nNk8 tf32 in the `rs` form; the next piece's A
//     loads under the products.
//   - Precision: each piece (32 k values) is one chain: the small terms lo
//     hi and hi lo first, then hi hi on top of them, so the tensor core's
//     truncation of its running sum falls on the small terms at their own
//     scale and on the big term once a k8 step; the piece's sum then joins
//     the total on the CUDA cores, rounded to nearest (one chain over a
//     long k drifts toward zero). The prologue is the bf16 core's (below).
//     Bias, residual and the store are the bf16 core's epilogue in fp32.
//   - Below 32 channels (C = 8) a piece is a 32-wide k slice of the packed
//     weight spanning 32 / C taps, each lane's half of a k8 step at its own
//     tap's shift; a ragged last chunk's k8 steps past C are skipped.
#include "common.cuh"
#include "tma.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps: two warpgroups

struct ConvArgs {
  const void* x;        // (B, H, W, C)
  const void* w;        // (Co, 9 C)
  const float* bias;    // (Co,)
  const float* scale;   // (B, C) or null
  const float* shift;   // (B, C) or null
  const void* res;      // (B, H, W, Co) or null
  void* out;            // (B, H, W, Co)
  int B, H, W, C, Co, K;  // K = 9 C
};

// silu(v * a + s) with the multiply and the add rounded apart, as the plain
// version and the TPU kernel compute it. The sigmoid is 1 / (1 + 2^(-t
// log2 e)) on the special-function unit (ex2 and rcp, each within a few ulp
// of fp32: far below the bf16 rounding that follows; the fp32 kernel stays
// within a tenth of chip_smoke.py's ref64 bound with it, and expf with an
// IEEE division made its prologue cases 13-16% slower at full width);
// below -80 silu is under 1e-33 and reads 0.
__device__ __forceinline__ float prologue(float v, float a, float s) {
  const float t = __fadd_rn(__fmul_rn(v, a), s);
  const float e = ex2(-kLog2e * t);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return t < -80.f ? 0.f : t * r;
}

// -- bf16: the wgmma core ---------------------------------------------------

constexpr int kChunk = 64;     // channels per halo chunk: 128-byte rows
constexpr int kAhead = 2;      // weight pieces in flight ahead of the products
constexpr int kRing = kAhead + 2;  // ring slots: the products of piece i - 1
                                   // may still read while i + 2 lands

template <int TW, int BN>
struct ConvPlan {
  static constexpr int TH = 128 / TW;        // image rows per tile
  static constexpr int HW = TW + 2;          // halo width
  static constexpr int HP = (TH + 2) * HW;   // halo pixels
  static constexpr int HB = (HP * 128 + 1023) / 1024 * 1024;  // halo bytes
  static constexpr int WB = BN * 128;        // bytes of one weight piece
  static constexpr int SS = 2 * kChunk * 4;  // a chunk's scale and shift
  static constexpr size_t smem_bytes = 1024 + 2 * static_cast<size_t>(HB) +
                                       kRing * static_cast<size_t>(WB) +
                                       2 * SS;
  static_assert(BN % 8 == 0 && WB % 1024 == 0, "BN rows of 128 bytes");
};

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d += a (64 x 16 in registers: each warp's 16 rows as the mma.sync A
// fragment) * b (16 x 160, shared, K-major descriptor) for the warpgroup.
__device__ __forceinline__ void wgmma_rs_kn160(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a (64 x 16 in registers: each warp's 16 rows as the mma.sync A
// fragment) * b (16 x 64, shared, K-major descriptor) for the warpgroup.
__device__ __forceinline__ void wgmma_rs_kn64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (BN == 160)
    wgmma_rs_kn160(d, a, b);
  else
    wgmma_rs_kn64(d, a, b);
}

// The prologue on the interior pixels of a staged halo chunk, in place,
// rounded to bf16; border pixels (outside the image) and channels past the
// chunk's `cc` stay 0. ss: the chunk's 64 scale, then 64 shift values.
template <int TW, int BN>
__device__ __forceinline__ void activate_halo(unsigned char* hb,
                                              const float* ss,
                                              const ConvArgs& a, int y0,
                                              int x0, int cc) {
  using P = ConvPlan<TW, BN>;
  for (int idx = threadIdx.x; idx < P::HP * 8; idx += kThreads) {
    const int hp = idx >> 3;
    const int c = (idx & 7) ^ (hp & 7);  // logical chunk of this piece
    const int hy = hp / P::HW;
    const int y = y0 + hy - 1;
    const int x = x0 + hp - hy * P::HW - 1;
    if (c * 8 >= cc || y < 0 || y >= a.H || x < 0 || x >= a.W) continue;
    const float4 s0 = *reinterpret_cast<const float4*>(ss + c * 8);
    const float4 s1 = *reinterpret_cast<const float4*>(ss + c * 8 + 4);
    const float4 h0 = *reinterpret_cast<const float4*>(ss + kChunk + c * 8);
    const float4 h1 =
        *reinterpret_cast<const float4*>(ss + kChunk + c * 8 + 4);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float sh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    uint4* p = reinterpret_cast<uint4*>(hb + idx * 16);
    uint4 v = *p;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      e[i] = __floats2bfloat162_rn(
          prologue(f.x, sc[2 * i], sh[2 * i]),
          prologue(f.y, sc[2 * i + 1], sh[2 * i + 1]));
    }
    *p = v;
  }
}

// grid (B x row tiles x strips, Co tiles); one block of two warpgroups.
template <int TW, int BN, bool kPro, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wg_kernel(const ConvArgs a) {
  using P = ConvPlan<TW, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  unsigned char* halo = smem + ((1024 - (sa & 1023)) & 1023);  // 2 buffers
  unsigned char* ring = halo + 2 * P::HB;
  float* sshift = reinterpret_cast<float*>(ring + kRing * P::WB);  // 2 bufs

  const int strips = (a.W + TW - 1) / TW;
  const int rows = (a.H + P::TH - 1) / P::TH;
  const int x0 = static_cast<int>(blockIdx.x % strips) * TW;
  const int y0 = static_cast<int>(blockIdx.x / strips % rows) * P::TH;
  const int b = static_cast<int>(blockIdx.x / strips / rows);
  const int n0 = blockIdx.y * BN;
  const int nchunks = (a.C + kChunk - 1) / kChunk;
  const int nsteps = 9 * nchunks;
  const bf16* xb = static_cast<const bf16*>(a.x) +
                   static_cast<long long>(b) * a.H * a.W * a.C;
  const bf16* wb = static_cast<const bf16*>(a.w) +
                   static_cast<long long>(n0) * a.K;

  // the halo of `chunk` into its buffer (chunk % 2)
  auto load_halo = [&](int chunk) {
    const int c0 = chunk * kChunk;
    const int cc = min(kChunk, a.C - c0);
    unsigned char* dst = halo + (chunk & 1) * P::HB;
    if (kPro && threadIdx.x < 32) {  // the chunk's scale, then its shift
      const int q = threadIdx.x & 15;
      const float* src = threadIdx.x < 16 ? a.scale : a.shift;
      const bool ok = q * 4 < cc;
      cp_async16(sshift + (chunk & 1) * 2 * kChunk + threadIdx.x * 4,
                 src + static_cast<long long>(b) * a.C + c0 + (ok ? q * 4 : 0),
                 ok);
    }
    for (int idx = threadIdx.x; idx < P::HP * 8; idx += kThreads) {
      const int hp = idx >> 3;
      const int c = idx & 7;
      const int hy = hp / P::HW;
      const int y = y0 + hy - 1;
      const int x = x0 + hp - hy * P::HW - 1;
      const bool ok = c * 8 < cc && y >= 0 && y < a.H && x >= 0 && x < a.W;
      cp_async16(dst + hp * 128 + ((c ^ (hp & 7)) << 4),
                 ok ? xb + (static_cast<long long>(y) * a.W + x) * a.C + c0 +
                          c * 8
                    : xb,
                 ok);
    }
  };
  // cp.async group j: weight piece j (tap j % 9 of chunk j / 9) and, when
  // j opens a chunk, that chunk's halo (and its scale and shift)
  auto issue = [&](int j) {
    if (j < nsteps) {
      const int chunk = j / 9;
      const int tap = j - 9 * chunk;
      const int c0 = chunk * kChunk;
      const int cc = min(kChunk, a.C - c0);
      if (tap == 0) load_halo(chunk);
      unsigned char* dst = ring + (j % kRing) * P::WB;
      const bf16* src = wb + tap * a.C + c0;
      for (int idx = threadIdx.x; idx < BN * 8; idx += kThreads) {
        const int r = idx >> 3;
        const int c = idx & 7;
        const bool ok = n0 + r < a.Co && c * 8 < cc;
        cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
                   ok ? src + static_cast<long long>(r) * a.K + c * 8 : src,
                   ok);
      }
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  // this lane's ldmatrix row: pixel warp * 16 + (lane & 15) of the tile, at
  // halo pixel hp0 for tap (0, 0); its k half (lane >> 4)
  const int pix = warp * 16 + (lane & 15);
  const int hp0 = pix / TW * P::HW + pix % TW;
  const int khalf = lane >> 4;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t af[3][4][4];  // three taps' A fragments: one in flight, one next

  if (a.C < kChunk) {
    // every channel fits one halo chunk: the pieces are 64-wide k slices of
    // the packed weight, each spanning 64 / C taps (C = 8: eight taps and
    // then one), and each lane's 8-k half of a k16 step reads its own
    // tap's shift; k at or past 9 C reads zero weights
    const int npieces = (a.K + kChunk - 1) / kChunk;
    auto issue_small = [&](int j) {
      if (j < npieces) {
        if (j == 0) load_halo(0);
        unsigned char* dst = ring + (j % kRing) * P::WB;
        for (int idx = threadIdx.x; idx < BN * 8; idx += kThreads) {
          const int r = idx >> 3;
          const int k = j * kChunk + (idx & 7) * 8;
          const bool ok = n0 + r < a.Co && k < a.K;
          cp_async16(dst + r * 128 + (((idx & 7) ^ (r & 7)) << 4),
                     ok ? wb + static_cast<long long>(r) * a.K + k : wb, ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < kAhead; ++j) issue_small(j);
    for (int j = 0; j < npieces; ++j) {
      cp_async_wait<kAhead - 1>();
      fence_async_shared();
      __syncthreads();
      issue_small(j + kAhead);
      if (kPro && j == 0) {
        activate_halo<TW, BN>(halo, sshift, a, y0, x0, a.C);
        __syncthreads();
      }
      uint32_t A[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const int k = j * kChunk + kc * 16 + khalf * 8;
        if (k - khalf * 8 >= a.K) break;
        const int tap = min(k / a.C, 8);
        const int c8 = (k - tap * a.C) >> 3;
        const int hp = hp0 + (tap / 3) * P::HW + tap % 3;
        ldsm_x4(A[kc], halo + hp * 128 + ((c8 ^ (hp & 7)) << 4));
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) reg_fence(A[kc]);
      reg_fence(acc);
      wgmma_fence();
      const unsigned char* ws = ring + (j % kRing) * P::WB;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        if (j * kChunk + kc * 16 < a.K)
          wgmma_rs_k<BN>(acc, A[kc], sw128_desc(ws + kc * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
    }
  } else {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) issue(j);
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const unsigned char* hb = halo + (chunk & 1) * P::HB;
      const int cc = min(kChunk, a.C - chunk * kChunk);
      const int nk = (cc + 15) / 16;  // k16 steps of this chunk
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int i = chunk * 9 + tap;
        cp_async_wait<kAhead - 1>();
        fence_async_shared();
        __syncthreads();  // group i (piece i, any halo in it) landed; the
                          // slot of piece i - 2 is free
        issue(i + kAhead);
        if (kPro && tap == 0) {
          activate_halo<TW, BN>(halo + (chunk & 1) * P::HB,
                                sshift + (chunk & 1) * 2 * kChunk, a, y0, x0,
                                cc);
          __syncthreads();
        }
        const int hp = hp0 + (tap / 3) * P::HW + tap % 3;
        uint32_t(&A)[4][4] = af[tap % 3];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          if (kc < nk)
            ldsm_x4(A[kc],
                    hb + hp * 128 + (((2 * kc + khalf) ^ (hp & 7)) << 4));
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) reg_fence(A[kc]);
        reg_fence(acc);
        wgmma_fence();
        const unsigned char* ws = ring + (i % kRing) * P::WB;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          if (kc < nk)
            wgmma_rs_k<BN>(acc, A[kc], sw128_desc(ws + kc * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait_one();
      }
    }
  }
  wgmma_wait_all();
  reg_fence(acc);

  // epilogue: the fp32 tile goes through shared memory (the halo and ring
  // are free now) so that each thread then writes whole 16-byte pieces of
  // an output row: + bias, + residual, in fp32; one cast
  constexpr int kPitch = BN + 4;  // floats: fragment writes conflict-free
  static_assert(128 * kPitch * 4 + 1024 <= P::smem_bytes, "staging");
  float* stage = reinterpret_cast<float*>(halo);
  __syncthreads();  // every warp's last fragment loads are done
  {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(stage + (warp * 16 + g + 8 * hh) * kPitch +
                                   8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(a.out);
  const bf16* res = static_cast<const bf16*>(a.res);
  for (int idx = threadIdx.x; idx < 128 * (BN / 8); idx += kThreads) {
    const int p = idx / (BN / 8);
    const int col = n0 + (idx - p * (BN / 8)) * 8;
    const int y = y0 + p / TW;
    const int x = x0 + p % TW;
    if (y >= a.H || x >= a.W || col >= a.Co) continue;  // Co % 8 == 0
    const float* sv = stage + p * kPitch + col - n0;
    const float4 v0 = *reinterpret_cast<const float4*>(sv);
    const float4 v1 = *reinterpret_cast<const float4*>(sv + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(a.bias + col);
    const float4 b1 = *reinterpret_cast<const float4*>(a.bias + col + 4);
    float v[8] = {v0.x + b0.x, v0.y + b0.y, v0.z + b0.z, v0.w + b0.w,
                  v1.x + b1.x, v1.y + b1.y, v1.z + b1.z, v1.w + b1.w};
    const long long off =
        ((static_cast<long long>(b) * a.H + y) * a.W + x) * a.Co + col;
    if (kRes) {
      const uint4 r = *reinterpret_cast<const uint4*>(res + off);
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(r2[i]);
        v[2 * i] += f.x;
        v[2 * i + 1] += f.y;
      }
    }
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(out + off) = o;
  }
}

// -- fp32: split TF32 on wgmma -----------------------------------------------

constexpr int kChunkF = 32;  // fp32 channels per halo chunk: 128-byte rows
constexpr int kConsumersF = 256;                  // two consumer warpgroups
constexpr int kThreadsF = kConsumersF + 128;      // and a producer warpgroup
// registers a thread after setmaxnreg: 2 x 232 + 40 = 3 x 168, the share
// each of the 384 threads starts with
constexpr int kConsumerRegsF = 232;
constexpr int kProducerRegsF = 40;
constexpr int kLeadF = 2;   // pieces the weight copies run ahead of the split
constexpr int kRawF = kLeadF + 1;  // raw weight slots (TMA)
constexpr int kSlotsF = 2;         // split slots (hi, lo) the products read

// The tensor maps: the packed weight (Co, 9 C) in boxes of 32 k x BN
// rows; x (B, H, W, C) in halo boxes of 32 channels x (TW + 2) x (TH + 2)
// pixels x 1 image, whose coordinates start one pixel before the tile
struct ConvMaps {
  CUtensorMap w, x;
};

template <int TW, int BN>
struct ConvPlanF32 : ConvPlan<TW, BN> {
  using P = ConvPlan<TW, BN>;
  // two halo buffers, kRawF raw weight slots, kSlotsF split slots (hi and
  // lo), the mbarriers
  static constexpr size_t smem_bytes =
      1024 + 2 * static_cast<size_t>(P::HB) +
      (kRawF + 2 * kSlotsF) * static_cast<size_t>(P::WB) + 128;
};

// grid (B x row tiles x strips, Co tiles); one block of a producer
// warpgroup and two consumer warpgroups. The bf16 core's tiles and halo,
// at 32 channels a chunk; every product three TF32 products of split
// operands.
template <int TW, int BN, bool kPro, bool kRes>
__global__ void __launch_bounds__(kThreadsF, 1)
conv3x3_tf32_kernel(const __grid_constant__ ConvMaps maps, const ConvArgs a) {
  using P = ConvPlan<TW, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  unsigned char* halo = smem + ((1024 - (sa & 1023)) & 1023);  // 2 buffers
  unsigned char* raw = halo + 2 * P::HB;         // kRawF raw weight slots
  unsigned char* split = raw + kRawF * P::WB;    // kSlotsF x (hi, lo)
  uint64_t* full = reinterpret_cast<uint64_t*>(split + 2 * kSlotsF * P::WB);
  uint64_t* empty = full + kSlotsF;   // split slot s read by every warp
  uint64_t* hfull = empty + kSlotsF;  // halo buffer b staged (activated)
  uint64_t* hempty = hfull + 2;       // halo buffer b read by every warp
  uint64_t* rawfull = hempty + 2;     // raw slot r landed (TMA)
  uint64_t* hland = rawfull + kRawF;  // halo buffer b landed (TMA)

  const int strips = (a.W + TW - 1) / TW;
  const int rows = (a.H + P::TH - 1) / P::TH;
  const int x0 = static_cast<int>(blockIdx.x % strips) * TW;
  const int y0 = static_cast<int>(blockIdx.x / strips % rows) * P::TH;
  const int b = static_cast<int>(blockIdx.x / strips / rows);
  const int n0 = blockIdx.y * BN;
  // below 32 channels one halo chunk holds every channel and piece j is
  // the k slice [32 j, 32 j + 32) of the packed weight (spanning 32 / C
  // taps); else piece j is tap j % 9 of chunk j / 9
  const bool narrow = a.C < kChunkF;
  const int npieces = narrow ? (a.K + kChunkF - 1) / kChunkF
                             : 9 * ((a.C + kChunkF - 1) / kChunkF);
  auto chunk_of = [&](int j) { return narrow ? 0 : j / 9; };
  auto channels = [&](int chunk) {
    return narrow ? a.C : min(kChunkF, a.C - chunk * kChunkF);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlotsF; ++i) {
      mbar_init(&full[i], 128);   // every producer thread
      mbar_init(&empty[i], 8);    // every consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&hfull[i], 128);
      mbar_init(&hempty[i], 8);
      mbar_init(&hland[i], 1);
    }
    for (int i = 0; i < kRawF; ++i) mbar_init(&rawfull[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumersF) {
    // -- producer: one thread streams each weight piece (and each chunk's
    // halo) by TMA, kLeadF pieces ahead; once a piece has landed the
    // warpgroup splits it into hi and lo in a split slot (and activates a
    // chunk's halo once it has landed)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegsF));
    const int t = threadIdx.x - kConsumersF;
    // the piece whose copy carries chunk c's halo: the first, or tap 4 of
    // the chunk before (c - 2's halo buffer is read by then)
    const int nchunks = narrow ? 1 : npieces / 9;
    auto carries_halo = [&](int j, int& chunk) {
      chunk = narrow ? 0 : (j + 5) / 9;
      return j == 0 || (!narrow && (j + 5) % 9 == 0 && chunk < nchunks);
    };
    // the part of a chunk's activation due once piece j is finished: chunk
    // 0 at once with piece 0, chunk c > 0 in four parts with pieces 9 c - 5
    // .. 9 c - 2, so that no piece waits long for its split
    auto activation = [&](int j, int& chunk, int& part, int& parts) {
      chunk = narrow ? 0 : (j + 5) / 9;
      part = j == 0 ? 0 : j + 5 - 9 * chunk;
      parts = j == 0 ? 1 : 4;
      return j == 0 || (!narrow && chunk < nchunks && part < 4);
    };
    for (int j = 0; j < npieces + kLeadF; ++j) {
      int chunk;
      if (t == 0 && j < npieces) {
        if (carries_halo(j, chunk)) {
          if (chunk >= 2) mbar_wait(&hempty[chunk & 1], ((chunk >> 1) - 1) & 1);
          mbar_expect_tx(&hland[chunk & 1], P::HP * 128);
          tma_load_4d(halo + (chunk & 1) * P::HB, &maps.x, &hland[chunk & 1],
                      chunk * kChunkF, x0 - 1, y0 - 1, b);
        }
        const int wc = chunk_of(j);
        const int k0 = narrow ? j * kChunkF : (j - 9 * wc) * a.C + wc * kChunkF;
        mbar_expect_tx(&rawfull[j % kRawF], P::WB);
        tma_load_2d(raw + (j % kRawF) * P::WB, &maps.w, &rawfull[j % kRawF],
                    k0, n0);
      }
      const int jj = j - kLeadF;  // the piece to finish
      if (jj < 0) continue;
      int part, parts;
      if (activation(jj, chunk, part, parts)) {
        if (part == 0) mbar_wait(&hland[chunk & 1], (chunk >> 1) & 1);
        if (kPro) {
          // the thread's 4 channels (t % 8) of every 16th halo pixel, a
          // part of them; the zero border and channels past C stay 0
          const int c0 = chunk * kChunkF + (t & 7) * 4;
          if (c0 < a.C) {
            const long long bc = static_cast<long long>(b) * a.C + c0;
            const float4 sc = *reinterpret_cast<const float4*>(a.scale + bc);
            const float4 sh = *reinterpret_cast<const float4*>(a.shift + bc);
            unsigned char* hb = halo + (chunk & 1) * P::HB;
#pragma unroll 2
            for (int hp = (t >> 3) + 16 * part; hp < P::HP; hp += 16 * parts) {
              const int hy = hp / P::HW;
              const int y = y0 + hy - 1;
              const int x = x0 + hp - hy * P::HW - 1;
              if (y < 0 || y >= a.H || x < 0 || x >= a.W) continue;
              float4* q = reinterpret_cast<float4*>(
                  hb + hp * 128 + (((t & 7) ^ (hp & 7)) << 4));
              float4 v = *q;
              v.x = prologue(v.x, sc.x, sh.x);
              v.y = prologue(v.y, sc.y, sh.y);
              v.z = prologue(v.z, sc.z, sh.z);
              v.w = prologue(v.w, sc.w, sh.w);
              *q = v;
            }
          }
        }
        if (part == parts - 1) mbar_arrive(&hfull[chunk & 1]);
      }
      const int s = jj % kSlotsF;
      mbar_wait(&rawfull[jj % kRawF], (jj / kRawF) & 1);
      if (jj >= kSlotsF) mbar_wait(&empty[s], ((jj / kSlotsF) - 1) & 1);
      const unsigned char* src = raw + (jj % kRawF) * P::WB;
      unsigned char* hi = split + 2 * s * P::WB;
#pragma unroll 2
      for (int off = t * 16; off < P::WB; off += 128 * 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + off);
        uint4 h, l;
        split_tf32(__uint_as_float(v.x), h.x, l.x);
        split_tf32(__uint_as_float(v.y), h.y, l.y);
        split_tf32(__uint_as_float(v.z), h.z, l.z);
        split_tf32(__uint_as_float(v.w), h.w, l.w);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(hi + P::WB + off) = l;
      }
      fence_async_shared();  // wgmma reads the split slot; the next TMA
                             // into the raw slot comes after these reads
      mbar_arrive(&full[s]);
      named_bar(2, 128);     // the raw slot is free for piece jj + kRawF
    }
    return;
  }

  // -- consumers: warpgroup w multiplies pixels 64 w.. of the tile --------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegsF));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  // this lane's ldmatrix row: pixel warp * 16 + (lane & 15) of the tile, at
  // halo pixel hp0 for tap (0, 0); its 4-channel half of a k8 step
  const int pix = warp * 16 + (lane & 15);
  const int hp0 = pix / TW * P::HW + pix % TW;
  const int khalf = lane >> 4;

  // A of piece i: the warp's 16 pixels at the piece's tap shift through
  // ldmatrix (lane l gets fp32 word l % 4 of row l / 4: the TF32 A
  // fragment), k8 steps at or past nk(i) left alone
  auto nk_of = [&](int i) {
    return narrow ? min(4, (a.K - i * kChunkF) / 8)
                  : min(4, (channels(chunk_of(i)) + 7) / 8);
  };
  auto load_a = [&](int i, uint32_t (&r)[4][4]) {
    const int chunk = chunk_of(i);
    const int nk = nk_of(i);
    const unsigned char* hb = halo + (chunk & 1) * P::HB;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if (kc < nk) {
        int tap = i - 9 * chunk, c4 = 2 * kc + khalf;
        if (narrow) {
          const int k = i * kChunkF + kc * 8 + khalf * 4;
          tap = min(k / a.C, 8);
          c4 = (k - tap * a.C) >> 2;
        }
        const int hp = hp0 + (tap / 3) * P::HW + tap % 3;
        ldsm_x4(r[kc], hb + hp * 128 + ((c4 ^ (hp & 7)) << 4));
      }
    }
  };
  auto opens = [&](int i) { return narrow ? i == 0 : i % 9 == 0; };

  float part[BN / 2], total[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) total[i] = 0.f;
  uint32_t nr[4][4];  // the next piece's A, loaded under the products
  mbar_wait(&hfull[0], 0);
  load_a(0, nr);
  for (int i = 0; i < npieces; ++i) {
    const int chunk = chunk_of(i);
    const int nk = nk_of(i);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      if (kc < nk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(nr[kc][e]), ah[kc][e], al[kc][e]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      reg_fence(ah[kc]);
      reg_fence(al[kc]);
    }
    const int s = i % kSlotsF;
    mbar_wait(&full[s], (i / kSlotsF) & 1);
    wgmma_fence();
    // one chain of at most 32 k values: the small terms lo hi and hi lo
    // first, then the big term hi hi on top of them, so the tensor core's
    // truncation of its sum falls on the small terms at their own scale
    // and on the big term once a k8 step; the chain's sum then joins the
    // total on the CUDA cores, rounded to nearest
    const unsigned char* ws = split + 2 * s * P::WB;
    const unsigned char* wl = ws + P::WB;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      if (kc < nk) {
        wgmma_tf32<BN>(part, al[kc], sw128_desc(ws + kc * 32, 16, 1024),
                       kc);
        wgmma_tf32<BN>(part, ah[kc], sw128_desc(wl + kc * 32, 16, 1024), 1);
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      if (kc < nk)
        wgmma_tf32<BN>(part, ah[kc], sw128_desc(ws + kc * 32, 16, 1024), 1);
    wgmma_commit();
    // under the products: the next piece's A
    if (i + 1 < npieces) {
      if (opens(i + 1))
        mbar_wait(&hfull[chunk_of(i + 1) & 1], (chunk_of(i + 1) >> 1) & 1);
      load_a(i + 1, nr);
    }
    wgmma_wait_all();
    reg_fence(part);
    if (lane == 0) {  // this warp is done with the slot (and the chunk)
      mbar_arrive(&empty[s]);
      if (narrow ? i == npieces - 1 : i % 9 == 8)
        mbar_arrive(&hempty[chunk & 1]);
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) total[e] += part[e];
  }

  // epilogue: the fp32 tile through shared memory (the halo and the slots
  // are free once both consumer warpgroups are past their last products),
  // then whole 16-byte pieces of output rows: + bias, + residual, in fp32
  constexpr int kPitch = BN + 4;  // floats: fragment writes conflict-free
  static_assert(128 * kPitch * 4 + 1024 <= ConvPlanF32<TW, BN>::smem_bytes,
                "staging");
  float* stage = reinterpret_cast<float*>(halo);
  named_bar(1, kConsumersF);
  {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(stage + (warp * 16 + g + 8 * hh) * kPitch +
                                   8 * j + 2 * t) =
            make_float2(total[4 * j + 2 * hh], total[4 * j + 2 * hh + 1]);
  }
  named_bar(1, kConsumersF);
  float* out = static_cast<float*>(a.out);
  const float* res = static_cast<const float*>(a.res);
  for (int idx = threadIdx.x; idx < 128 * (BN / 4); idx += kConsumersF) {
    const int p = idx / (BN / 4);
    const int col = n0 + (idx - p * (BN / 4)) * 4;
    const int y = y0 + p / TW;
    const int x = x0 + p % TW;
    if (y >= a.H || x >= a.W || col >= a.Co) continue;  // Co % 8 == 0
    const float4 v = *reinterpret_cast<const float4*>(stage + p * kPitch +
                                                      col - n0);
    const float4 bs = *reinterpret_cast<const float4*>(a.bias + col);
    float4 o = make_float4(v.x + bs.x, v.y + bs.y, v.z + bs.z, v.w + bs.w);
    const long long off =
        ((static_cast<long long>(b) * a.H + y) * a.W + x) * a.Co + col;
    if (kRes) {
      const float4 r = *reinterpret_cast<const float4*>(res + off);
      o.x += r.x;
      o.y += r.y;
      o.z += r.z;
      o.w += r.w;
    }
    *reinterpret_cast<float4*>(out + off) = o;
  }
}

template <bool kF32, int TW, int BN, bool kPro, bool kRes>
cudaError_t launch_wg(const ConvArgs& a, cudaStream_t stream) {
  using P = ConvPlan<TW, BN>;
  const long long tiles = static_cast<long long>(a.B) *
                          ((a.H + P::TH - 1) / P::TH) *
                          ((a.W + TW - 1) / TW);
  const dim3 grid(static_cast<unsigned>(tiles), (a.Co + BN - 1) / BN);
  if constexpr (kF32) {
    ConvMaps maps;
    const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(a.K),
                                 static_cast<cuuint64_t>(a.Co)};
    const cuuint64_t wstr[1] = {static_cast<cuuint64_t>(a.K) * 4};
    const cuuint32_t wbox[2] = {kChunkF, BN};
    const cuuint64_t xdims[4] = {
        static_cast<cuuint64_t>(a.C), static_cast<cuuint64_t>(a.W),
        static_cast<cuuint64_t>(a.H), static_cast<cuuint64_t>(a.B)};
    const cuuint64_t xstr[3] = {static_cast<cuuint64_t>(a.C) * 4,
                                static_cast<cuuint64_t>(a.W) * a.C * 4,
                                static_cast<cuuint64_t>(a.H) * a.W * a.C * 4};
    const cuuint32_t xbox[4] = {kChunkF, TW + 2, P::TH + 2, 1};
    if (!encode_f32(&maps.w, static_cast<const float*>(a.w), 2, wdims, wstr,
                    wbox) ||
        !encode_f32(&maps.x, static_cast<const float*>(a.x), 4, xdims, xstr,
                    xbox))
      return cudaErrorInvalidValue;
    auto kernel = conv3x3_tf32_kernel<TW, BN, kPro, kRes>;
    constexpr size_t smem = ConvPlanF32<TW, BN>::smem_bytes;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreadsF, smem, stream>>>(maps, a);
    return cudaGetLastError();
  } else {
    auto kernel = conv3x3_wg_kernel<TW, BN, kPro, kRes>;
    const cudaError_t err = allow_smem(kernel, P::smem_bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, P::smem_bytes, stream>>>(a);
    return cudaGetLastError();
  }
}

template <bool kF32, int TW, bool kPro, bool kRes>
cudaError_t launch_bn(const ConvArgs& a, cudaStream_t stream) {
  return a.Co % 160 == 0 ? launch_wg<kF32, TW, 160, kPro, kRes>(a, stream)
                         : launch_wg<kF32, TW, 64, kPro, kRes>(a, stream);
}

template <bool kPro, bool kRes>
cudaError_t launch(const ConvArgs& a, int dtype, cudaStream_t stream) {
  // strips of 64 pixels where the image is that wide, else of 32
  if (dtype == kFloat32)
    return a.W >= 64 ? launch_bn<true, 64, kPro, kRes>(a, stream)
                     : launch_bn<true, 32, kPro, kRes>(a, stream);
  return a.W >= 64 ? launch_bn<false, 64, kPro, kRes>(a, stream)
                   : launch_bn<false, 32, kPro, kRes>(a, stream);
}

int run(const void* x, const void* w, const void* bias, const void* scale,
        const void* shift, const void* res, void* out, int B, int H, int W,
        int C, int Co, int dtype, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  // C and Co multiples of 8 (16-byte pieces); the grid's x extent (pixel
  // tiles of 64 or more) below 2^31 and its y extent (Co / 64) within 65535
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
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.K = 9 * C;
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
