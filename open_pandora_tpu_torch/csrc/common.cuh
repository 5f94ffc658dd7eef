// Shared helpers for the kernels: element conversion for the two supported
// element types (fp32 and bf16), warp reductions, the online-softmax
// attention tiles (the tensor-core `WgTile` for every bf16 launch of the
// flash and packed attention kernels, whose softmax and gated two-stream
// sum the dual cross-attention kernel shares; `tc_softmax` also runs the
// fp32 flash tiles), the cp.async, ldmatrix, mma.sync and wgmma wrappers of
// the tensor-core kernels, and the split-TF32 fragments of the fp32 flash
// and small-attention kernels; the warp-owned tiles of the small-attention
// kernels (bf16 and fp32); mbarrier and TMA helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pandora {

// dtype codes passed through the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// -0.7 * FLT_MAX: the value a causally masked score takes in the plain
// attention (ops/attention_xla.py), so fully masked rows agree with it.
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  // Value of x after a round trip through the element type.
  __device__ static float round(float x) { return x; }
  // Two consecutive elements; p must be 8-byte aligned.
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  // Two consecutive elements; p must be 4-byte aligned.
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// -- tensor-core helpers (the attention tiles below, fused_temporal_attn.cu,
//    conv3x3.cu, fused_geglu.cu)

// Two consecutive bf16 values as one 32-bit word; p must be 4-byte aligned.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// The same copy with a source size: 16 copies the piece, 0 reads nothing
// and zero-fills the 16 bytes of dst.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate. Fragments
// (g = lane / 4, t = lane % 4): a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}; each a and b word holds two k-consecutive
// values.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, which lands in r[i]; lane l gets
// row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of each (of each
// transpose with `trans`).
template <bool kTrans = false>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// Two fp32 values rounded to bf16 in one word, lo in the low half (the
// lower k index of an mma operand).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- wgmma (sm_90a): warpgroup products with operands in shared memory ------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous product.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async
// included) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Matrix descriptor of a tile in shared memory laid out with the 128-byte
// swizzle: rows of 128 bytes (64 bf16), the 16-byte chunk c of row r stored
// at chunk c ^ (r % 8), atoms of 8 rows 1024-byte aligned. lbo: bytes from
// one 64-column block to the next (MN-major operands), sbo: bytes from one
// 8-row group to the next.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d (+)= a (64 x 16, shared, K-major descriptor) * b (16 x 64, shared,
// K-major descriptor) for the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += a (64 x 16 in registers: each warp's 16 rows as the mma.sync A
// fragment) * b (16 x 64, shared, MN-major descriptor) for the warpgroup.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a (64 x 16 in registers: each warp's 16 rows as the mma.sync A
// fragment) * b (16 x 128, shared, MN-major descriptor) for the warpgroup.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 128, shared, K-major) for
// the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 160, shared, K-major) for
// the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n160(float (&d)[80], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
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
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 192, shared, K-major) for
// the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
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
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}
// d (+)= a (64 x 16, shared, K-major) * b (16 x 16, shared, K-major) for
// the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 32, shared, K-major) for
// the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 48, shared, K-major) for
// the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 80, shared, K-major) for
// the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 128, shared, MN-major)
// for the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 256, shared, MN-major)
// for the warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n256_mn(float (&d)[128], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
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
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// TF32 (conv3x3.cu and fused_geglu.cu, fp32 in split TF32): d (+)= a (64 x
// 8 in registers: each warp's 16 rows as the mma.sync m16n8k8 TF32 A
// fragment) * b (8 x N, shared, K-major descriptor, 128-byte swizzled) for
// the warpgroup, N = 64, 128 or 160; scale_d 0 overwrites d. The tensor
// core reads the top 19 bits of each operand.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n160(float (&d)[80],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
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
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  if constexpr (BN == 160)
    wgmma_tf32_n160(d, a, b, scale_d);
  else if constexpr (BN == 128)
    wgmma_tf32_n128(d, a, b, scale_d);
  else
    wgmma_tf32_n64(d, a, b, scale_d);
}

// -- mbarriers and TMA (sm_90) ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the other threads (and the async
// proxy) before any thread or copy uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival on the barrier (a consumer releasing a ring slot).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// TMA: the box of a 2-D tensor map at (c0 innermost, c1) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// TMA: the box of a 4-D tensor map at (c0 innermost, c1, c2, c3) into
// shared memory, completing on `bar`; coordinates may lie outside the
// tensor (what falls outside fills with zeros).
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A barrier among `count` threads (a multiple of 32) under id 1-15.
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The 8 x 8 bf16 matrix of a warp's fragments (lane l: row l / 4, elements
// 2 (l % 4) and 2 (l % 4) + 1) transposed into the same fragment layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// 2^x on the special-function unit (denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- tensor-core attention tiles, bf16 (flash_fwd.cu, packed_attn_fwd.cu) ---
//
// `WgTile`: D <= DMAX <= 128. Two consumer warpgroups, each owning 64 rows
// of a 128-row q tile. Per key tile of 64 the warpgroup issues S = q k^T as
// wgmma with both operands in shared memory (q and k K-major), runs the
// online softmax on the S accumulator fragments in registers (fp32 row max
// and sum, reduced across the quad of lanes that share a row with two
// shuffles; exp2 with log2(e) folded into the scale), repacks p as bf16
// straight from those fragments (the accumulator of two n8 column tiles is
// the A fragment of one k16 chunk, FlashAttention-2's identity) and issues
// O += p v as wgmma with p from registers and v MN-major from shared
// memory. S and p never touch shared memory. K and V tiles stream through
// a two-stage cp.async ring in the 128-byte-swizzled layout wgmma reads
// (which also keeps every 16-byte chunk of a column on its own bank
// group): the next tile's copy is in flight while the current one is
// multiplied; rows past M are zero-filled by the copy itself (a stale row
// could hold a NaN, and 0 * NaN is NaN). The k16 tail of a head width with
// D % 16 == 8 is zeroed once in q and k.
//
// Masking is attn_stream's: keys at or past M weigh exactly 0 (score -inf);
// with `causal` a key col > row + q_offset scores kMaskValue (in the exp2
// domain; a row with no allowed key then weighs every key alike, as the
// plain version does, and its log-sum-exp is kMaskValue).

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Natural-log LSE from the exp2-domain row max m and the row sum l.
__device__ __forceinline__ float tc_lse(float m, float l) {
  return m == kMaskValue ? kMaskValue
                         : (m + log2f(fmaxf(l, 1e-37f))) * kLn2;
}

// The online softmax of one key tile on a warp's S fragments (rows g and
// g + 8 of its 16, g = lane / 4; n8 column tiles j of keys k0 + 8 j +
// 2 (lane % 4) + {0, 1}): masks, the running max m and sum l (fp32, l
// per thread until the caller's quad reduction), the rescale of acc, and s
// overwritten by p. rbase: the sequence index of row g.
template <int NT, int DT, bool kCausal>
__device__ __forceinline__ void tc_softmax(float (&s)[NT][4],
                                           float (&acc)[DT][4],
                                           float (&m)[2], float (&l)[2],
                                           int k0, int M, int rbase,
                                           int q_offset, float scale_log2) {
  const int t = threadIdx.x & 3;
  float sc = scale_log2;
  if (kCausal || k0 + NT * 8 > M) {  // masked tile: work in the exp2 domain
    sc = 1.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale_log2;
        if (col >= M)
          x = -INFINITY;
        else if (kCausal && col > rbase + 8 * (e >> 1) + q_offset)
          x = kMaskValue;
        s[j][e] = x;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * sc);  // finite: col k0 < M
    const float alpha = ex2(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = ex2(fmaf(s[j][e], sc, -m_new));
        sum += p;  // fp32, before the rounding for p v
        s[j][e] = p;
      }
    l[h] = alpha * l[h] + sum;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][2 * h] *= alpha;
      acc[j][2 * h + 1] *= alpha;
    }
  }
}

// -- split-TF32 tiles of the fp32 flash kernels (flash_fwd.cu, flash_bwd.cu)
//    and of the fp32 small-attention kernels (small_attn_fwd.cu,
//    small_attn_bwd.cu: the warp-owned fp32 tiles further below)
//
// An fp32 product runs on the tensor cores as three TF32 products
// (CUTLASS's 3xTF32): each operand x = hi + lo with hi = x rounded to TF32
// (10 mantissa bits, to nearest, ties away from zero: cvt.rna's rounding)
// and lo = x - hi rounded the same way; a b accumulates in fp32 as lo_a hi_b
// + hi_a lo_b + hi_a hi_b, and lo_a lo_b (about 2^-22 of a b) is dropped.
// hi is rounded explicitly: the tensor core would truncate the low 13 bits
// itself, and lo would then not be x - hi. Tiles stay fp32 in shared memory
// (rows of ld = DMAX + 4 floats: every fragment load below is bank-conflict
// free) and are split in registers as fragments are loaded.
//
// Fragments of mma.sync m16n8k8 (g = lane / 4, t = lane % 4): A = {A[g][t],
// A[g+8][t], A[g][t+4], A[g+8][t+4]}, B = {B[t][g], B[t+4][g]}, the
// accumulator as mma_bf16's (rows g, g + 8; columns 2t, 2t + 1). A product
// whose A is an accumulator (p v, p^T do, ds k, ...) reads the k slots in
// another order: slot t is column 2t and slot t + 4 column 2t + 1, so A
// comes from the accumulator without shuffles (`acc_a`) and B's rows are
// taken in the same order (`ldb_kmajor`); an A staged in shared memory is
// read in that order too (`lda_pairs`, `lda_trans_pairs`).

// x = hi + lo, each a TF32 operand. Rounding to nearest with ties away is
// adding half a TF32 ulp (0x1000) to the bit pattern and dropping the low
// 13 bits: hi's are dropped here, lo's by the tensor core, which reads
// only the top 19 bits of a .tf32 operand. (cvt.rna.tf32.f32 compiles to
// the same add and mask behind an isfinite test and a select, twice the
// instructions; attention's operands are finite, and a NaN or an infinity
// stays one in hi + lo.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a (16x8, row) b (8x8, col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment and B fragment, each as its hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// d += a b in split TF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// A fragment of rows {g, g + 8} and columns {t, t + 4} of a row-major fp32
// tile (p: its element (0, 0); ld: its pitch).
__device__ __forceinline__ FragA lda_rows(const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  FragA a;
  split_tf32(p[g * ld + t], a.hi[0], a.lo[0]);
  split_tf32(p[(g + 8) * ld + t], a.hi[1], a.lo[1]);
  split_tf32(p[g * ld + t + 4], a.hi[2], a.lo[2]);
  split_tf32(p[(g + 8) * ld + t + 4], a.hi[3], a.lo[3]);
  return a;
}

// A fragment in the k-slot order of `acc_a` from a row-major fp32 tile
// whose rows are the m index: slots t and t + 4 are columns 2t and 2t + 1
// of rows g and g + 8, one float2 load a row (conflict-free at a pitch of
// 8 mod 16 floats).
__device__ __forceinline__ FragA lda_pairs(const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float2 x0 = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
  FragA a;
  split_tf32(x0.x, a.hi[0], a.lo[0]);
  split_tf32(x1.x, a.hi[1], a.lo[1]);
  split_tf32(x0.y, a.hi[2], a.lo[2]);
  split_tf32(x1.y, a.hi[3], a.lo[3]);
  return a;
}

// The same fragment of X^T, X a row-major fp32 tile whose rows are the k
// index: A[m][slot t] = X[2t][m], A[m][slot t + 4] = X[2t + 1][m].
__device__ __forceinline__ FragA lda_trans_pairs(const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float* r0 = p + 2 * t * ld + g;
  const float* r1 = r0 + ld;
  FragA a;
  split_tf32(r0[0], a.hi[0], a.lo[0]);
  split_tf32(r0[8], a.hi[1], a.lo[1]);
  split_tf32(r1[0], a.hi[2], a.lo[2]);
  split_tf32(r1[8], a.hi[3], a.lo[3]);
  return a;
}

// A fragment of four fp32 values held in registers (rows g, g + 8 at k
// slots t, t + 4).
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA a;
  split_tf32(a0, a.hi[0], a.lo[0]);
  split_tf32(a1, a.hi[1], a.lo[1]);
  split_tf32(a2, a.hi[2], a.lo[2]);
  split_tf32(a3, a.hi[3], a.lo[3]);
  return a;
}

// The A fragment of one n8 tile of an accumulator in the k-slot order
// above: rows g, g + 8 at columns 2t (slot t) and 2t + 1 (slot t + 4).
__device__ __forceinline__ FragA acc_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// B fragment whose n index is a row of a row-major tile: B[k][n] = X[n][k]
// (X's rows g, columns t and t + 4): k^T in q k^T.
__device__ __forceinline__ FragB ldb_nmajor(const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  FragB b;
  split_tf32(p[g * ld + t], b.hi[0], b.lo[0]);
  split_tf32(p[g * ld + t + 4], b.hi[1], b.lo[1]);
  return b;
}

// B fragment whose k index is a row of a row-major tile, in the k-slot
// order of `acc_a`: B[slot t][n] = X[2t][n], B[slot t + 4][n] = X[2t + 1][n]
// (column g): v in p v.
__device__ __forceinline__ FragB ldb_kmajor(const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  FragB b;
  split_tf32(p[2 * t * ld + g], b.hi[0], b.lo[0]);
  split_tf32(p[(2 * t + 1) * ld + g], b.hi[1], b.lo[1]);
  return b;
}

// The tensor core rounds toward zero as it accumulates, so a product
// chained through one accumulator over a whole key axis (hundreds of
// mma.sync steps) drifts tens of times further from the float64 result
// than an fp32 sum does. The products below therefore start from a fresh
// partial over at most 64 of their k values (eight k8 steps) and add it to
// the running sum on the CUDA cores, in fp32 with round to nearest.

// s[i][j] = a_i b_j^T over the head dim: a_i the warp's m16 row tile i of
// a row-major tile (pointer at the first tile's row 0; tile i 16 i rows
// further), b_j row block j of another (pointer at row 0), both at pitch
// ld; k8 steps past D skipped. Each split B fragment feeds all MT tiles.
template <int MT, int NT, int DT>
__device__ __forceinline__ void scores_3xtf32(float (&s)[MT][NT][4],
                                              const float* a, const float* b,
                                              int ld, int D) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < DT; c0 += 8) {
    if (c0 * 8 >= D) break;
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
#pragma unroll
    for (int kc = c0; kc < c0 + 8 && kc < DT; ++kc) {
      if (kc * 8 >= D) break;
      FragA fa[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        fa[i] = lda_rows(a + 16 * i * ld + kc * 8, ld);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const FragB fb = ldb_nmajor(b + j * 8 * ld + kc * 8, ld);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_3xtf32(part[i][j], fa[i], fb);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] += part[i][j][e];
  }
}

// acc[i][j] += p_i x: p_i the warp's m16 tile i of (16, 8 KT) accumulator
// fragments (A in the k-slot order of `acc_a`), x KT * 8 rows of a
// row-major tile at pitch ld (pointer at row 0, column 0 of the output's
// columns); n8 tiles of the output past D skipped. KT <= 8: one partial
// per call, over JMAX n8 tiles of the output at a time. Each split B
// fragment feeds all MT tiles.
template <int MT, int KT, int DT, int JMAX = 8>
__device__ __forceinline__ void acc_pv(float (&acc)[MT][DT][4],
                                       const float (&p)[MT][KT][4],
                                       const float* x, int ld, int D) {
  static_assert(KT <= 8, "one partial covers at most 64 k values");
  constexpr int JB = DT < JMAX ? DT : JMAX;  // n8 tiles per partial
#pragma unroll
  for (int j0 = 0; j0 < DT; j0 += JB) {
    if (j0 * 8 >= D) break;
    float part[MT][JB][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JB; ++j)
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      FragA pa[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) pa[i] = acc_a(p[i][kc]);
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        if ((j0 + j) * 8 >= D) break;
        const FragB fb = ldb_kmajor(x + kc * 8 * ld + (j0 + j) * 8, ld);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_3xtf32(part[i][j], pa[i], fb);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j0 + j][e] += part[i][j][e];
  }
}

// 4 bytes through cp.async (zero-filled where !valid).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// Copy rows [0, ROWS) of a row-major fp32 tile in pieces of W floats
// (PIECES a row, W = 4: 16-byte cp.async, W = 1: 4-byte), zero-filling rows
// at or past `valid` (a stale row could hold a NaN, and 0 * NaN is NaN);
// columns at or past D are not written. A thread keeps its columns and
// steps its source and destination by whole passes of rows.
template <int ROWS, int PIECES, int W, int NTHREADS>
__device__ __forceinline__ void f32_copy_rows(float* dst, int ld,
                                              const float* src,
                                              long long row_stride, int valid,
                                              int D) {
  constexpr int kCols = PIECES > NTHREADS ? PIECES / NTHREADS : 1;
  constexpr int kStep = PIECES > NTHREADS ? 1 : NTHREADS / PIECES;  // rows
  static_assert(PIECES % NTHREADS == 0 || NTHREADS % PIECES == 0,
                "whole rows a pass");
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int piece = threadIdx.x % PIECES + k * NTHREADS;
    const int c = piece * W;
    if (c >= D) continue;
    int r = threadIdx.x / PIECES;
    const float* s = src + r * row_stride + c;
    float* d = dst + r * ld + c;
    for (; r < ROWS; r += kStep, s += kStep * row_stride, d += kStep * ld) {
      const bool ok = r < valid;
      if constexpr (W == 4)
        cp_async16(d, ok ? s : src, ok);
      else
        cp_async4(d, ok ? s : src, ok);
    }
  }
}

// Copy rows [0, ROWS) of D <= DMAX fp32 values (D % 4 == 0) into shared
// memory of pitch ld floats through cp.async (`f32_copy_rows`): 16-byte
// pieces where `vec` (src and the row stride give 16-byte aligned rows),
// else 4-byte ones.
template <int ROWS, int DMAX, int NTHREADS>
__device__ __forceinline__ void f32_load_rows(float* dst, int ld,
                                              const float* src,
                                              long long row_stride, int valid,
                                              int D, bool vec) {
  if (vec)
    f32_copy_rows<ROWS, DMAX / 4, 4, NTHREADS>(dst, ld, src, row_stride,
                                               valid, D);
  else
    f32_copy_rows<ROWS, DMAX, 1, NTHREADS>(dst, ld, src, row_stride, valid,
                                           D);
}

// Copy rows [0, ROWS) of D <= DMAX bf16 (D % 8 == 0; src and the row stride
// 16-byte aligned) into a 128-byte-swizzled tile through cp.async,
// zero-filling rows at or past `valid`. The loop runs over DMAX / 8 pieces
// a row, so its index splits with shifts.
template <int ROWS, int DMAX, int NTHREADS>
__device__ __forceinline__ void sw128_load_rows(unsigned char* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride,
                                                int valid, int D) {
  constexpr int kPieces = DMAX / 8;
  for (int idx = threadIdx.x; idx < ROWS * kPieces; idx += NTHREADS) {
    const int r = idx / kPieces;
    const int c = idx % kPieces;
    if (c * 8 >= D) continue;
    const bool ok = r < valid;
    cp_async16(dst + (c >> 3) * ROWS * 128 + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               src + (ok ? r * row_stride + c * 8 : 0), ok);
  }
}

// Zero the 16-byte chunk D / 8 of every row of a swizzled tile: the k16
// tail of a head width with D % 16 == 8. The copies never write there.
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void sw128_zero_tail(unsigned char* dst, int D) {
  if (D % 16 == 0) return;
  const int c = D / 8;
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS)
    *reinterpret_cast<uint4*>(dst + (c >> 3) * ROWS * 128 + r * 128 +
                              (((c & 7) ^ (r & 7)) << 4)) =
        make_uint4(0, 0, 0, 0);
}

constexpr int kWgGroups = 2;  // consumer warpgroups per block
constexpr int kWgThreads = 128 * kWgGroups;

// Resident blocks per SM of the wgmma tile: a D <= 64 block stays under
// 128 registers a thread, so two blocks (four warpgroups) share an SM and
// one block's softmax overlaps the other's products.
template <int DMAX>
constexpr int kWgMinBlocks = DMAX == 64 ? 2 : 1;

template <int DMAX>
struct WgTile {
  static_assert(DMAX == 64 || DMAX == 128, "wgmma tile: DMAX 64 or 128");
  static constexpr int BQ = 64 * kWgGroups;
  static constexpr int BK = 64;
  static constexpr int NCB = DMAX / 64;  // 64-column swizzle blocks
  static constexpr int NT = BK / 8;      // n8 tiles of a key tile
  static constexpr int DT = DMAX / 8;    // n8 tiles of the output
  static constexpr int QB = BQ * 128;    // bytes of a column block of q
  static constexpr int KB = BK * 128;    // ... of a k or v tile
  // q, then two stages of k and two of v; 1 KB of slack for the alignment
  static constexpr size_t smem_bytes =
      1024 + static_cast<size_t>(NCB) * (QB + 4 * KB);

  unsigned char* q;
  unsigned char* k;  // stage s at k + s * NCB * KB
  unsigned char* v;

  __device__ static WgTile carve(unsigned char* smem, int D) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    WgTile t;
    t.q = smem + ((1024 - (a & 1023)) & 1023);
    t.k = t.q + NCB * QB;
    t.v = t.k + 2 * NCB * KB;
    sw128_zero_tail<BQ, kWgThreads>(t.q, D);
    for (int st = 0; st < 2; ++st) {
      sw128_zero_tail<BK, kWgThreads>(t.k + st * NCB * KB, D);
      sw128_zero_tail<BK, kWgThreads>(t.v + st * NCB * KB, D);
    }
    return t;
  }

  // Load the block's q rows (rows past `valid` zero).
  __device__ void load_q(const __nv_bfloat16* src, long long row_stride,
                         int valid, int D) const {
    sw128_load_rows<BQ, DMAX, kWgThreads>(q, src, row_stride, valid, D);
    cp_async_commit();
  }

  // One key/value stream against the q tile: acc (the warp's 16 rows, D
  // columns, unnormalised), and per row half h (rows g and g + 8) the
  // exp2-domain max m and the quad-reduced sum l. k and v point at key row
  // 0 of this (b, h); key tiles up to kv_end. row0: the sequence index of
  // the block's first q row.
  template <bool kCausal>
  __device__ void stream(float (&acc)[DT][4], float (&m)[2], float (&l)[2],
                         const __nv_bfloat16* kp, long long ksn,
                         const __nv_bfloat16* vp, long long vsn, int M, int D,
                         int row0, int kv_end, float scale_log2,
                         int q_offset) const {
    const int warp = threadIdx.x / 32;
    const int wg = warp / 4;
    const int g = (threadIdx.x & 31) >> 2;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float(&accf)[DT * 4] = reinterpret_cast<float(&)[DT * 4]>(acc);
    const int ntiles = (kv_end + BK - 1) / BK;
    auto issue = [&](int it) {
      const int k0 = it * BK;
      const int valid = min(BK, M - k0);
      sw128_load_rows<BK, DMAX, kWgThreads>(k + (it & 1) * NCB * KB,
                                            kp + k0 * ksn, ksn, valid, D);
      sw128_load_rows<BK, DMAX, kWgThreads>(v + (it & 1) * NCB * KB,
                                            vp + k0 * vsn, vsn, valid, D);
      cp_async_commit();
    };
    __syncthreads();  // earlier readers of the stages are done
    issue(0);
    const unsigned char* qw = q + wg * 64 * 128;
    for (int it = 0; it < ntiles; ++it) {
      cp_async_wait<0>();
      fence_async_shared();
      __syncthreads();  // tile it (and q) landed; tile it - 1's stage is free
      if (it + 1 < ntiles) issue(it + 1);
      const unsigned char* ks = k + (it & 1) * NCB * KB;
      const unsigned char* vs = v + (it & 1) * NCB * KB;

      // S = q k^T: one m64n64k16 per k16 chunk of the head dim
      float s[NT][4];
      float(&sf)[NT * 4] = reinterpret_cast<float(&)[NT * 4]>(s);
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) sf[i] = 0.f;
      reg_fence(sf);  // every operand is written before the fence
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DMAX / 16; ++kc) {
        if (kc * 16 >= D) break;
        const int off = (kc & 3) * 32;  // k16 step inside a 128-byte row
        wgmma_ss_n64(sf, sw128_desc(qw + (kc >> 2) * QB + off, 16, 1024),
                     sw128_desc(ks + (kc >> 2) * KB + off, 16, 1024), kc);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sf);

      tc_softmax<NT, DT, kCausal>(s, acc, m, l, it * BK, M,
                                  row0 + warp * 16 + g, q_offset, scale_log2);

      // acc += p v: p (bf16) straight from the S fragments
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
        reg_fence(pa[kc]);
      }
      reg_fence(accf);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint64_t dv = sw128_desc(vs + kc * 16 * 128, KB, 1024);
        if constexpr (DMAX == 64)
          wgmma_rs_n64(accf, pa[kc], dv);
        else
          wgmma_rs_n128(accf, pa[kc], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(accf);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};

// The gated sum of the two-stream kernels (packed_attn_fwd.cu,
// dual_cross_attn_fwd.cu): stream si's unnormalised output acc divided by
// its fp32 row sums l (a row with no key, l = 0, by 1) into out as
// o_0 + gate * o_1, all in fp32, on a warp's rows g and g + 8. kRcp
// multiplies by one correctly rounded reciprocal a row instead of dividing
// each element (within an ulp of the quotient; an IEEE division per
// element took half of the dual kernel's time on the card).
template <int DT, bool kRcp = false>
__device__ __forceinline__ void wg_gated_sum(float (&out)[DT][4],
                                             const float (&acc)[DT][4],
                                             const float (&l)[2], int si,
                                             float gate) {
  float rl[2];
  if constexpr (kRcp)
    for (int h = 0; h < 2; ++h) rl[h] = __frcp_rn(l[h] == 0.f ? 1.f : l[h]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float div = l[e >> 1] == 0.f ? 1.f : l[e >> 1];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float x = kRcp ? acc[j][e] * rl[e >> 1] : acc[j][e] / div;
      out[j][e] = si == 0 ? x : out[j][e] + gate * x;
    }
  }
}

// A warp's rows of out, cast once to bf16: rows g and g + 8 of its 16 are
// rows `row` and row + 8 of o (row stride rs elements); rows at or past N
// and columns at or past D are not written.
template <int DT>
__device__ __forceinline__ void wg_store_rows(__nv_bfloat16* o, long long rs,
                                              const float (&out)[DT][4],
                                              int row, int N, int D) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= N) continue;
    __nv_bfloat16* orow = o + r * rs;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D)
        Elem<__nv_bfloat16>::store2(orow + col, out[j][2 * hh],
                                    out[j][2 * hh + 1]);
    }
  }
}

// -- warp-owned bf16 tiles of tiny sequences (small_attn_fwd.cu,
//    small_attn_bwd.cu): one warp holds whole (rows, D) operands of one
//    (b, h) pair (rows <= 32) in its own shared memory, at a pitch of
//    warp_tile_ld(KT) elements, KT = ceil(D / 16) k16 steps over D.
//    Fragments (g = lane / 4, t = lane % 4) as in mma_bf16.

// 16 KT columns and 8 more: the eight rows an ldmatrix reads fall on eight
// different groups of four banks.
__host__ __device__ constexpr int warp_tile_ld(int KT) { return 16 * KT + 8; }

// The tensor-core tiles' condition on memory: every pointer and every
// stride (in elements of `elem` bytes, bf16 by default) gives 16-byte
// aligned rows.
template <int P, int S>
bool rows_aligned16(const void* const (&p)[P], const long long (&st)[S],
                    int elem = 2) {
  for (const void* x : p)
    if (reinterpret_cast<uintptr_t>(x) & 15u) return false;
  for (long long s : st)
    if (s * elem % 16 != 0) return false;
  return true;
}

// Copy `rows` rows (a multiple of 16) of D bf16 (D % 8 == 0, 16-byte
// aligned rows) to dst at pitch ld, in 16-byte cp.async pieces, the lanes
// on consecutive pieces; rows at or past `valid` are zero-filled (source
// size 0), and so are columns [D, 16 ceil(D / 16)), the k16 tail. The
// caller commits and waits.
__device__ __forceinline__ void warp_load_rows16(
    __nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
    long long row_stride, int valid, int rows, int D, int lane) {
  const int pieces = D / 8;
  for (int idx = lane; idx < rows * pieces; idx += 32) {
    const int r = idx / pieces;
    const int c = (idx - r * pieces) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c, src + (ok ? r * row_stride + c : 0), ok);
  }
  if (D % 16 != 0)
    for (int r = lane; r < rows; r += 32)
      *reinterpret_cast<uint4*>(dst + r * ld + D) = make_uint4(0, 0, 0, 0);
}

// Write rows [0, valid) of D bf16 from src (pitch ld) to dst (row stride
// row_stride elements, 16-byte aligned rows) in 16-byte pieces.
__device__ __forceinline__ void warp_store_rows16(
    __nv_bfloat16* dst, long long row_stride, const __nv_bfloat16* src,
    int ld, int valid, int D, int lane) {
  const int pieces = D / 8;
  for (int idx = lane; idx < valid * pieces; idx += 32) {
    const int r = idx / pieces;
    const int c = (idx - r * pieces) * 8;
    *reinterpret_cast<uint4*>(dst + r * row_stride + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// x as two bf16 operand words: hi = bf16(x0, x1) and lo = bf16(x - hi).
// hi + lo carries about 16 bits of x, so a product run once with each part
// adds x's rounding to the result only at the 2^-17 level.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo,
                                           float x0, float x1) {
  hi = pack_bf16(x0, x1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// s = A B^T for 16 rows of A at `a` against MP <= 32 rows of B at `b`, both
// (rows, D) tiles: s[j] holds keys 8 j.. of rows g and g + 8; key tiles at
// or past MP stay 0.
template <int KT>
__device__ __forceinline__ void warp_scores(float (&s)[4][4],
                                            const __nv_bfloat16* a,
                                            const __nv_bfloat16* b, int MP,
                                            int lane) {
  constexpr int LD = warp_tile_ld(KT);
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      if (jp * 16 >= MP) break;
      uint32_t bb[4];
      ldsm_x4(bb, b + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                      kc * 16 + ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {bb[0], bb[1]};
      const uint32_t b1[2] = {bb[2], bb[3]};
      mma_bf16(s[2 * jp], af, b0);
      mma_bf16(s[2 * jp + 1], af, b1);
    }
  }
}

// The scores of warp_scores into p = softmax(s scale), normalised, in fp32
// on the fragments: e = 0, 1 is row g and e = 2, 3 row g + 8 (key
// 8 j + 2 t + (e & 1)); the quad's four lanes share a row, so the row max
// and sum take two shuffles; exp2 with scale log2 e folded in, one
// reciprocal per row; a key at or past M weighs exactly 0.
__device__ __forceinline__ void warp_softmax(float (&s)[4][4], int M,
                                             float scale_log2, int lane) {
  const int t = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = 8 * j + 2 * t + (e & 1) < M;
      s[j][e] = in ? s[j][e] * scale_log2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(s[j][e] - mx[e >> 1]);  // ex2(-inf) = 0
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    sum[hh] = __frcp_rn(sum[hh]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= sum[e >> 1];
}

template <int KT>
__device__ __forceinline__ void zero_acc(float (&acc)[2 * KT][4]) {
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc (m16 x 16 KT) += A B, A (m16 x k16) given as its hi and lo parts, so
// each product runs twice; B's 16 rows at `b`, a (k, D) tile read with
// ldmatrix.trans.
template <int KT>
__device__ __forceinline__ void warp_mma_split(float (&acc)[2 * KT][4],
                                               const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4],
                                               const __nv_bfloat16* b,
                                               int lane) {
  constexpr int LD = warp_tile_ld(KT);
#pragma unroll
  for (int dp = 0; dp < KT; ++dp) {
    uint32_t bb[4];
    ldsm_x4<true>(bb, b + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                          dp * 16 + (lane >> 4) * 8);
    const uint32_t b0[2] = {bb[0], bb[1]};
    const uint32_t b1[2] = {bb[2], bb[3]};
    mma_bf16(acc[2 * dp], hi, b0);
    mma_bf16(acc[2 * dp], lo, b0);
    mma_bf16(acc[2 * dp + 1], hi, b1);
    mma_bf16(acc[2 * dp + 1], lo, b1);
  }
}

// The 16 rows of acc as bf16 into a (rows, D) tile at `dst`.
template <int KT>
__device__ __forceinline__ void warp_stage(__nv_bfloat16* dst,
                                           const float (&acc)[2 * KT][4],
                                           int lane) {
  constexpr int LD = warp_tile_ld(KT);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    *reinterpret_cast<uint32_t*>(dst + g * LD + 8 * j + 2 * t) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * LD + 8 * j + 2 * t) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
}

// -- warp-owned fp32 tiles of tiny sequences (small_attn_fwd.cu,
//    small_attn_bwd.cu): one warp holds whole (rows, D) fp32 operands of
//    one (b, h) pair (rows <= 32, padded to a multiple of 16) in its own
//    shared memory at a pitch of f32_tile_ld(D) floats, and runs every
//    product as split TF32 (the fragments above).

// 8 ceil(D / 8) columns (whole k8 steps) and 4 more: a pitch of 4 mod 8
// floats keeps lda_rows, ldb_nmajor and ldb_kmajor free of bank conflicts.
__host__ __device__ constexpr int f32_tile_ld(int D) {
  return (D + 7) / 8 * 8 + 4;
}

// Copy `rows` rows of D fp32 values to dst at pitch ld through cp.async,
// the lanes on consecutive pieces: 16-byte pieces where `vec` (D % 4 == 0
// and 16-byte aligned rows), else 4-byte ones. Rows at or past `valid` and
// the columns [D, 8 ceil(D / 8)) of the k8 tail are zero-filled by the
// copy itself (source size 0): a stale value could be a NaN, and 0 * NaN
// is NaN. The caller commits and waits.
__device__ __forceinline__ void warp_load_rows_f32(
    float* dst, int ld, const float* src, long long row_stride, int valid,
    int rows, int D, bool vec, int lane) {
  const int D8 = (D + 7) & ~7;
  if (vec) {
    const int pieces = D8 / 4;  // <= 32
    const int dr = 32 / pieces, dc = 32 - dr * pieces;
    for (int r = lane / pieces, c = lane - r * pieces; r < rows;) {
      const int col = 4 * c;
      const bool ok = r < valid && col < D;
      cp_async16(dst + r * ld + col, src + (ok ? r * row_stride + col : 0),
                 ok);
      r += dr;
      c += dc;
      if (c >= pieces) {
        c -= pieces;
        ++r;
      }
    }
  } else {
    for (int r = 0; r < rows; ++r)
      for (int c = lane; c < D8; c += 32) {
        const bool ok = r < valid && c < D;
        cp_async4(dst + r * ld + c, src + (ok ? r * row_stride + c : 0), ok);
      }
  }
}

// Write rows [0, valid) of D fp32 values from src (pitch ld) to dst (row
// stride row_stride elements): 16-byte pieces where `vec` (D % 4 == 0,
// dst and the row stride 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void warp_store_rows_f32(
    float* dst, long long row_stride, const float* src, int ld, int valid,
    int D, bool vec, int lane) {
  if (vec) {
    const int pieces = D / 4;  // <= 32
    const int dr = 32 / pieces, dc = 32 - dr * pieces;
    for (int r = lane / pieces, c = lane - r * pieces; r < valid;) {
      *reinterpret_cast<float4*>(dst + r * row_stride + 4 * c) =
          *reinterpret_cast<const float4*>(src + r * ld + 4 * c);
      r += dr;
      c += dc;
      if (c >= pieces) {
        c -= pieces;
        ++r;
      }
    }
  } else {
    for (int r = 0; r < valid; ++r)
      for (int c = lane; c < D; c += 32)
        dst[r * row_stride + c] = src[r * ld + c];
  }
}

// The three split products of a b in two chains: big += a.hi b.hi, small
// += a.lo b.hi + a.hi b.lo. The tensor core truncates its sum at every
// mma.sync, so the big term, chained alone, is truncated once a k8 step
// instead of three times, and the small terms' truncations are about
// 2^-11 of its; the chains meet on the CUDA cores.
__device__ __forceinline__ void mma_3xtf32_two(float (&big)[4],
                                               float (&small)[4],
                                               const FragA& a,
                                               const FragB& b) {
  mma_tf32(small, a.lo, b.hi);
  mma_tf32(small, a.hi, b.lo);
  mma_tf32(big, a.hi, b.hi);
}

// s = A B^T over the head dim in split TF32 for the warp's 16 rows of A
// at `a` against the nk <= 32 rows (a multiple of 8) of B at `b`, both at
// pitch ld: s[j] holds keys 8 j.. of rows g and g + 8 (as `warp_scores`),
// key tiles at or past nk stay 0. The chains start afresh every 64 values
// of D (DT = DMAX / 8 k8 steps at most; those past D skipped).
template <int DT>
__device__ __forceinline__ void warp_scores_f32(float (&s)[4][4],
                                                const float* a,
                                                const float* b, int ld,
                                                int nk, int D) {
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < DT; c0 += 8) {
    if (c0 * 8 >= D) break;
    float big[4][4] = {}, small[4][4] = {};
#pragma unroll
    for (int kc = c0; kc < c0 + 8 && kc < DT; ++kc) {
      if (kc * 8 >= D) break;
      const FragA fa = lda_rows(a + kc * 8, ld);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j * 8 >= nk) break;
        mma_3xtf32_two(big[j], small[j], fa,
                       ldb_nmajor(b + j * 8 * ld + kc * 8, ld));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += big[j][e] + small[j][e];
  }
}

// The warp's 16 rows of A X in split TF32, staged in fp32 into a tile at
// dst (pitch ldd): A's k8 fragment kc from afrag(kc) (its k slots in the
// order of `acc_a`), X's k rows from x (pitch ldx) by `ldb_kmajor`, over
// the k8 steps [0, nk / 8), nk <= 32; the output's n8 tiles past D
// skipped, eight at a time (DT = DMAX / 8 at most). The caller makes sure
// no lane still reads dst.
template <int DT, class AFrag>
__device__ __forceinline__ void warp_product_f32(float* dst, int ldd,
                                                 AFrag afrag, const float* x,
                                                 int ldx, int nk, int D) {
  constexpr int JB = DT < 8 ? DT : 8;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j0 = 0; j0 < DT; j0 += JB) {
    if (j0 * 8 >= D) break;
    float big[JB][4] = {}, small[JB][4] = {};
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if (kc * 8 >= nk) break;
      const FragA fa = afrag(kc);
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        if ((j0 + j) * 8 >= D) break;
        mma_3xtf32_two(big[j], small[j], fa,
                       ldb_kmajor(x + kc * 8 * ldx + (j0 + j) * 8, ldx));
      }
    }
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      if ((j0 + j) * 8 >= D) break;
      const int c = 8 * (j0 + j) + 2 * t;
      *reinterpret_cast<float2*>(dst + g * ldd + c) =
          make_float2(big[j][0] + small[j][0], big[j][1] + small[j][1]);
      *reinterpret_cast<float2*>(dst + (g + 8) * ldd + c) =
          make_float2(big[j][2] + small[j][2], big[j][3] + small[j][3]);
    }
  }
}

// Warps a block of the warp-owned tiles, per_warp bytes of shared memory
// each: the count up to max_warps that keeps the most warps resident on an
// SM (228 KB, 1 KB of it reserved a block; at most 32 blocks and 64
// warps), the larger block on a tie; 0 if one warp needs more than a
// block's 227 KB.
inline int warps_per_block(size_t per_warp, int max_warps) {
  constexpr size_t kBlockBytes = 227 * 1024, kSmBytes = 228 * 1024;
  int best = 0, best_resident = 0;
  for (int w = 1; w <= max_warps; ++w) {
    const size_t bytes = w * per_warp;
    if (bytes > kBlockBytes) break;
    const size_t fit = kSmBytes / (bytes + 1024);
    const int blocks = static_cast<int>(fit < 32 ? fit : 32);
    const int resident = w * blocks < 64 ? w * blocks : 64;
    if (resident >= best_resident) {
      best = w;
      best_resident = resident;
    }
  }
  return best;
}

// Cards a process may drive (per-card state of the launchers).
constexpr int kMaxDevices = 16;

// Opt into more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Opt kKernel into a block's whole 227 KB of dynamic shared memory, once
// per card, so that no launch pays for the attribute call: where a
// launch's own host work is most of its time (tiny attention calls), one
// on every launch shows.
template <auto kKernel>
cudaError_t allow_smem_once() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace pandora
