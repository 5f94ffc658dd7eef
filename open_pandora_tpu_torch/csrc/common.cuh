// Shared helpers for the kernels: element conversion for the two supported
// element types (fp32 and bf16), warp reductions, and the online-softmax
// attention tile that the flash and packed attention kernels share.
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// -- online-softmax attention tiles (flash_fwd.cu, packed_attn_fwd.cu) ------
//
// A block of kAttnThreads threads owns kAttnBQ query rows of one (b, h) and
// walks the key axis in tiles of BK rows. Shared memory holds the q tile
// (kAttnBQ x ld), one k and one v tile (BK x ld each, ld = D + 2 elements),
// the fp32 scores (kAttnBQ x (BK + 1)) and the per-row running max, sum and
// rescale factor. Thread (ty, tx) of the 16 x 16 grid keeps output rows
// ty + 16 i (i < 4) and column pairs 2 (tx + 16 j) in registers.

constexpr int kAttnBQ = 64;        // query rows per block
constexpr int kAttnThreads = 256;  // 16 x 16 thread grid

// Copy `rows` rows of D elements into shared memory (row pitch `ld`
// elements) in 32-bit words; rows at or beyond `valid` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long row_stride, int valid,
                                          int rows, int D) {
  constexpr int kPerWord = 4 / sizeof(T);
  const int words = D / kPerWord;
  for (int idx = threadIdx.x; idx < rows * words; idx += kAttnThreads) {
    const int r = idx / words;
    const int w = idx - r * words;
    uint32_t val = 0u;
    if (r < valid)
      val = reinterpret_cast<const uint32_t*>(src + r * row_stride)[w];
    reinterpret_cast<uint32_t*>(dst + r * ld)[w] = val;
  }
}

// Bytes of dynamic shared memory the tiles take.
template <typename T, int BK>
constexpr size_t attn_smem_bytes(int D) {
  return static_cast<size_t>(kAttnBQ + 2 * BK) * (D + 2) * sizeof(T) +
         static_cast<size_t>(kAttnBQ) * (BK + 1) * sizeof(float) +
         3 * kAttnBQ * sizeof(float);
}

template <typename T>
struct AttnSmem {
  T* q;       // (kAttnBQ, ld)
  T* k;       // (BK, ld)
  T* v;       // (BK, ld)
  float* s;   // (kAttnBQ, BK + 1) scores, then probabilities
  float* m;   // running max per row
  float* l;   // running sum per row
  float* a;   // rescale factor of the last tile per row
  int ld;

  template <int BK>
  __device__ static AttnSmem carve(unsigned char* smem, int D) {
    AttnSmem t;
    t.ld = D + 2;  // padded by one 32-bit word: conflict-free column reads
    t.q = reinterpret_cast<T*>(smem);
    t.k = t.q + kAttnBQ * t.ld;
    t.v = t.k + BK * t.ld;
    t.s = reinterpret_cast<float*>(t.v + BK * t.ld);
    t.m = t.s + kAttnBQ * (BK + 1);
    t.l = t.m + kAttnBQ;
    t.a = t.l + kAttnBQ;
    return t;
  }
};

// One key/value stream: acc = sum over key tiles of p v with an online
// softmax against the q tile already in sm.q. k and v point at key row 0 of
// this (b, h); rows are `ksn` / `vsn` elements apart. On return acc holds
// the unnormalised output and sm.l / sm.m the row sums and maxima (fp32).
// p is rounded to the element type for the product with v, as the TPU
// kernels do (p.astype(v.dtype)). Masking: keys at or past M weigh exactly
// 0; with `causal`, key col > row + q_offset scores kMaskValue.
template <typename T, int DMAX, int BK>
__device__ __forceinline__ void attn_stream(
    const AttnSmem<T>& sm, float (&acc)[4][DMAX / 32][2], const T* k,
    long long ksn, const T* v, long long vsn, int M, int D, int q0,
    int kv_end, float scale, int causal, int q_offset) {
  constexpr int ldS = BK + 1;
  constexpr int kSC = BK / 16;      // score columns per thread
  constexpr int kNJ = DMAX / 32;    // output column pairs per thread
  constexpr int kRowsPerWarp = kAttnBQ / (kAttnThreads / 32);
  constexpr int kLaneCols = (BK + 31) / 32;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ld = sm.ld;

  __syncthreads();  // earlier readers of sm.m / sm.l are done
  if (tid < kAttnBQ) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int kvalid = min(BK, M - k0);
    __syncthreads();
    load_rows(sm.k, ld, k + k0 * ksn, ksn, kvalid, BK, D);
    load_rows(sm.v, ld, v + k0 * vsn, vsn, kvalid, BK, D);
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
    float s[4][kSC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSC; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 2) {
      float2 qv[4], kv[kSC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = Elem<T>::load2(sm.q + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < kSC; ++j)
        kv[j] = Elem<T>::load2(sm.k + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kSC; ++j)
          s[i][j] = fmaf(qv[i].y, kv[j].y, fmaf(qv[i].x, kv[j].x, s[i][j]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSC; ++j)
        sm.s[(ty + 16 * i) * ldS + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();

    // online softmax, one warp per row
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = q0 + r;
      float vals[kLaneCols];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) {
        const int c = lane + 32 * t;
        const int col = k0 + c;
        float x = -INFINITY;  // beyond the key edge: weight exactly 0
        if (c < BK && col < M) {
          x = sm.s[r * ldS + c];
          if (causal && col > row + q_offset) x = kMaskValue;
        }
        vals[t] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: column k0 is valid
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) {
        const int c = lane + 32 * t;
        if (c < BK) {
          const float p = expf(vals[t] - m_new);
          sum += p;
          // the product with v uses p in the element type; the row sum
          // stays fp32
          sm.s[r * ldS + c] = Elem<T>::round(p);
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sm.a[r] = alpha;
        sm.l[r] = alpha * sm.l[r] + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p v
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[i] = sm.a[ty + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        acc[i][j][0] *= alpha[i];
        acc[i][j][1] *= alpha[i];
      }
    for (int c = 0; c < kvalid; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sm.s[(ty + 16 * i) * ldS + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int col = 2 * (tx + 16 * j);
        if (col < D) {
          const float2 vv = Elem<T>::load2(sm.v + c * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j][0] = fmaf(p[i], vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(p[i], vv.y, acc[i][j][1]);
          }
        }
      }
    }
  }
}

// Opt into more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pandora
