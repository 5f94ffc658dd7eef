// Packed-layout attention forward for Hopper (sm_90a), bf16: one key/value
// stream, or two with the second scaled by a gate.
//
// Replaces the Pallas kernel `_kernel` in
// open_pandora_tpu/ops/packed_attention.py (reached through `_packed_call`
// from `self_attention_packed` and `dual_cross_attention_packed`): the
// UNet's spatial self-attention (attn1, N = M = 2560 or 640) and its dual
// text + image cross-attention (attn2, 77 text keys plus 16 image keys per
// frame), computed as
//     o = attn(q, k0, v0) [+ gate * attn(q, k1, v1)]
// with each stream normalised in fp32, the gate applied in fp32 and one
// cast at the end.
//
// Layout: q (B, N, H*D) and each stream's k, v (B, M_s, H*D), the packed
// rows the projections write, read through their batch and row strides;
// head h is the column slice [h*D, (h+1)*D). o is written contiguous
// (B, N, H*D), so no head-split or transpose copy surrounds the kernel. The
// TPU kernel keeps the whole packed feature axis per block and masks heads
// inside 128-lane groups; on the card the packing is only a stride, and a
// block owns one (b, h, 64-row q tile).
//
// What bounds it on the card: like the flash kernel it shares its key-tile
// loop with (`attn_stream` in common.cuh), this first version runs both
// products as scalar fp32 FMAs fed from shared memory, so it is bound by
// shared-memory bandwidth into the CUDA cores, far below the tensor-core
// rate. The online softmax walks each stream in 64-key tiles, so M is
// unbounded and the (N, M) scores never leave the chip; the ragged key edge
// is masked (weight exactly 0) instead of padded. The gated sum of the two
// streams happens in registers, and o is written once. Moving the products
// to mma/wgmma is later work.
#include "common.cuh"

namespace pandora {
namespace {

struct Stream {
  const void* k;
  const void* v;
  int M;
  long long ksb, ksn, vsb, vsn;  // batch and row strides, elements
};

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kAttnThreads, 1)
packed_attn_kernel(const T* __restrict__ q, Stream s0, Stream s1,
                   int nstreams, const float* __restrict__ gate_ptr,
                   float gate_value, T* __restrict__ o, int N, int D,
                   long long qsb, long long qsn, long long osb,
                   long long osn, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnSmem<T> sm = AttnSmem<T>::template carve<BK>(smem, D);
  constexpr int kNJ = DMAX / 32;

  const int q0 = blockIdx.x * kAttnBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long hoff = static_cast<long long>(h) * D;

  load_rows(sm.q, sm.ld, q + b * qsb + q0 * qsn + hoff, qsn,
            min(kAttnBQ, N - q0), kAttnBQ, D);

  float out[4][kNJ][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) out[i][j][0] = out[i][j][1] = 0.f;

  for (int si = 0; si < nstreams; ++si) {
    const Stream& st = si == 0 ? s0 : s1;
    const T* k = static_cast<const T*>(st.k) + b * st.ksb + hoff;
    const T* v = static_cast<const T*>(st.v) + b * st.vsb + hoff;
    float acc[4][kNJ][2];
    attn_stream<T, DMAX, BK>(sm, acc, k, st.ksn, v, st.vsn, st.M, D, q0,
                             st.M, scale, 0, 0);
    const float gate =
        si == 0 ? 1.f : (gate_ptr != nullptr ? *gate_ptr : gate_value);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float l = sm.l[ty + 16 * i];
      const float div = l == 0.f ? 1.f : l;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        out[i][j][0] += gate * (acc[i][j][0] / div);
        out[i][j][1] += gate * (acc[i][j][1] / div);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= N) continue;
    T* orow = o + b * osb + row * osn + hoff;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = 2 * (tx + 16 * j);
      if (col < D) Elem<T>::store2(orow + col, out[i][j][0], out[i][j][1]);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const Stream& s0, const Stream& s1,
                   int nstreams, const float* gate_ptr, float gate_value,
                   void* o, int B, int N, int H, int D, long long qsb,
                   long long qsn, long long osb, long long osn, float scale,
                   cudaStream_t stream) {
  constexpr int BK = 64;
  const size_t smem = attn_smem_bytes<T, BK>(D);
  auto kernel = packed_attn_kernel<T, DMAX, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kAttnBQ - 1) / kAttnBQ, H, B);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), s0, s1, nstreams, gate_ptr, gate_value,
      static_cast<T*>(o), N, D, qsb, qsn, osb, osn, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const Stream& s0, const Stream& s1,
                       int nstreams, const float* gate_ptr, float gate_value,
                       void* o, int B, int N, int H, int D, long long qsb,
                       long long qsn, long long osb, long long osn,
                       float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, s0, s1, nstreams, gate_ptr, gate_value, o, B, N,
                         H, D, qsb, qsn, osb, osn, scale, stream);
  return launch<T, 128>(q, s0, s1, nstreams, gate_ptr, gate_value, o, B, N,
                        H, D, qsb, qsn, osb, osn, scale, stream);
}

}  // namespace
}  // namespace pandora

// C interface. q and every k, v hold H heads of width D packed along their
// last (contiguous) axis; strides are in elements ({batch, row} each).
// nstreams is 1 or 2; the second stream is scaled by *gate_ptr when that
// is not null, else by gate_value. o is (B, N, H*D) with strides
// {o_sb, o_sn}. Returns cudaGetLastError() after the launch (0 on
// success); a dtype other than bf16 or an unsupported shape returns
// cudaErrorInvalidValue.
extern "C" int pandora_packed_attn_fwd(
    const void* q, const void* k0, const void* v0, const void* k1,
    const void* v1, const void* gate_ptr, void* o, int B, int N, int M0,
    int M1, int H, int D, int nstreams, long long q_sb, long long q_sn,
    long long k0_sb, long long k0_sn, long long v0_sb, long long v0_sn,
    long long k1_sb, long long k1_sn, long long v1_sb, long long v1_sn,
    long long o_sb, long long o_sn, float gate_value, float scale, int dtype,
    void* stream) {
  using namespace pandora;
  if (dtype != kBFloat16 || B <= 0 || N <= 0 || H <= 0 || D <= 0 ||
      D > 128 || D % 8 != 0 || nstreams < 1 || nstreams > 2 || M0 <= 0 ||
      (nstreams == 2 && M1 <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Stream s0{k0, v0, M0, k0_sb, k0_sn, v0_sb, v0_sn};
  const Stream s1{nstreams == 2 ? k1 : k0, nstreams == 2 ? v1 : v0,
                  nstreams == 2 ? M1 : M0, k1_sb, k1_sn, v1_sb, v1_sn};
  const float* g = static_cast<const float*>(gate_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_d<__nv_bfloat16>(
      q, s0, s1, nstreams, g, gate_value, o, B, N, H, D, q_sb, q_sn, o_sb,
      o_sn, scale, s));
}
