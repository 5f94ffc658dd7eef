// Dual cross-attention forward for Hopper (sm_90a), bf16: text and image
// key/value streams for the same queries in one kernel.
//
// Replaces the Pallas kernel `_kernel` in
// open_pandora_tpu/ops/dual_cross_attention.py (reached through `_forward`
// from `dual_cross_attention`): the UNet's attn2 where the packed kernel's
// gate refuses the head width (one that does not divide 128: 40, 48, 80,
// 96), computed as
//     o = attn(q, k_text, v_text) + gate * attn(q, k_img, v_img)
// with each stream's softmax normalised in fp32, the gate applied in fp32
// and one cast at the end.
//
// Layout: q (B, N, H, D) and each stream's k, v (B, M_s, H, D), read through
// their batch, row and head strides (the head dim is contiguous), so the
// views of the packed projections feed the kernel as they are: none of the
// transposes to (B, H, N, D), the key padding to 128 rows or the query
// padding to the block size that surround the TPU kernel. o is written
// contiguous (B, N, H, D). Both streams are short (77 text keys, 16 image
// keys per frame; at most 512 each), so a block owns one (b, h, 64-row q
// tile), loads q once and walks each stream in 64-key tiles with the online
// softmax of `attn_stream` (common.cuh); the ragged key edge is masked
// (weight exactly 0). The gated sum happens in registers.
//
// What bounds it on the card: the products are scalar fp32 FMAs fed from
// shared memory, as in the flash and packed kernels of this first version;
// with 93 keys the work per query row is small and the kernel is closer to
// its memory bound than those. Moving the products to mma is later work.
#include "common.cuh"

namespace pandora {
namespace {

struct KV {
  const void* k;
  const void* v;
  int M;
  long long ksb, ksn, ksh, vsb, vsn, vsh;  // batch, row, head strides
};

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kAttnThreads, 1)
dual_cross_attn_kernel(const T* __restrict__ q, KV text, KV image,
                       const float* __restrict__ gate_ptr, float gate_value,
                       T* __restrict__ o, int N, int H, int D, long long qsb,
                       long long qsn, long long qsh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnSmem<T> sm = AttnSmem<T>::template carve<BK>(smem, D);
  constexpr int kNJ = DMAX / 32;

  const int q0 = blockIdx.x * kAttnBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_rows(sm.q, sm.ld, q + b * qsb + q0 * qsn + h * qsh, qsn,
            min(kAttnBQ, N - q0), kAttnBQ, D);

  float out[4][kNJ][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) out[i][j][0] = out[i][j][1] = 0.f;

  for (int si = 0; si < 2; ++si) {
    const KV& st = si == 0 ? text : image;
    const T* k = static_cast<const T*>(st.k) + b * st.ksb + h * st.ksh;
    const T* v = static_cast<const T*>(st.v) + b * st.vsb + h * st.vsh;
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
    T* orow = o + ((static_cast<long long>(b) * N + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = 2 * (tx + 16 * j);
      if (col < D) Elem<T>::store2(orow + col, out[i][j][0], out[i][j][1]);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const KV& text, const KV& image,
                   const float* gate_ptr, float gate_value, void* o, int B,
                   int N, int H, int D, long long qsb, long long qsn,
                   long long qsh, float scale, cudaStream_t stream) {
  constexpr int BK = 64;
  const size_t smem = attn_smem_bytes<T, BK>(D);
  auto kernel = dual_cross_attn_kernel<T, DMAX, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kAttnBQ - 1) / kAttnBQ, H, B);
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), text, image, gate_ptr, gate_value,
      static_cast<T*>(o), N, H, D, qsb, qsn, qsh, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pandora

// C interface. q (B, N, H, D), text k/v (B, Mt, H, D), image k/v
// (B, Mi, H, D), the head dim contiguous; strides are in elements ({batch,
// row, head} each). The image stream is scaled by *gate_ptr when that is
// not null, else by gate_value. o is contiguous (B, N, H, D). Returns
// cudaGetLastError() after the launch (0 on success); a dtype other than
// bf16 or an unsupported shape returns cudaErrorInvalidValue.
extern "C" int pandora_dual_cross_attn_fwd(
    const void* q, const void* kt, const void* vt, const void* ki,
    const void* vi, const void* gate_ptr, void* o, int B, int N, int Mt,
    int Mi, int H, int D, long long q_sb, long long q_sn, long long q_sh,
    long long kt_sb, long long kt_sn, long long kt_sh, long long vt_sb,
    long long vt_sn, long long vt_sh, long long ki_sb, long long ki_sn,
    long long ki_sh, long long vi_sb, long long vi_sn, long long vi_sh,
    float gate_value, float scale, int dtype, void* stream) {
  using namespace pandora;
  if (dtype != kBFloat16 || B <= 0 || N <= 0 || H <= 0 || D <= 0 ||
      D > 128 || D % 8 != 0 || Mt <= 0 || Mi <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const KV text{kt, vt, Mt, kt_sb, kt_sn, kt_sh, vt_sb, vt_sn, vt_sh};
  const KV image{ki, vi, Mi, ki_sb, ki_sn, ki_sh, vi_sb, vi_sn, vi_sh};
  const float* g = static_cast<const float*>(gate_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 64)
    err = launch<__nv_bfloat16, 64>(q, text, image, g, gate_value, o, B, N, H,
                                    D, q_sb, q_sn, q_sh, scale, s);
  else
    err = launch<__nv_bfloat16, 128>(q, text, image, g, gate_value, o, B, N,
                                     H, D, q_sb, q_sn, q_sh, scale, s);
  return static_cast<int>(err);
}
