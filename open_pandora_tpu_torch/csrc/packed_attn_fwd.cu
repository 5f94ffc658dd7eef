// Packed-layout attention forward for Hopper (sm_90a), bf16: one key/value
// stream, or two with the second scaled by a gate.
//
// Replaces the Pallas kernels `_kernel` (:104) and `_kernel_multi` (:170) in
// open_pandora_tpu/ops/packed_attention.py (reached through `_packed_call`
// and `_packed_call_multi` from `self_attention_packed` and
// `dual_cross_attention_packed`): the UNet's spatial self-attention (attn1,
// N = M = 2560 or 640 at 320x512; 9216, 2304 and 576 at 576x1024, where the
// TPU needs its second kernel to carry the softmax across key blocks) and
// its dual text + image cross-attention (attn2, 77 text keys plus 16 image
// keys per frame), computed as
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
// block owns one (b, h, q tile).
//
// What bounds it on the card: the products, 4 N (M_0 + M_1) D operations per
// (b, h), against 989 TFLOP/s of bf16 tensor cores at attn1 (2560, 2304 and
// 9216 keys, where the bytes are two orders of magnitude below); at attn2
// (77 + 16 keys) the bytes of q and o, at 3.35 TB/s. The design is
// `WgTile` (common.cuh): two warpgroups own the 128 rows of a q tile; per
// 64-key tile each issues S = q k^T as wgmma from 128-byte-swizzled shared
// memory, runs the online softmax on the S accumulator in registers and
// issues O += p v as wgmma with p from registers, so neither S nor p leaves
// the registers and M is unbounded (the long-key regime of row 7 is the
// same code over more tiles); K/V stream through a two-stage cp.async ring
// that zero-fills the ragged key edge, and the next tile's copy overlaps
// the current products. At D <= 64 two blocks share an SM, so one block's
// softmax overlaps the other's products. Each stream is normalised in fp32,
// the gate applied in fp32, and o is written once.
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

struct Stream {
  const bf16* k;
  const bf16* v;
  int M;
  long long ksb, ksn, vsb, vsn;  // batch and row strides, elements
};

struct Args {
  const bf16* q;
  Stream s[2];
  const float* gate_ptr;
  float gate_value;
  bf16* o;
  int N, D;
  long long qsb, qsn, osb, osn;
  float scale_log2;  // scale * log2(e)
};

template <int DMAX, bool kTwo>
__global__ void __launch_bounds__(kWgThreads, kWgMinBlocks<DMAX>)
packed_attn_kernel(const Args a) {
  using Tile = WgTile<DMAX>;
  constexpr int DT = Tile::DT;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile tile = Tile::carve(smem, a.D);
  const int q0 = blockIdx.x * Tile::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x & 31) >> 2;
  const long long hoff = static_cast<long long>(h) * a.D;

  tile.load_q(a.q + b * a.qsb + q0 * a.qsn + hoff, a.qsn,
              min(Tile::BQ, a.N - q0), a.D);
  float out[DT][4];
#pragma unroll
  for (int si = 0; si < (kTwo ? 2 : 1); ++si) {
    const Stream& st = a.s[si];
    float acc[DT][4], m[2], l[2];
    tile.template stream<false>(acc, m, l, st.k + b * st.ksb + hoff, st.ksn,
                                st.v + b * st.vsb + hoff, st.vsn, st.M, a.D,
                                q0, st.M, a.scale_log2, 0);
    const float gate = si == 0 ? 1.f
                       : a.gate_ptr != nullptr ? *a.gate_ptr
                                               : a.gate_value;
    wg_gated_sum<DT>(out, acc, l, si, gate);
  }
  wg_store_rows<DT>(a.o + b * a.osb + hoff, a.osn, out, q0 + warp * 16 + g,
                    a.N, a.D);
}

template <int DMAX, bool kTwo>
cudaError_t launch(const Args& a, int B, int H, cudaStream_t stream) {
  using Tile = WgTile<DMAX>;
  auto kernel = packed_attn_kernel<DMAX, kTwo>;
  cudaError_t err = allow_smem(kernel, Tile::smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + Tile::BQ - 1) / Tile::BQ, H, B);
  kernel<<<grid, kWgThreads, Tile::smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool kTwo>
cudaError_t dispatch_d(const Args& a, int B, int H, cudaStream_t stream) {
  if (a.D <= 64) return launch<64, kTwo>(a, B, H, stream);
  return launch<128, kTwo>(a, B, H, stream);
}

}  // namespace
}  // namespace pandora

// C interface. q and every k, v hold H heads of width D packed along their
// last (contiguous) axis; strides are in elements ({batch, row} each), and
// every pointer and stride must give 16-byte aligned rows (cp.async).
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
      (nstreams == 2 && M1 <= 0) || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(q),
               {Stream{static_cast<const bf16*>(k0),
                       static_cast<const bf16*>(v0), M0, k0_sb, k0_sn, v0_sb,
                       v0_sn},
                Stream{static_cast<const bf16*>(k1),
                       static_cast<const bf16*>(v1), M1, k1_sb, k1_sn, v1_sb,
                       v1_sn}},
               static_cast<const float*>(gate_ptr),
               gate_value,
               static_cast<bf16*>(o),
               N,
               D,
               q_sb,
               q_sn,
               o_sb,
               o_sn,
               scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(nstreams == 2 ? dispatch_d<true>(a, B, H, s)
                                        : dispatch_d<false>(a, B, H, s));
}
