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
// their batch, row and head strides (the head dim contiguous, every row
// 16-byte aligned: the wrapper refuses other views), so the views of the
// packed projections feed the kernel as they are: none of the transposes
// to (B, H, N, D), the key padding to 128 rows or the query padding to the
// block size that surround the TPU kernel. o is written contiguous
// (B, N, H, D).
//
// What bounds it on the card: both streams are short (77 text and 16 image
// keys at the UNet's sites, at most 512 each by the gate), so the products,
// 4 N (M_t + M_i) D operations per (b, h), are about a third of the time
// the bytes of q and o take at 3.35 TB/s; the kernel should run at the pace
// of reading q and writing o. The design:
//   - Tensor cores. Each warpgroup owns 64-row q tiles. Per key tile it
//     issues S = q k^T as one wgmma per k16 step of the head, m64nNk16 with
//     N the tile's keys rounded up to 16 (77 keys cost 80, 16 cost 16); the
//     online softmax runs on the S fragments in registers (`tc_softmax`,
//     common.cuh), p is rounded to bf16 from those fragments and O += p v
//     is wgmma's register-A form over the same 16-key pieces. Each stream
//     is normalised in fp32 and summed with the gate in fp32 by the packed
//     kernel's own code (`wg_gated_sum`, `wg_store_rows`), with one
//     reciprocal a row where the packed kernel divides each element (the
//     division took half of this kernel's time on the card).
//   - Keys held on chip. A block owns one (b, h) and a run of its q tiles,
//     split between two independent warpgroups. Key tiles are up to 80 keys
//     (a stream's last one zero-filled to the next 16). Where every key tile
//     of both streams fits shared memory beside the q stages (the UNet's
//     77 + 16 keys: one text tile and one image tile), the block loads them
//     once and every q tile reads them there; otherwise each
//     warpgroup streams them through its own two-slot cp.async ring per q
//     tile (one code path: the ring's slots are the resident tiles when
//     they fit). The next q tile arrives by cp.async while the current
//     one's products and softmax run.
//   - Grid sized to the card: the wrapper (ops/dual_cross_attention.py
//     `launch_plan`) gives each warpgroup about an equal share of the
//     B H ceil(N / 64) q tiles over the card's multiprocessors, as runs of
//     consecutive tiles of one (b, h).
//   - Head width: D <= 64 runs 64-column tiles; 64 < D <= 128 runs two
//     64-column swizzle atoms, the second zero-padded past D (D = 80: its
//     k16 steps stop at 80, but O's wgmma is n128 over the padded columns:
//     products, not bytes, pay for the padding).
#include "common.cuh"

namespace pandora {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;            // two warpgroups, independent
constexpr int kRows = 64;                // q rows of a tile
constexpr int kKeys = 80;                // keys of a key tile
constexpr int kAtom = kRows * 128;       // one 64-column block of a q tile
constexpr int kKeyAtom = kKeys * 128;    // ... of a K or V tile
constexpr int kRingSlots = 4;            // two per warpgroup when streaming
constexpr size_t kSmemLimit = 232448;

struct KV {
  const bf16* k;
  const bf16* v;
  int M;
  long long ksb, ksn, ksh, vsb, vsn, vsh;  // batch, row, head strides
};

struct Args {
  const bf16* q;
  KV s[2];
  const float* gate_ptr;
  float gate_value;
  bf16* o;
  int N, H, D;
  long long qsb, qsn, qsh;
  float scale_log2;     // scale * log2(e)
  int tiles_per_block;  // 64-row q tiles of one (b, h) per block
  int resident;         // 1: every key tile of both streams stays on chip
};

__host__ __device__ inline int key_tiles(int M) {
  return (M + kKeys - 1) / kKeys;
}

// Shared memory: four q stages (two per warpgroup) and `slots` key slots,
// each a K and a V tile; 1 KB of slack for the 1024-byte alignment.
template <int DMAX>
constexpr size_t smem_bytes(int slots) {
  return 1024 + static_cast<size_t>(4 * kAtom + 2 * slots * kKeyAtom) *
                    (DMAX / 64);
}

// Rows [0, rows) of D <= DMAX bf16 (16-byte aligned rows, row stride rs)
// into a tile in the 128-byte-swizzled layout wgmma reads (64-column blocks
// `atom` bytes apart), through cp.async, by thread `tid` of `nthreads`;
// rows at or past `valid` are zero-filled by the copy (a stale row could
// hold a NaN, and 0 * NaN is NaN).
template <int DMAX>
__device__ __forceinline__ void load_tile(unsigned char* dst, int atom,
                                          const bf16* src, long long rs,
                                          int valid, int rows, int D,
                                          int tid, int nthreads) {
  constexpr int kPieces = DMAX / 8;
  for (int idx = tid; idx < rows * kPieces; idx += nthreads) {
    const int r = idx / kPieces;
    const int c = idx % kPieces;
    if (c * 8 >= D) continue;
    const bool ok = r < valid;
    cp_async16(dst + (c >> 3) * atom + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               src + (ok ? r * rs + c * 8 : 0), ok);
  }
}

// Zero the 16-byte chunk D / 8 of every row of a tile of `rows` rows: the
// k16 tail of a head width with D % 16 == 8, which the copies never write.
__device__ __forceinline__ void zero_tail(unsigned char* dst, int rows,
                                          int D, int tid, int nthreads) {
  const int c = D / 8;
  for (int r = tid; r < rows; r += nthreads)
    *reinterpret_cast<uint4*>(dst + (c >> 3) * rows * 128 + r * 128 +
                              (((c & 7) ^ (r & 7)) << 4)) =
        make_uint4(0, 0, 0, 0);
}

// S (+)= q k^T over one k16 step for a key tile of `pieces` 16-key pieces:
// one wgmma m64nNk16, N = 16 pieces, into the first 8 pieces floats of s.
template <int NT>
__device__ __forceinline__ void score_step(float (&s)[NT * 4], uint64_t dq,
                                           uint64_t dk, int pieces) {
  static_assert(NT == 10, "key tiles of 80 keys");
  switch (pieces) {
    case 1: wgmma_ss_n16(reinterpret_cast<float(&)[8]>(s[0]), dq, dk, 1);
      break;
    case 2: wgmma_ss_n32(reinterpret_cast<float(&)[16]>(s[0]), dq, dk, 1);
      break;
    case 3: wgmma_ss_n48(reinterpret_cast<float(&)[24]>(s[0]), dq, dk, 1);
      break;
    case 4: wgmma_ss_n64(reinterpret_cast<float(&)[32]>(s[0]), dq, dk, 1);
      break;
    default: wgmma_ss_n80(reinterpret_cast<float(&)[40]>(s[0]), dq, dk, 1);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
dual_cross_tc_kernel(const __grid_constant__ Args a) {
  constexpr int NCB = DMAX / 64;       // 64-column blocks of a tile
  constexpr int DT = DMAX / 8;         // n8 tiles of the output
  constexpr int NT = kKeys / 8;        // n8 tiles of a key tile
  constexpr int TB = NCB * kAtom;      // bytes of a q tile
  constexpr int KB = NCB * kKeyAtom;   // bytes of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qbuf =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* slots = qbuf + 4 * TB;  // slot i: K at 2 i KB, V after it
  const int tid = threadIdx.x;
  const int w = tid / 128;             // warpgroup
  const int wt = tid % 128;
  const int warp = wt / 32;            // within the warpgroup
  const int g = (tid & 31) >> 2;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.D;
  const int T0 = key_tiles(a.s[0].M);
  const int T = T0 + key_tiles(a.s[1].M);
  const int first = blockIdx.x * a.tiles_per_block;
  const int last = min(first + a.tiles_per_block, (a.N + kRows - 1) / kRows);
  const bool resident = a.resident != 0;
  unsigned char* qw = qbuf + w * 2 * TB;
  unsigned char* ring = slots + w * 4 * KB;  // streaming: two slots
  const bf16* qbh = a.q + b * a.qsb + h * a.qsh;
  const float gate = a.gate_ptr != nullptr ? *a.gate_ptr : a.gate_value;

  // key tile it (text tiles first) into a slot, by thread `id` of `n`
  auto issue_kv = [&](int it, unsigned char* slot, int id, int n) {
    const int si = it < T0 ? 0 : 1;
    const KV& st = si ? a.s[1] : a.s[0];
    const int k0 = (it - (si ? T0 : 0)) * kKeys;
    const int valid = min(kKeys, st.M - k0);
    const int rows = (valid + 15) & ~15;
    load_tile<DMAX>(slot, kKeyAtom,
                    st.k + b * st.ksb + h * st.ksh + k0 * st.ksn, st.ksn,
                    valid, rows, D, id, n);
    load_tile<DMAX>(slot + KB, kKeyAtom,
                    st.v + b * st.vsb + h * st.vsh + k0 * st.vsn, st.vsn,
                    valid, rows, D, id, n);
  };
  auto issue_q = [&](int qt, int stage) {
    const int r0 = qt * kRows;
    load_tile<DMAX>(qw + stage * TB, kAtom, qbh + r0 * a.qsn, a.qsn,
                    min(kRows, a.N - r0), kRows, D, wt, 128);
  };

  if (D % 16 != 0) {
    for (int i = 0; i < 4; ++i)
      zero_tail(qbuf + i * TB, kRows, D, tid, kThreads);
    for (int i = 0; i < (resident ? T : kRingSlots); ++i)
      zero_tail(slots + 2 * i * KB, kKeys, D, tid, kThreads);
  }
  if (resident)
    for (int it = 0; it < T; ++it)
      issue_kv(it, slots + 2 * it * KB, tid, kThreads);
  if (first + w < last) issue_q(first + w, 0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();

  int n = 0;
  for (int qt = first + w; qt < last; qt += 2, ++n) {
    const unsigned char* qs = qw + (n & 1) * TB;
    named_bar(1 + w, 128);  // the last tile's readers of the other stage
    if (qt + 2 < last) issue_q(qt + 2, (n + 1) & 1);
    cp_async_commit();
    if (resident) {
      cp_async_wait<1>();   // this tile's q landed; the next one in flight
      fence_async_shared();
      named_bar(1 + w, 128);
    } else {
      issue_kv(0, ring, wt, 128);
      cp_async_commit();
    }

    float out[DT][4];
    int it = 0;
#pragma unroll
    for (int si = 0; si < 2; ++si) {
      const KV& st = si ? a.s[1] : a.s[0];
      float acc[DT][4], m[2], l[2];
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      float(&accf)[DT * 4] = reinterpret_cast<float(&)[DT * 4]>(acc);
      for (; it < (si ? T : T0); ++it) {
        const unsigned char* ks;
        if (resident) {
          ks = slots + 2 * it * KB;
        } else {
          cp_async_wait<0>();
          fence_async_shared();
          named_bar(1 + w, 128);  // tile it landed; tile it - 1 is read
          if (it + 1 < T) {
            issue_kv(it + 1, ring + 2 * ((it + 1) & 1) * KB, wt, 128);
            cp_async_commit();
          }
          ks = ring + 2 * (it & 1) * KB;
        }
        const unsigned char* vs = ks + KB;
        const int k0 = (it - (si ? T0 : 0)) * kKeys;
        const int pieces = (min(kKeys, st.M - k0) + 15) / 16;

        // S = q k^T, one m64nNk16 per k16 step of the head
        float s[NT][4];
        float(&sf)[NT * 4] = reinterpret_cast<float(&)[NT * 4]>(s);
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) sf[i] = 0.f;
        reg_fence(sf);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < DMAX / 16; ++kc) {
          if (kc * 16 >= D) break;
          score_step<NT>(
              sf, sw128_desc(qs + (kc >> 2) * kAtom + (kc & 3) * 32, 16, 1024),
              sw128_desc(ks + (kc >> 2) * kKeyAtom + (kc & 3) * 32, 16, 1024),
              pieces);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sf);

        tc_softmax<NT, DT, false>(s, acc, m, l, k0, st.M, 0, 0,
                                  a.scale_log2);

        // acc += p v: p (bf16) straight from the S fragments
        uint32_t pa[NT / 2][4];
#pragma unroll
        for (int c = 0; c < NT / 2; ++c) {
          pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
          pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
          pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
          pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
          reg_fence(pa[c]);
        }
        reg_fence(accf);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NT / 2; ++c) {
          if (c >= pieces) break;
          const uint64_t dv = sw128_desc(vs + c * 16 * 128, kKeyAtom, 1024);
          if constexpr (DMAX == 64)
            wgmma_rs_n64(accf, pa[c], dv);
          else
            wgmma_rs_n128(accf, pa[c], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(accf);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      }
      wg_gated_sum<DT, true>(out, acc, l, si, si ? gate : 1.f);
    }
    wg_store_rows<DT>(a.o + (static_cast<long long>(b) * a.N * a.H + h) * D,
                      static_cast<long long>(a.H) * D, out,
                      qt * kRows + warp * 16 + g, a.N, D);
  }
}

template <int DMAX>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int T = key_tiles(a.s[0].M) + key_tiles(a.s[1].M);
  const size_t smem = smem_bytes<DMAX>(a.resident ? T : kRingSlots);
  if (smem > kSmemLimit || a.tiles_per_block < 1)
    return cudaErrorInvalidValue;
  auto kernel = dual_cross_tc_kernel<DMAX>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (a.N + kRows - 1) / kRows;
  dim3 grid((ntiles + a.tiles_per_block - 1) / a.tiles_per_block, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pandora

// C interface. q (B, N, H, D), text k/v (B, Mt, H, D), image k/v
// (B, Mi, H, D), the head dim contiguous; strides are in elements ({batch,
// row, head} each), and every pointer and stride must give 16-byte aligned
// rows (cp.async). The image stream is scaled by *gate_ptr when that is
// not null, else by gate_value. o is contiguous (B, N, H, D). The launch
// plan (ops/dual_cross_attention.py `launch_plan`): tiles_per_block q tiles
// of 64 rows per block, and resident 1 to hold every key tile on chip (it
// must fit shared memory). Returns cudaGetLastError() after the launch (0
// on success); a dtype other than bf16, an unsupported shape or plan, or
// misaligned rows return cudaErrorInvalidValue.
extern "C" int pandora_dual_cross_attn_fwd(
    const void* q, const void* kt, const void* vt, const void* ki,
    const void* vi, const void* gate_ptr, void* o, int B, int N, int Mt,
    int Mi, int H, int D, int tiles_per_block, int resident, long long q_sb,
    long long q_sn, long long q_sh, long long kt_sb, long long kt_sn,
    long long kt_sh, long long vt_sb, long long vt_sn, long long vt_sh,
    long long ki_sb, long long ki_sn, long long ki_sh, long long vi_sb,
    long long vi_sn, long long vi_sh, float gate_value, float scale,
    int dtype, void* stream) {
  using namespace pandora;
  if (dtype != kBFloat16 || B <= 0 || N <= 0 || H <= 0 || D <= 0 ||
      D > 128 || D % 8 != 0 || Mt <= 0 || Mi <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const ptrs[6] = {q, kt, vt, ki, vi, o};
  const long long strides[15] = {q_sb,  q_sn,  q_sh,  kt_sb, kt_sn,
                                 kt_sh, vt_sb, vt_sn, vt_sh, ki_sb,
                                 ki_sn, ki_sh, vi_sb, vi_sn, vi_sh};
  if (!rows_aligned16(ptrs, strides))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(q),
               {KV{static_cast<const bf16*>(kt), static_cast<const bf16*>(vt),
                   Mt, kt_sb, kt_sn, kt_sh, vt_sb, vt_sn, vt_sh},
                KV{static_cast<const bf16*>(ki), static_cast<const bf16*>(vi),
                   Mi, ki_sb, ki_sn, ki_sh, vi_sb, vi_sn, vi_sh}},
               static_cast<const float*>(gate_ptr),
               gate_value,
               static_cast<bf16*>(o),
               N,
               H,
               D,
               q_sb,
               q_sn,
               q_sh,
               scale * kLog2e,
               tiles_per_block,
               resident};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? launch<64>(a, B, s)
                                  : launch<128>(a, B, s));
}
