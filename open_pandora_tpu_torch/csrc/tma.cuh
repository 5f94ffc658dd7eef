// Host side of the TMA: tensor maps of 2-D bf16 tensors and of 2-D and
// 4-D fp32 tensors, encoded through cuTensorMapEncodeTiled, which the
// runtime's driver entry point gives (fused_temporal_attn.cu,
// fused_geglu.cu, conv3x3.cu), so nothing links against libcuda.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pandora {

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (rows x cols) bf16 matrix with row stride `stride` elements, in boxes
// of box_cols (64: one 128-byte row) by box_rows, 128-byte swizzled, the
// layout wgmma reads. Boxes past the matrix's edge fill with zeros.
inline bool encode_bf16_2d(CUtensorMap* m, const __nv_bfloat16* p,
                           long long rows, long long cols, long long stride,
                           int box_cols, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<__nv_bfloat16*>(p), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An fp32 tensor of `rank` dims (dims[0] innermost, contiguous; strides in
// bytes of dims 1..rank-1) in boxes of `box`: by default the innermost box
// 32 floats (one 128-byte row), 128-byte swizzled; with swizzle false a
// plain row-major box (innermost up to 256 floats, a multiple of 4). Boxes
// past an edge fill with zeros, before the first element too.
inline bool encode_f32(CUtensorMap* m, const float* p, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, bool swizzle = true) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace pandora
