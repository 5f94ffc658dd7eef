"""Kernel name -> class, a frozen copy of the port's
`eval/profile_step.KERNEL_CLASSES` and `kernel_class` at the time the
benchmark was defined, so that a later change to the program does not move
the yardstick. A kernel the program adds later falls in a library class or
"other" until a benchmark change names it.
"""

from __future__ import annotations

# (class, substrings of the lower-cased kernel name); the first match wins
KERNEL_CLASSES = (
    ("flash_fwd", ("flash_fwd_f32_kernel", "flash_fwd_f32_wide_kernel",
                   "flash_fwd_tc_kernel", "flash_fwd_wide_kernel")),
    ("flash_bwd", ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel",
                   "flash_bwd_dkv_tc_kernel", "flash_bwd_dq_tc_kernel")),
    ("small_attn_fwd", ("small_attn_fwd_f32_kernel", "small_attn_fwd_kernel",
                        "small_attn_fwd_tc_kernel")),
    ("small_attn_bwd", ("small_attn_bwd_f32_kernel", "small_attn_bwd_kernel",
                        "small_attn_bwd_tc_kernel")),
    ("packed_attn_fwd", ("packed_attn_kernel",)),   # both regimes
    ("dual_cross_attn", ("dual_cross_tc_kernel",)),
    ("fused_temporal_attn", ("fused_temporal_kernel",
                             "fused_temporal_tc_kernel")),
    ("group_norm_silu", ("gn_stats_kernel", "gn_apply_kernel")),
    ("conv3x3", ("conv3x3_wg_kernel", "conv3x3_tf32_kernel")),  # both rows
    ("fused_geglu", ("geglu_ln_kernel", "geglu_gemm_kernel",
                     "geglu_tf32_kernel")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce", "welford", "layer_norm", "group_norm")),
    ("copy", ("copy", "catarray", "transpose")),
    ("elementwise", ("elementwise",)),
    ("foreach", ("multi_tensor_apply",)),   # the clip and AdamW
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"
