"""PyTorch port, eval/profile_step's kernel classes: every kernel that the
CUDA sources declare (a regex over their `__global__` functions) is classed
as its own source's kernel, ahead of the library classes (`conv` and
`gemm` also match names such as "...conv3x3..." and "...ConvArgs")."""

import re
from pathlib import Path

import pytest

from open_pandora_tpu_torch.eval.profile_step import (KERNEL_CLASSES,
                                                    kernel_class)

CSRC = Path(__file__).resolve().parents[1] / "open_pandora_tpu_torch" / "csrc"
# source file -> the class of every kernel it declares
SOURCE_CLASS = {
    "flash_fwd": "flash_fwd", "flash_bwd": "flash_bwd",
    "small_attn_fwd": "small_attn_fwd", "small_attn_bwd": "small_attn_bwd",
    "packed_attn_fwd": "packed_attn_fwd",
    "dual_cross_attn_fwd": "dual_cross_attn",
    "fused_temporal_attn": "fused_temporal_attn",
    "group_norm_silu": "group_norm_silu", "conv3x3": "conv3x3",
    "fused_geglu": "fused_geglu",
}
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(")


def declared() -> list:
    """(source stem, kernel name) of every __global__ function in csrc/."""
    return [(src.stem, name) for src in sorted(CSRC.glob("*.cu"))
            for name in GLOBAL.findall(src.read_text())]


def test_every_source_declares_kernels_of_its_class():
    assert {stem for stem, _ in declared()} == set(SOURCE_CLASS)
    classes = [cls for cls, _ in KERNEL_CLASSES]
    for cls in SOURCE_CLASS.values():
        assert classes.index(cls) < classes.index("conv"), cls
        assert classes.index(cls) < classes.index("gemm"), cls


@pytest.mark.parametrize("stem,name", declared())
def test_kernel_names_map_to_their_class(stem, name):
    # as torch.profiler shows a template instance of the kernel
    shown = (f"void pandora::(anonymous namespace)::{name}<64, 160, true, "
             "true>(pandora::(anonymous namespace)::ConvArgs)")
    assert kernel_class(shown) == SOURCE_CLASS[stem]
    assert kernel_class(name) == SOURCE_CLASS[stem]
