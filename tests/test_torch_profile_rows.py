"""``profile_slice.kernel_ms`` on hand-made profiler rows: each CUDA kernel's
device time per call is the sum of its rows, over every instantiation of its
template, and of no other kernel's."""

import re
from pathlib import Path

import pytest

from probabilisticteacher_torch import profile_slice
from probabilisticteacher_torch.profile_slice import KERNEL_ROWS, kernel_ms

CSRC = Path(profile_slice.__file__).resolve().parent / "csrc"

# (kernel name as the profiler prints it, device ms) of one profiled mutual step
ROWS = [
    ("void (anonymous namespace)::roi_align_fwd_kernel<__nv_bfloat16, 8, 7, 2, 448, 2>"
     "(__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, int, int, int, int, "
     "float)", 1.25),
    ("void (anonymous namespace)::roi_align_fwd_kernel<float, 4, 0, 0, 896, 1>(float const*, "
     "float const*, float*, int, int, int, int, int, int, float)", 0.5),
    ("void (anonymous namespace)::roi_align_bwd_kernel<__nv_bfloat16, 16>(__nv_bfloat16 "
     "const*, float const*, __nv_bfloat16*, (anonymous namespace)::Params)", 2.5),
    ("void (anonymous namespace)::nms_keep_kernel(float const*, float const*, unsigned char "
     "const*, unsigned char*, int, int, float)", 1.0),
    ("void (anonymous namespace)::nms_keep_kernel(float const*, float const*, unsigned char "
     "const*, unsigned char*, int, int, float)", 2.0),
    ("void (anonymous namespace)::aug_gray_sums_kernel<unsigned char, __nv_bfloat16>("
     "unsigned char const*, float*, int, float const*, float const*, long long const*, "
     "(anonymous namespace)::Luma, float)", 0.125),
    ("void (anonymous namespace)::aug_color_kernel<unsigned char, __nv_bfloat16>(unsigned "
     "char const*, __nv_bfloat16*, int, int, float const*, float const*, long long const*, "
     "float const*, float const*, int, float, (anonymous namespace)::Luma, "
     "(anonymous namespace)::Gates)", 0.75),
    ("void (anonymous namespace)::aug_color_kernel<float, float>(float const*, float*, int, "
     "int, float const*, float const*, long long const*, float const*, float const*, int, "
     "float, (anonymous namespace)::Luma, (anonymous namespace)::Gates)", 0.25),
    ("void (anonymous namespace)::aug_scale_jitter_kernel<__nv_bfloat16>(__nv_bfloat16 "
     "const*, __nv_bfloat16*, int, int, float const*, float const*, float, float, float)",
     0.5),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", 9.0),
    ("void at::native::elementwise_kernel<128, 2>(int, at::native::gpu_kernel_impl)", 4.0),
]
WANT = {"roi_align_fwd_ms": 1.75, "roi_align_bwd_ms": 2.5, "nms_keep_ms": 3.0,
        "aug_gray_sums_ms": 0.125, "aug_color_ms": 1.0, "aug_scale_jitter_ms": 0.5}


@pytest.mark.parametrize("key", list(KERNEL_ROWS))
def test_kernel_ms_sums_one_kernels_rows(key):
    assert kernel_ms(ROWS, KERNEL_ROWS[key]) == pytest.approx(WANT[key], abs=0)


@pytest.mark.parametrize("key", list(KERNEL_ROWS))
def test_kernel_ms_is_zero_without_the_kernel(key):
    name = KERNEL_ROWS[key]
    assert kernel_ms([row for row in ROWS if name not in row[0]], name) == 0
    assert kernel_ms([], name) == 0


@pytest.mark.parametrize("key", list(KERNEL_ROWS))
def test_kernel_rows_name_a_cuda_kernel_of_the_port(key):
    """The names ``profile_slice`` sums by are ``__global__`` functions of the
    port's CUDA sources, so a renamed kernel cannot drop out of the sums unseen."""
    sources = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    kernels = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                             sources))
    assert KERNEL_ROWS[key] in kernels, sorted(kernels)

