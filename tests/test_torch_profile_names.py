"""The profilers' kernel names cover every kernel of the port: each
``__global__`` function in ``paddle_tpu_torch/csrc/*.cu`` maps to one of
"our" names in ``profile_serving._short``, so no kernel falls into a
breakdown's "other" row (``profile_serving``, ``profile_training`` and
``profile_generate`` share the map)."""
import pathlib
import re

import pytest

from paddle_tpu_torch import _kernels
from paddle_tpu_torch.profile_serving import _short

CSRC = pathlib.Path(_kernels.CSRC)

# `__global__ void [__launch_bounds__(...)] name(` over line breaks
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def _global_functions():
    found = []
    for path in sorted(CSRC.glob("*.cu")):
        found += [(path.name, m.group(1))
                  for m in _GLOBAL.finditer(path.read_text())]
    return found


def test_scan_finds_every_library_kernel():
    found = _global_functions()
    names = {name for _, name in found}
    # every library has at least one kernel, and the tensor-core designs
    # sit beside the SIMT ones
    assert {f for f, _ in found} == {f"{n}.cu" for n in _kernels.KERNELS}
    assert {"flash_fwd_mma", "flash_dkdv_mma", "flash_dq_mma",
            "flash_decode_kernel"} <= names


@pytest.mark.parametrize("source,kernel", _global_functions())
def test_every_kernel_has_a_profile_name(source, kernel):
    # the profiler reports demangled names with the namespace, template
    # arguments and parameters around the function's own name
    demangled = (f"void (anonymous namespace)::{kernel}<64>(float const*, "
                 "int)")
    short = _short(demangled)
    assert short.endswith(" (ours)"), (source, kernel, short)
    # under the name of the library it belongs to
    assert short.split()[0] == source[:-3], (source, kernel, short)


@pytest.mark.parametrize("kernel", [
    # PyTorch's native depthwise kernels and cuDNN's grouped / depthwise
    # ones (MobileNet's 3 x 3 convolutions with groups = channels)
    "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel"
    "<1, float, int>(at::GenericPackedTensorAccessor<float const, 4ul>)",
    "void at::native::(anonymous namespace)::"
    "conv_depthwise2d_grad_weight_kernel<float, float, int>(int)",
    "void cudnn::cnn::conv2d_grouped_direct_kernel<false, true>(int)",
    "void cudnn::cnn::wgrad2d_grouped_direct_kernel<float>(int)",
    "void depthwise_fprop_kernel<__nv_bfloat16, 3>(int)",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
])
def test_depthwise_convolutions_fall_into_the_convolution_group(kernel):
    from paddle_tpu_torch.profile_training import VISION, _vision_group
    assert "mobilenet_v2" in VISION
    assert _vision_group(kernel) == "convolution (cuDNN)"
