"""Device time per call, in ms, of the ops between a ConvNeXt's GEMMs: the
LayerNorms, the GELUs, the depthwise convs and the layer-scale multiplies,
in the traced window.  The depthwise convs' bias adds are left out: they
run the same bf16 add kernel as the residual adds."""
import re

# on the card (an H100 trace of the ConvNeXt cell, torch 2.11): ATen's
# vectorized_layer_norm_kernel<c10::BFloat16, ...>; cuDNN's depthwise
# conv2d_c1_k1_nhwc_specialized; the GELU's passes, which are the only
# users of neg_kernel_cuda, erfc_kernel_vectorized4_kernel, the float32
# multiplies (vectorized_elementwise_kernel<4, BinaryFunctor<float, float,
# float, MulFunctor<float>>> and elementwise_kernel<128, 2,
# gpu_kernel_impl_nocast<BinaryFunctor<float, ...MulFunctor>>>), the
# bf16-to-float32 direct copies (direct_copy_kernel_cuda's
# {lambda(float)#1}) and bfloat16_copy_kernel_cuda back; and the bf16
# multiplies of GELU's 0.5 * x and the layer scale
# (gpu_kernel_impl_nocast<BinaryFunctor<c10::BFloat16, ...MulFunctor>>).
# The W8A8 chain's float32 multiplies run gpu_kernel_impl (with casts),
# not matched here.
KERNEL = re.compile(
    r"layer_norm_kernel|conv2d_c1_k1_nhwc|neg_kernel_cuda|erfc_kernel"
    r"|bfloat16_copy_kernel_cuda|direct_copy_kernel_cuda.*\{lambda\(float\)"
    r"|vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, "
    r"float, float, at::native::binary_internal::MulFunctor"
    r"|gpu_kernel_impl_nocast<at::native::BinaryFunctor<(float|c10::BFloat16)"
    r", \S+, \S+ at::native::binary_internal::MulFunctor")


def read(run):
    t, w = run.trace, run.traced
    if t is None or not (w.calls - w.failed) or not run.kernels_ok:
        return None
    busy = sum(v for n, v in t.device_ops.items() if KERNEL.search(n))
    if not busy:
        return None
    return 1e3 * busy / (w.calls - w.failed)
