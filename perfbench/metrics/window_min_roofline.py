"""B4/B5 (``csrc/window_min.cu``, the row-major phase 1): share of the roofline of the
stored rows read once, in per cent."""

from perfbench import roofline

UNIT = "%"
KERNELS = ("window_mma_kernel",)


def read(ctx):
    return roofline.kernel_share(ctx, KERNELS, ctx.config["engine"].get("dtype", "float32"))
