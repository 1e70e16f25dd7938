"""B1/B3 (``csrc/sweep_min.cu``, the certified sweep's phase 1): share of the roofline of
the sweep mirror read once, in per cent; None without a mirror."""

from perfbench import roofline

UNIT = "%"
KERNELS = ("sweep_mma_kernel",)


def read(ctx):
    operand = ctx.config["engine"].get("sweep_dtype")
    return roofline.kernel_share(ctx, KERNELS, operand) if operand else None
