"""k3_ms_per_iter: the exact greedy NMS kernel's (K3, ``ops/nms_cuda.py``,
``csrc/nms.cu``) device time per iteration of the traced window, in ms. Its roofline
share is ``k3_roofline``, from the program's count of the IoUs the data needs."""

KERNEL = "nms_keep_kernel"


def read(ctx):
    t = ctx.get("trace")
    if not t or not ctx.get("iterations"):
        return None
    from harness.trace import kernel_time
    sec, n = kernel_time(t["kernels"], KERNEL)
    if n == 0:
        return None
    return sec / ctx["iterations"] * 1e3
