"""k2_roofline: ROIAlign backward (K2, ``ops/roi_align_cuda.py``,
``csrc/roi_align_bwd.cu``): the least time of the window's K2 launches (the output
gradient read once and dF written once at the HBM rate; ``harness/counts.py``) over
K2's kernel time in the trace."""

KERNEL = "roi_align_bwd_kernel"


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    from harness.trace import kernel_time
    sec, n = kernel_time(t["kernels"], KERNEL)
    per_iter = ctx["launches"]["k2"]
    if sec <= 0 or n == 0 or n % len(per_iter):
        return None
    return 100.0 * sum(per_iter) * (n // len(per_iter)) / sec
