"""k1_roofline: ROIAlign forward (K1, ``ops/roi_align_cuda.py``,
``csrc/roi_align_fwd.cu``): the least time of the window's K1 launches (bytes read
and written once at the HBM rate, or the f32 operations, whichever is longer;
``harness/counts.py``, from the configuration's shapes) over K1's kernel time in the
trace."""

KERNEL = "roi_align_fwd_kernel"


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    from harness.trace import kernel_time
    sec, n = kernel_time(t["kernels"], KERNEL)
    per_iter = ctx["launches"]["k1"]
    if sec <= 0 or n == 0 or n % len(per_iter):
        return None
    return 100.0 * sum(per_iter) * (n // len(per_iter)) / sec
