"""k3_roofline: the exact greedy NMS kernel's (K3, ``ops/nms_cuda.py``,
``csrc/nms.cu``) share (%) of its operation bound, on the steps whose scans the
program counted (the tracer's first; ``harness/stages.py``): the IoUs those scans
needed (the ``k3.ious`` counter, counted after the window by the kernel's counting
instantiation), at 13 f32 operations each (the overlap, the union, the division
and the comparison) and the card's 67 TFLOP/s of f32 outside the tensor cores, over
the time of K3's kernels that those steps launched. Layer: NMS K3. None where the
run has no IoU count or no K3 time, or where the trace's K3 kernels of those steps
are not the launches the program counted (``k3.launches``)."""

KERNEL = "nms_keep_kernel"
IOU_OPS = 13


def read(ctx):
    st = ctx.get("stages")
    if not st or not st["ious"]:
        return None
    from harness.counts import H100_F32_FLOPS
    from harness.trace import kernel_time
    sec, n = kernel_time(st["counted_kernels"], KERNEL)
    if sec <= 0 or n == 0 or n != st["counted_k3_launches"]:
        return None
    return 100.0 * st["ious"] * IOU_OPS / H100_F32_FLOPS / sec
