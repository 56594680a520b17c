"""step_mfu: the model FLOPs of the window's iterations (``harness/counts.py``:
VGG16 convs, RPN head and ROI box head at the configuration's budgets; teacher
forward, student forward, backward at 2x over the trainable part) over the window's
seconds times the card's dense bf16 peak. Layer: train step (``engine/steps.py``)."""


def read(ctx):
    if not ctx.get("iterations"):
        return None
    return 100.0 * ctx["flops_per_iter"] * ctx["iterations"] / ctx["window_s"] / ctx["peak_flops"]
