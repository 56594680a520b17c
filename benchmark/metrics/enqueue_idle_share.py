"""enqueue_idle_share: the share (%) of the traced window in which the device was idle
while the trainer's thread was inside a ``step`` span and outside its ``data``
span: the host issuing the step's work (``engine/trainer.py`` ``run_step``,
``engine/steps.py``) fell behind the device, or was held. From the program's spans
and the trace's device operations (``harness/stages.py``). Layer: train step, host
side. None where the run has no program spans."""


def read(ctx):
    st = ctx.get("stages")
    if not st or not st["iterations"] or st["window_s"] <= 0:
        return None
    return 100.0 * st["idle_enqueue_s"] / st["window_s"]
