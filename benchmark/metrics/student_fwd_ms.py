"""student_fwd_ms: the device time, in ms per iteration of the traced window, that the
compute stream spends on the operations launched in the ``forward`` stage of
``engine/steps.py`` (the student's losses: ``student_losses`` or
``supervised_losses``), from the program's stage spans joined to the trace by
``harness/stages.py``. Layer: student forward. None where the run has no stage
spans."""

STAGES = ("forward",)


def read(ctx):
    from harness.stages import stage_ms
    return stage_ms(ctx, STAGES)
