"""teacher_ms: the device time, in ms per iteration of the traced window, that the
compute stream spends on the operations launched in the ``ema`` and
``pseudo_labels`` stages of ``engine/steps.py`` (the EMA update and the teacher's
pseudo-labels), from the program's stage spans joined to the trace by
``harness/stages.py``. Layer: teacher. None where the run has no stage spans, or
no teacher (burn-in)."""

STAGES = ("ema", "pseudo_labels")


def read(ctx):
    from harness.stages import stage_ms
    return stage_ms(ctx, STAGES)
