"""augment_ms: the device time, in ms per iteration of the traced window, that the
compute stream spends on the operations launched in the ``augment`` stage of
``engine/steps.py`` (``data/device_aug.py``: strong augmentation and scale jitter),
from the program's stage spans joined to the trace by ``harness/stages.py``.
Layer: augmentation. None where the run has no stage spans."""

STAGES = ("augment",)


def read(ctx):
    from harness.stages import stage_ms
    return stage_ms(ctx, STAGES)
