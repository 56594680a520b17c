"""student_bwd_ms: the device time, in ms per iteration of the traced window, that the
compute stream spends on the operations launched in the ``backward``,
``grad_all_reduce`` and ``optimizer`` stages of ``engine/steps.py`` (autograd's
backward, the gradient sum over ranks, ``solver.py``'s clipped SGD), from the
program's stage spans joined to the trace by ``harness/stages.py``; autograd's
thread launches the backward while the main thread is in ``backward``. Layer:
student backward and update. None where the run has no stage spans."""

STAGES = ("backward", "grad_all_reduce", "optimizer")


def read(ctx):
    from harness.stages import stage_ms
    return stage_ms(ctx, STAGES)
