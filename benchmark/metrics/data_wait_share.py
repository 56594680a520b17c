"""data_wait_share: the share (%) of the window that the trainer spent waiting in
``next(batch_iter)`` for its next batch (``PTrainer.last_data_time`` summed over the
window's iterations, over the window's seconds). Layer: host data
(``data/loader.py``, ``parallel/prefetch.py`` through ``engine/trainer.py``)."""


def read(ctx):
    if not ctx.get("iterations"):
        return None
    return 100.0 * ctx["data_wait_s"] / ctx["window_s"]
