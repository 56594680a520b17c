"""enqueue_idle_loader_share: the part (% of the traced window) of
``enqueue_idle_share`` during which another thread did host work that holds the
interpreter: a ``loader.map`` span (a map thread reading, decoding and cropping an
image, ``data/loader.py``) or a ``prefetch.copy`` span (the prefetcher pinning and
queuing a batch, ``parallel/prefetch.py``) was open. ``loader.batch`` and
``prefetch.wait`` do not count: they are mostly waits. From the program's spans and
the trace (``harness/stages.py``). Layer: host threads. None where the run has no
program spans."""


def read(ctx):
    st = ctx.get("stages")
    if not st or not st["iterations"] or st["window_s"] <= 0:
        return None
    return 100.0 * st["idle_enqueue_host_s"] / st["window_s"]
