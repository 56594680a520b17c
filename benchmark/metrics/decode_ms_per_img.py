"""decode_ms_per_img: the host milliseconds per image of the loader's ``Mapper``
(``data/loader.py``: read, decode, resize, crop, flip), the ``loader.map`` spans
that began and ended in the traced window summed over both streams, over their
number (a span still open at the window's end may wait on the host's work after
it). Layer: host data. None where the run has no such spans."""


def read(ctx):
    st = ctx.get("stages")
    if not st or not sum(st["map_n"].values()):
        return None
    return sum(st["map_s"].values()) / sum(st["map_n"].values()) * 1e3
