"""GOP device step (``parallel/gop.py`` ``_step``): ms of the synchronised
span ``gop.device`` a frame position."""
from benchmark.readers import span_ms

UNIT = "ms"


def read(run):
    return span_ms(run, ["gop.device"])
