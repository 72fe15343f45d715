"""GOP host parse (``parallel/gop.py`` ``parse_frame_batch`` and the native
parsers): ms of span ``gop.parse`` a frame position."""
from benchmark.readers import span_ms

UNIT = "ms"


def read(run):
    return span_ms(run, ["gop.parse"])
