"""The single-frame decoder's parse (``decoder/decoder.py``,
``decoder/parse.py``): ms of span ``decode.parse`` a frame decoded (a
chunk's decode-along; the rebase's ``parse_prediction``)."""
from benchmark.readers import span_ms

UNIT = "ms"


def read(run):
    return span_ms(run, ["decode.parse"])
