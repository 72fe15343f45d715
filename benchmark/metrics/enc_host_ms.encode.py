"""The encoder's host tail (``encoder/encode_inter.py`` ``finish_interframe``,
``encoder/serializer.py``, the native bit writers): ms of spans
``enc.inter_host`` and the key frame's ``enc.lf_search``,
``enc.token_counts_join`` and ``enc.serialize``, a frame delivered."""
from benchmark.readers import span_ms

UNIT = "ms"


def read(run):
    return span_ms(run, ["enc.inter_host", "enc.lf_search",
                         "enc.token_counts_join", "enc.serialize"],
                   per=run.records.get("frames"))
