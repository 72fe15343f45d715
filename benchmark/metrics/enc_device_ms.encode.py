"""The encoder's device step (``encoder/encode_intra.py``,
``encode_inter.py`` -> K7, K8): ms of the synchronised spans
``enc.kf_mb_wavefront`` and ``enc.inter_kernel``, a frame delivered."""
from benchmark.readers import span_ms

UNIT = "ms"


def read(run):
    return span_ms(run, ["enc.kf_mb_wavefront", "enc.inter_kernel"],
                   per=run.records.get("frames"))
