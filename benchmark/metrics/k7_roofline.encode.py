"""K7 (``csrc/enc_intra.cu``, a key frame's macroblocks): its least time
over its device time."""
from benchmark.bounds import kernels as b
from benchmark.readers import geometry, roofline

UNIT = "%"
KERNELS = ("enc_kf_row_kernel",)


def read(run):
    G, R, C, _ = geometry(run)
    n = G * R * C
    return roofline(run, "k7_roofline.encode", KERNELS, b.k7_bytes(n), b.k7_ops(n))
