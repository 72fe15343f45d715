"""K1 (``csrc/wavefront.cu``, intra prediction and loop filter of a frame
position): its bytes' least time over its device time."""
from benchmark.bounds import kernels as b
from benchmark.readers import geometry, roofline

UNIT = "%"
KERNELS = ("wave_row_kernel",)


def read(run):
    G, R, C, _ = geometry(run)
    return roofline(run, "k1_roofline.decode", KERNELS, b.k1_bytes(G * R * C))
