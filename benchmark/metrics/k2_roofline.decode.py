"""K2 (``csrc/sixtap_mc.cu``, the six-tap prediction of an interframe
position's three planes): its bytes' least time over its device time."""
from benchmark.bounds import kernels as b
from benchmark.readers import geometry, roofline

UNIT = "%"
KERNELS = ("mc_planes_kernel",)


def read(run):
    G, R, C, _ = geometry(run)
    return roofline(run, "k2_roofline.decode", KERNELS, b.k2_bytes(G * R * C))
