"""Frozen counts of what a kernel call has to move and compute, and the
card's peaks.  The counts follow ``chip_smoke.py``'s bound functions as
they stood when the benchmark was written; they take only the call's
geometry (frames, macroblock rows and columns, quantizers), so a share
reads the same work whatever implements the kernel.  Work that only the
call's data tells (intra macroblocks, filtered edges) is not counted:
every bound here is a lower bound on the time, and a share computed from
it can only read low, never above 100 %.  K8's and K9's work is mostly
the motion search, which only the data tells, so they have no count.
"""

# NVIDIA H100 SXM data sheet, at its 700 W power limit: HBM3 bandwidth.
PEAK_BYTES_PER_S = 3.35e12
# Assumed ceiling for the kernels' integer work: the published float32
# rate outside the tensor cores (no integer rate is published for it).
PEAK_OPS_PER_S = 67e12

MB_PIXELS = 384          # a macroblock's luma and chroma pixels (4:2:0)
WAVE_WORDS = 12          # K1's int16 words a macroblock (csrc/wavefront_device.cuh)


def least_time(bytes_, ops):
    """(seconds, which bound sets it) of a call that moves ``bytes_`` and
    computes ``ops``."""
    tb, to = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_bytes(n_mb):
    """wavefront_decode (intra prediction and loop filter): predictions (1
    byte a pixel) and residues (2) in, the per-macroblock words and 16
    subblock modes in, the planes out."""
    px = n_mb * MB_PIXELS
    return px + 2 * px + n_mb * (WAVE_WORDS * 2 + 16) + px


def k2_bytes(n_mb):
    """The six-tap prediction of the three planes, each frame with its own
    references: 16 luma and 4 chroma vectors (two int16 each) and a
    reference selector byte in, a reference macroblock in, the prediction
    out."""
    return n_mb * ((16 + 4) * 2 * 2 + 1 + 2 * MB_PIXELS)


K7_MODE_BYTES = 20       # K7's mode words a macroblock, as chip_smoke counts them
K7_OPS_MB = (16 * 10 * 16 * 12 + 4 * 256 * 8 + 4 * 128 * 6   # searches
             + 24 * 400)                                      # 24 transform chains


def k7_bytes(n_mb):
    """encode_kf_frame: the original planes in; coefficients, modes and
    the reconstruction out."""
    return n_mb * (MB_PIXELS + 25 * 16 * 2 + K7_MODE_BYTES + MB_PIXELS)


def k7_ops(n_mb):
    """Every macroblock's subblock, whole-mode and chroma searches and its
    16 luma and 8 chroma transform chains (a whole-mode winner's Y2 chain
    and the trellis, which only the data tells, left out)."""
    return n_mb * K7_OPS_MB

