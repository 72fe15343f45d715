"""Forward transforms and quantization of one 4x4 block (bit-exact to the
reference dct.cc:45-163 and quantization.cc:149-157), for the host intra
encoder of the fast path's host patch (encoder/encode_intra_np.py).

``subtract_fdct`` and ``quantize`` call the native encode kernels
(native/enckernel.cc), which must build; ``subtract_fdct_plain`` and
``quantize_plain`` are their numpy bodies, the plain versions the tests
hold them against.  Intermediates the reference stores in int16
coefficient arrays are wrapped to int16 here too.
"""
import numpy as np

from alfalfa_tpu_torch.native import enckernel


def subtract_fdct(block4, pred4):
    """(original - prediction) -> forward 4x4 DCT coefficients, int16[16]
    (vp8_short_fdct4x4), in C.  block4, pred4: (4, 4) uint8."""
    return enckernel.subtract_fdct(block4, pred4)


def subtract_fdct_plain(block4, pred4):
    """``subtract_fdct`` in numpy."""
    inp = block4.astype(np.int32) - pred4.astype(np.int32)

    # pass 1: over input rows
    a1 = (inp[:, 0] + inp[:, 3]) * 8
    b1 = (inp[:, 1] + inp[:, 2]) * 8
    c1 = (inp[:, 1] - inp[:, 2]) * 8
    d1 = (inp[:, 0] - inp[:, 3]) * 8
    rows = np.zeros((4, 4), np.int32)
    rows[:, 0] = a1 + b1
    rows[:, 2] = a1 - b1
    rows[:, 1] = (c1 * 2217 + d1 * 5352 + 14500) >> 12
    rows[:, 3] = (d1 * 2217 - c1 * 5352 + 7500) >> 12
    rows = rows.astype(np.int16).astype(np.int32)  # stored int16

    # pass 2: over columns
    a1 = rows[0, :] + rows[3, :]
    b1 = rows[1, :] + rows[2, :]
    c1 = rows[1, :] - rows[2, :]
    d1 = rows[0, :] - rows[3, :]
    out = np.zeros((4, 4), np.int32)
    out[0, :] = (a1 + b1 + 7) >> 4
    out[2, :] = (a1 - b1 + 7) >> 4
    out[1, :] = ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0)
    out[3, :] = (d1 * 2217 - c1 * 5352 + 51000) >> 16
    return out.astype(np.int16).reshape(16)


def fwht(dc16):
    """Forward Walsh-Hadamard of the 16 luma DCs in raster order (the
    walsh input) -> int16[16] Y2 (dct.cc:106-163)."""
    inp = np.asarray(dc16, np.int32).reshape(4, 4)
    a1 = (inp[:, 0] + inp[:, 2]) * 4
    d1 = (inp[:, 1] + inp[:, 3]) * 4
    c1 = (inp[:, 1] - inp[:, 3]) * 4
    b1 = (inp[:, 0] - inp[:, 2]) * 4
    rows = np.zeros((4, 4), np.int32)
    rows[:, 0] = a1 + d1 + (a1 != 0)
    rows[:, 1] = b1 + c1
    rows[:, 2] = b1 - c1
    rows[:, 3] = a1 - d1
    rows = rows.astype(np.int16).astype(np.int32)

    a1 = rows[0, :] + rows[2, :]
    d1 = rows[1, :] + rows[3, :]
    c1 = rows[1, :] - rows[3, :]
    b1 = rows[0, :] - rows[2, :]
    out = np.zeros((4, 4), np.int32)
    for k, v in enumerate((a1 + d1, b1 + c1, b1 - c1, a1 - d1)):
        v = v + (v < 0)
        out[k, :] = (v + 3) >> 3
    return out.astype(np.int16).reshape(16)


def quantize(coeffs16, dc_factor, ac_factor):
    """Truncating division: the DC factor at position 0, the AC factor
    elsewhere -> int16[16], in C."""
    return enckernel.quantize(coeffs16, dc_factor, ac_factor)


def quantize_plain(coeffs16, dc_factor, ac_factor):
    """``quantize`` in numpy."""
    c = coeffs16.astype(np.int32)
    f = np.full(16, ac_factor, np.int32)
    f[0] = dc_factor
    q = np.abs(c) // f
    return (np.sign(c) * q).astype(np.int16)
