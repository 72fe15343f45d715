"""Host (numpy) pieces of the decoder's reconstruction that the rebase's
intra macroblocks need (encoder/reencode.py): intra prediction with the
127/129 edge rules, dequantization, the inverse WHT and the 4x4 inverse
DCT added into the plane (in C: native/enckernel.cc; ``idct_add_plain``
is its numpy body), bit-exact to the reference (prediction.cc:99-643,
quantization.cc:95-126, transform.cc:47-137, macroblock.cc:504-521).
Copied from the JAX package's scalar reconstruction
(decoder/reconstruct_np.py); intermediates stored as int16 by the
reference are int16 here too.
"""
import numpy as np

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.native import enckernel


def clamp255(x):
    return np.clip(x, 0, 255)


def dequantize(coeffs16, dc_factor, ac_factor):
    """int16-wrapping dequantization (quantization.cc:95-126)."""
    factors = np.full(16, ac_factor, np.int32)
    factors[0] = dc_factor
    return (coeffs16.astype(np.int32) * factors).astype(np.int16)


def iwht(y2_coeffs):
    """Inverse Walsh-Hadamard: 16 Y2 coefficients -> 4x4 DC terms
    (transform.cc:47-88). Input raster order int16[16]; returns int16(4,4)."""
    c = y2_coeffs.astype(np.int32).reshape(4, 4)
    a1 = c[0] + c[3]
    b1 = c[1] + c[2]
    c1 = c[1] - c[2]
    d1 = c[0] - c[3]
    inter = np.empty((4, 4), np.int16)
    inter[0] = a1 + b1
    inter[1] = c1 + d1
    inter[2] = a1 - b1
    inter[3] = d1 - c1
    i = inter.astype(np.int32)
    a1 = i[:, 0] + i[:, 3]
    b1 = i[:, 1] + i[:, 2]
    c1 = i[:, 1] - i[:, 2]
    d1 = i[:, 0] - i[:, 3]
    out = np.empty((4, 4), np.int16)
    out[:, 0] = (a1 + b1 + 3) >> 3
    out[:, 1] = (c1 + d1 + 3) >> 3
    out[:, 2] = (a1 - b1 + 3) >> 3
    out[:, 3] = (d1 - c1 + 3) >> 3
    return out


def _mul_20091(a):
    return ((a * 20091) >> 16) + a


def _mul_35468(a):
    return (a * 35468) >> 16


def idct_add(coeffs16, target4x4):
    """4x4 inverse DCT + add into the raster block (transform.cc:100-137),
    in C (native/enckernel.cc, which must build)."""
    enckernel.idct_add(coeffs16, target4x4)


def idct_add_plain(coeffs16, target4x4):
    """``idct_add`` in numpy.  Intermediates are stored as int16 exactly
    like the reference."""
    c = coeffs16.astype(np.int32).reshape(4, 4)
    # first pass: over columns, intermediate transposed, stored int16
    t0 = c[0] + c[2]
    t1 = c[0] - c[2]
    t2 = _mul_35468(c[1]) - _mul_20091(c[3])
    t3 = _mul_20091(c[1]) + _mul_35468(c[3])
    inter = np.empty((4, 4), np.int16)
    inter[:, 0] = t0 + t3
    inter[:, 1] = t1 + t2
    inter[:, 2] = t1 - t2
    inter[:, 3] = t0 - t3
    i = inter.astype(np.int32)
    t0 = i[0] + i[2]
    t1 = i[0] - i[2]
    t2 = _mul_35468(i[1]) - _mul_20091(i[3])
    t3 = _mul_20091(i[1]) + _mul_35468(i[3])
    rows = np.stack([(t0 + t3 + 4) >> 3,
                     (t1 + t2 + 4) >> 3,
                     (t1 - t2 + 4) >> 3,
                     (t0 - t3 + 4) >> 3], axis=1)
    target4x4[:] = clamp255(target4x4.astype(np.int32) + rows).astype(np.uint8)


def _predictors(plane, col, row, size):
    """above[-1..2*size-1] and left[0..size-1] with VP8 edge rules
    (prediction.cc:99-167). Returns (above_ext, left) where above_ext[0] is
    the above-left pixel and above_ext[1:] is above[0..2*size-1]."""
    h, w = plane.shape
    left = np.full(size, 129, np.int32)
    if col > 0:
        left[:] = plane[row * size:row * size + size, col * size - 1]
    above = np.full(2 * size + 1, 127, np.int32)  # [0]=above-left
    if row > 0:
        above[1:size + 1] = plane[row * size - 1,
                                  col * size:col * size + size]
    if col > 0 and row > 0:
        above[0] = plane[row * size - 1, col * size - 1]
    elif row > 0:
        above[0] = 129

    if size != 4:
        return above, left

    # above-right for 4x4 subblocks (prediction.cc:141-163)
    if row == 0:
        above[size + 1:] = 127
    elif size * (col + 1) >= w:
        if row >= 4:
            above[size + 1:] = plane[(row // 4) * 4 * size - 1, size * (col + 1) - 1]
        else:
            above[size + 1:] = 127
    else:
        if col % 4 == 3 and row % 4 != 0:
            if row >= 4:
                above[size + 1:] = plane[(row // 4) * 4 * size - 1,
                                         size * (col + 1):size * (col + 1) + size]
            else:
                above[size + 1:] = 127
        else:
            above[size + 1:] = plane[row * size - 1,
                                     size * (col + 1):size * (col + 1) + size]
    return above, left


def intra_predict_mb(plane, col, row, size, mode):
    """Whole-block intra prediction for 16x16 (Y) or 8x8 (chroma) blocks."""
    above_ext, left = _predictors(plane, col, row, size)
    above = above_ext[1:size + 1]
    above_left = above_ext[0]
    out = plane[row * size:(row + 1) * size, col * size:(col + 1) * size]
    log2size = {4: 2, 8: 3, 16: 4}[size]

    if mode == T.DC_PRED:
        if col and row:
            value = (above.sum() + left.sum() + (1 << log2size)) >> (log2size + 1)
        elif row:
            value = (above.sum() + (1 << (log2size - 1))) >> log2size
        elif col:
            value = (left.sum() + (1 << (log2size - 1))) >> log2size
        else:
            value = 128
        out[:] = value
    elif mode == T.V_PRED:
        out[:] = above[np.newaxis, :]
    elif mode == T.H_PRED:
        out[:] = left[:, np.newaxis]
    elif mode == T.TM_PRED:
        out[:] = clamp255(left[:, np.newaxis] + above[np.newaxis, :] - above_left)
    else:
        raise ValueError(f"bad whole-block mode {mode}")


def _avg2(x, y):
    return (x + y + 1) >> 1


def _avg3(x, y, z):
    return (x + 2 * y + z + 2) >> 2


def intra_predict_b(plane, col4, row4, bmode):
    """4x4 subblock intra prediction (prediction.cc:479-643).
    col4/row4 are subblock coordinates within the frame plane."""
    above_ext, left = _predictors(plane, col4, row4, 4)
    a = above_ext[1:]       # above[0..7]
    al = above_ext[0]       # above[-1]
    out = plane[row4 * 4:row4 * 4 + 4, col4 * 4:col4 * 4 + 4]

    def east(i):
        return left[3 - i] if i <= 3 else (al if i == 4 else a[i - 5])

    m = bmode
    if m == T.B_DC_PRED:
        out[:] = (a[:4].sum() + left.sum() + 4) >> 3
    elif m == T.B_TM_PRED:
        out[:] = clamp255(left[:, np.newaxis] + a[np.newaxis, :4] - al)
    elif m == T.B_VE_PRED:
        vals = [_avg3(al, a[0], a[1]), _avg3(a[0], a[1], a[2]),
                _avg3(a[1], a[2], a[3]), _avg3(a[2], a[3], a[4])]
        out[:] = np.array(vals, np.int32)[np.newaxis, :]
    elif m == T.B_HE_PRED:
        vals = [_avg3(al, left[0], left[1]), _avg3(left[0], left[1], left[2]),
                _avg3(left[1], left[2], left[3]), _avg3(left[2], left[3], left[3])]
        out[:] = np.array(vals, np.int32)[:, np.newaxis]
    elif m == T.B_LD_PRED:
        v = [_avg3(a[k], a[k + 1], a[k + 2]) for k in range(6)]
        v.append(_avg3(a[6], a[7], a[7]))
        # v[k] corresponds to anti-diagonal k = x + y
        for y in range(4):
            for x in range(4):
                out[y, x] = v[x + y]
    elif m == T.B_RD_PRED:
        v = [_avg3(east(i), east(i + 1), east(i + 2)) for i in range(7)]
        # out[y][x] with x - y + 3 indexing into v
        for y in range(4):
            for x in range(4):
                out[y, x] = v[x - y + 3]
    elif m == T.B_VR_PRED:
        # mapping from prediction.cc:527-541 (output.at(column,row))
        out[3, 0] = _avg3(east(1), east(2), east(3))
        out[2, 0] = _avg3(east(2), east(3), east(4))
        out[3, 1] = out[1, 0] = _avg3(east(3), east(4), east(5))
        out[2, 1] = out[0, 0] = _avg2(east(4), east(5))
        out[3, 2] = out[1, 1] = _avg3(east(4), east(5), east(6))
        out[2, 2] = out[0, 1] = _avg2(east(5), east(6))
        out[3, 3] = out[1, 2] = _avg3(east(5), east(6), east(7))
        out[2, 3] = out[0, 2] = _avg2(east(6), east(7))
        out[1, 3] = _avg3(east(6), east(7), east(8))
        out[0, 3] = _avg2(east(7), east(8))
    elif m == T.B_VL_PRED:
        out[0, 0] = _avg2(a[0], a[1])
        out[1, 0] = _avg3(a[0], a[1], a[2])
        out[2, 0] = out[0, 1] = _avg2(a[1], a[2])
        out[1, 1] = out[3, 0] = _avg3(a[1], a[2], a[3])
        out[2, 1] = out[0, 2] = _avg2(a[2], a[3])
        out[3, 1] = out[1, 2] = _avg3(a[2], a[3], a[4])
        out[2, 2] = out[0, 3] = _avg2(a[3], a[4])
        out[3, 2] = out[1, 3] = _avg3(a[3], a[4], a[5])
        out[2, 3] = _avg3(a[4], a[5], a[6])
        out[3, 3] = _avg3(a[5], a[6], a[7])
    elif m == T.B_HD_PRED:
        out[3, 0] = _avg2(east(0), east(1))
        out[3, 1] = _avg3(east(0), east(1), east(2))
        out[2, 0] = out[3, 2] = _avg2(east(1), east(2))
        out[2, 1] = out[3, 3] = _avg3(east(1), east(2), east(3))
        out[2, 2] = out[1, 0] = _avg2(east(2), east(3))
        out[2, 3] = out[1, 1] = _avg3(east(2), east(3), east(4))
        out[1, 2] = out[0, 0] = _avg2(east(3), east(4))
        out[1, 3] = out[0, 1] = _avg3(east(3), east(4), east(5))
        out[0, 2] = _avg3(east(4), east(5), east(6))
        out[0, 3] = _avg3(east(5), east(6), east(7))
    elif m == T.B_HU_PRED:
        out[0, 0] = _avg2(left[0], left[1])
        out[0, 1] = _avg3(left[0], left[1], left[2])
        out[1, 0] = out[0, 2] = _avg2(left[1], left[2])
        out[1, 1] = out[0, 3] = _avg3(left[1], left[2], left[3])
        out[1, 2] = out[2, 0] = _avg2(left[2], left[3])
        out[1, 3] = out[2, 1] = _avg3(left[2], left[3], left[3])
        out[2, 2] = out[2, 3] = out[3, 0] = out[3, 1] = out[3, 2] = out[3, 3] \
            = left[3]
    else:
        raise ValueError(f"bad b-mode {m}")


def _dequant_y(arrays, r, c, q):
    return [dequantize(arrays.coeffs[r, c, i], q["y_dc"], q["y_ac"])
            for i in range(16)]


def _apply_walsh(arrays, raster, r, c, q):
    """Y2 iWHT -> DC terms -> per-subblock iDCT-add (macroblock.cc:504-521)."""
    yd = _dequant_y(arrays, r, c, q)
    dc = iwht(dequantize(arrays.coeffs[r, c, 24], q["y2_dc"], q["y2_ac"]))
    for sr in range(4):
        for sc in range(4):
            blk = yd[sr * 4 + sc].copy()
            blk[0] = dc[sr, sc]
            idct_add(blk, raster.y[r * 16 + sr * 4:r * 16 + sr * 4 + 4,
                                   c * 16 + sc * 4:c * 16 + sc * 4 + 4])
