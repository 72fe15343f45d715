"""VP8 frame reconstruction in plain numpy, vectorised over macroblocks.

The pixel semantics are those of RFC 6386 as the scalar reference pipeline
states them (127/129 intra edges, all ten subblock modes, six-tap
sub-pixel prediction with reads clamped to the plane, the iDCT and iWHT
with int16 intermediates, the normal loop filter in its four-pass order).
What makes it fast enough for 4K frames is the order of work, not the
arithmetic:

- residues: every block's dequantisation, iWHT and iDCT at once (a
  residue never depends on the prediction it is added to);
- inter prediction: every 4x4 block of every inter macroblock at once;
- intra prediction: a wavefront over the anti-diagonals ``c + 2r``.  A
  macroblock reads its left, above, above-left and above-right
  neighbours, which all lie on earlier diagonals; subblocks of B_PRED
  macroblocks go in raster order inside the step;
- loop filter: the same wavefront.  A macroblock's edges read and write at
  most four pixels into its left and upper neighbours, so macroblocks of
  one diagonal touch disjoint pixels, and every macroblock that precedes
  one in raster order and touches its pixels lies on an earlier diagonal.

``planes`` are int32 arrays (H, W) of padded, macroblock-aligned size.
"""
import numpy as np

from . import tables as T
from .lf_params import frame_lf_params

SIXTAP = np.array([
    [0, 0, 128, 0, 0, 0],
    [0, -6, 123, 12, -1, 0],
    [2, -11, 108, 36, -8, 1],
    [0, -9, 93, 50, -6, 0],
    [3, -16, 77, 77, -16, 3],
    [0, -6, 50, 93, -9, 0],
    [1, -8, 36, 108, -11, 2],
    [0, -1, 12, 123, -6, 0]], np.int32)

_A4 = np.arange(4)


def _clamp255(x):
    return np.clip(x, 0, 255)


# ------------------------------------------------------------ residues

def _as_i16(x):
    return x.astype(np.int16).astype(np.int32)


def iwht(c):
    """(N, 4, 4) dequantised Y2 blocks -> (N, 4, 4) DC terms."""
    a1 = c[:, 0] + c[:, 3]
    b1 = c[:, 1] + c[:, 2]
    c1 = c[:, 1] - c[:, 2]
    d1 = c[:, 0] - c[:, 3]
    i = _as_i16(np.stack([a1 + b1, c1 + d1, a1 - b1, d1 - c1], axis=1))
    a1 = i[:, :, 0] + i[:, :, 3]
    b1 = i[:, :, 1] + i[:, :, 2]
    c1 = i[:, :, 1] - i[:, :, 2]
    d1 = i[:, :, 0] - i[:, :, 3]
    return _as_i16(np.stack([(a1 + b1 + 3) >> 3, (c1 + d1 + 3) >> 3,
                             (a1 - b1 + 3) >> 3, (d1 - c1 + 3) >> 3], axis=2))


def _m20091(a):
    return ((a * 20091) >> 16) + a


def _m35468(a):
    return (a * 35468) >> 16


def idct(c, rnd=4):
    """(N, 4, 4) dequantised blocks -> (N, 4, 4) residues (``rnd`` the
    final rounding offset; the control drops it)."""
    t0 = c[:, 0] + c[:, 2]
    t1 = c[:, 0] - c[:, 2]
    t2 = _m35468(c[:, 1]) - _m20091(c[:, 3])
    t3 = _m20091(c[:, 1]) + _m35468(c[:, 3])
    # inter[n, k, m]: first-pass output m of column k, stored as int16
    i = _as_i16(np.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], axis=2))
    t0 = i[:, 0] + i[:, 2]
    t1 = i[:, 0] - i[:, 2]
    t2 = _m35468(i[:, 1]) - _m20091(i[:, 3])
    t3 = _m20091(i[:, 1]) + _m35468(i[:, 3])
    return np.stack([(t0 + t3 + rnd) >> 3, (t1 + t2 + rnd) >> 3,
                     (t1 - t2 + rnd) >> 3, (t0 - t3 + rnd) >> 3], axis=2)


def _dequant(coeffs, dc, ac):
    """coeffs (..., 16) int16; dc, ac broadcastable to coeffs[..., 0]."""
    f = np.empty(coeffs.shape, np.int32)
    f[...] = ac[..., None]
    f[..., 0] = dc
    return _as_i16(coeffs.astype(np.int32) * f)


def residues(arrays, q, rnd=4):
    """Residue planes (int32): luma (R*16, C*16), chroma (2, R*8, C*8)."""
    R, C = arrays.mb_rows, arrays.mb_cols
    co = arrays.coeffs
    y = _dequant(co[:, :, :16], q["y_dc"][..., None], q["y_ac"][..., None])
    y2 = _dequant(co[:, :, 24], q["y2_dc"], q["y2_ac"])
    dc = iwht(y2.reshape(-1, 4, 4)).reshape(R, C, 16)
    y[..., 0] = np.where(arrays.y2_coded[..., None], dc, y[..., 0])
    ry = idct(y.reshape(-1, 4, 4), rnd).reshape(R, C, 4, 4, 4, 4)
    ry = ry.transpose(0, 2, 4, 1, 3, 5).reshape(R * 16, C * 16)
    uv = _dequant(co[:, :, 16:24], q["uv_dc"][..., None], q["uv_ac"][..., None])
    ruv = idct(uv.reshape(-1, 4, 4), rnd).reshape(R, C, 2, 2, 2, 4, 4)
    ruv = ruv.transpose(2, 0, 3, 5, 1, 4, 6).reshape(2, R * 8, C * 8)
    return ry, ruv


# ---------------------------------------------------------- inter

def _sixtap_blocks(ref, sel, y0, x0, mv, chunk=1 << 17):
    """4x4 predictions (N, 4, 4) from ``ref`` (S, H, W) at slot ``sel``,
    block corners (y0, x0) and vectors ``mv`` (N, 2) in 1/8 pel."""
    _, h, w = ref.shape
    out = np.empty((len(y0), 4, 4), np.int32)
    taps9 = np.arange(-2, 7)
    for s in range(0, len(y0), chunk):
        e = slice(s, s + chunk)
        mx, my = mv[e, 0] & 7, mv[e, 1] & 7
        rows = np.clip((y0[e] + (mv[e, 1] >> 3))[:, None] + taps9, 0, h - 1)
        cols = np.clip((x0[e] + (mv[e, 0] >> 3))[:, None] + taps9, 0, w - 1)
        patch = ref[sel[e, None, None], rows[:, :, None],
                    cols[:, None, :]].astype(np.int32)          # (n, 9, 9)
        hf, vf = SIXTAP[mx], SIXTAP[my]
        acc = np.zeros((patch.shape[0], 9, 4), np.int32)
        for k in range(6):
            acc += patch[:, :, k:k + 4] * hf[:, k, None, None]
        mid = _clamp255((acc + 64) >> 7)
        acc = np.zeros((patch.shape[0], 4, 4), np.int32)
        for k in range(6):
            acc += mid[:, k:k + 4] * vf[:, k, None, None]
        out[e] = _clamp255((acc + 64) >> 7)
    return out


def inter_predict(arrays, refs, Y, UV, ry, ruv):
    """Predict and reconstruct every inter macroblock in place."""
    rr, cc = np.nonzero(arrays.ref != T.CURRENT_FRAME)
    if not len(rr):
        return
    sel = arrays.ref[rr, cc].astype(np.int64) - 1
    ref_y = np.stack([refs[k][0] for k in ("last", "golden", "alternative")])
    # luma: 16 blocks a macroblock
    sr, sc = np.divmod(np.arange(16), 4)
    y0 = (rr[:, None] * 16 + sr * 4).reshape(-1)
    x0 = (cc[:, None] * 16 + sc * 4).reshape(-1)
    mv = arrays.sub_mv[rr, cc].reshape(-1, 2).astype(np.int64)
    p = _sixtap_blocks(ref_y, np.repeat(sel, 16), y0, x0, mv)
    yy = y0[:, None, None] + _A4[None, :, None]
    xx = x0[:, None, None] + _A4[None, None, :]
    Y[yy, xx] = _clamp255(p + ry[yy, xx])
    # chroma: 4 blocks a macroblock in each plane
    sr, sc = np.divmod(np.arange(4), 2)
    y0 = (rr[:, None] * 8 + sr * 4).reshape(-1)
    x0 = (cc[:, None] * 8 + sc * 4).reshape(-1)
    mv = arrays.uv_mv[rr, cc].reshape(-1, 2).astype(np.int64)
    yy = y0[:, None, None] + _A4[None, :, None]
    xx = x0[:, None, None] + _A4[None, None, :]
    for k in range(2):
        ref = np.stack([refs[n][1 + k] for n in ("last", "golden", "alternative")])
        p = _sixtap_blocks(ref, np.repeat(sel, 4), y0, x0, mv)
        UV[k][yy, xx] = _clamp255(p + ruv[k][yy, xx])


# ---------------------------------------------------------- intra

def _edges(plane, r, c, size):
    """above (n, size), left (n, size), above-left (n,) of the size x size
    blocks at block coordinates (r, c), with VP8's edge values."""
    top, lft = r * size, c * size
    left = np.where((c > 0)[:, None],
                    plane[top[:, None] + np.arange(size), np.maximum(lft - 1, 0)[:, None]],
                    129)
    above = np.where((r > 0)[:, None],
                     plane[np.maximum(top - 1, 0)[:, None], lft[:, None] + np.arange(size)],
                     127)
    al = np.where(r > 0, np.where(c > 0, plane[np.maximum(top - 1, 0),
                                               np.maximum(lft - 1, 0)], 129), 127)
    return above, left, al


def _whole_block(plane, r, c, size, mode, res):
    """Predict and reconstruct whole-block modes (DC, V, H, TM)."""
    above, left, al = _edges(plane, r, c, size)
    log2 = {8: 3, 16: 4}[size]
    sa, sl = above.sum(1), left.sum(1)
    dc = np.where((r > 0) & (c > 0), (sa + sl + size) >> (log2 + 1),
                  np.where(r > 0, (sa + (size >> 1)) >> log2,
                           np.where(c > 0, (sl + (size >> 1)) >> log2, 128)))
    m = mode[:, None, None]
    pred = np.where(m == T.DC_PRED, dc[:, None, None],
           np.where(m == T.V_PRED, above[:, None, :],
           np.where(m == T.H_PRED, left[:, :, None],
                    _clamp255(left[:, :, None] + above[:, None, :]
                              - al[:, None, None]))))
    yy = r[:, None, None] * size + np.arange(size)[None, :, None]
    xx = c[:, None, None] * size + np.arange(size)[None, None, :]
    plane[yy, xx] = _clamp255(pred + res[yy, xx])


def _avg2(x, y):
    return (x + y + 1) >> 1


def _avg3(x, y, z):
    return (x + 2 * y + z + 2) >> 2


def _bpred(E, m):
    """4x4 subblock predictions (n, 4, 4) for b-mode ``m`` from the edge
    rows E (n, 13): left[3..0], above-left, above[0..7]."""
    e = lambda i: E[:, i]
    a = lambda k: E[:, 5 + k]
    left = lambda j: E[:, 3 - j]
    out = np.empty((E.shape[0], 4, 4), np.int32)
    if m == T.B_DC_PRED:
        out[:] = ((E[:, 5:9].sum(1) + E[:, 0:4].sum(1) + 4) >> 3)[:, None, None]
    elif m == T.B_TM_PRED:
        lv = E[:, 3::-1]
        out[:] = _clamp255(lv[:, :, None] + E[:, None, 5:9] - e(4)[:, None, None])
    elif m == T.B_VE_PRED:
        out[:] = np.stack([_avg3(e(4 + x), e(5 + x), e(6 + x))
                           for x in range(4)], 1)[:, None, :]
    elif m == T.B_HE_PRED:
        out[:] = np.stack([_avg3(e(4), left(0), left(1)),
                           _avg3(left(0), left(1), left(2)),
                           _avg3(left(1), left(2), left(3)),
                           _avg3(left(2), left(3), left(3))], 1)[:, :, None]
    elif m == T.B_LD_PRED:
        v = [_avg3(a(k), a(k + 1), a(k + 2)) for k in range(6)]
        v.append(_avg3(a(6), a(7), a(7)))
        for y in range(4):
            for x in range(4):
                out[:, y, x] = v[x + y]
    elif m == T.B_RD_PRED:
        v = [_avg3(e(i), e(i + 1), e(i + 2)) for i in range(7)]
        for y in range(4):
            for x in range(4):
                out[:, y, x] = v[x - y + 3]
    elif m == T.B_VR_PRED:
        out[:, 3, 0] = _avg3(e(1), e(2), e(3))
        out[:, 2, 0] = _avg3(e(2), e(3), e(4))
        out[:, 3, 1] = out[:, 1, 0] = _avg3(e(3), e(4), e(5))
        out[:, 2, 1] = out[:, 0, 0] = _avg2(e(4), e(5))
        out[:, 3, 2] = out[:, 1, 1] = _avg3(e(4), e(5), e(6))
        out[:, 2, 2] = out[:, 0, 1] = _avg2(e(5), e(6))
        out[:, 3, 3] = out[:, 1, 2] = _avg3(e(5), e(6), e(7))
        out[:, 2, 3] = out[:, 0, 2] = _avg2(e(6), e(7))
        out[:, 1, 3] = _avg3(e(6), e(7), e(8))
        out[:, 0, 3] = _avg2(e(7), e(8))
    elif m == T.B_VL_PRED:
        out[:, 0, 0] = _avg2(a(0), a(1))
        out[:, 1, 0] = _avg3(a(0), a(1), a(2))
        out[:, 2, 0] = out[:, 0, 1] = _avg2(a(1), a(2))
        out[:, 1, 1] = out[:, 3, 0] = _avg3(a(1), a(2), a(3))
        out[:, 2, 1] = out[:, 0, 2] = _avg2(a(2), a(3))
        out[:, 3, 1] = out[:, 1, 2] = _avg3(a(2), a(3), a(4))
        out[:, 2, 2] = out[:, 0, 3] = _avg2(a(3), a(4))
        out[:, 3, 2] = out[:, 1, 3] = _avg3(a(3), a(4), a(5))
        out[:, 2, 3] = _avg3(a(4), a(5), a(6))
        out[:, 3, 3] = _avg3(a(5), a(6), a(7))
    elif m == T.B_HD_PRED:
        out[:, 3, 0] = _avg2(e(0), e(1))
        out[:, 3, 1] = _avg3(e(0), e(1), e(2))
        out[:, 2, 0] = out[:, 3, 2] = _avg2(e(1), e(2))
        out[:, 2, 1] = out[:, 3, 3] = _avg3(e(1), e(2), e(3))
        out[:, 2, 2] = out[:, 1, 0] = _avg2(e(2), e(3))
        out[:, 2, 3] = out[:, 1, 1] = _avg3(e(2), e(3), e(4))
        out[:, 1, 2] = out[:, 0, 0] = _avg2(e(3), e(4))
        out[:, 1, 3] = out[:, 0, 1] = _avg3(e(3), e(4), e(5))
        out[:, 0, 2] = _avg3(e(4), e(5), e(6))
        out[:, 0, 3] = _avg3(e(5), e(6), e(7))
    elif m == T.B_HU_PRED:
        out[:] = left(3)[:, None, None]
        out[:, 0, 0] = _avg2(left(0), left(1))
        out[:, 0, 1] = _avg3(left(0), left(1), left(2))
        out[:, 1, 0] = out[:, 0, 2] = _avg2(left(1), left(2))
        out[:, 1, 1] = out[:, 0, 3] = _avg3(left(1), left(2), left(3))
        out[:, 1, 2] = out[:, 2, 0] = _avg2(left(2), left(3))
        out[:, 1, 3] = out[:, 2, 1] = _avg3(left(2), left(3), left(3))
    else:
        raise ValueError("bad b-mode %d" % m)
    return out


def _tap_table():
    """The eight directional b-modes are (taps . E + 2) >> 2 for small
    integer taps; read each mode's taps off ``_bpred`` one edge pixel at a
    time (an edge of 1000 at pixel i gives 250 times its tap)."""
    taps = np.zeros((T.NUM_INTRA_B_MODES, 16, 13), np.int64)
    for m in range(T.NUM_INTRA_B_MODES):
        if m in (T.B_DC_PRED, T.B_TM_PRED):
            continue
        for i in range(13):
            E = np.zeros((1, 13), np.int64)
            E[0, i] = 1000
            taps[m, :, i] = _bpred(E, m).reshape(16) // 250
    return taps


_BTAPS = _tap_table()


def _subblocks(Y, r, c, bmode, ry):
    """The 16 subblocks of B_PRED macroblocks (r, c), in raster order."""
    W = Y.shape[1]
    for sb in range(16):
        sr, sc = divmod(sb, 4)
        row4, col4 = r * 4 + sr, c * 4 + sc
        above, left, al = _edges(Y, row4, col4, 4)
        # above-right (prediction.cc:141-163): the row above the
        # macroblock for the right column below its first row; the last
        # pixel of that row repeated at the frame's right edge
        mb_top = np.maximum(r * 16 - 1, 0)
        at_edge = 4 * (col4 + 1) >= W
        src_row = mb_top if (sc == 3 and sr != 0) else np.maximum(row4 * 4 - 1, 0)
        ar_cols = np.where(at_edge[:, None], W - 1, 4 * (col4 + 1)[:, None] + _A4)
        ar = Y[src_row[:, None], np.minimum(ar_cols, W - 1)]
        if at_edge.any():
            ar = np.where(at_edge[:, None], Y[mb_top, W - 1][:, None], ar)
        if sr == 0:
            have = r > 0
        else:
            have = np.where(at_edge | (sc == 3), r > 0, True)
        ar = np.where(have[:, None], ar, 127)
        E = np.concatenate([left[:, ::-1], al[:, None], above, ar], axis=1)
        modes = bmode[:, sr, sc].astype(np.int64)
        pred = (np.einsum("npk,nk->np", _BTAPS[modes], E) + 2) >> 2
        dc = (E[:, 0:4].sum(1) + E[:, 5:9].sum(1) + 4) >> 3
        tm = _clamp255(E[:, 3::-1][:, :, None] + E[:, None, 5:9]
                       - E[:, 4, None, None]).reshape(-1, 16)
        pred = np.where((modes == T.B_DC_PRED)[:, None], dc[:, None],
                        np.where((modes == T.B_TM_PRED)[:, None], tm, pred))
        pred = pred.reshape(-1, 4, 4)
        yy = row4[:, None, None] * 4 + _A4[None, :, None]
        xx = col4[:, None, None] * 4 + _A4[None, None, :]
        Y[yy, xx] = _clamp255(pred + ry[yy, xx])


def _diagonals(mask):
    """Macroblocks of ``mask`` grouped by wavefront step c + 2r, in order."""
    rr, cc = np.nonzero(mask)
    t = cc + 2 * rr
    order = np.argsort(t, kind="stable")
    rr, cc, t = rr[order], cc[order], t[order]
    cuts = np.flatnonzero(np.diff(t)) + 1
    return list(zip(np.split(rr, cuts), np.split(cc, cuts)))


def intra_predict(arrays, Y, UV, ry, ruv, intra):
    ymode, uvmode, bmode = arrays.ymode, arrays.uvmode, arrays.bmode
    for r, c in _diagonals(intra):
        for k in range(2):
            _whole_block(UV[k], r, c, 8, uvmode[r, c], ruv[k])
        b = ymode[r, c] == T.B_PRED
        if (~b).any():
            _whole_block(Y, r[~b], c[~b], 16, ymode[r[~b], c[~b]], ry)
        if b.any():
            _subblocks(Y, r[b], c[b], bmode[r[b], c[b]], ry)


# ---------------------------------------------------------- loop filter

def _c(x):
    return np.clip(x, -128, 127)


def _filter(g, interior, edge, hev_t, mb_edge):
    """Filter across the edge between g[..., 3] and g[..., 4] (int32
    pixels, 8 taps on the last axis); returns the new taps 1..6."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (g[..., i] for i in range(8))
    lim = interior[:, None]
    mask = ~((np.abs(p3 - p2) > lim) | (np.abs(p2 - p1) > lim)
             | (np.abs(p1 - p0) > lim) | (np.abs(q1 - q0) > lim)
             | (np.abs(q2 - q1) > lim) | (np.abs(q3 - q2) > lim)
             | (np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2 > edge[:, None]))
    hev = (np.abs(p1 - p0) > hev_t[:, None]) | (np.abs(q1 - q0) > hev_t[:, None])
    p2, p1, p0, q0, q1, q2 = (v - 128 for v in (p2, p1, p0, q0, q1, q2))
    if mb_edge:
        fv = np.where(mask, _c(_c(p1 - q1) + 3 * (q0 - p0)), 0)
        f2 = np.where(hev, fv, 0)
        f1 = _c(f2 + 4) >> 3
        f2 = _c(f2 + 3) >> 3
        q0, p0 = _c(q0 - f1), _c(p0 + f2)
        w = np.where(hev, 0, fv)
        u = _c((63 + w * 27) >> 7)
        q0, p0 = _c(q0 - u), _c(p0 + u)
        u = _c((63 + w * 18) >> 7)
        q1, p1 = _c(q1 - u), _c(p1 + u)
        u = _c((63 + w * 9) >> 7)
        q2, p2 = _c(q2 - u), _c(p2 + u)
    else:
        fv = np.where(hev, _c(p1 - q1), 0)
        fv = np.where(mask, _c(fv + 3 * (q0 - p0)), 0)
        f1 = _c(fv + 4) >> 3
        f2 = _c(fv + 3) >> 3
        q0, p0 = _c(q0 - f1), _c(p0 + f2)
        fv2 = np.where(hev, 0, (f1 + 1) >> 1)
        q1, p1 = _c(q1 - fv2), _c(p1 + fv2)
    return [v + 128 for v in (p2, p1, p0, q0, q1, q2)]


_T8 = np.arange(-4, 4)


def _edge_v(plane, rows, x, prm, mb_edge):
    """Vertical edge at columns x (n,) over rows (n, L)."""
    cols = x[:, None] + _T8                                # (n, 8)
    g = plane[rows[:, :, None], cols[:, None, :]]          # (n, L, 8)
    new = _filter(g, prm[0], prm[1] if mb_edge else prm[2], prm[3], mb_edge)
    first = 0 if mb_edge else 1
    for j, v in enumerate(new[first:len(new) - first]):
        plane[rows, (x + (first + j - 3))[:, None]] = v


def _edge_h(plane, cols, y, prm, mb_edge):
    """Horizontal edge at rows y (n,) over columns (n, L)."""
    rows = y[:, None] + _T8
    g = plane[rows[:, None, :], cols[:, :, None]]          # (n, L, 8)
    new = _filter(g, prm[0], prm[1] if mb_edge else prm[2], prm[3], mb_edge)
    first = 0 if mb_edge else 1
    for j, v in enumerate(new[first:len(new) - first]):
        plane[(y + (first + j - 3))[:, None], cols] = v


def loop_filter(header, arrays, state, key_frame, Y, UV, luma_only=False):
    """The frame's loop filter, in place on the int32 planes; with
    ``luma_only`` the chroma planes are left as they are."""
    level, interior, mb_limit, sb_limit, hev, skip_sb = frame_lf_params(
        header, arrays, state, key_frame)
    if not header.loop_filter_level:
        return
    half = UV.shape[2]
    CV = np.concatenate([UV[0], UV[1]], axis=1)   # U | V side by side
    for r, c in _diagonals(level > 0):
        prm = [a[r, c] for a in (interior, mb_limit, sb_limit, hev)]
        inner = ~skip_sb[r, c]
        planes = [(Y, 16, r, c, prm, inner, c * 16)]
        if not luma_only:
            planes.append((CV, 8, np.concatenate([r, r]), np.concatenate([c, c]),
                           [np.concatenate([a, a]) for a in prm],
                           np.concatenate([inner, inner]),
                           np.concatenate([c * 8, c * 8 + half])))
        for plane, size, rr, cc, p, inn, colx in planes:
            lines = np.arange(size)
            rows = rr[:, None] * size + lines
            cols = colx[:, None] + lines

            def sub(m, p=p):
                return [a[m] for a in p]
            m = cc > 0
            if m.any():
                _edge_v(plane, rows[m], colx[m], sub(m), True)
            if inn.any():
                for off in range(4, size, 4):
                    _edge_v(plane, rows[inn], colx[inn] + off, sub(inn), False)
            m = rr > 0
            if m.any():
                _edge_h(plane, cols[m], rr[m] * size, sub(m), True)
            if inn.any():
                for off in range(4, size, 4):
                    _edge_h(plane, cols[inn], rr[inn] * size + off, sub(inn), False)
    UV[0], UV[1] = CV[:, :half], CV[:, half:]


# ---------------------------------------------------------- frame

def quantizers(header, arrays, state):
    """The six dequantisation factors per macroblock, as (R, C) arrays."""
    seg = state.segmentation
    if seg is not None:
        qs = [header.quant_indices.quantizer(int(seg.quantizer_adjustments[i]),
                                             seg.absolute) for i in range(4)]
        idx = arrays.segment.astype(np.int64)
    else:
        qs = [header.quant_indices.quantizer()]
        idx = np.zeros((arrays.mb_rows, arrays.mb_cols), np.int64)
    return {k: np.array([q[k] for q in qs], np.int32)[idx] for k in qs[0]}


def reconstruct(header, arrays, state, refs, key_frame, exact=True,
                unfiltered=None):
    """One frame: ``refs`` maps last / golden / alternative to (y, u, v)
    uint8 planes.  Returns the new (y, u, v) uint8 planes.  ``exact``
    False: the control, whose inverse transform drops its rounding.
    ``unfiltered``: a list that gets the (Y, UV) int32 planes before the
    loop filter."""
    R, C = arrays.mb_rows, arrays.mb_cols
    ry, ruv = residues(arrays, quantizers(header, arrays, state),
                       4 if exact else 0)
    Y = np.zeros((R * 16, C * 16), np.int32)
    UV = np.zeros((2, R * 8, C * 8), np.int32)
    intra = np.ones((R, C), bool)
    if not key_frame:
        intra = arrays.ref == T.CURRENT_FRAME
        inter_predict(arrays, refs, Y, UV, ry, ruv)
    intra_predict(arrays, Y, UV, ry, ruv, intra)
    if unfiltered is not None:
        unfiltered.append((Y.copy(), UV.copy()))
    loop_filter(header, arrays, state, key_frame, Y, UV)
    return Y.astype(np.uint8), UV[0].astype(np.uint8), UV[1].astype(np.uint8)
