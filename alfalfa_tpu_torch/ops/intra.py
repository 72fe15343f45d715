"""Batched intra prediction (PyTorch), tile-local formulation.

The VP8 reference predicts from the frame raster with 127/129 edge rules.
Here each macroblock is processed from a small context: ``e`` = extended
above row [above-left, above x size, above-right x 4] and ``lcol`` = left
column, both pre-substituted with the edge constants, so subblock
extraction needs no frame-level branches.

Every function takes a leading batch dimension N (the macroblocks of one
wavefront diagonal, over all GOPs) and int32 tensors.
"""
import torch


def _avg2(x, y):
    return (x + y + 1) >> 1


def _avg3(x, y, z):
    return (x + 2 * y + z + 2) >> 2


def whole_block_predict(e, lcol, has_row, has_col, mode, size):
    """16x16 or 8x8 prediction, all four modes computed and selected.

    e: (N, size+1) or longer: e[:, 0] = above-left, e[:, 1:size+1] = above.
    lcol: (N, size).  has_row/has_col: (N,) bool.  mode: (N,) int.
    Returns (N, size, size) int32."""
    above = e[:, 1:size + 1]
    left = lcol
    al = e[:, 0]
    log2 = {4: 2, 8: 3, 16: 4}[size]
    N = e.shape[0]

    sa, sl = above.sum(dim=1), left.sum(dim=1)
    dc_both = (sa + sl + (1 << log2)) >> (log2 + 1)
    dc_row = (sa + (1 << (log2 - 1))) >> log2
    dc_col = (sl + (1 << (log2 - 1))) >> log2
    dc = torch.where(has_row & has_col, dc_both,
                     torch.where(has_row, dc_row,
                                 torch.where(has_col, dc_col,
                                             torch.full_like(sa, 128))))
    shape = (N, size, size)
    dc_pred = dc[:, None, None].expand(shape)
    v_pred = above[:, None, :].expand(shape)
    h_pred = left[:, :, None].expand(shape)
    tm_pred = torch.clamp(left[:, :, None] + above[:, None, :]
                          - al[:, None, None], 0, 255)

    preds = torch.stack([dc_pred, v_pred, h_pred, tm_pred], dim=1)
    idx = torch.clamp(mode, 0, 3).to(torch.int64)
    return preds[torch.arange(N, device=e.device), idx].to(torch.int32)




def subblock_predict_all(above4, left4, al, ar4):
    """All ten 4x4 b-mode predictions: returns (N, 10, 4, 4) int32.

    above4/left4/ar4: (N, 4) int32; al: (N,).  Order matches the bmode enum
    (DC, TM, VE, HE, LD, RD, VR, VL, HD, HU)."""
    N = above4.shape[0]
    a = torch.cat([above4, ar4], dim=1)                      # a[0..7]
    l = left4
    # east(i): left bottom-up, above-left, then the above row
    e = torch.cat([left4.flip(1), al[:, None], a], dim=1)    # (N, 13)
    A = lambda k: a[:, k]
    E = lambda k: e[:, k]
    L = lambda k: l[:, k]

    def cells(vals):
        """16 row-major (N,) cell tensors -> (N, 4, 4)."""
        return torch.stack(vals, dim=1).reshape(N, 4, 4)

    dc = ((a[:, :4].sum(1) + l.sum(1) + 4) >> 3)[:, None, None] \
        .expand(N, 4, 4)
    tm = torch.clamp(l[:, :, None] + a[:, None, :4] - al[:, None, None],
                     0, 255)
    ve_v = torch.stack([_avg3(al, A(0), A(1)), _avg3(A(0), A(1), A(2)),
                        _avg3(A(1), A(2), A(3)), _avg3(A(2), A(3), A(4))],
                       dim=1)
    ve = ve_v[:, None, :].expand(N, 4, 4)
    he_v = torch.stack([_avg3(al, L(0), L(1)), _avg3(L(0), L(1), L(2)),
                        _avg3(L(1), L(2), L(3)), _avg3(L(2), L(3), L(3))],
                       dim=1)
    he = he_v[:, :, None].expand(N, 4, 4)

    # B_LD: anti-diagonals of smoothed above
    ld_v = [_avg3(A(k), A(k + 1), A(k + 2)) for k in range(6)] \
        + [_avg3(A(6), A(7), A(7))]
    ld = cells([ld_v[x + y] for y in range(4) for x in range(4)])

    # B_RD: diagonals of east
    rd_v = [_avg3(E(k), E(k + 1), E(k + 2)) for k in range(7)]
    rd = cells([rd_v[x - y + 3] for y in range(4) for x in range(4)])

    vr3 = [_avg3(E(k + 1), E(k + 2), E(k + 3)) for k in range(6)]
    vr2 = [_avg2(E(k + 4), E(k + 5)) for k in range(5)]
    vr = cells([vr2[0], vr2[1], vr2[2], vr2[3],
                vr3[2], vr3[3], vr3[4], vr3[5],
                vr3[1], vr2[0], vr2[1], vr2[2],
                vr3[0], vr3[2], vr3[3], vr3[4]])

    vl2 = [_avg2(A(k), A(k + 1)) for k in range(4)]
    vl3 = [_avg3(A(k), A(k + 1), A(k + 2)) for k in range(6)]
    vl = cells([vl2[0], vl2[1], vl2[2], vl2[3],
                vl3[0], vl3[1], vl3[2], vl3[3],
                vl2[1], vl2[2], vl2[3], vl3[4],
                vl3[1], vl3[2], vl3[3], vl3[5]])

    hd2 = [_avg2(E(k), E(k + 1)) for k in range(5)]
    hd3 = [_avg3(E(k), E(k + 1), E(k + 2)) for k in range(6)]
    hd = cells([hd2[3], hd3[3], hd3[4], hd3[5],
                hd2[2], hd3[2], hd2[3], hd3[3],
                hd2[1], hd3[1], hd2[2], hd3[2],
                hd2[0], hd3[0], hd2[1], hd3[1]])

    hu = cells([_avg2(L(0), L(1)), _avg3(L(0), L(1), L(2)),
                _avg2(L(1), L(2)), _avg3(L(1), L(2), L(3)),
                _avg2(L(1), L(2)), _avg3(L(1), L(2), L(3)),
                _avg2(L(2), L(3)), _avg3(L(2), L(3), L(3)),
                _avg2(L(2), L(3)), _avg3(L(2), L(3), L(3)),
                L(3), L(3),
                L(3), L(3), L(3), L(3)])

    return torch.stack([dc, tm, ve, he, ld, rd, vr, vl, hd, hu], dim=1) \
        .to(torch.int32)


def bpred_tile(e21, lcol16, bmodes, residuals, apply_residue):
    """Reconstruct B_PRED macroblocks: 16 sequential 4x4 subblocks, each
    predicted from already reconstructed neighbours, with the residual
    added in the chain.

    e21: (N, 21), lcol16: (N, 16), bmodes: (N, 4, 4) int, residuals:
    (N, 16, 4, 4) int32, apply_residue: (N,) bool (the MB's has_nonzero).
    Returns (N, 16, 16) int32 tiles.

    The right-most subblock of rows 1..3 takes its above-right pixels from
    e21[17:21] (the row above the macroblock), not from the macroblock to
    the right, which is not decoded yet."""
    N = e21.shape[0]
    tile = torch.zeros((N, 16, 16), dtype=torch.int32, device=e21.device)
    ar_n = torch.arange(N, device=e21.device)
    bm = torch.clamp(bmodes, 0, 9).to(torch.int64)
    for sr in range(4):
        for sc in range(4):
            y0, x0 = sr * 4, sc * 4
            above4 = (tile[:, y0 - 1, x0:x0 + 4] if sr > 0
                      else e21[:, 1 + x0:1 + x0 + 4])
            left4 = (tile[:, y0:y0 + 4, x0 - 1] if sc > 0
                     else lcol16[:, y0:y0 + 4])
            if sr == 0:
                al = e21[:, x0]
            else:
                al = tile[:, y0 - 1, x0 - 1] if sc > 0 else lcol16[:, y0 - 1]
            if sr == 0:
                ar4 = e21[:, 1 + x0 + 4:1 + x0 + 8]
            elif sc < 3:
                ar4 = tile[:, y0 - 1, x0 + 4:x0 + 8]
            else:
                ar4 = e21[:, 17:21]

            preds = subblock_predict_all(above4, left4, al, ar4)
            pred = preds[ar_n, bm[:, sr, sc]]
            res = torch.where(apply_residue[:, None, None],
                              residuals[:, sr * 4 + sc],
                              torch.zeros_like(pred))
            tile[:, y0:y0 + 4, x0:x0 + 4] = torch.clamp(pred + res, 0, 255)
    return tile
