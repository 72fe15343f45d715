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




# Cells of the eight directional b-modes (VE, HE, LD, RD, VR, VL, HD, HU),
# row-major, as columns of subblock_predict_all's table V: 0-11 avg2 of
# edge pixels (k, k+1), 12-22 avg3 of (k, k+1, k+2), 23 avg3(L2, L3, L3),
# 24 avg3(A6, A7, A7), 25 L3; edge pixel k of
# [L3, L2, L1, L0, above-left, A0 .. A7].
_DIRECTIONAL = (
    [16, 17, 18, 19] * 4,                                           # VE
    [14] * 4 + [13] * 4 + [12] * 4 + [23] * 4,                      # HE
    [17 + x + y if x + y < 6 else 24
     for y in range(4) for x in range(4)],                          # LD
    [15 + x - y for y in range(4) for x in range(4)],               # RD
    [4, 5, 6, 7, 15, 16, 17, 18, 14, 4, 5, 6, 13, 15, 16, 17],      # VR
    [5, 6, 7, 8, 17, 18, 19, 20, 6, 7, 8, 21, 18, 19, 20, 22],      # VL
    [3, 15, 16, 17, 2, 14, 3, 15, 1, 13, 2, 14, 0, 12, 1, 13],      # HD
    [2, 13, 1, 12, 1, 12, 0, 23, 0, 23, 25, 25, 25, 25, 25, 25],    # HU
)


def subblock_predict_all(above4, left4, al, ar4):
    """All ten 4x4 b-mode predictions: returns (N, 10, 4, 4) int32.

    above4/left4/ar4: (N, 4) int32; al: (N,).  Order matches the bmode enum
    (DC, TM, VE, HE, LD, RD, VR, VL, HD, HU).  Every cell of the eight
    directional modes is one smoothed pair or triple of edge pixels (or
    one pixel): all of them are computed once, and each mode gathers its
    sixteen (see _DIRECTIONAL)."""
    N = above4.shape[0]
    a = torch.cat([above4, ar4], dim=1)                      # A0..A7
    l = left4
    # edge pixels: left bottom-up, above-left, then the above row
    e = torch.cat([left4.flip(1), al[:, None], a], dim=1)    # (N, 13)
    V = torch.cat([_avg2(e[:, :-1], e[:, 1:]),
                   _avg3(e[:, :-2], e[:, 1:-1], e[:, 2:]),
                   _avg3(l[:, 2:3], l[:, 3:4], l[:, 3:4]),
                   _avg3(a[:, 6:7], a[:, 7:8], a[:, 7:8]),
                   l[:, 3:4]], dim=1)                        # (N, 26)
    idx = torch.tensor(_DIRECTIONAL, device=e.device).reshape(-1)
    directional = V[:, idx].reshape(N, 8, 4, 4)
    dc = ((a[:, :4].sum(1) + l.sum(1) + 4) >> 3)[:, None, None, None] \
        .expand(N, 1, 4, 4)
    tm = torch.clamp(l[:, :, None] + a[:, None, :4] - al[:, None, None],
                     0, 255)[:, None]
    return torch.cat([dc, tm, directional], dim=1).to(torch.int32)


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
