"""Plain PyTorch version of the keyframe-encode kernel K7
(ops/enc_intra_cuda.py, csrc/enc_intra.cu): every macroblock of a key
frame, over anti-diagonals d = 2*row + col, vectorised over the
macroblocks of a diagonal, as a Python loop over diagonals (like
ops/wavefront.py).

Per macroblock (reference encoder/encode_intra.cc:36-456, the JAX
package's host loop encoder/encode_intra_np.py:encode_intra_mb):

1. B_PRED candidate: the 16 sub-blocks in raster order, each scoring the
   ten b-modes by SSE rd-cost under the key frame's contextual mode costs
   (above and left b-modes, B_DC_PRED off-frame), then subtract, fDCT,
   quantize (or trellis), dequantize and iDCT-add into the working
   reconstruction the next sub-block predicts from.
2. Whole-MB luma: DC/V/H/TM scored by variance rd-cost.
3. B_PRED wins only if strictly cheaper.
4. Whole-mode transform path: 16 fDCTs, their DCs through the WHT into Y2,
   quantize (or trellis), reconstruct through iWHT and iDCT.
5. Chroma: the mode of least raw SSE over U and V (no rate), then the
   same transform chain.

Every mode scan is ascending with strict ``<`` (``argmin`` returns the
first minimum).  Costs are int64.  With token costs the quantizer is the
trellis (--two-pass), whose entry contexts are the neighbours' nonzero
flags after trellis quantization: per 4x4 block across macroblock borders,
and for Y2 a chain along each row and each column that B_PRED macroblocks
(which have no Y2) pass on unchanged.
"""
import functools

import numpy as np
import torch

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.encoder.costs import Costs
from alfalfa_tpu_torch.ops import enc_transforms as ET
from alfalfa_tpu_torch.ops import intra, transforms
from alfalfa_tpu_torch.ops import trellis as TR
from alfalfa_tpu_torch.ops.wavefront import diagonals, tile, untile

B_PRED = 4
MODE_WORDS = 20     # modes per macroblock: ymode, uvmode, y2_coded,
                    # has_nonzero, the 16 b-modes in raster order
# whole mode (DC, V, H, TM) -> the b-mode neighbours see (parse.py)
IMPLIED_BMODE = (T.B_DC_PRED, T.B_VE_PRED, T.B_HE_PRED, T.B_TM_PRED)


@functools.cache
def _cost_tables():
    c = Costs()
    return (np.asarray(c.mbmode_costs[0][:5], np.int64),
            np.asarray(c.bmode_costs, np.int64))


def mode_costs(device):
    """(5,) key-frame macroblock mode costs and (10, 10, 10) b-mode costs
    [above][left][mode], int64 tensors on ``device``."""
    mb, bm = _cost_tables()
    return (torch.from_numpy(mb).to(device), torch.from_numpy(bm).to(device))


def _rdcost(rate, dist, rm, dm):
    return ((128 + rate * rm) >> 8) + dist * dm


def _dq(coeffs, dc, ac):
    """transforms.dequantize with int factors."""
    f = lambda x: torch.tensor(x, dtype=torch.int32, device=coeffs.device)
    return transforms.dequantize(coeffs, f(dc), f(ac))


def _to_blocks(t, n):
    """(..., 4n, 4n) tiles -> (..., n*n, 16) 4x4 blocks, raster order."""
    return t.unflatten(-1, (n, 4)).unflatten(-3, (n, 4)).transpose(-3, -2) \
        .reshape(t.shape[:-2] + (n * n, 16))


def _from_blocks(b, n):
    """Inverse of _to_blocks."""
    return b.unflatten(-1, (4, 4)).unflatten(-3, (n, n)).transpose(-3, -2) \
        .reshape(b.shape[:-2] + (4 * n, 4 * n))


def _chain(nodes, tc, first, nz_abv, nz_left, n, rm, dm):
    """Resolve the trellis choice of an n x n grid of blocks per
    macroblock in raster order, each with its known entry context (the
    backward passes do not depend on it and ran batched).  nodes: of
    (N * n * n) blocks; nz_abv (N, n) / nz_left (N, n): the neighbours'
    flags.  Returns ((N, n*n, 16) int32 coefficients, (N, n, n) bool)."""
    N = nz_abv.shape[0]
    outs = [TR.trellis_walk(nodes, torch.full((N * n * n,), lvl,
                                              dtype=torch.int64,
                                              device=nz_abv.device), first)
            for lvl in (0, 1)]
    sub = lambda t, b: t.reshape((N, n * n) + t.shape[1:])[:, b]
    nz = torch.zeros((N, n, n), dtype=torch.bool, device=nz_abv.device)
    out = torch.zeros((N, n * n, 16), dtype=torch.int32,
                      device=nz_abv.device)
    for b in range(n * n):
        sr, sc = divmod(b, n)
        up = nz[:, sr - 1, sc] if sr else nz_abv[:, sc]
        lf = nz[:, sr, sc - 1] if sc else nz_left[:, sr]
        nb = tuple(sub(x, b) for x in nodes)
        ch = TR.trellis_choose(nb, tc, first, up.to(torch.int64)
                               + lf.to(torch.int64), rm, dm).bool()
        out[:, b] = torch.where(ch[:, None], sub(outs[1][0], b),
                                sub(outs[0][0], b))
        nz[:, sr, sc] = torch.where(ch, sub(outs[1][1], b),
                                    sub(outs[0][1], b))
    return out, nz


def _edges(Tp, r, c, ru, cl, hrow, hcol, S):
    """(e0, above row, left column) of the macroblocks (r, c) in the S x S
    tiles ``Tp``, with the 127/129 edge rules applied."""
    above = torch.where(hrow[:, None], Tp[ru, c, S - 1, :], 127)
    corner = Tp[ru, cl, S - 1, S - 1]
    e0 = torch.where(hrow & hcol, corner,
                     torch.where(hrow, 129, 127).to(corner.dtype))
    left = torch.where(hcol[:, None], Tp[r, cl, :, S - 1], 129)
    return e0, above, left


def y2_residue(oy, pred, q):
    """The whole-macroblock luma chain with plain quantization: 16 fDCTs of
    ``oy`` - ``pred`` ((N, 16, 16) raster tiles), their DCs through the WHT
    into Y2, quantize, then the decoder's reconstruction (iWHT, iDCT, add,
    clamp).  Shared by whole-mode intra and inter macroblocks.  Returns
    ((N, 16, 16) AC coefficients per 4x4 block, (N, 16) Y2, (N, 16, 16)
    reconstructed tile)."""
    ydc, yac, y2dc, y2ac = q[:4]
    pb = _to_blocks(pred, 4)
    co = ET.fdct(_to_blocks(oy, 4), pb)
    y2q = ET.quantize(ET.fwht(co[:, :, 0]), y2dc, y2ac)
    wco = ET.quantize(torch.cat([torch.zeros_like(co[:, :, :1]),
                                 co[:, :, 1:]], dim=2), ydc, yac)
    return wco, y2q, _y2_recon(pb, wco, y2q, q)


def _y2_recon(pb, wco, y2q, q):
    ydc, yac, y2dc, y2ac = q[:4]
    N = pb.shape[0]
    yd = _dq(wco, ydc, yac)
    dc = transforms.iwht(_dq(y2q, y2dc, y2ac)).reshape(N, 16)
    yd = torch.cat([dc[:, :, None], yd[:, :, 1:]], dim=2)
    return _from_blocks(torch.clamp(pb + transforms.idct(yd).reshape(N, 16, 16),
                                    0, 255), 4)


def chroma_residue(o, p, q):
    """One 8x8 chroma block with plain quantization: ((N, 4, 16)
    coefficients, (N, 8, 8) reconstruction) of ``o`` - ``p``."""
    uvdc, uvac = q[4:6]
    N = o.shape[0]
    pb = _to_blocks(p, 2)
    qc = ET.quantize(ET.fdct(_to_blocks(o, 2), pb), uvdc, uvac)
    res = transforms.idct(_dq(qc, uvdc, uvac)).reshape(N, 4, 16)
    return qc, _from_blocks(torch.clamp(pb + res, 0, 255), 2)


def intra_mbs(st, r, c, q, rm, dm, tcs, mbc, bcost):
    """The intra encode of the macroblocks (r, c) ((N,) tensors), which
    may all be encoded at once: every neighbour they read is in ``st``
    already (see encode_kf_frame_plain for ``st``).  ``mbc``: the (5,)
    macroblock mode costs; ``bcost``: the b-mode costs, (10, 10, 10)
    [above][left][mode] under the key frame's context (read from
    ``st["BM"]``), or (10,) for an interframe, which has no context.

    Writes nothing; returns a dict of per-macroblock results: coeffs (N,
    25, 16) int32, ymode, uvmode, use_b (N,), bmodes (N, 4, 4), the
    reconstructed tiles y (N, 16, 16), u, v (N, 8, 8), nz (N,) and, with
    token costs, the trellis state ynz (N, 4, 4), unz, vnz (N, 2, 2) and
    y2c (N, 4)."""
    dev = st["Ty"].device
    C = st["C"]
    N = r.shape[0]
    ar = torch.arange(N, device=dev)
    ru, cl, cr = (r - 1).clamp(min=0), (c - 1).clamp(min=0), \
        (c + 1).clamp(max=C - 1)
    hrow, hcol, lastc = r > 0, c > 0, c == C - 1
    Ty, Tu, Tv = st["Ty"], st["Tu"], st["Tv"]
    oy, ou, ov = st["Oy"][r, c], st["Ou"][r, c], st["Ov"][r, c]
    ydc, yac, y2dc, y2ac, uvdc, uvac = q
    contextual = bcost.dim() == 3

    e0, above16, lcol = _edges(Ty, r, c, ru, cl, hrow, hcol, 16)
    ar4 = torch.where((hrow & ~lastc)[:, None], Ty[ru, cr, 15, 0:4],
                      torch.where(hrow[:, None], above16[:, 15:16]
                                  .expand(N, 4), 127))
    e21 = torch.cat([e0[:, None], above16, ar4], dim=1)
    if contextual:
        BM = st["BM"]
        abv_bm = torch.where(hrow[:, None], BM[ru, c, 3, :], T.B_DC_PRED)
        left_bm = torch.where(hcol[:, None], BM[r, cl, :, 3], T.B_DC_PRED)
    if tcs is not None:
        ynz_abv = st["ynz"][ru, c, 3, :] & hrow[:, None]
        ynz_left = st["ynz"][r, cl, :, 3] & hcol[:, None]

    # ---- B_PRED candidate, reconstruction in the loop ----
    btile = torch.zeros((N, 16, 16), dtype=torch.int32, device=dev)
    bm = torch.zeros((N, 4, 4), dtype=torch.int64, device=dev)
    bco = torch.zeros((N, 16, 16), dtype=torch.int32, device=dev)
    bnz = torch.zeros((N, 4, 4), dtype=torch.bool, device=dev)
    b_rate = mbc[B_PRED].expand(N).clone()
    b_dist = torch.zeros(N, dtype=torch.int64, device=dev)
    for sr in range(4):
        for sc in range(4):
            y0, x0 = sr * 4, sc * 4
            above4 = (btile[:, y0 - 1, x0:x0 + 4] if sr
                      else e21[:, 1 + x0:5 + x0])
            left4 = btile[:, y0:y0 + 4, x0 - 1] if sc else lcol[:, y0:y0 + 4]
            if sr == 0:
                al = e21[:, x0]
                ra = e21[:, 5 + x0:9 + x0]
            else:
                al = btile[:, y0 - 1, x0 - 1] if sc else lcol[:, y0 - 1]
                # the right-most column takes its above-right from the row
                # above the macroblock
                ra = btile[:, y0 - 1, x0 + 4:x0 + 8] if sc < 3 \
                    else e21[:, 17:21]
            preds = intra.subblock_predict_all(above4, left4, al, ra)
            o = oy[:, y0:y0 + 4, x0:x0 + 4]
            sse = ((o[:, None] - preds) ** 2).sum(dim=(2, 3)).to(torch.int64)
            if contextual:
                am = bm[:, sr - 1, sc] if sr else abv_bm[:, sc]
                lm = bm[:, sr, sc - 1] if sc else left_bm[:, sr]
                rates = bcost[am, lm]                             # (N, 10)
            else:
                rates = bcost.expand(N, 10)
            m = _rdcost(rates, sse, rm, dm).argmin(dim=1)
            bm[:, sr, sc] = m
            b_rate += rates[ar, m]
            b_dist += sse[ar, m]
            pred = preds[ar, m].reshape(N, 16)
            co = ET.fdct(o.reshape(N, 16), pred)
            if tcs is None:
                qc = ET.quantize(co, ydc, yac)
            else:
                up = bnz[:, sr - 1, sc] if sr else ynz_abv[:, sc]
                lf = bnz[:, sr, sc - 1] if sc else ynz_left[:, sr]
                qc, bnz[:, sr, sc] = TR.trellis_quantize(
                    co, ydc, yac, tcs[T.BLOCK_Y_WITHOUT_Y2],
                    up.to(torch.int64) + lf.to(torch.int64), 0, rm, dm)
            bco[:, sr * 4 + sc] = qc
            res = transforms.idct(_dq(qc, ydc, yac))
            btile[:, y0:y0 + 4, x0:x0 + 4] = torch.clamp(
                pred.reshape(N, 4, 4) + res, 0, 255)
    b_cost = _rdcost(b_rate, b_dist, rm, dm)

    # ---- whole-MB luma, scored by variance ----
    wpreds = intra.whole_predict_all(e21, lcol, hrow, hcol, 16)
    d = (oy[:, None] - wpreds).reshape(N, 4, 256).to(torch.int64)
    s = d.sum(dim=2)
    var = (d * d).sum(dim=2) - (s * s) // 256
    wcost = _rdcost(mbc[:4][None, :], var, rm, dm)
    wm = wcost.argmin(dim=1)
    use_b = b_cost < wcost[ar, wm]
    if tcs is None:
        wco, y2q, wrec = y2_residue(oy, wpreds[ar, wm], q)
    else:
        wpred = _to_blocks(wpreds[ar, wm], 4)                 # (N, 16, 16)
        co = ET.fdct(_to_blocks(oy, 4), wpred)
        y2 = ET.fwht(co[:, :, 0])
        co = torch.cat([torch.zeros_like(co[:, :, :1]), co[:, :, 1:]], dim=2)
        tcy = tcs[T.BLOCK_Y_AFTER_Y2]
        nodes = TR.trellis_nodes(co.reshape(N * 16, 16), ydc, yac, tcy, 1,
                                 rm, dm)
        wco, wnz = _chain(nodes, tcy, 1, ynz_abv, ynz_left, 4, rm, dm)
        col_in, row_in = y2_chains(st["y2c"], r, c, ru, cl, hrow, hcol)
        ctx = (col_in[:, 0] & col_in[:, 1]).to(torch.int64) \
            + (row_in[:, 0] & row_in[:, 1]).to(torch.int64)
        y2q, y2nz = TR.trellis_quantize(y2, y2dc, y2ac, tcs[T.BLOCK_Y2], ctx,
                                        0, rm, dm)
        wrec = _y2_recon(wpred, wco, y2q, q)

    # ---- chroma, by raw SSE over U and V ----
    chroma = []
    for Tp, o in ((Tu, ou), (Tv, ov)):
        ce0, a8, l8 = _edges(Tp, r, c, ru, cl, hrow, hcol, 8)
        p = intra.whole_predict_all(torch.cat([ce0[:, None], a8], dim=1), l8,
                                    hrow, hcol, 8)
        chroma.append((o, p))
    uv_sse = sum(((o[:, None] - p) ** 2).sum(dim=(2, 3)).to(torch.int64)
                 for o, p in chroma)
    uvm = uv_sse.argmin(dim=1)
    uv_co, uv_rec, uv_nz = [], [], []
    for pl, (o, p) in enumerate(chroma):
        if tcs is None:
            qc, rec = chroma_residue(o, p[ar, uvm], q)
        else:
            pb = _to_blocks(p[ar, uvm], 2)
            co_c = ET.fdct(_to_blocks(o, 2), pb)
            nzp = st["unz" if pl == 0 else "vnz"]
            tcu = tcs[T.BLOCK_UV]
            nodes = TR.trellis_nodes(co_c.reshape(N * 4, 16), uvdc, uvac,
                                     tcu, 0, rm, dm)
            qc, nz = _chain(nodes, tcu, 0, nzp[ru, c, 1, :] & hrow[:, None],
                            nzp[r, cl, :, 1] & hcol[:, None], 2, rm, dm)
            uv_nz.append(nz)
            res = transforms.idct(_dq(qc, uvdc, uvac)).reshape(N, 4, 16)
            rec = _from_blocks(torch.clamp(pb + res, 0, 255), 2)
        uv_co.append(qc)
        uv_rec.append(rec)

    ub = use_b[:, None, None]
    coeffs = torch.cat([torch.where(ub, bco, wco), uv_co[0], uv_co[1],
                        torch.where(ub[:, 0], 0, y2q)[:, None]], dim=1)
    implied = torch.tensor(IMPLIED_BMODE, device=dev)[wm]
    out = {"coeffs": coeffs, "ymode": torch.where(use_b, B_PRED, wm),
           "uvmode": uvm, "use_b": use_b,
           "bmodes": torch.where(ub, bm, implied[:, None, None]),
           "y": torch.where(ub, btile, wrec), "u": uv_rec[0], "v": uv_rec[1],
           "nz": (coeffs != 0).flatten(1).any(dim=1)}
    if tcs is not None:
        one = torch.ones_like(y2nz)
        out.update(ynz=torch.where(ub, bnz, wnz), unz=uv_nz[0], vnz=uv_nz[1],
                   y2c=torch.stack([
                       torch.where(use_b, col_in[:, 0], y2nz),
                       torch.where(use_b, col_in[:, 1], one),
                       torch.where(use_b, row_in[:, 0], y2nz),
                       torch.where(use_b, row_in[:, 1], one)], dim=1))
    return out


def y2_chains(y2c, r, c, ru, cl, hrow, hcol):
    """The Y2 context chains entering the macroblocks (r, c): (column nz,
    valid) from the one above, (row nz, valid) from the one to the left;
    False off the frame.  A macroblock without Y2 passes them on."""
    col_in = torch.where(hrow[:, None], y2c[ru, c, 0:2], False)
    row_in = torch.where(hcol[:, None], y2c[r, cl, 2:4], False)
    return col_in, row_in


def _encode_diag(st, rs, cs, q, rm, dm, tcs):
    """Encode the macroblocks (rs, cs) of one diagonal into the state
    ``st`` (see encode_kf_frame_plain)."""
    dev = st["Ty"].device
    r = torch.tensor(rs, device=dev)
    c = torch.tensor(cs, device=dev)
    o = intra_mbs(st, r, c, q, rm, dm, tcs, st["mbc"], st["bcost"])
    st["coeffs"][r, c] = o["coeffs"].to(torch.int16)
    st["modes"][r, c] = torch.cat([
        torch.stack([o["ymode"], o["uvmode"], (~o["use_b"]).to(torch.int64),
                     o["nz"].to(torch.int64)], dim=1),
        o["bmodes"].reshape(-1, 16)], dim=1).to(torch.uint8)
    st["Ty"][r, c] = o["y"]
    st["Tu"][r, c] = o["u"]
    st["Tv"][r, c] = o["v"]
    st["BM"][r, c] = o["bmodes"]
    if tcs is not None:
        for k in ("ynz", "unz", "vnz", "y2c"):
            st[k][r, c] = o[k]


def encode_kf_frame_plain(oy, ou, ov, quant, rate_mult, dist_mult,
                          token_costs=None, order=None):
    """Plain version of ops.enc_intra_cuda.encode_kf_frame (same contract,
    any device), the macroblocks in ``order`` (default the anti-diagonals
    d = 2r + c; any list of (rows, cols) in which every macroblock comes
    after those it reads, such as ops.wavefront.row_order's).

    oy: (16R, 16C), ou / ov: (8R, 8C) uint8 original planes, padded to
    whole macroblocks; quant: the six quantizer factors (y_dc, y_ac,
    y2_dc, y2_ac, uv_dc, uv_ac); rate_mult / dist_mult: the RD
    multipliers; token_costs: None (plain quantization), or the
    (4, 16, 36) int32 position-major token costs of the frame's
    probabilities (encoder/trellis.py:token_costs_pm) for the trellis.

    Returns (coeffs (R, C, 25, 16) int16 in raster order, modes (R, C,
    MODE_WORDS) uint8, and the reconstructed, unfiltered (16R, 16C),
    (8R, 8C), (8R, 8C) uint8 planes)."""
    dev = oy.device
    R, C = oy.shape[0] // 16, oy.shape[1] // 16
    mbc, bcost = mode_costs(dev)
    st = {"R": R, "C": C, "mbc": mbc, "bcost": bcost,
          "Oy": tile(oy[None], 16)[0], "Ou": tile(ou[None], 8)[0],
          "Ov": tile(ov[None], 8)[0],
          "Ty": torch.zeros((R, C, 16, 16), dtype=torch.int32, device=dev),
          "Tu": torch.zeros((R, C, 8, 8), dtype=torch.int32, device=dev),
          "Tv": torch.zeros((R, C, 8, 8), dtype=torch.int32, device=dev),
          "BM": torch.zeros((R, C, 4, 4), dtype=torch.int64, device=dev),
          "coeffs": torch.zeros((R, C, 25, 16), dtype=torch.int16,
                                device=dev),
          "modes": torch.zeros((R, C, MODE_WORDS), dtype=torch.uint8,
                               device=dev)}
    tcs = None
    if token_costs is not None:
        tcs = token_costs.to(dev, torch.int64)
        z = lambda n: torch.zeros((R, C, n, n), dtype=torch.bool, device=dev)
        st.update(ynz=z(4), unz=z(2), vnz=z(2),
                  y2c=torch.zeros((R, C, 4), dtype=torch.bool, device=dev))
    q = tuple(int(x) for x in quant)
    for rs, cs in diagonals(R, C) if order is None else order:
        _encode_diag(st, rs, cs, q, int(rate_mult), int(dist_mult), tcs)
    y = untile(st["Ty"][None])[0]
    u = untile(st["Tu"][None])[0]
    v = untile(st["Tv"][None])[0]
    return st["coeffs"], st["modes"], y, u, v
