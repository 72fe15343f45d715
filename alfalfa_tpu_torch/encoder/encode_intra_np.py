"""The host intra encoder of one macroblock: mode decision, transform,
quantization and the decoder-identical reconstruction, in numpy.

Copied from the JAX package's encoder/encode_intra_np.py (encode_intra.cc:
36-456 of the reference): whole-macroblock modes are scored by variance
(the DC moves into Y2), B_PRED sub-blocks by SSE with reconstruction in
the loop, chroma by SSE over both planes.  The fast path's host-patch
variant encodes its intra macroblocks with encode_intra_mb
(encoder/encode_inter_fast.py); the rebase predicts its intra macroblocks
with _predict_whole and _predict_b (encoder/reencode.py).  The JAX
package's key-frame loop and trellis option are not here: the port's key
frames are K7's (encoder/encode_intra.py).

The B_PRED search and the 4x4 prediction run in native/enckernel.cc
(bpred_search, bpred_predict; no fallback); bpred_search_plain and
bpred_predict_plain are their numpy bodies, which the tests hold them to.
"""
import numpy as np

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.decoder import reconstruct_np as R
from alfalfa_tpu_torch.native import enckernel
from . import transforms_np as FX
from .costs import Costs, rdcost

_COSTS = Costs()

# the b-mode a whole-macroblock luma mode implies, for the contexts of
# later B_PRED macroblocks
_IMPLIED_BMODE = {T.DC_PRED: T.B_DC_PRED, T.V_PRED: T.B_VE_PRED,
                  T.H_PRED: T.B_HE_PRED, T.TM_PRED: T.B_TM_PRED}


def _variance(orig, pred):
    d = orig.astype(np.int32) - pred.astype(np.int32)
    s = int(d.sum())
    return int((d * d).sum()) - (s * s) // d.size


def _sse(orig, pred):
    d = orig.astype(np.int32) - pred.astype(np.int32)
    return int((d * d).sum())


def _predict_whole(plane, col, row, size, mode):
    """The size x size prediction (16: luma, 8: chroma) of whole-block
    mode ``mode`` at macroblock (row, col), the plane left as it was."""
    block = plane[row * size:(row + 1) * size, col * size:(col + 1) * size]
    saved = block.copy()
    R.intra_predict_mb(plane, col, row, size, mode)
    pred = block.copy()
    block[:] = saved
    return pred


def _predict_b(plane, col4, row4, mode):
    """The 4x4 prediction of b-mode ``mode`` at sub-block (row4, col4)
    (native/enckernel.cc vp8_bpred_predict)."""
    return enckernel.bpred_predict(plane, col4, row4, mode)


def bpred_predict_plain(plane, col4, row4, mode):
    """_predict_b's numpy body, the plane left as it was."""
    block = plane[row4 * 4:row4 * 4 + 4, col4 * 4:col4 * 4 + 4]
    saved = block.copy()
    R.intra_predict_b(plane, col4, row4, mode)
    pred = block.copy()
    block[:] = saved
    return pred


def bpred_search_plain(plane, col4, row4, orig4, mode_costs, rate_mult,
                       dist_mult):
    """enckernel.bpred_search's numpy body: the b-mode of least RD cost
    (the first of equal ones) for the 4x4 block ``orig4`` at (row4, col4)
    predicted from ``plane``, and its prediction."""
    best = (1 << 62, 0, None)
    for m in range(T.NUM_INTRA_B_MODES):
        pred = bpred_predict_plain(plane, col4, row4, m)
        cost = rdcost(int(mode_costs[m]), _sse(orig4, pred), rate_mult,
                      dist_mult)
        if cost < best[0]:
            best = (cost, m, pred)
    return best[1], best[2]


def encode_intra_mb(orig, recon, arrays, r, c, q, rate_mult, dist_mult,
                    interframe=False):
    """Encode one intra macroblock against the current reconstruction,
    B_PRED and the four whole-MB modes tried; writes coefficients/modes
    into ``arrays`` and the reconstructed pixels into ``recon`` (the
    decoder-identical reconstruction).  The whole modes alone (the JAX
    package's ``skip_bpred``) are K10's work (ops/enc_intra_fixup.py)."""
    oy, ou, ov = orig
    mode_cost_idx = 1 if interframe else 0

    # ---- luma: B_PRED candidate (reconstruction in the loop) ----
    bpred_rate = int(_COSTS.mbmode_costs[mode_cost_idx][T.B_PRED])
    bpred_dist = 0
    bpred_coeffs = np.zeros((16, 16), np.int16)
    bpred_modes = np.zeros((4, 4), np.int8)
    saved_y = recon.y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16].copy()

    for sr in range(4):
        for sc in range(4):
            col4, row4 = c * 4 + sc, r * 4 + sr
            osb = oy[row4 * 4:row4 * 4 + 4, col4 * 4:col4 * 4 + 4]
            if interframe:
                mode_costs = _COSTS.inter_bmode_costs
            else:
                if sr > 0:
                    above = int(bpred_modes[sr - 1, sc])
                elif r > 0:
                    above = int(arrays.bmode[r - 1, c, 3, sc])
                else:
                    above = T.B_DC_PRED
                if sc > 0:
                    left = int(bpred_modes[sr, sc - 1])
                elif c > 0:
                    left = int(arrays.bmode[r, c - 1, sr, 3])
                else:
                    left = T.B_DC_PRED
                mode_costs = _COSTS.bmode_costs[above, left]
            m, pred = enckernel.bpred_search(recon.y, col4, row4, osb,
                                             mode_costs, rate_mult,
                                             dist_mult)
            bpred_modes[sr, sc] = m
            bpred_rate += int(mode_costs[m])
            bpred_dist += _sse(osb, pred)
            # transform + quantize + reconstruct in place
            qc = FX.quantize(FX.subtract_fdct(osb, pred), q["y_dc"],
                             q["y_ac"])
            bpred_coeffs[sr * 4 + sc] = qc
            dq = R.dequantize(qc, q["y_dc"], q["y_ac"])
            blk = recon.y[row4 * 4:row4 * 4 + 4, col4 * 4:col4 * 4 + 4]
            blk[:] = pred
            R.idct_add(dq, blk)

    bpred_cost = rdcost(bpred_rate, bpred_dist, rate_mult, dist_mult)
    bpred_recon = recon.y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16].copy()
    recon.y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = saved_y

    # ---- luma: whole-MB modes ----
    best_whole = (1 << 62, None, None)
    o16 = oy[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16]
    for m in range(T.B_PRED):
        pred = _predict_whole(recon.y, c, r, 16, m)
        cost = rdcost(int(_COSTS.mbmode_costs[mode_cost_idx][m]),
                      _variance(o16, pred), rate_mult, dist_mult)
        if cost < best_whole[0]:
            best_whole = (cost, m, pred)

    if bpred_cost < best_whole[0]:
        arrays.ymode[r, c] = T.B_PRED
        arrays.bmode[r, c] = bpred_modes
        arrays.coeffs[r, c, 0:16] = bpred_coeffs
        arrays.y2_coded[r, c] = False
        recon.y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = bpred_recon
    else:
        _, ymode, pred = best_whole
        arrays.ymode[r, c] = ymode
        arrays.bmode[r, c] = _IMPLIED_BMODE[ymode]
        arrays.y2_coded[r, c] = True
        # whole-mode transform path: per-sub-block fDCT, DCs -> Y2 WHT
        walsh_input = np.zeros(16, np.int16)
        for sr in range(4):
            for sc in range(4):
                osb = o16[sr * 4:sr * 4 + 4, sc * 4:sc * 4 + 4]
                psb = pred[sr * 4:sr * 4 + 4, sc * 4:sc * 4 + 4]
                coeffs = FX.subtract_fdct(osb, psb)
                walsh_input[sr * 4 + sc] = coeffs[0]
                coeffs[0] = 0
                arrays.coeffs[r, c, sr * 4 + sc] = FX.quantize(
                    coeffs, q["y_dc"], q["y_ac"])
        arrays.coeffs[r, c, 24] = FX.quantize(FX.fwht(walsh_input),
                                              q["y2_dc"], q["y2_ac"])
        # reconstruct via the decoder path (prediction + walsh + idct_add)
        recon.y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = pred
        R._apply_walsh(arrays, recon, r, c, q)

    # ---- chroma ----
    best_uv = (1 << 62, None, None, None)
    ou8 = ou[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8]
    ov8 = ov[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8]
    for m in range(T.NUM_UV_MODES):
        pu = _predict_whole(recon.u, c, r, 8, m)
        pv = _predict_whole(recon.v, c, r, 8, m)
        dist = _sse(ou8, pu) + _sse(ov8, pv)
        # the reference picks chroma by raw distortion (encode_intra.cc:276)
        if dist < best_uv[0]:
            best_uv = (dist, m, pu, pv)
    _, uvmode, pu, pv = best_uv
    arrays.uvmode[r, c] = uvmode
    for plane, opl, ppl, base in ((recon.u, ou8, pu, 16),
                                  (recon.v, ov8, pv, 20)):
        for sr in range(2):
            for sc in range(2):
                osb = opl[sr * 4:sr * 4 + 4, sc * 4:sc * 4 + 4]
                psb = ppl[sr * 4:sr * 4 + 4, sc * 4:sc * 4 + 4]
                qc = FX.quantize(FX.subtract_fdct(osb, psb), q["uv_dc"],
                                 q["uv_ac"])
                arrays.coeffs[r, c, base + sr * 2 + sc] = qc
                dq = R.dequantize(qc, q["uv_dc"], q["uv_ac"])
                blk = plane[r * 8 + sr * 4:r * 8 + sr * 4 + 4,
                            c * 8 + sc * 4:c * 8 + sc * 4 + 4]
                blk[:] = psb
                R.idct_add(dq, blk)

    arrays.has_nonzero[r, c] = bool(arrays.coeffs[r, c].any())
    arrays.ref[r, c] = T.CURRENT_FRAME
