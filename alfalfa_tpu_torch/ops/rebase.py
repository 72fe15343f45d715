"""The rebase's residue update of one frame (PyTorch): the plain version of
the CUDA kernel csrc/rebase_residues.cu (wrapper ops/rebase_cuda.py).

The rebase keeps a prediction frame's modes and vectors and recomputes
only the residues against the encoder's own references (reference
reencode.cc:131-230).  ``rebase_frame_plain`` does the whole frame:

- every inter macroblock at once (they read the references only): K3's
  six-tap prediction (``sixtap.mc_planes_plain``), then
  ``inter_residues_plain``: the original minus the prediction, forward
  DCT, truncating quantization (a whole-vector macroblock's 16 luma DCs
  through the WHT into Y2; SPLITMV keeps them in-block and codes no Y2),
  and the reconstruction a decoder makes of the result.  This is the
  function of the JAX package's encoder/reencode_device.py:_fn_core, which
  computes it with H1's helpers under XLA around K3 (it reaches no
  pallas_call of its own);
- then the intra macroblocks with the prediction's modes as given, no
  search (the JAX package's encoder/reencode.py:_apply_intra_mb), each
  predicted from the final reconstruction of its neighbours: a whole luma
  mode through the Y2 chain, B_PRED as a chain of 16 sub-blocks with their
  b-modes (no Y2), chroma with the prediction's chroma mode.  They go over
  the anti-diagonals d = 2r + c (a B_PRED macroblock reads its above-right
  neighbour's bottom row), vectorised over each diagonal's macroblocks, or
  in any ``order`` that respects those reads.

Coefficients come out in _tiles_to_blocks order: 16 luma blocks, 4 U, 4
V, then Y2, each 16 values in raster order.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.ops import enc_transforms as ET
from alfalfa_tpu_torch.ops import intra
from alfalfa_tpu_torch.ops import transforms as TR
from alfalfa_tpu_torch.ops.enc_intra import (_dq, _edges, _from_blocks,
                                             _to_blocks, chroma_residue,
                                             y2_residue)
from alfalfa_tpu_torch.ops.sixtap import mc_planes_plain
from alfalfa_tpu_torch.ops.wavefront import diagonals, tile, untile

# A macroblock's modes and vectors as the kernel reads them: MB_WORDS int32
# words, word 0 the reference (0 intra, 1-3 last, golden, alternate), 1
# the luma mode, 2 the chroma mode, 4-7 the b-modes (sub-block row k in
# word 4 + k, a byte a sub-block), 8-23 the 16 luma vectors and 24-27 the
# 4 chroma vectors (x in the low 16 bits, y in the high 16), the rest zero.
MB_WORDS = 32
W_REF, W_YMODE, W_UVMODE, W_BMODE, W_MV, W_UVMV = 0, 1, 2, 4, 8, 24

# The output words of a macroblock: its 400 coefficients, then a flag word
# (bit 0: any coefficient nonzero, bit 1: Y2 coded).
OUT_WORDS = 401
NONZERO, Y2_CODED = 1, 2


def mb_words(ref, ymode, uvmode, bmode, sub_mv, uv_mv):
    """The (R, C, MB_WORDS) int32 numpy words of a frame's modes and
    vectors (numpy arrays of FrameArrays' shapes: (R, C), (R, C), (R, C),
    (R, C, 4, 4), (R, C, 4, 4, 2), (R, C, 2, 2, 2)), written through byte
    and int16 views of the words (little-endian, as host and card are)."""
    R, C = np.shape(ref)
    out = np.zeros((R, C, MB_WORDS), np.int32)
    out[..., W_REF], out[..., W_YMODE], out[..., W_UVMODE] = ref, ymode, uvmode
    out.view(np.uint8)[..., 4 * W_BMODE:4 * W_MV] = \
        np.reshape(bmode, (R, C, 16))
    halves = out.view(np.int16)
    halves[..., 2 * W_MV:2 * W_UVMV] = np.reshape(sub_mv, (R, C, 32))
    halves[..., 2 * W_UVMV:2 * W_UVMV + 8] = np.reshape(uv_mv, (R, C, 8))
    return out


def _vectors(words, n):
    """(..., n, n, 2) int32 vectors of packed words (..., n * n)."""
    x = (words << 16) >> 16
    return torch.stack([x, words >> 16], -1).reshape(
        words.shape[:-1] + (n, n, 2))


def split_out(out):
    """(coefficients (R, C, 25, 16), nonzero (R, C) bool, Y2 coded (R, C)
    bool) of a frame's output words (numpy or torch)."""
    coeffs = out[..., :400].reshape(out.shape[:-1] + (25, 16))
    return coeffs, (out[..., 400] & NONZERO) != 0, \
        (out[..., 400] & Y2_CODED) != 0


def plane_tiles(plane, S):
    """An (R S, C S) plane as an (R, C, S, S) view of its macroblocks."""
    H, W = plane.shape
    return plane.view(H // S, S, W // S, S).permute(0, 2, 1, 3)


def inter_residues_plain(orig, pred, ref_sel, splitmv, quant, recon):
    """Update every inter macroblock's residues.

    orig: the original (y, u, v) planes, (16R, 16C), (8R, 8C), (8R, 8C)
    uint8, padded to whole macroblocks; pred: K3's predictions of the
    three planes, (R, C, 16, 16), (R, C, 8, 8), (R, C, 8, 8) uint8;
    ref_sel: (R, C) int, 0 = intra; splitmv: (R, C) bool; quant: the six
    factors (y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac) as ints; recon: the
    (y, u, v) planes of the reconstruction, written in place at inter
    macroblocks.  Returns the coefficients (R, C, 25, 16) int16 (zero at
    intra macroblocks) and the nonzero flags (R, C) bool."""
    y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac = (int(x) for x in quant)
    dev = ref_sel.device
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    inter = ref_sel != 0
    sm = splitmv.to(torch.bool) & inter

    # luma: DCs ride Y2 on whole-vector macroblocks, stay in-block on SPLITMV
    o_y, p_y = _to_blocks(plane_tiles(orig[0], 16), 4), _to_blocks(pred[0], 4)
    co = ET.fdct(o_y, p_y)                                  # (R, C, 16, 16)
    y2q = ET.quantize(ET.fwht(co[..., 0]), y2_dc, y2_ac)    # (R, C, 16)
    y2q = torch.where(sm[..., None], 0, y2q)
    ac_only = co.clone()
    ac_only[..., 0] = 0
    co_y = torch.where(sm[..., None, None], ET.quantize(co, y_dc, y_ac),
                       ET.quantize(ac_only, y_dc, y_ac))
    yd = TR.dequantize(co_y, i32(y_dc), i32(y_ac))
    dc = TR.iwht(TR.dequantize(y2q, i32(y2_dc), i32(y2_ac))).reshape(
        y2q.shape)
    yd[..., 0] = torch.where(sm[..., None], yd[..., 0], dc)
    rec = [(p_y, yd)]
    coeffs = [co_y]

    # chroma
    for k in (1, 2):
        o_c, p_c = _to_blocks(plane_tiles(orig[k], 8), 2), _to_blocks(pred[k], 2)
        co_c = ET.quantize(ET.fdct(o_c, p_c), uv_dc, uv_ac)
        coeffs.append(co_c)
        rec.append((p_c, TR.dequantize(co_c, i32(uv_dc), i32(uv_ac))))

    out = torch.cat(coeffs + [y2q[:, :, None]], dim=2).to(torch.int16)
    out = torch.where(inter[..., None, None], out, 0).to(torch.int16)
    nonzero = (out != 0).flatten(2).any(dim=2)

    for plane, (p, d), S in zip(recon, rec, (16, 8, 8)):
        res = TR.idct(d).reshape(d.shape)
        tiles = _from_blocks(torch.clamp(p.to(torch.int32) + res, 0, 255)
                             .to(torch.uint8), S // 4)
        plane_tiles(plane, S)[inter] = tiles[inter]
    return out, nonzero


def _intra_given(st, r, c, q):
    """The intra macroblocks (r, c) ((N,) tensors, which may all be done
    at once: every neighbour they read is final in ``st``) with their
    given modes: writes their reconstruction into the tiles and their
    coefficients and flags into ``st``."""
    dev = r.device
    C = st["C"]
    N = r.shape[0]
    ar = torch.arange(N, device=dev)
    ru, cl, cr = (r - 1).clamp(min=0), (c - 1).clamp(min=0), \
        (c + 1).clamp(max=C - 1)
    hrow, hcol, lastc = r > 0, c > 0, c == C - 1
    ydc, yac = q[:2]
    oy = st["Oy"][r, c]
    ymode, uvmode = st["ymode"][r, c], st["uvmode"][r, c]
    bp = ymode == T.B_PRED

    # luma: the row above with its above-right pixels (the above row's last
    # pixel at the frame's right edge, 127 on the top row), the left column
    e0, above16, lcol = _edges(st["Ty"], r, c, ru, cl, hrow, hcol, 16)
    ar4 = torch.where((hrow & ~lastc)[:, None], st["Ty"][ru, cr, 15, 0:4],
                      torch.where(hrow[:, None], above16[:, 15:16]
                                  .expand(N, 4), 127))
    e21 = torch.cat([e0[:, None], above16, ar4], dim=1)
    wpred = intra.whole_block_predict(e21, lcol, hrow, hcol,
                                      torch.where(bp, 0, ymode), 16)
    wco, y2q, wrec = y2_residue(oy, wpred, q)

    # B_PRED: the 16 sub-blocks in raster order, each predicted with its
    # b-mode from what the ones before it reconstructed; the right-most
    # column takes its above-right from the row above the macroblock
    bm = st["bmode"][r, c].clamp(0, 9)
    btile = torch.zeros((N, 16, 16), dtype=torch.int32, device=dev)
    bco = torch.zeros((N, 16, 16), dtype=torch.int32, device=dev)
    for sr in range(4):
        for sc in range(4):
            y0, x0 = sr * 4, sc * 4
            above4 = (btile[:, y0 - 1, x0:x0 + 4] if sr
                      else e21[:, 1 + x0:5 + x0])
            left4 = btile[:, y0:y0 + 4, x0 - 1] if sc else lcol[:, y0:y0 + 4]
            if sr == 0:
                al, ra = e21[:, x0], e21[:, 5 + x0:9 + x0]
            else:
                al = btile[:, y0 - 1, x0 - 1] if sc else lcol[:, y0 - 1]
                ra = btile[:, y0 - 1, x0 + 4:x0 + 8] if sc < 3 \
                    else e21[:, 17:21]
            pred = intra.subblock_predict_all(above4, left4, al, ra)[
                ar, bm[:, sr, sc]].reshape(N, 16)
            qc = ET.quantize(ET.fdct(oy[:, y0:y0 + 4, x0:x0 + 4]
                                     .reshape(N, 16), pred), ydc, yac)
            bco[:, sr * 4 + sc] = qc
            btile[:, y0:y0 + 4, x0:x0 + 4] = torch.clamp(
                pred.reshape(N, 4, 4) + TR.idct(_dq(qc, ydc, yac)), 0, 255)

    # chroma, the prediction's chroma mode
    uv = []
    for k in "uv":
        ce0, a8, l8 = _edges(st["T" + k], r, c, ru, cl, hrow, hcol, 8)
        p = intra.whole_block_predict(torch.cat([ce0[:, None], a8], 1), l8,
                                      hrow, hcol, uvmode, 8)
        qc, st["T" + k][r, c] = chroma_residue(st["O" + k][r, c], p, q)
        uv.append(qc)

    b3 = bp[:, None, None]
    coeffs = torch.cat([torch.where(b3, bco, wco), uv[0], uv[1],
                        torch.where(bp[:, None], 0, y2q)[:, None]], dim=1)
    st["Ty"][r, c] = torch.where(b3, btile, wrec)
    st["co"][r, c] = coeffs.to(torch.int16)
    st["nz"][r, c] = (coeffs != 0).flatten(1).any(dim=1)
    st["y2"][r, c] = ~bp


def rebase_frame_plain(orig, refs, words, quant, recon, order=None):
    """Plain version of ops.rebase_cuda.rebase_frame (same contract, any
    device).

    orig: the original (y, u, v) planes, (16R, 16C), (8R, 8C), (8R, 8C)
    uint8, padded to whole macroblocks; refs: {"y", "u", "v"} -> the three
    reference slots (last, golden, alternate) of each plane, (H, W) uint8;
    words: (R, C, MB_WORDS) int32 (``mb_words``'s, as a tensor); quant: the six factors
    (y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac); recon: the (y, u, v) planes
    of the unfiltered reconstruction, written whole in place.  Returns the
    (R, C, OUT_WORDS) int16 output words (``split_out``).

    The intra macroblocks go in ``order`` (default the anti-diagonals
    d = 2r + c; any list of (rows, cols) in which every intra macroblock
    comes after the intra macroblocks whose pixels it reads, such as
    ops.wavefront.row_order's under the kernel's lags)."""
    R, C = words.shape[:2]
    ref_sel = words[..., W_REF]
    ymode = words[..., W_YMODE]
    pred = mc_planes_plain(refs, ref_sel[None],
                           _vectors(words[..., W_MV:W_MV + 16], 4)[None],
                           _vectors(words[..., W_UVMV:W_UVMV + 4], 2)[None])
    inter = ref_sel != T.CURRENT_FRAME
    split = ymode == T.SPLITMV
    co, nz = inter_residues_plain(orig, [p[0] for p in pred], ref_sel,
                                  split, quant, recon)
    st = {"C": C, "co": co, "nz": nz, "y2": inter & ~split,
          "ymode": ymode.to(torch.int64),
          "uvmode": words[..., W_UVMODE].to(torch.int64),
          "bmode": torch.stack([(words[..., W_BMODE:W_BMODE + 4] >> s) & 255
                                for s in (0, 8, 16, 24)], -1).to(torch.int64),
          "Oy": tile(orig[0][None], 16)[0], "Ou": tile(orig[1][None], 8)[0],
          "Ov": tile(orig[2][None], 8)[0], "Ty": tile(recon[0][None], 16)[0],
          "Tu": tile(recon[1][None], 8)[0], "Tv": tile(recon[2][None], 8)[0]}
    q = tuple(int(x) for x in quant)
    if not bool(inter.all()):
        dev = words.device
        for rs, cs in diagonals(R, C, 2) if order is None else order:
            r, c = torch.tensor(rs, device=dev), torch.tensor(cs, device=dev)
            keep = ~inter[r, c]
            if bool(keep.any()):
                _intra_given(st, r[keep], c[keep], q)
        for plane, k in zip(recon, "yuv"):
            plane.copy_(untile(st["T" + k][None])[0])
    flags = st["nz"].to(torch.int16) * NONZERO \
        + st["y2"].to(torch.int16) * Y2_CODED
    return torch.cat([st["co"].reshape(R, C, 400), flags[..., None]], 2)
