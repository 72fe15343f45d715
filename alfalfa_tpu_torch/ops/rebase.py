"""The rebase's inter residue update (PyTorch): the plain version of the
CUDA kernel csrc/rebase_residues.cu (wrapper ops/rebase_cuda.py).

The rebase keeps a prediction frame's modes and vectors and recomputes
only the residues against the encoder's own references
(reference reencode.cc:162-210).  Its inter macroblocks have no search and
no dependencies on each other, so all of them are updated at once: the
original minus the six-tap prediction (K3's output), forward DCT,
quantization (a whole-vector macroblock's 16 luma DCs through the WHT into
Y2; SPLITMV keeps them in-block and codes no Y2), and the reconstruction a
decoder makes of the result.  This is the function of the JAX package's
encoder/reencode_device.py:_fn_core, which computes it with H1's helpers
under XLA around K3 (it reaches no pallas_call of its own).

Coefficients come out in _tiles_to_blocks order: 16 luma blocks, 4 U, 4
V, then Y2, each 16 values in raster order.  Intra macroblocks (ref_sel
0) are left for the host's raster-order loop: their coefficients and flag
are zero and their reconstruction is not written.
"""
import torch

from alfalfa_tpu_torch.ops import enc_transforms as ET
from alfalfa_tpu_torch.ops import transforms as TR
from alfalfa_tpu_torch.ops.enc_intra import _from_blocks, _to_blocks


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
    macroblocks.  Returns the coefficients (R, C, 25, 16) int16 and the
    nonzero flags (R, C) bool."""
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
