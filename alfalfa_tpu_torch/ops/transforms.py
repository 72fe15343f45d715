"""Batched integer transforms (PyTorch): dequantize, iWHT, iDCT.

Bit-exact equivalents of the VP8 reference transforms, operating on whole
frames of coefficients at once: shapes (..., 16) in raster (de-zigzagged)
order.  Intermediates that the reference stores as int16 are wrapped to
int16 here too (``.to(int16).to(int32)``), so results match to the bit.
All arithmetic is int32: the products below stay under 2^31 only because
their operands were wrapped to int16 first.
"""
import torch


def _wrap16(x):
    return x.to(torch.int16).to(torch.int32)


def dequantize(coeffs, dc_factor, ac_factor):
    """coeffs (..., 16) int, factors broadcastable to (...,).

    Returns (..., 16) int32 (wrapped to int16 range like the reference's
    int16 storage)."""
    c = coeffs.to(torch.int32)
    dc = c[..., :1] * dc_factor.to(torch.int32)[..., None]
    ac = c[..., 1:] * ac_factor.to(torch.int32)[..., None]
    return _wrap16(torch.cat([dc, ac], dim=-1))


def iwht(y2):
    """Inverse Walsh-Hadamard on (..., 16) -> (..., 4, 4) DC terms."""
    c = y2.reshape(y2.shape[:-1] + (4, 4)).to(torch.int32)
    a1 = c[..., 0, :] + c[..., 3, :]
    b1 = c[..., 1, :] + c[..., 2, :]
    c1 = c[..., 1, :] - c[..., 2, :]
    d1 = c[..., 0, :] - c[..., 3, :]
    inter = _wrap16(torch.stack([a1 + b1, c1 + d1, a1 - b1, d1 - c1], dim=-2))
    a1 = inter[..., :, 0] + inter[..., :, 3]
    b1 = inter[..., :, 1] + inter[..., :, 2]
    c1 = inter[..., :, 1] - inter[..., :, 2]
    d1 = inter[..., :, 0] - inter[..., :, 3]
    out = torch.stack([(a1 + b1 + 3) >> 3,
                       (c1 + d1 + 3) >> 3,
                       (a1 - b1 + 3) >> 3,
                       (d1 - c1 + 3) >> 3], dim=-1)
    # reference stores DCs via int16 coefficients
    return _wrap16(out)


def _mul_20091(a):
    return ((a * 20091) >> 16) + a


def _mul_35468(a):
    return (a * 35468) >> 16


def idct(coeffs):
    """Batched 4x4 inverse DCT: (..., 16) -> (..., 4, 4) int32 residuals
    (the values added to prediction before clamping)."""
    c = coeffs.reshape(coeffs.shape[:-1] + (4, 4)).to(torch.int32)
    t0 = c[..., 0, :] + c[..., 2, :]
    t1 = c[..., 0, :] - c[..., 2, :]
    t2 = _mul_35468(c[..., 1, :]) - _mul_20091(c[..., 3, :])
    t3 = _mul_20091(c[..., 1, :]) + _mul_35468(c[..., 3, :])
    # intermediate[i][j]: i = input column index, stored int16
    inter = _wrap16(torch.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], dim=-1))
    t0 = inter[..., 0, :] + inter[..., 2, :]
    t1 = inter[..., 0, :] - inter[..., 2, :]
    t2 = _mul_35468(inter[..., 1, :]) - _mul_20091(inter[..., 3, :])
    t3 = _mul_20091(inter[..., 1, :]) + _mul_35468(inter[..., 3, :])
    # rows[..., i, j]: output row index i comes from intermediate column i
    return torch.stack([(t0 + t3 + 4) >> 3,
                        (t1 + t2 + 4) >> 3,
                        (t1 - t2 + 4) >> 3,
                        (t0 - t3 + 4) >> 3], dim=-1)


def residuals_from_coeffs(coeffs, qfactors, y2_coded):
    """Full residual computation for a frame (or a batch of frames).

    coeffs: (..., r, c, 25, 16) int; qfactors: dict of (..., r, c) int
    tensors (y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac); y2_coded: (..., r, c)
    bool.

    Returns (..., r, c, 24, 4, 4) int32 residuals for the 16 Y + 4 U + 4 V
    blocks, with Y2 DC substitution already applied where coded."""
    y = dequantize(coeffs[..., 0:16, :], qfactors["y_dc"][..., None],
                   qfactors["y_ac"][..., None])
    uv = dequantize(coeffs[..., 16:24, :], qfactors["uv_dc"][..., None],
                    qfactors["uv_ac"][..., None])
    y2 = dequantize(coeffs[..., 24, :], qfactors["y2_dc"], qfactors["y2_ac"])
    dc = iwht(y2)
    dc_flat = dc.reshape(dc.shape[:-2] + (16,))
    y_dc = torch.where(y2_coded[..., None], dc_flat, y[..., 0])
    y = torch.cat([y_dc[..., None], y[..., 1:]], dim=-1)
    return idct(torch.cat([y, uv], dim=-2))
