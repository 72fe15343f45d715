"""Forward transforms and quantization of the encoder (PyTorch), the plain
versions of H1: the device helpers of csrc/enc_transforms.cuh compute the
same functions inside the encode kernels.

Replaces, with ops/transforms.py (dequantize, iWHT, iDCT), the TPU helpers
alfalfa_tpu/ops/enc_transforms_pallas.py (fdct, fwht, quantize; traced
inside the keyframe-encode kernel).  Blocks are (..., 16) int tensors in
raster order.  Bit-exact to the reference (dct.cc:45-163,
quantization.cc:149-157): intermediates the reference stores as int16 are
wrapped to int16 here too, ``>>`` on negatives is arithmetic, and
quantization truncates toward zero.
"""
import torch

from alfalfa_tpu_torch.ops.transforms import _wrap16


def fdct(orig, pred):
    """Subtract and forward 4x4 DCT: (orig - pred) -> (..., 16) int32
    coefficients (vp8_short_fdct4x4 semantics, int16 range)."""
    x = (orig.to(torch.int32) - pred.to(torch.int32))
    x = x.reshape(x.shape[:-1] + (4, 4))
    # pass 1 over rows
    a1 = (x[..., 0] + x[..., 3]) * 8
    b1 = (x[..., 1] + x[..., 2]) * 8
    c1 = (x[..., 1] - x[..., 2]) * 8
    d1 = (x[..., 0] - x[..., 3]) * 8
    rows = _wrap16(torch.stack([a1 + b1,
                                (c1 * 2217 + d1 * 5352 + 14500) >> 12,
                                a1 - b1,
                                (d1 * 2217 - c1 * 5352 + 7500) >> 12], dim=-1))
    # pass 2 over columns
    a1 = rows[..., 0, :] + rows[..., 3, :]
    b1 = rows[..., 1, :] + rows[..., 2, :]
    c1 = rows[..., 1, :] - rows[..., 2, :]
    d1 = rows[..., 0, :] - rows[..., 3, :]
    out = torch.stack([(a1 + b1 + 7) >> 4,
                       ((c1 * 2217 + d1 * 5352 + 12000) >> 16)
                       + (d1 != 0).to(torch.int32),
                       (a1 - b1 + 7) >> 4,
                       (d1 * 2217 - c1 * 5352 + 51000) >> 16], dim=-2)
    return _wrap16(out).reshape(out.shape[:-2] + (16,))


def fwht(dc):
    """Forward Walsh-Hadamard over (..., 16) DC terms in raster order
    (the 16 luma blocks' DCs of a macroblock) -> (..., 16) int32 Y2."""
    x = dc.to(torch.int32).reshape(dc.shape[:-1] + (4, 4))
    a1 = (x[..., 0] + x[..., 2]) * 4
    d1 = (x[..., 1] + x[..., 3]) * 4
    c1 = (x[..., 1] - x[..., 3]) * 4
    b1 = (x[..., 0] - x[..., 2]) * 4
    rows = _wrap16(torch.stack([a1 + d1 + (a1 != 0).to(torch.int32),
                                b1 + c1, b1 - c1, a1 - d1], dim=-1))
    a1 = rows[..., 0, :] + rows[..., 2, :]
    d1 = rows[..., 1, :] + rows[..., 3, :]
    c1 = rows[..., 1, :] - rows[..., 3, :]
    b1 = rows[..., 0, :] - rows[..., 2, :]
    outs = []
    for v in (a1 + d1, b1 + c1, b1 - c1, a1 - d1):
        v = v + (v < 0).to(torch.int32)
        outs.append((v + 3) >> 3)
    out = _wrap16(torch.stack(outs, dim=-2))
    return out.reshape(out.shape[:-2] + (16,))


def quantize(coeffs, dc_factor, ac_factor):
    """Truncating division of (..., 16) coefficients by the DC factor at
    position 0 and the AC factor elsewhere (ints or tensors broadcastable
    to the leading shape).  Returns (..., 16) int32."""
    c = coeffs.to(torch.int32)
    dev = c.device
    f = torch.stack(torch.broadcast_tensors(
        torch.as_tensor(dc_factor, dtype=torch.int32, device=dev),
        torch.as_tensor(ac_factor, dtype=torch.int32, device=dev)), dim=-1)
    f = f[..., [0] + [1] * 15]
    q = torch.div(c.abs(), f, rounding_mode="floor")
    return torch.where(c < 0, -q, q)
