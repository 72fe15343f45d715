"""Dense batched encoder math (PyTorch): forward DCT/WHT, quantization,
variance and source-based intra screening over whole frames of
macroblocks at once.

These are the data-parallel halves of the fast interframe encode
(encoder/encode_inter_fast.py) once K9 (ops/enc_decide_cuda.py) has fixed
the per-macroblock decisions: prediction, residual transforms,
quantization and reconstruction have no dependency between macroblocks.
Port of alfalfa_tpu/ops/enc_batch.py (XLA there, plain torch here).  The
transforms and quantization are H1's plain versions (ops/enc_transforms.py)
and the chroma vector is K8's (ops/enc_inter.py), each bit-exact to the
reference (dct.cc:45-163, quantization.cc:149-157) with the int16 wraps of
its intermediates; they are named here only for the blocked (..., 4, 4)
layout of the dense path.
"""
import torch

from alfalfa_tpu_torch.ops import enc_transforms as ET
from alfalfa_tpu_torch.ops import intra
from alfalfa_tpu_torch.ops.enc_inter import chroma_mv  # noqa: F401

# (..., 16) coefficients -> (..., 16) Y2; (..., 16) coefficients at DC and
# AC factors -> (..., 16) truncated quotients (factors broadcast to (...,))
fwht_blocks = ET.fwht
quantize_blocks = ET.quantize


def fdct_blocks(diff):
    """Forward 4x4 DCT of residual blocks: (..., 4, 4) int -> (..., 16)
    int32, int16-wrapped."""
    return ET.fdct(diff.flatten(-2), torch.zeros((), dtype=torch.int32,
                                                 device=diff.device))


def variance_blocks(diff):
    """sse - s*s // 256 over the last axis (256 values of a 16x16 tile),
    int32.  s*s overflows int32 for large sums, so s*s // 256 is taken as
    256*hi*hi + 2*hi*lo + lo*lo // 256 with |s| = 256*hi + lo, exactly."""
    d = diff.to(torch.int32)
    sse = (d * d).sum(dim=-1, dtype=torch.int32)
    sa = d.sum(dim=-1, dtype=torch.int32).abs()
    hi, lo = sa >> 8, sa & 255
    return sse - (hi * hi * 256 + 2 * hi * lo + (lo * lo) // 256)


def intra_screen_source(oy_t, mbc, rmult, dmult):
    """Best whole-macroblock intra rd cost of each macroblock, DC/V/H/TM
    predicted from the SOURCE neighbours' pixels (the fast path's stand-in
    for the reconstruction-based screening of the serial encoder), with the
    127 (above) / 129 (left) frame-edge defaults and the TM corner 127 on
    the top row, 129 on the left column below it.

    oy_t: (R, C, 16, 16) int source luma tiles; mbc: the macroblock mode
    costs (at least 4, DC V H TM first); rmult / dmult: int RD
    multipliers.  Returns (R*C,) int32, in int32 arithmetic as the JAX
    package computes it."""
    R, C = oy_t.shape[:2]
    dev = oy_t.device
    o = oy_t.to(torch.int32).reshape(R * C, 16, 16)
    r = torch.arange(R, device=dev).repeat_interleave(C)
    c = torch.arange(C, device=dev).repeat(R)
    hrow, hcol = r > 0, c > 0
    ru, cl = (r - 1).clamp(min=0), (c - 1).clamp(min=0)
    tiles = oy_t.to(torch.int32)
    above = torch.where(hrow[:, None], tiles[ru, c, 15, :], 127)
    left = torch.where(hcol[:, None], tiles[r, cl, :, 15], 129)
    corner = torch.where(hrow & hcol, tiles[ru, cl, 15, 15],
                         torch.where(hrow, 129, 127).to(torch.int32))
    preds = intra.whole_predict_all(torch.cat([corner[:, None], above], 1),
                                    left, hrow, hcol, 16)
    var = variance_blocks((o[:, None] - preds).reshape(R * C, 4, 256))
    rate = ((128 + mbc[:4].to(torch.int32) * int(rmult)) >> 8)
    return (rate[None, :] + var * int(dmult)).min(dim=1).values
