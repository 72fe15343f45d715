"""Structural similarity, x264-window formulation (integer 4x4 block sums,
8x8 overlapping windows on a 4-pixel grid), in PyTorch on the images'
device.

Same algorithm as the quality metric the codec uses for loop-filter search
and SSIM-target rate control (reference util/ssim.cc wraps libx264's).
The block and window sums are exact in int64, and each window's ratio is
computed in float64 in the reference's operation order.  The ratios are
then summed on the host one after another in raster order, as the C loop
does: a pairwise or parallel sum rounds differently in the last bits, and
the loop-filter climb and the SSIM-target search compare these values.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.util import tracing

C1 = 416      # .01^2 * 255^2 * 64
C2 = 235963   # .03^2 * 255^2 * 64 * 63


def ssim(img1, img2):
    """SSIM over the overlap of 8x8 windows.

    img1, img2: (..., H, W) uint8 tensors on one device (leading dimensions
    broadcast: a batch of candidates against one original).  Returns a
    float64 numpy array of the leading shape."""
    h, w = img1.shape[-2:]
    bh, bw = h // 4, w // 4
    lead = torch.broadcast_shapes(img1.shape[:-2], img2.shape[:-2])
    if bh < 2 or bw < 2:
        return np.ones(lead, np.float64)

    def blocks(x):
        x = x[..., :bh * 4, :bw * 4].to(torch.int64)
        return x.reshape(x.shape[:-2] + (bh, 4, bw, 4))

    a, b = blocks(img1), blocks(img2)
    s1 = a.sum(dim=(-3, -1))
    s2 = b.sum(dim=(-3, -1))
    ss = (a * a).sum(dim=(-3, -1)) + (b * b).sum(dim=(-3, -1))
    s12 = (a * b).sum(dim=(-3, -1))

    def win(x):
        return (x[..., :-1, :-1] + x[..., :-1, 1:] + x[..., 1:, :-1]
                + x[..., 1:, 1:])

    t1, t2, tss, t12 = win(s1), win(s2), win(ss), win(s12)
    vars_ = tss * 64 - t1 * t1 - t2 * t2
    covar = t12 * 64 - t1 * t2
    f = lambda x: x.to(torch.float64)
    vals = ((2.0 * f(t1) * f(t2) + C1) * (2.0 * f(covar) + C2)
            / (f(t1 * t1 + t2 * t2 + C1) * f(vars_ + C2)))
    host = vals.expand(lead + vals.shape[-2:]).flatten(-2).cpu().numpy()
    tracing.count("d2h.ssim", host.nbytes)
    with tracing.stage("ssim.serial_mean"):
        return serial_mean(host)


def serial_mean(vals):
    """Mean over the last axis of float64 ``vals``, summed left to right
    (``cumsum`` accumulates serially; ``sum`` and ``mean`` go pairwise)."""
    return np.cumsum(vals, axis=-1)[..., -1] / float(vals.shape[-1])
