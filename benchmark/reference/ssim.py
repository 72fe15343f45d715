"""Structural similarity as the configuration's loop-filter search scores
a candidate: libx264's formulation, which the reference codec wraps
(integer sums over 4x4 blocks, 8x8 windows on a 4-pixel grid, each
window's ratio in float64, the ratios summed one after another in raster
order).  Plain numpy; it imports nothing of the program."""
import numpy as np

C1 = 416      # .01^2 * 255^2 * 64
C2 = 235963   # .03^2 * 255^2 * 64 * 63


def ssim(img1, img2):
    """SSIM of two (H, W) uint8 planes over the overlap of their 8x8
    windows."""
    h, w = img1.shape
    bh, bw = h // 4, w // 4
    if bh < 2 or bw < 2:
        return 1.0

    def blocks(x):
        return x[:bh * 4, :bw * 4].astype(np.int64).reshape(bh, 4, bw, 4)

    a, b = blocks(img1), blocks(img2)
    s1, s2 = a.sum(axis=(1, 3)), b.sum(axis=(1, 3))
    ss = (a * a).sum(axis=(1, 3)) + (b * b).sum(axis=(1, 3))
    s12 = (a * b).sum(axis=(1, 3))

    def win(x):
        return x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1] + x[1:, 1:]

    t1, t2, tss, t12 = win(s1), win(s2), win(ss), win(s12)
    var = tss * 64 - t1 * t1 - t2 * t2
    covar = t12 * 64 - t1 * t2
    f = lambda x: x.astype(np.float64)
    vals = ((2.0 * f(t1) * f(t2) + C1) * (2.0 * f(covar) + C2)
            / (f(t1 * t1 + t2 * t2 + C1) * f(var + C2)))
    # summed left to right (``cumsum`` accumulates serially)
    return float(np.cumsum(vals.ravel())[-1] / vals.size)
