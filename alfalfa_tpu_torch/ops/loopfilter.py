"""Batched VP8 normal loop filter (PyTorch), window formulation.

Each macroblock is filtered on a local window [4 halo + size] wide/high:
Y: (20, 20), chroma: (12, 12).  The four passes (left MB edge, vertical
subblock edges, top MB edge, horizontal subblock edges) run in the
reference decoder's order; the arithmetic mirrors its signed-char
kernels: pixels are biased by -128 and every step saturates to int8.

All functions take int32 tensors in [0, 255] with any leading batch
dimensions, and per-MB parameters that broadcast against them.
"""
import torch


def _c8(x):
    return torch.clamp(x, -128, 127)


def _common_filter(p1, p0, q0, q1, mask, hev):
    zero = torch.zeros_like(p0)
    fv = torch.where(hev, _c8(p1 - q1), zero)
    fv = torch.where(mask, _c8(fv + 3 * (q0 - p0)), zero)
    f1 = _c8(fv + 4) >> 3
    f2 = _c8(fv + 3) >> 3
    q0n = _c8(q0 - f1)
    p0n = _c8(p0 + f2)
    outer = torch.where(hev, zero, (f1 + 1) >> 1)
    return _c8(p1 + outer), p0n, q0n, _c8(q1 - outer)


def _mb_filter(p2, p1, p0, q0, q1, q2, mask, hev):
    zero = torch.zeros_like(p0)
    fv = torch.where(mask, _c8(_c8(p1 - q1) + 3 * (q0 - p0)), zero)
    f = torch.where(hev, fv, zero)
    f1 = _c8(f + 4) >> 3
    f2 = _c8(f + 3) >> 3
    q0 = _c8(q0 - f1)
    p0 = _c8(p0 + f2)
    w = torch.where(hev, zero, fv)
    u = _c8((63 + w * 27) >> 7)
    q0, p0 = _c8(q0 - u), _c8(p0 + u)
    u = _c8((63 + w * 18) >> 7)
    q1, p1 = _c8(q1 - u), _c8(p1 + u)
    u = _c8((63 + w * 9) >> 7)
    q2, p2 = _c8(q2 - u), _c8(p2 + u)
    return p2, p1, p0, q0, q1, q2


def _mask_hev(limit, blimit, thresh, p3, p2, p1, p0, q0, q1, q2, q3):
    ab = torch.abs
    m = ((ab(p3 - p2) > limit) | (ab(p2 - p1) > limit)
         | (ab(p1 - p0) > limit) | (ab(q1 - q0) > limit)
         | (ab(q2 - q1) > limit) | (ab(q3 - q2) > limit)
         | (ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) > blimit))
    hev = (ab(p1 - p0) > thresh) | (ab(q1 - q0) > thresh)
    return ~m, hev


def _filter_groups(groups, limit, blimit, thresh, mb_edge):
    """groups: p3..p0, q0..q3 raw [0, 255]; returns the 8 updated groups."""
    mask, hev = _mask_hev(limit, blimit, thresh, *groups)
    s = [g - 128 for g in groups]
    if mb_edge:
        p2, p1, p0, q0, q1, q2 = _mb_filter(s[1], s[2], s[3], s[4], s[5],
                                            s[6], mask, hev)
        new = [s[0], p2, p1, p0, q0, q1, q2, s[7]]
    else:
        p1, p0, q0, q1 = _common_filter(s[2], s[3], s[4], s[5], mask, hev)
        new = [s[0], s[1], p1, p0, q0, q1, s[6], s[7]]
    return [v + 128 for v in new]


def filter_v_edge(window, x, limit, blimit, thresh, mb_edge):
    """Filter the vertical edge at column ``x`` (static) of a (..., S, S)
    window, touching only the MB's own rows (the 4 halo rows are read-only
    context).  Params broadcast over (..., S-4).  Returns a new window."""
    cols = [window[..., 4:, x - 4 + i] for i in range(8)]  # p3..p0 q0..q3
    new = _filter_groups(cols, limit, blimit, thresh, mb_edge)
    window = window.clone()
    window[..., 4:, x - 4:x + 4] = torch.stack(new, dim=-1)
    return window


def filter_h_edge(window, y, limit, blimit, thresh, mb_edge):
    rows = [window[..., y - 4 + i, 4:] for i in range(8)]
    new = _filter_groups(rows, limit, blimit, thresh, mb_edge)
    window = window.clone()
    window[..., y - 4:y + 4, 4:] = torch.stack(new, dim=-2)
    return window


def filter_mb_window(window, size, limit, blimit_mb, blimit_sb, thresh,
                     do_left, do_top, do_sb):
    """All four filter passes on MB windows of shape (..., size+4, size+4)
    (4-pixel halo above and left).  Per-MB parameters have shape (..., 1)
    (limit/blimits/thresh, int32) and (..., 1, 1) (do_left/do_top/do_sb,
    bool).  Returns the filtered windows."""
    halo = 4

    w = filter_v_edge(window, halo, limit, blimit_mb, thresh, True)
    window = torch.where(do_left, w, window)

    w = window
    for off in range(4, size, 4):
        w = filter_v_edge(w, halo + off, limit, blimit_sb, thresh, False)
    window = torch.where(do_sb, w, window)

    w = filter_h_edge(window, halo, limit, blimit_mb, thresh, True)
    window = torch.where(do_top, w, window)

    w = window
    for off in range(4, size, 4):
        w = filter_h_edge(w, halo + off, limit, blimit_sb, thresh, False)
    window = torch.where(do_sb, w, window)

    return window
