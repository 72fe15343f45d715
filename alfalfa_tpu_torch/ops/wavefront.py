"""Plain PyTorch versions of the decode wavefront kernels: intra
prediction (ops/intra_cuda.py), the loop filter (ops/lf_cuda.py) and the
two in turn (ops/wavefront_cuda.py), over macroblock anti-diagonals
d = 2*row + col, vectorised over the G frames and the macroblocks of a
diagonal, as a Python loop over diagonals.

Storage is plain (G, R, C, S, S) tiles indexed by a per-diagonal (r, c)
list.  Intra prediction of (r, c) reads unfiltered neighbours, so the
whole frame is predicted before any of it is filtered; the filter of
(r, c) finds (r, c-1), (r-1, c) and (r-1, c+1) already filtered because
they lie on earlier diagonals.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.ops import intra, loopfilter

B_PRED = 4


def diagonals(R, C, k=2):
    """[(rows, cols)] of the macroblocks on each diagonal d = k*r + c: k = 2
    for a macroblock that reads its above-right neighbour, k = 1 for one
    that reads left, above and above-left only."""
    out = []
    for d in range(k * (R - 1) + C):
        r_lo = max(0, -((-(d - C + 1)) // k))
        rs = list(range(r_lo, min(R - 1, d // k) + 1))
        out.append((rs, [d - k * r for r in rs]))
    return out


def row_order(R, C, lag, seed):
    """[([r], [c])]: an order of the R x C macroblocks, one at a time, that
    row walkers under the progress-flag rule of csrc/row_sched.cuh could
    produce: each row in column order, macroblock (r, c) only after row
    r - 1 has done min(c + lag, C) (``lag`` an int, or an (R, C) array of
    each macroblock's own), the rows interleaved at random (numpy
    generator ``seed``).  In the same form as ``diagonals``."""
    rng = np.random.default_rng(seed)
    lags = np.broadcast_to(np.asarray(lag), (R, C))
    done = [0] * R
    out = []
    while len(out) < R * C:
        ready = [r for r in range(R) if done[r] < C and
                 (r == 0 or done[r - 1] >= min(done[r] + int(lags[r, done[r]]),
                                               C))]
        r = ready[int(rng.integers(len(ready)))]
        out.append(([r], [done[r]]))
        done[r] += 1
    return out


def _intra_diag(Ty, Tu, Tv, rs, cs, res_y, res_u, res_v, ymode, uvmode,
                bmode, has_nonzero, intra_mask, R, C):
    dev = Ty.device
    G = Ty.shape[0]
    n = len(rs)
    r = torch.tensor(rs, device=dev)
    c = torch.tensor(cs, device=dev)
    write = intra_mask[:, r, c]                              # (G, n)
    if not bool(write.any()):
        return
    ru, cl, cr = (r - 1).clamp(min=0), (c - 1).clamp(min=0), \
        (c + 1).clamp(max=C - 1)
    N = G * n
    flat = lambda x: x.reshape((N,) + x.shape[2:])
    exp = lambda m: m[None, :].expand(G, n).reshape(N)
    hrow, hcol, lastc = exp(r > 0), exp(c > 0), exp(c == C - 1)
    c127 = lambda x: torch.full_like(x, 127)
    c129 = lambda x: torch.full_like(x, 129)
    nz = flat(has_nonzero[:, r, c])
    zero_res = lambda x: torch.where(nz[:, None, None], x, torch.zeros_like(x))

    def edges(T, S):
        """(e0, above, left column) with the 127/129 rules applied."""
        above = flat(T[:, ru, c, S - 1, :])
        above = torch.where(hrow[:, None], above, c127(above))
        corner = flat(T[:, ru, cl, S - 1, S - 1])
        e0 = torch.where(hrow & hcol, corner,
                         torch.where(hrow, c129(corner), c127(corner)))
        left = flat(T[:, r, cl][..., S - 1])
        left = torch.where(hcol[:, None], left, c129(left))
        return e0, above, left

    e0, above16, lcol = edges(Ty, 16)
    ar = flat(Ty[:, ru, cr, 15, 0:4])
    ar4 = torch.where((hrow & ~lastc)[:, None], ar,
                      torch.where((hrow & lastc)[:, None],
                                  above16[:, 15:16].expand(N, 4), c127(ar)))
    e21 = torch.cat([e0[:, None], above16, ar4], dim=1)
    my_ymode = flat(ymode[:, r, c])
    res16 = flat(res_y[:, r, c]).to(torch.int32)

    whole = intra.whole_block_predict(e21, lcol, hrow, hcol, my_ymode, 16)
    new_y = torch.clamp(whole + zero_res(res16), 0, 255)
    is_b = (my_ymode == B_PRED) & flat(write)
    if bool(is_b.any()):
        # sub-block layout of the residual: (16 blocks, 4, 4)
        k = torch.nonzero(is_b)[:, 0]
        resb = res16[k].reshape(-1, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
            .reshape(-1, 16, 4, 4)
        bt = intra.bpred_tile(e21[k], lcol[k],
                              flat(bmode[:, r, c])[k].reshape(-1, 4, 4)
                              .to(torch.int32), resb, nz[k])
        new_y[k] = bt
    wm = write[:, :, None, None]
    Ty[:, r, c] = torch.where(wm, new_y.reshape(G, n, 16, 16), Ty[:, r, c])

    my_uvmode = flat(uvmode[:, r, c])
    for T, res in ((Tu, res_u), (Tv, res_v)):
        ce0, a8, cl8 = edges(T, 8)
        ce = torch.cat([ce0[:, None], a8], dim=1)
        p = intra.whole_block_predict(ce, cl8, hrow, hcol, my_uvmode, 8)
        new = torch.clamp(p + zero_res(flat(res[:, r, c]).to(torch.int32)),
                          0, 255)
        T[:, r, c] = torch.where(wm, new.reshape(G, n, 8, 8), T[:, r, c])


def _lf_diag(planes, rs, cs, lf_params):
    level, interior, mb_limit, sb_limit, hev, skip_sb = lf_params
    dev = level.device
    G = level.shape[0]
    n = len(rs)
    r = torch.tensor(rs, device=dev)
    c = torch.tensor(cs, device=dev)
    apply = level[:, r, c] > 0                               # (G, n)
    if not bool(apply.any()):
        return
    ru, cl = (r - 1).clamp(min=0), (c - 1).clamp(min=0)
    N = G * n
    par = lambda x: x[:, r, c].reshape(N, 1).to(torch.int32)
    flag = lambda m: m.reshape(N, 1, 1)
    do_left = flag(apply & (c > 0)[None, :])
    do_top = flag(apply & (r > 0)[None, :])
    do_sb = flag(apply & ~skip_sb[:, r, c])
    am = apply[:, :, None, None]
    for T, S in planes:
        cur, left = T[:, r, c], T[:, r, cl]
        top, tl = T[:, ru, c], T[:, ru, cl]
        win = torch.cat([
            torch.cat([tl[..., S - 4:, S - 4:], top[..., S - 4:, :]], dim=-1),
            torch.cat([left[..., :, S - 4:], cur], dim=-1)], dim=-2)
        fwin = loopfilter.filter_mb_window(
            win.reshape(N, S + 4, S + 4), S, par(interior), par(mb_limit),
            par(sb_limit), par(hev), do_left, do_top, do_sb) \
            .reshape(G, n, S + 4, S + 4)
        # neighbours first: in column 0 / row 0 the clamped neighbour index
        # is the macroblock itself, and its own write must come last
        T[:, r, cl, :, S - 3:] = torch.where(
            do_left.reshape(G, n, 1, 1), fwin[..., 4:, 1:4],
            left[..., :, S - 3:])
        T[:, ru, c, S - 3:, :] = torch.where(
            do_top.reshape(G, n, 1, 1), fwin[..., 1:4, 4:],
            top[..., S - 3:, :])
        T[:, r, c] = torch.where(am, fwin[..., 4:, 4:], cur)


def untile(T):
    """(G, R, C, S, S) tiles -> (G, R*S, C*S) uint8 planes."""
    G, R, C, S, _ = T.shape
    return T.permute(0, 1, 3, 2, 4).reshape(G, R * S, C * S).to(torch.uint8)


def tile(P, S):
    """(G, R*S, C*S) planes -> (G, R, C, S, S) int32 tiles (fresh)."""
    G, H, W = P.shape
    return P.reshape(G, H // S, S, W // S, S).permute(0, 1, 3, 2, 4) \
        .to(torch.int32, copy=True)


def intra_frame_plain(y, u, v, res_y, res_u, res_v, ymode, uvmode, bmode,
                      has_nonzero, intra_mask, order=None):
    """Plain version of ops.intra_cuda.intra_frame: the intra phase alone.
    Arguments as wavefront_decode_plain's without lf_params, the
    macroblocks in ``order`` (default the anti-diagonals d = 2r + c; any
    list of (rows, cols) in which every macroblock comes after those whose
    pixels it reads, such as row_order's); returns the reconstructed,
    unfiltered (G, 16R, 16C), (G, 8R, 8C), (G, 8R, 8C) uint8 planes."""
    G, R, C = ymode.shape
    Ty, Tu, Tv = (t.to(torch.int32) for t in (y, u, v))     # fresh copies
    for rs, cs in diagonals(R, C) if order is None else order:
        _intra_diag(Ty, Tu, Tv, rs, cs, res_y, res_u, res_v, ymode, uvmode,
                    bmode, has_nonzero, intra_mask, R, C)
    return untile(Ty), untile(Tu), untile(Tv)


def loop_filter_plain(y, u, v, lf_params, order=None):
    """Plain version of ops.lf_cuda.loop_filter: the loop filter of whole
    (G, 16R, 16C), (G, 8R, 8C), (G, 8R, 8C) uint8 planes with the six
    (G, R, C) limit tensors (level 0 = macroblock not filtered), the
    macroblocks in ``order`` (default the anti-diagonals d = 2r + c; any
    list of (rows, cols) in which every macroblock comes after those whose
    pixels it reads or writes, such as row_order's).  Returns new planes;
    the inputs are not written."""
    G, R, C = lf_params[0].shape
    # U and V filter alike: one batch of 2G chroma planes
    Ty, Tuv = tile(y, 16), tile(torch.cat([u, v]), 8)
    lf_uv = tuple(torch.cat([x, x]) for x in lf_params)
    for rs, cs in diagonals(R, C) if order is None else order:
        _lf_diag(((Ty, 16),), rs, cs, lf_params)
        _lf_diag(((Tuv, 8),), rs, cs, lf_uv)
    U, V = untile(Tuv).chunk(2)
    return untile(Ty), U, V


def wavefront_decode_plain(y, u, v, res_y, res_u, res_v, ymode, uvmode,
                           bmode, has_nonzero, intra_mask, lf_params,
                           order=None):
    """Plain version of ops.wavefront_cuda.wavefront_decode (same
    contract, any device).  By default intra_frame_plain, then
    loop_filter_plain.  With ``order`` (a list of (rows, cols) in which
    every macroblock comes after those whose pixels it reads or writes,
    such as row_order's), the kernel's two planes: each macroblock in
    turn is predicted from the unfiltered tiles, copied into the filtered
    ones and filtered there."""
    if order is None:
        return loop_filter_plain(
            *intra_frame_plain(y, u, v, res_y, res_u, res_v, ymode, uvmode,
                               bmode, has_nonzero, intra_mask), lf_params)
    G, R, C = ymode.shape
    Ty, Tu, Tv = (t.to(torch.int32) for t in (y, u, v))     # fresh copies
    # U and V filter alike: one batch of 2G chroma tiles
    Fy, Fuv = Ty.clone(), torch.cat([Tu, Tv])
    lf_uv = tuple(torch.cat([x, x]) for x in lf_params)
    for rs, cs in order:
        _intra_diag(Ty, Tu, Tv, rs, cs, res_y, res_u, res_v, ymode, uvmode,
                    bmode, has_nonzero, intra_mask, R, C)
        r = torch.tensor(rs, device=y.device)
        c = torch.tensor(cs, device=y.device)
        Fy[:, r, c] = Ty[:, r, c]
        Fuv[:, r, c] = torch.cat([Tu[:, r, c], Tv[:, r, c]])
        _lf_diag(((Fy, 16),), rs, cs, lf_params)
        _lf_diag(((Fuv, 8),), rs, cs, lf_uv)
    U, V = untile(Fuv).chunk(2)
    return untile(Fy), U, V
