"""Plain PyTorch version of the interframe-encode kernel K8
(ops/enc_inter_cuda.py, csrc/enc_inter.cu): every macroblock of an
interframe, over anti-diagonals d = 2*row + col, vectorised over the
macroblocks of a diagonal, as a Python loop over diagonals (like
ops/enc_intra.py); one frame per quantizer, the quantizers one after the
other.

Per macroblock (reference encoder/encode_inter.cc:231-369, the JAX
package's host loop encoder/encode_inter_np.py:encode_interframe):

1. Census of the above, left and above-left macroblocks' motion vectors
   (decoder/parse.py:mv_census): best, nearest and near, and the mv_ref
   leaf costs of their counts.
2. Intra screening: DC/V/H/TM by variance rd-cost against the unfiltered
   reconstruction of this frame.
3. ZEROMV, and NEARESTMV and NEARMV where their clamped vector is not zero,
   by variance rd-cost of the six-tap prediction from LAST.
4. NEWMV by the iterated diamond search (step 512 down to 1, SAD plus the
   SAD mv cost; every macroblock, or in realtime quality those with row and
   column both multiples of 4), as a masked loop that runs while any
   macroblock of the diagonal still searches; its vector is the search's
   plus the clamped best, not clamped again.
5. The winner (strict ``<`` in the order intra, ZERO, NEAREST, NEAR, NEW):
   an inter macroblock through the Y2/WHT path with chroma predicted at the
   symmetrically rounded average vector; an intra one through the full
   intra encode of K7's plain version (ops/enc_intra.py:intra_mbs) with the
   interframe mode costs and the non-contextual b-mode costs, and the
   trellis with token costs (two-pass).  Inter macroblocks are never
   trellis-quantized: their nonzero flags are zero and they pass the Y2
   chains on.

Costs are int64, as the host loop's Python ints (the TPU kernel's are int32
with INF = 1 << 30).
"""
import torch

from alfalfa_tpu_torch.ops.enc_intra import (_edges, chroma_residue,
                                             intra_mbs, y2_chains,
                                             y2_residue, _rdcost)
from alfalfa_tpu_torch.ops import intra
from alfalfa_tpu_torch.ops.sixtap import SIXTAP_TABLE
from alfalfa_tpu_torch.ops.wavefront import diagonals, tile, untile

MODE_WORDS = 32     # per macroblock: ymode, uvmode, is_inter, has_nonzero,
                    # mvx, mvy, chroma mvx, mvy, 16 b-modes, diamond sites
                    # evaluated, candidates scored, six-tap taps their luma
                    # predictions need, 5 zero
SITES = 24          # the word that counts the diamond sites evaluated
CANDS = 25          # ... the candidates scored (ZERO, and NEAREST, NEAR,
                    # NEW where enabled)
TAPS = 26           # ... the six-tap taps the luma predictions of those
                    # sites and candidates need (luma_taps)
N_SCALARS = 9       # per quantizer: y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac,
                    # rate multiplier, distortion multiplier, SAD per bit
ZEROMV, NEARESTMV, NEARMV, NEWMV = 7, 5, 6, 8
MV_LIMIT = 1023     # the search's vectors stay within +-MV_LIMIT
# the diamond's sites, in the order the search scores them
DIAMOND = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
INF = 1 << 62


def clamp_mv(x, y, r, c, R, C):
    """decoder/parse.py:clamp_mv on tensors: within one macroblock and 16
    pixels of the frame (eighth-pel)."""
    return (torch.clamp(x, -(c * 128) - 128, (C - 1 - c) * 128 + 128),
            torch.clamp(y, -(r * 128) - 128, (R - 1 - r) * 128 + 128))


def luma_taps(fx, fy):
    """The six-tap taps a 16x16 prediction at sub-pel phases (fx, fy)
    needs: the horizontal pass over 21 rows (16 without a vertical phase),
    the vertical pass over 16; a zero phase's pass is the identity."""
    return 6 * 16 * (torch.where(fx != 0, torch.where(fy != 0, 21, 16), 0)
                     + torch.where(fy != 0, 16, 0))


def chroma_mv(v):
    """The chroma vector of a uniform luma vector: (4v + 4) >> 3, rounded
    symmetrically about zero."""
    return torch.sign(v) * ((4 * v.abs() + 4) >> 3)


def predict_mbs(plane, r, c, mx, my, S):
    """Six-tap predictions of the S x S blocks of the macroblocks (r, c)
    of ``plane`` (H, W) at eighth-pel vectors (mx, my), every read clamped
    per index to the plane (the two passes of ops/sixtap.py on one
    (S+5) x (S+5) window per block): (N, S, S) int32."""
    H, W = plane.shape
    dev = plane.device
    o = torch.arange(-2, S + 3, device=dev)
    yy = torch.clamp((r * S + (my >> 3))[:, None] + o, 0, H - 1)
    xx = torch.clamp((c * S + (mx >> 3))[:, None] + o, 0, W - 1)
    patch = plane[yy[:, :, None], xx[:, None, :]].to(torch.int32)
    taps = torch.tensor(SIXTAP_TABLE, dtype=torch.int32, device=dev)
    hf, vf = taps[mx & 7], taps[my & 7]
    acc = sum(patch[:, :, k:k + S] * hf[:, k, None, None] for k in range(6))
    mid = torch.clamp((acc + 64) >> 7, 0, 255)
    acc = sum(mid[:, k:k + S, :] * vf[:, k, None, None] for k in range(6))
    return torch.clamp((acc + 64) >> 7, 0, 255)


def variance(o, p):
    """sse - s*s/256 of 16x16 blocks, int64 (N,)."""
    d = (o - p).reshape(o.shape[0], -1).to(torch.int64)
    s = d.sum(dim=1)
    return (d * d).sum(dim=1) - (s * s) // 256


def _census(md, r, c, ru, cl, hrow, hcol):
    """mv_census over the macroblocks of a diagonal: (scores (N, 4) with
    scores[:, 3] the SPLITMV score 0, best, nearest, near (N, 2))."""
    N = r.shape[0]
    dev = r.device
    ar = torch.arange(N, device=dev)
    S = torch.zeros((N, 4), dtype=torch.int64, device=dev)
    M = torch.zeros((N, 4, 2), dtype=torch.int64, device=dev)
    idx = torch.zeros(N, dtype=torch.int64, device=dev)
    for score, valid, nr, nc in ((2, hrow, ru, c), (2, hcol, r, cl),
                                 (1, hrow & hcol, ru, cl)):
        mv = md[nr, nc, 4:6]
        use = valid & (md[nr, nc, 2] != 0)
        zero = (mv == 0).all(dim=1)
        S[:, 0] += torch.where(use & zero, score, 0)
        nz = use & ~zero
        bump = nz & (mv != M[ar, idx]).any(dim=1)
        idx = idx + bump.to(torch.int64)
        M[ar, idx] = torch.where(bump[:, None], mv, M[ar, idx])
        S[ar, idx] += torch.where(nz, score, 0)
    # Scorer::calculate (macroblock.cc:156-172)
    merge = (S[:, 3] > 0) & (M[ar, idx] == M[:, 1]).all(dim=1)
    S[:, 1] += torch.where(merge, S[:, 3], 0)
    swap = S[:, 2] > S[:, 1]
    S[:, 1], S[:, 2] = (torch.where(swap, S[:, 2], S[:, 1]),
                        torch.where(swap, S[:, 1], S[:, 2]))
    M[:, 1], M[:, 2] = (torch.where(swap[:, None], M[:, 2], M[:, 1]),
                        torch.where(swap[:, None], M[:, 1], M[:, 2]))
    best = torch.where((S[:, 1] >= S[:, 0])[:, None], M[:, 1], 0)
    S[:, 3] = 0                                     # no SPLITMV neighbours
    return S, best, M[:, 1], M[:, 2]


def _diamond_search(o, ly, r, c, brx, bry, weight, sadcost, R, C):
    """The iterated diamond search (encode_inter_np.py:115-147, 237-251) of
    the macroblocks (r, c), all at once: masked loops run while any of them
    still searches.  Returns the search's vectors (mx, my) (before the best
    vector is added), the sites evaluated and the six-tap taps their
    predictions need (N,)."""
    N = r.shape[0]
    dev = r.device
    z = lambda v: torch.full((N,), v, dtype=torch.int64, device=dev)
    mx, my, step, sites, taps = z(0), z(0), z(512), z(0), z(0)
    dx = torch.tensor([s[0] for s in DIAMOND], device=dev)
    dy = torch.tensor([s[1] for s in DIAMOND], device=dev)
    active = step > 1
    while bool(active.any()):
        # one diamond_search call from (mx, my) at ``step``
        ox, oy, s = mx.clone(), my.clone(), torch.where(active, step, 1)
        first = s // 2
        inner = s > 1
        while bool(inner.any()):
            i = inner.nonzero()[:, 0]
            n = i.shape[0]
            sx = ox[i, None] + s[i, None] * dx[None]          # (n, 5)
            sy = oy[i, None] + s[i, None] * dy[None]
            oob = (sx.abs() > MV_LIMIT) | (sy.abs() > MV_LIMIT)
            ri, ci = r[i, None].expand(n, 5), c[i, None].expand(n, 5)
            tx, ty = clamp_mv(sx + brx[i, None], sy + bry[i, None], ri, ci,
                              R, C)
            pred = predict_mbs(ly, ri.reshape(-1), ci.reshape(-1),
                               tx.reshape(-1), ty.reshape(-1), 16)
            dist = (o[i][:, None] - pred.reshape(n, 5, 16, 16)).abs() \
                .sum(dim=(2, 3)).to(torch.int64)
            cx = torch.clamp(sx >> 2, -255, 255).abs()
            cy = torch.clamp(sy >> 2, -255, 255).abs()
            rate = ((sadcost[cy] + sadcost[cx]) * weight + 128) >> 8
            cost = torch.where(oob, INF, ((128 + rate) >> 8) + dist)
            k = cost.argmin(dim=1)
            a = torch.arange(n, device=dev)
            bx, by = sx[a, k], sy[a, k]
            stay = (bx == ox[i]) & (by == oy[i])
            first[i] = torch.where(stay, s[i] // 2, first[i])
            ox[i], oy[i] = bx, by
            s[i] = s[i] // 2
            sites[i] += (~oob).sum(dim=1)
            taps[i] += torch.where(oob, 0, luma_taps(tx & 7, ty & 7)).sum(dim=1)
            inner = s > 1
        # a restart that comes back where it started ends the search
        same = (ox == mx) & (oy == my)
        mx = torch.where(active, ox, mx)
        my = torch.where(active, oy, my)
        step = torch.where(active, torch.where(same, 1, first), step)
        active = active & (step > 1)
    return mx, my, sites, taps


def _inter_diag(st, r, c, q, rm, dm, sadw, tables, realtime, tcs):
    dev = r.device
    R, C = st["R"], st["C"]
    N = r.shape[0]
    ar = torch.arange(N, device=dev)
    mbc, ibc, mvc2p, pcost, sadcost, mvcost = tables
    ru, cl = (r - 1).clamp(min=0), (c - 1).clamp(min=0)
    hrow, hcol = r > 0, c > 0
    md = st["modes"]
    oy = st["Oy"][r, c]

    # ---- census and mv_ref costs ----
    S, best, nearest, near = _census(md, r, c, ru, cl, hrow, hcol)
    p = mvc2p[S, torch.arange(4, device=dev)[None, :]]          # (N, 4)
    c0, c1 = pcost[p], pcost[255 - p]
    rates = (c0[:, 0], c1[:, 0] + c0[:, 1], c1[:, 0] + c1[:, 1] + c0[:, 2],
             c1[:, 0] + c1[:, 1] + c1[:, 2] + c0[:, 3])
    brx, bry = clamp_mv(best[:, 0], best[:, 1], r, c, R, C)

    # ---- intra screening: whole modes by variance ----
    e0, above16, lcol = _edges(st["Ty"], r, c, ru, cl, hrow, hcol, 16)
    wpreds = intra.whole_predict_all(torch.cat([e0[:, None], above16], 1),
                                     lcol, hrow, hcol, 16)
    wvar = torch.stack([variance(oy, wpreds[:, m]) for m in range(4)], 1)
    wcost = _rdcost(mbc[:4][None, :], wvar, rm, dm)
    best_cost = wcost.min(dim=1).values
    kind = torch.zeros(N, dtype=torch.int64, device=dev)     # 0 intra
    mode = torch.zeros_like(kind)
    bmx, bmy = torch.zeros_like(kind), torch.zeros_like(kind)

    cands = torch.zeros(N, dtype=torch.int64, device=dev)
    taps = torch.zeros_like(cands)

    def consider(m, x, y, rate, enabled):
        nonlocal best_cost, kind, mode, bmx, bmy, cands, taps
        cands = cands + enabled.to(torch.int64)
        taps = taps + torch.where(enabled, luma_taps(x & 7, y & 7), 0)
        var = variance(oy, predict_mbs(st["Ly"], r, c, x, y, 16))
        cost = torch.where(enabled, _rdcost(rate, var, rm, dm), INF)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        kind = torch.where(better, 1, kind)
        mode = torch.where(better, m, mode)
        bmx = torch.where(better, x, bmx)
        bmy = torch.where(better, y, bmy)

    zero = torch.zeros_like(kind)
    consider(ZEROMV, zero, zero, rates[0], torch.ones_like(hrow))
    for m, mv, rate in ((NEARESTMV, nearest, rates[1]),
                        (NEARMV, near, rates[2])):
        x, y = clamp_mv(mv[:, 0], mv[:, 1], r, c, R, C)
        consider(m, x, y, rate, (x != 0) | (y != 0))

    # ---- NEWMV ----
    search = ((r % 4 == 0) & (c % 4 == 0)) if realtime \
        else torch.ones_like(hrow)
    sx, sy, sites, site_taps = (zero.clone() for _ in range(4))
    i = search.nonzero()[:, 0]
    if i.numel():
        sx[i], sy[i], sites[i], site_taps[i] = _diamond_search(
            oy[i], st["Ly"], r[i], c[i], brx[i], bry[i], sadw, sadcost, R, C)
    fx, fy = sx + brx, sy + bry
    mvrate = mvcost[(sy < 0).to(torch.int64), sy.abs()] \
        + mvcost[2 + (sx < 0).to(torch.int64), sx.abs()]
    consider(NEWMV, fx, fy, rates[3] + (mvrate * 96) // 128,
             search & ((fx != 0) | (fy != 0)))

    # ---- encode the winners ----
    words = torch.zeros((N, MODE_WORDS), dtype=torch.int64, device=dev)
    words[:, SITES] = sites
    words[:, CANDS] = cands
    words[:, TAPS] = taps + site_taps
    ty = torch.zeros((N, 16, 16), dtype=torch.int32, device=dev)
    tu = torch.zeros((N, 8, 8), dtype=torch.int32, device=dev)
    tv = torch.zeros_like(tu)
    coeffs = torch.zeros((N, 25, 16), dtype=torch.int32, device=dev)
    inter = kind == 1
    ii = inter.nonzero()[:, 0]
    if ii.numel():
        ri, ci, x, y = r[ii], c[ii], bmx[ii], bmy[ii]
        wco, y2q, ty[ii] = y2_residue(
            oy[ii], predict_mbs(st["Ly"], ri, ci, x, y, 16), q)
        cx, cy = chroma_mv(x), chroma_mv(y)
        uco, tu[ii] = chroma_residue(
            st["Ou"][ri, ci], predict_mbs(st["Lu"], ri, ci, cx, cy, 8), q)
        vco, tv[ii] = chroma_residue(
            st["Ov"][ri, ci], predict_mbs(st["Lv"], ri, ci, cx, cy, 8), q)
        coeffs[ii] = torch.cat([wco, uco, vco, y2q[:, None]], dim=1)
        words[ii, 0] = mode[ii]
        words[ii, 2] = 1
        words[ii, 4], words[ii, 5], words[ii, 6], words[ii, 7] = x, y, cx, cy
    ia = (~inter).nonzero()[:, 0]
    if ia.numel():
        o = intra_mbs(st, r[ia], c[ia], q, rm, dm, tcs, mbc, ibc)
        coeffs[ia] = o["coeffs"]
        ty[ia], tu[ia], tv[ia] = o["y"], o["u"], o["v"]
        words[ia, 0], words[ia, 1] = o["ymode"], o["uvmode"]
        words[ia, 8:24] = o["bmodes"].reshape(-1, 16)
    words[:, 3] = (coeffs != 0).flatten(1).any(dim=1).to(torch.int64)

    st["coeffs"][r, c] = coeffs.to(torch.int16)
    md[r, c] = words
    st["Ty"][r, c], st["Tu"][r, c], st["Tv"][r, c] = ty, tu, tv
    if tcs is not None:
        # inter macroblocks: zero flags, the Y2 chains passed on
        col_in, row_in = y2_chains(st["y2c"], r, c, ru, cl, hrow, hcol)
        ynz = torch.zeros((N, 4, 4), dtype=torch.bool, device=dev)
        unz = torch.zeros((N, 2, 2), dtype=torch.bool, device=dev)
        vnz = torch.zeros_like(unz)
        y2c = torch.cat([col_in, row_in], dim=1)
        if ia.numel():
            ynz[ia], unz[ia], vnz[ia], y2c[ia] = (o["ynz"], o["unz"], o["vnz"],
                                                  o["y2c"])
        st["ynz"][r, c], st["unz"][r, c] = ynz, unz
        st["vnz"][r, c], st["y2c"][r, c] = vnz, y2c


def _encode_frame(oy, ou, ov, ly, lu, lv, sc, tables, realtime, tcs,
                  order=None):
    """One quantizer's frame: the macroblocks in ``order`` (default the
    anti-diagonals d = 2r + c; any list of (rows, cols) in which every
    macroblock comes after those it reads)."""
    dev = oy.device
    R, C = oy.shape[0] // 16, oy.shape[1] // 16
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    st = {"R": R, "C": C, "Oy": tile(oy[None], 16)[0],
          "Ou": tile(ou[None], 8)[0], "Ov": tile(ov[None], 8)[0],
          "Ly": ly, "Lu": lu, "Lv": lv,
          "Ty": z(R, C, 16, 16), "Tu": z(R, C, 8, 8), "Tv": z(R, C, 8, 8),
          "coeffs": torch.zeros((R, C, 25, 16), dtype=torch.int16, device=dev),
          "modes": torch.zeros((R, C, MODE_WORDS), dtype=torch.int64,
                               device=dev)}
    if tcs is not None:
        b = lambda n: torch.zeros((R, C, n, n), dtype=torch.bool, device=dev)
        st.update(ynz=b(4), unz=b(2), vnz=b(2),
                  y2c=torch.zeros((R, C, 4), dtype=torch.bool, device=dev))
    q, (rm, dm, sadw) = tuple(sc[:6]), sc[6:9]
    for rs, cs in diagonals(R, C) if order is None else order:
        _inter_diag(st, torch.tensor(rs, device=dev),
                    torch.tensor(cs, device=dev), q, rm, dm, sadw, tables,
                    realtime, tcs)
    planes = [untile(st[k][None])[0] for k in ("Ty", "Tu", "Tv")]
    return (st["coeffs"], st["modes"].to(torch.int32), *planes)


def encode_inter_frame_plain(oy, ou, ov, ly, lu, lv, scalars, tables,
                             realtime, token_costs=None):
    """Plain version of ops.enc_inter_cuda.encode_inter_frame (same
    contract, any device).

    oy: (16R, 16C), ou / ov: (8R, 8C) uint8 original planes, padded to
    whole macroblocks; ly / lu / lv: the LAST reference's planes, the same
    shapes; scalars: (Q, N_SCALARS) int32, one row per quantizer (y_dc,
    y_ac, y2_dc, y2_ac, uv_dc, uv_ac, rate multiplier, distortion
    multiplier, SAD per bit); tables: (macroblock mode costs (5,), b-mode
    costs (10,), MV_COUNTS_TO_PROBS (6, 4), PROB_COST (256,), SAD mv costs
    (256,), mv component costs (4, 1024) [component * 2 + sign]) int32, all
    of the interframe; realtime: search NEWMV only where row and column
    are multiples of 4; token_costs: None, or the (4, 16, 36) int32 token
    costs for the trellis of intra macroblocks (two-pass).

    Returns, one frame per quantizer: coeffs (Q, R, C, 25, 16) int16,
    modes (Q, R, C, MODE_WORDS) int32, and the reconstructed, unfiltered
    (Q, 16R, 16C), (Q, 8R, 8C), (Q, 8R, 8C) uint8 planes."""
    dev = oy.device
    tables = tuple(t.to(dev, torch.int64) for t in tables)
    tcs = None if token_costs is None else token_costs.to(dev, torch.int64)
    outs = [_encode_frame(oy, ou, ov, ly, lu, lv, [int(x) for x in sc],
                          tables, bool(realtime), tcs)
            for sc in scalars.tolist()]
    return tuple(torch.stack(x) for x in zip(*outs))
