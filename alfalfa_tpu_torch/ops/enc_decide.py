"""Plain PyTorch version of the interframe-decision kernel K9
(ops/enc_decide_cuda.py, csrc/enc_decide.cu): the mode and motion-vector
decision of every macroblock of an interframe for the fast rt encode, over
anti-diagonals d = row + col (each macroblock reads the committed decisions
of its left, above and above-left neighbours only), vectorised over the
macroblocks of a diagonal; one frame per quantizer.

Per macroblock it is K8's decision chain (ops/enc_inter.py, whose helpers
it calls): the census of the neighbours' vectors and the mv_ref leaf costs,
ZEROMV, NEARESTMV and NEARMV where their clamped vector is not zero, NEWMV
by the iterated diamond search where row and column are multiples of 4
(rt), each by variance rd-cost of the six-tap prediction from LAST, the
winner by strict ``<`` in the order intra, ZERO, NEAREST, NEAR, NEW.  It
differs from K8 as the JAX package's fast path does
(alfalfa_tpu/ops/enc_decide_pallas.py:19-27): the intra candidate is a
given cost per macroblock (``icost``, ops/enc_batch.intra_screen_source:
screened against the source neighbours, not the reconstruction), nothing
is encoded, and the costs are int32 with INF = 1 << 30 as the TPU
kernel's: a candidate that is not scored costs INF and still wins over an
intra cost above INF (K8's int64 costs would not let it).  No cost reaches
2^31 (variance <= 256 * 255^2 times a distortion multiplier <= 100), so
int64 arithmetic compared against INF gives the int32 results.
"""
import torch

from alfalfa_tpu_torch.ops.enc_inter import (NEARESTMV, NEARMV, NEWMV,
                                             ZEROMV, _census, _diamond_search,
                                             clamp_mv, luma_taps, predict_mbs,
                                             variance)
from alfalfa_tpu_torch.ops.wavefront import diagonals

INF = 1 << 30
DECIDE_WORDS = 8    # per macroblock: is_inter, mode, mvx, mvy, diamond
                    # sites evaluated, candidates scored, six-tap taps their
                    # luma predictions need, 0
SITES, CANDS, TAPS = 4, 5, 6


def _decide_diag(st, r, c, rm, dm, sadw, icost, tables):
    dev = r.device
    R, C = st["R"], st["C"]
    mvc2p, pcost, sadcost, mvcost = tables
    ru, cl = (r - 1).clamp(min=0), (c - 1).clamp(min=0)
    hrow, hcol = r > 0, c > 0
    oy = st["Oy"][r, c]

    # the census reads words 2 (is_inter) and 4, 5 (the vector) of each
    # neighbour, as K8's mode words hold them
    S, best, nearest, near = _census(st["nb"], r, c, ru, cl, hrow, hcol)
    p = mvc2p[S, torch.arange(4, device=dev)[None, :]]
    c0, c1 = pcost[p], pcost[255 - p]
    rates = (c0[:, 0], c1[:, 0] + c0[:, 1], c1[:, 0] + c1[:, 1] + c0[:, 2],
             c1[:, 0] + c1[:, 1] + c1[:, 2] + c0[:, 3])
    brx, bry = clamp_mv(best[:, 0], best[:, 1], r, c, R, C)

    best_cost = icost[r * C + c].to(torch.int64)
    kind = torch.zeros_like(best_cost)                  # 0 intra
    mode, bmx, bmy = (torch.zeros_like(kind) for _ in range(3))
    cands, taps = torch.zeros_like(kind), torch.zeros_like(kind)

    def consider(m, x, y, rate, enabled):
        nonlocal best_cost, kind, mode, bmx, bmy, cands, taps
        cands = cands + enabled.to(torch.int64)
        taps = taps + torch.where(enabled, luma_taps(x & 7, y & 7), 0)
        var = variance(oy, predict_mbs(st["Ly"], r, c, x, y, 16))
        cost = torch.where(enabled, ((128 + rate * rm) >> 8) + var * dm, INF)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        kind = torch.where(better, 1, kind)
        mode = torch.where(better, m, mode)
        # a candidate not scored wins with the vector (0, 0), as the TPU
        # kernel's NEWMV without a search
        bmx = torch.where(better, torch.where(enabled, x, 0), bmx)
        bmy = torch.where(better, torch.where(enabled, y, 0), bmy)

    zero = torch.zeros_like(kind)
    consider(ZEROMV, zero, zero, rates[0], torch.ones_like(hrow))
    for m, mv, rate in ((NEARESTMV, nearest, rates[1]),
                        (NEARMV, near, rates[2])):
        x, y = clamp_mv(mv[:, 0], mv[:, 1], r, c, R, C)
        consider(m, x, y, rate, (x != 0) | (y != 0))

    search = (r % 4 == 0) & (c % 4 == 0)
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

    words = torch.stack([kind, mode, bmx, bmy, sites, cands, taps + site_taps,
                         zero], dim=1)
    st["md"][r, c] = words
    st["nb"][r, c, 2] = kind
    st["nb"][r, c, 4] = torch.where(kind != 0, bmx, 0)
    st["nb"][r, c, 5] = torch.where(kind != 0, bmy, 0)


def decide_inter_frame_plain(oy, ly, scalars, icost, tables):
    """Plain version of ops.enc_decide_cuda.decide_inter_frame (same
    contract, any device).

    oy: (16R, 16C) uint8 original luma, padded to whole macroblocks; ly:
    the LAST reference's luma, the same shape; scalars: (Q, N_SCALARS)
    int32 (ops/enc_inter.py: only the rate and distortion multipliers and
    the SAD per bit are read); icost: (Q, R*C) int32, the intra cost of each
    macroblock at each quantizer (ops/enc_batch.intra_screen_source);
    tables: (MV_COUNTS_TO_PROBS (6, 4), PROB_COST (256,), SAD mv costs
    (256,), mv component costs (4, 1024) [component * 2 + sign]) int32.

    Returns (Q, R, C, DECIDE_WORDS) int32: is_inter, mode (ZEROMV,
    NEARESTMV, NEARMV, NEWMV; 0 intra), mvx, mvy (0 intra), the diamond
    sites evaluated, the candidates scored, the six-tap taps of their luma
    predictions, 0."""
    dev = oy.device
    R, C = oy.shape[0] // 16, oy.shape[1] // 16
    tables = tuple(t.to(dev, torch.int64) for t in tables)
    tiles = oy.reshape(R, 16, C, 16).permute(0, 2, 1, 3).to(torch.int32)
    out = []
    for q, sc in enumerate(scalars.tolist()):
        st = {"R": R, "C": C, "Oy": tiles, "Ly": ly,
              "nb": torch.zeros((R, C, 6), dtype=torch.int64, device=dev),
              "md": torch.zeros((R, C, DECIDE_WORDS), dtype=torch.int64,
                                device=dev)}
        for rs, cs in diagonals(R, C, 1):
            _decide_diag(st, torch.tensor(rs, device=dev),
                         torch.tensor(cs, device=dev), int(sc[6]),
                         int(sc[7]), int(sc[8]), icost[q], tables)
        out.append(st["md"].to(torch.int32))
    return torch.stack(out)
