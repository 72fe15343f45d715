"""Plain PyTorch version of the intra-fixup kernel K10
(ops/enc_intra_fixup_cuda.py, csrc/enc_intra_fixup.cu): the macroblocks of
a fast interframe that K9 left intra get a whole-mode intra encode against
the FINAL reconstruction of their neighbours, over anti-diagonals
d = row + col (an intra macroblock reads its left, above and above-left
neighbours only), vectorised over the intra macroblocks of a diagonal; one
frame per quantizer.  Inter macroblocks pass through.

Per intra macroblock (the JAX package's encode_intra_np.encode_intra_mb
with interframe=True, skip_bpred=True): DC/V/H/TM by variance rd-cost under
the interframe's macroblock mode costs, the Y2/WHT luma chain, the chroma
mode of least raw SSE over U and V, the chroma chain (ops/enc_intra.py's
pieces, plain quantization).  The whole-mode scan starts from INF = 1 << 30
as the TPU kernel's (alfalfa_tpu/ops/enc_intra_fixup_pallas.py): a mode
costing INF or more is never taken, and DC is kept if all do.
"""
import torch

from alfalfa_tpu_torch.ops import intra
from alfalfa_tpu_torch.ops.enc_decide import INF
from alfalfa_tpu_torch.ops.enc_inter import variance
from alfalfa_tpu_torch.ops.enc_intra import (_edges, _rdcost, chroma_residue,
                                             y2_residue)
from alfalfa_tpu_torch.ops.wavefront import diagonals, tile, untile

FIXUP_WORDS = 3     # per macroblock: ymode (whole mode), uvmode, nonzero


def _fixup_diag(st, r, c, q, rm, dm, mbc):
    dev = r.device
    N = r.shape[0]
    ar = torch.arange(N, device=dev)
    ru, cl = (r - 1).clamp(min=0), (c - 1).clamp(min=0)
    hrow, hcol = r > 0, c > 0
    oy = st["Oy"][r, c]

    e0, above, left = _edges(st["Ty"], r, c, ru, cl, hrow, hcol, 16)
    wpreds = intra.whole_predict_all(torch.cat([e0[:, None], above], 1),
                                     left, hrow, hcol, 16)
    best = torch.full((N,), INF, dtype=torch.int64, device=dev)
    wm = torch.zeros(N, dtype=torch.int64, device=dev)
    for m in range(4):
        cost = _rdcost(mbc[m], variance(oy, wpreds[:, m]), rm, dm)
        better = cost < best
        best = torch.where(better, cost, best)
        wm = torch.where(better, m, wm)
    wco, y2q, st["Ty"][r, c] = y2_residue(oy, wpreds[ar, wm], q)

    chroma = []
    for k in ("u", "v"):
        ce0, a8, l8 = _edges(st["T" + k], r, c, ru, cl, hrow, hcol, 8)
        p = intra.whole_predict_all(torch.cat([ce0[:, None], a8], 1), l8,
                                    hrow, hcol, 8)
        chroma.append((k, st["O" + k][r, c], p))
    uv_sse = sum(((o[:, None] - p) ** 2).sum(dim=(2, 3)).to(torch.int64)
                 for _, o, p in chroma)
    uvm = uv_sse.argmin(dim=1)
    uv_co = []
    for k, o, p in chroma:
        qc, st["T" + k][r, c] = chroma_residue(o, p[ar, uvm], q)
        uv_co.append(qc)

    coeffs = torch.cat([wco, uv_co[0], uv_co[1], y2q[:, None]], dim=1)
    st["co"][r, c] = coeffs.to(torch.int16)
    st["md2"][r, c] = torch.stack(
        [wm, uvm, (coeffs != 0).flatten(1).any(dim=1).to(torch.int64)], 1)


def intra_fixup_frame_plain(oy, ou, ov, md, y, u, v, scalars, mbc):
    """Plain version of ops.enc_intra_fixup_cuda.intra_fixup_frame (same
    contract, any device).

    oy: (16R, 16C), ou / ov: (8R, 8C) uint8 original planes, padded to
    whole macroblocks; md: (Q, R, C, DECIDE_WORDS) int32, K9's decisions
    (word 0: is_inter); y / u / v: (Q, 16R, 16C), (Q, 8R, 8C) uint8, the
    reconstruction of the inter macroblocks (intra ones arbitrary);
    scalars: (Q, N_SCALARS) int32 (ops/enc_inter.py); mbc: (5,) int32, the
    interframe's macroblock mode costs.

    Returns coeffs (Q, R, C, 25, 16) int16 (zero at inter macroblocks),
    modes (Q, R, C, FIXUP_WORDS) int32 [whole mode, chroma mode, any
    nonzero coefficient] (zero at inter macroblocks), and the final
    unfiltered (Q, 16R, 16C), (Q, 8R, 8C), (Q, 8R, 8C) uint8 planes."""
    dev = oy.device
    R, C = oy.shape[0] // 16, oy.shape[1] // 16
    mbc = mbc.to(dev, torch.int64)
    orig = {"Oy": tile(oy[None], 16)[0], "Ou": tile(ou[None], 8)[0],
            "Ov": tile(ov[None], 8)[0]}
    outs = []
    for qn, sc in enumerate(scalars.tolist()):
        st = dict(orig, Ty=tile(y[qn][None], 16)[0],
                  Tu=tile(u[qn][None], 8)[0], Tv=tile(v[qn][None], 8)[0],
                  co=torch.zeros((R, C, 25, 16), dtype=torch.int16,
                                 device=dev),
                  md2=torch.zeros((R, C, FIXUP_WORDS), dtype=torch.int64,
                                  device=dev))
        intra_mb = md[qn, :, :, 0] == 0
        q = tuple(int(x) for x in sc[:6])
        for rs, cs in diagonals(R, C, 1):
            r, c = torch.tensor(rs, device=dev), torch.tensor(cs, device=dev)
            keep = intra_mb[r, c]
            if bool(keep.any()):
                _fixup_diag(st, r[keep], c[keep], q, int(sc[6]), int(sc[7]),
                            mbc)
        outs.append((st["co"], st["md2"].to(torch.int32),
                     *(untile(st[k][None])[0] for k in ("Ty", "Tu", "Tv"))))
    return tuple(torch.stack(x) for x in zip(*outs))
