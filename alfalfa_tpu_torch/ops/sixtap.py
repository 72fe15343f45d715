"""Batched inter prediction (PyTorch): VP8 six-tap subpel filter, gather
formulation.  This is the plain version of the ``sixtap_mc`` CUDA kernel
(ops/sixtap_cuda.py).

The reference treats full-pel MVs as a copy fast path and subpel as a
two-pass 6-tap filter; filter index 0 is the identity tap, so a uniform
two-pass filter over every 4x4 subblock is bit-exact for all MVs and maps
to dense gathers + multiplies.  Out-of-frame reads clamp per index to the
plane edge, which is what edge extension amounts to.
"""
import torch

SIXTAP_TABLE = (
    (0, 0, 128, 0, 0, 0),
    (0, -6, 123, 12, -1, 0),
    (2, -11, 108, 36, -8, 1),
    (0, -9, 93, 50, -6, 0),
    (3, -16, 77, 77, -16, 3),
    (0, -6, 50, 93, -9, 0),
    (1, -8, 36, 108, -11, 2),
    (0, -1, 12, 123, -6, 0),
)


def predict_4x4_blocks(ref_planes, ref_sel, block_y, block_x, mv):
    """Predict N 4x4 blocks from selected reference planes.

    ref_planes: (n_refs, H, W) uint8: stacked reference planes.
    ref_sel: (N,) int: which plane each block reads.
    block_y/block_x: (N,) int: top-left plane coords of each 4x4 block.
    mv: (N, 2) int32: (x, y) in 1/8-pel units.

    Returns (N, 4, 4) int32 predictions.
    """
    H, W = ref_planes.shape[-2:]
    dev = ref_planes.device
    mv = mv.to(torch.int32)
    mx = (mv[:, 0] & 7).to(torch.int64)
    my = (mv[:, 1] & 7).to(torch.int64)
    src_x = block_x.to(torch.int64) + (mv[:, 0] >> 3)
    src_y = block_y.to(torch.int64) + (mv[:, 1] >> 3)

    # gather 9x9 patches (rows src_y-2 .. src_y+6), edge-clamped
    o = torch.arange(-2, 7, device=dev)
    yy = torch.clamp(src_y[:, None] + o[None, :], 0, H - 1)    # (N, 9)
    xx = torch.clamp(src_x[:, None] + o[None, :], 0, W - 1)    # (N, 9)
    patch = ref_planes[ref_sel.to(torch.int64)[:, None, None],
                       yy[:, :, None],
                       xx[:, None, :]].to(torch.int32)          # (N, 9, 9)

    taps = torch.tensor(SIXTAP_TABLE, dtype=torch.int32, device=dev)
    hf = taps[mx]                                               # (N, 6)
    acc = torch.zeros((patch.shape[0], 9, 4), dtype=torch.int32, device=dev)
    for k in range(6):
        acc = acc + patch[:, :, k:k + 4] * hf[:, k, None, None]
    inter = torch.clamp((acc + 64) >> 7, 0, 255)                # (N, 9, 4)

    vf = taps[my]
    acc = torch.zeros((patch.shape[0], 4, 4), dtype=torch.int32, device=dev)
    for k in range(6):
        acc = acc + inter[:, k:k + 4, :] * vf[:, k, None, None]
    return torch.clamp((acc + 64) >> 7, 0, 255)


def predict_mb_tiles(ref_planes, ref_sel, sub_mv, S):
    """Motion-compensate all macroblock tiles of one plane, for one frame
    or a batch of frames.

    ref_planes: (..., n_refs, H, W) uint8; ref_sel: (..., R, C) plane index
    per MB; sub_mv: (..., R, C, n, n, 2) eighth-pel MVs (n = S // 4); the
    leading batch dimensions (none, or G) agree.  Each frame reads only its
    own planes.  Returns (..., R, C, S, S) int32."""
    lead = ref_sel.shape[:-2]
    R, C = ref_sel.shape[-2:]
    n_refs, H, W = ref_planes.shape[-3:]
    n = S // 4
    dev = ref_planes.device
    B = 1
    for d in lead:
        B *= d
    shape = (B, R, C, n, n)
    rr = torch.arange(R, device=dev)[None, :, None, None, None]
    cc = torch.arange(C, device=dev)[None, None, :, None, None]
    si = torch.arange(n, device=dev)
    sby = (rr * S + si[None, None, None, :, None] * 4).expand(shape)
    sbx = (cc * S + si[None, None, None, None, :] * 4).expand(shape)
    plane = ref_sel.reshape(B, R, C).to(torch.int64) \
        + n_refs * torch.arange(B, device=dev)[:, None, None]
    N = B * R * C * n * n
    pred = predict_4x4_blocks(
        ref_planes.reshape(B * n_refs, H, W),
        plane[:, :, :, None, None].expand(shape).reshape(N),
        sby.reshape(N), sbx.reshape(N), sub_mv.reshape(N, 2))
    return pred.reshape(B, R, C, n, n, 4, 4).permute(0, 1, 2, 3, 5, 4, 6) \
        .reshape(lead + (R, C, S, S))


def mc_tiles_plain(refs, ref_sel, sub_mv, S):
    """Plain version of ops.sixtap_cuda.mc_tiles (same contract).

    refs: (G, 3, H, W) uint8 (last, golden, alternate); ref_sel: (G, R, C)
    with 0 = intra, 1..3 = last/golden/alternate; sub_mv: (G, R, C, n, n, 2).
    Intra macroblocks (ref_sel 0) are predicted from ``last`` like any
    other; callers mask them.  Returns (G, R, C, S, S) uint8."""
    slot = torch.clamp(ref_sel.to(torch.int64) - 1, min=0)
    return predict_mb_tiles(refs, slot, sub_mv, S).to(torch.uint8)
