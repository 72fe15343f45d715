"""Device (PyTorch) frame reconstruction for G frames in lockstep.

Everything data-parallel runs as dense batched tensor ops over the whole
batch (residual transforms, the add-and-clip of inter prediction); the two
stages with per-macroblock control flow are the CUDA kernels
``ops.sixtap_cuda.mc_tiles`` (motion compensation) and
``ops.wavefront_cuda.wavefront_decode`` (intra prediction + loop filter).

The kernels take dense (G, R, C, ...) tensors and hand back (G, H, W)
uint8 planes: there is no diagonal skew, no pixel-major transpose and no
chunking of the batch here.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.ops import transforms
from alfalfa_tpu_torch.ops.sixtap_cuda import mc_tiles
from alfalfa_tpu_torch.ops.wavefront_cuda import wavefront_decode


def _assemble(blocks, n):
    """(G, R, C, n*n, 4, 4) residual blocks -> (G, R, C, 4n, 4n) tiles."""
    G, R, C = blocks.shape[:3]
    return blocks.reshape(G, R, C, n, n, 4, 4).permute(0, 1, 2, 3, 5, 4, 6) \
        .reshape(G, R, C, 4 * n, 4 * n)


def _stage_ab(key_frame, coeffs, qf, y2_coded, has_nonzero,
              ref_sel, sub_mv, uv_mv, refs):
    """Stages A (residuals) + B (inter prediction): the fully parallel
    dense front of the pipeline.

    coeffs: (G, R, C, 25, 16) int; qf: dict of (G, R, C) int tensors;
    y2_coded, has_nonzero: (G, R, C) bool; ref_sel: (G, R, C) int32;
    sub_mv: (G, R, C, 4, 4, 2), uv_mv: (G, R, C, 2, 2, 2) int32; refs:
    {"y", "u", "v"} -> (G, 3, H, W) uint8 (unused on key frames).

    Returns (y, u, v stage-B tiles uint8; res_y, res_u, res_v int16;
    intra mask).  Intra macroblocks' tiles are zero."""
    res = transforms.residuals_from_coeffs(coeffs, qf, y2_coded)
    res = torch.where(has_nonzero[..., None, None, None], res,
                      torch.zeros_like(res)).to(torch.int16)
    res_y = _assemble(res[:, :, :, 0:16], 4).contiguous()
    res_u = _assemble(res[:, :, :, 16:20], 2).contiguous()
    res_v = _assemble(res[:, :, :, 20:24], 2).contiguous()
    G, R, C = ref_sel.shape
    dev = res.device

    if key_frame:
        tiles = [torch.zeros((G, R, C, S, S), dtype=torch.uint8, device=dev)
                 for S in (16, 8, 8)]
        intra_mask = torch.ones((G, R, C), dtype=torch.bool, device=dev)
        return (*tiles, res_y, res_u, res_v, intra_mask)

    is_inter = ref_sel > 0
    m = is_inter[..., None, None]
    tiles = []
    for plane, mv, S, r in (("y", sub_mv, 16, res_y), ("u", uv_mv, 8, res_u),
                            ("v", uv_mv, 8, res_v)):
        pred = mc_tiles(refs[plane], ref_sel, mv, S)
        t = torch.clamp(pred.to(torch.int16) + r, 0, 255).to(torch.uint8)
        tiles.append(torch.where(m, t, torch.zeros_like(t)))
    return (*tiles, res_y, res_u, res_v, ~is_inter)


def reconstruct_core_batch(key_frame, coeffs, qf, y2_coded, has_nonzero,
                           ymode, uvmode, bmode, ref_sel, sub_mv, uv_mv,
                           refs, lf_params):
    """Reconstruct one frame of each of G GOPs.  All tensor arguments
    carry a leading G axis (see _stage_ab; bmode: (G, R, C, 16) uint8;
    lf_params: six (G, R, C) tensors).  Returns (G, H, W) / (G, H/2, W/2)
    uint8 planes, decoded and loop-filtered."""
    y, u, v, res_y, res_u, res_v, intra_mask = _stage_ab(
        key_frame, coeffs, qf, y2_coded, has_nonzero, ref_sel, sub_mv,
        uv_mv, refs)
    return wavefront_decode(y, u, v, res_y, res_u, res_v, ymode, uvmode,
                            bmode, has_nonzero, intra_mask, lf_params)


def _frame_quant_factors(header, state, segment):
    """Per-MB dequantization factors as (r, c) int32 arrays."""
    seg = state.segmentation
    if seg is not None:
        per_seg = [header.quant_indices.quantizer(int(seg.quantizer_adjustments[i]),
                                                  seg.absolute) for i in range(4)]
        out = {}
        for k in per_seg[0]:
            table = np.array([int(q[k]) for q in per_seg], np.int32)
            out[k] = table[segment]
        return out
    q = header.quant_indices.quantizer()
    r, c = segment.shape
    return {k: np.full((r, c), int(v), np.int32) for k, v in q.items()}
