"""Device (PyTorch) frame reconstruction: G frames in lockstep (the GOP
decoder) or one frame (the single-frame ``Decoder``).

Everything data-parallel runs as dense batched tensor ops (residual
transforms, the add-and-clip of inter prediction); the stages with
per-macroblock control flow are CUDA kernels:

- GOP batch: ``ops.sixtap_cuda.mc_tiles`` (motion compensation of the
  three planes) and ``ops.wavefront_cuda.wavefront_decode`` (intra
  prediction + loop filter);
- one frame: ``ops.sixtap_cuda.predict_mb_tiles``, then
  ``ops.intra_cuda.intra_frame``, then ``ops.lf_cuda.loop_filter``; its
  inputs go up in one packed host-to-device copy (``reconstruct``).

The kernels take dense (G, R, C, ...) tensors and hand back (G, H, W)
uint8 planes: there is no diagonal skew, no pixel-major transpose and no
chunking of the batch here.  (The JAX package's skew schedule and its
``intra_active`` bucketing exist for XLA and are not ported.)
"""
import numpy as np
import torch

from alfalfa_tpu_torch.decoder.lf_params import frame_lf_params
from alfalfa_tpu_torch.ops import transforms
from alfalfa_tpu_torch.ops.intra_cuda import intra_frame
from alfalfa_tpu_torch.ops.lf_cuda import loop_filter
from alfalfa_tpu_torch.ops.sixtap_cuda import mc_tiles, predict_mb_tiles
from alfalfa_tpu_torch.ops.wavefront import untile
from alfalfa_tpu_torch.ops.wavefront_cuda import wavefront_decode
from alfalfa_tpu_torch.parallel.upload import (PinnedStaging, pack_upload,
                                               unpack_upload)
from alfalfa_tpu_torch.state.decoder_state import Raster
from alfalfa_tpu_torch.util import tracing


def _assemble(blocks, n):
    """(G, R, C, n*n, 4, 4) residual blocks -> (G, R, C, 4n, 4n) tiles."""
    G, R, C = blocks.shape[:3]
    return blocks.reshape(G, R, C, n, n, 4, 4).permute(0, 1, 2, 3, 5, 4, 6) \
        .reshape(G, R, C, 4 * n, 4 * n)


def _stage_ab(key_frame, coeffs, qf, y2_coded, has_nonzero,
              ref_sel, sub_mv, uv_mv, refs, mc=mc_tiles):
    """Stages A (residuals) + B (inter prediction): the fully parallel
    dense front of the pipeline.

    coeffs: (G, R, C, 25, 16) int; qf: dict of (G, R, C) int tensors;
    y2_coded, has_nonzero: (G, R, C) bool; ref_sel: (G, R, C) int32;
    sub_mv: (G, R, C, 4, 4, 2), uv_mv: (G, R, C, 2, 2, 2) int32; refs:
    the references as ``mc`` takes them (unused on key frames); mc: the
    motion compensation of the three planes, mc_tiles or
    predict_mb_tiles.

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
    for pred, r in zip(mc(refs, ref_sel, sub_mv, uv_mv),
                       (res_y, res_u, res_v)):
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


# ---------------------------------------------------------------------------
# one frame: the single-frame Decoder's path and the encoders' loop filter
# ---------------------------------------------------------------------------

def reconstruct_core(key_frame, coeffs, qf, y2_coded, has_nonzero, ymode,
                     uvmode, bmode, ref_sel, sub_mv, uv_mv, refs, lf_params):
    """Reconstruct one frame: reconstruct_core_batch's arguments without
    the G axis; refs: {"y", "u", "v"} -> the (H, W) uint8 planes of the
    three references (last, golden, alternate), None on key frames.
    Stages A/B (K3), then intra prediction (K4), then the loop filter of
    the three planes (K5).  Returns (H, W), (H/2, W/2), (H/2, W/2) uint8
    planes."""
    one = lambda x: x[None]
    y, u, v, res_y, res_u, res_v, intra_mask = _stage_ab(
        key_frame, one(coeffs), {k: one(q) for k, q in qf.items()},
        one(y2_coded), one(has_nonzero), one(ref_sel), one(sub_mv),
        one(uv_mv), refs, mc=predict_mb_tiles)
    planes = intra_frame(y, u, v, res_y, res_u, res_v, one(ymode),
                         one(uvmode), one(bmode), one(has_nonzero),
                         intra_mask)
    Y, U, V = loop_filter(*planes, tuple(one(x) for x in lf_params))
    return Y[0], U[0], V[0]


def loopfilter_tiles(y_tiles, u_tiles, v_tiles, lf_params):
    """Whole-frame loop filter of one frame held as tiles (the encoders'
    entry): y_tiles (R, C, 16, 16) or (R, C, 256), u_tiles / v_tiles
    (R, C, 8, 8) or (R, C, 64), any integer type with values in 0..255;
    lf_params: six (R, C) tensors as reconstruct_core takes them.
    Returns the filtered (H, W), (H/2, W/2), (H/2, W/2) uint8 planes."""
    R, C = lf_params[0].shape
    planes = [untile(t.reshape(1, R, C, S, S)).contiguous()
              for t, S in ((y_tiles, 16), (u_tiles, 8), (v_tiles, 8))]
    Y, U, V = loop_filter(*planes, tuple(x[None] for x in lf_params))
    return Y[0], U[0], V[0]


def reconstruct(header, arrays, state, references, key_frame, device=None,
                staging=None):
    """Reconstruct one parsed frame on ``device`` (default CUDA), with the
    contract of the JAX package's reconstruct_jax.reconstruct: returns a
    new Raster, here with tensor planes on ``device``.  The parse arrays go
    up in one packed copy (parallel/upload.py's layout) through
    ``staging``, a PinnedStaging for ``device`` that the caller keeps from
    frame to frame (None: a new one); the reference rasters' planes are
    used where they lie if they are on ``device``, and copied there if
    not."""
    dev = torch.device("cuda" if device is None else device)
    R, C = arrays.mb_rows, arrays.mb_cols
    i32 = lambda a: np.asarray(a, np.int32)
    with tracing.stage("decode.prep"):
        host = {"coeffs": np.asarray(arrays.densify_coeffs(), np.int16),
                "y2_coded": np.asarray(arrays.y2_coded, bool),
                "has_nonzero": np.asarray(arrays.has_nonzero, bool),
                "ymode": i32(arrays.ymode), "uvmode": i32(arrays.uvmode),
                "bmode": np.asarray(arrays.bmode, np.uint8).reshape(R, C, 16),
                "ref_sel": i32(arrays.ref), "sub_mv": i32(arrays.sub_mv),
                "uv_mv": i32(arrays.uv_mv)}
        host.update(("qf." + k, i32(q)) for k, q in
                    _frame_quant_factors(header, state, arrays.segment).items())
        lf = frame_lf_params(header, arrays, state, key_frame)
        host.update(("lf%d" % i, i32(x)) for i, x in enumerate(lf[:5]))
        host["lf5"] = np.asarray(lf[5], bool)
        mega, spec = pack_upload(host)
    with tracing.stage("decode.upload"):
        if staging is None:
            staging = PinnedStaging(dev)
        d = unpack_upload(staging.upload(mega), spec)
    with tracing.stage("decode.device"):
        refs = None
        if not key_frame:
            rasters = [r.on_device(dev) for r in (
                references.last, references.golden, references.alternative)]
            refs = {p: tuple(getattr(r, p) for r in rasters) for p in "yuv"}
        y, u, v = reconstruct_core(
            key_frame, d["coeffs"], {k[3:]: q for k, q in d.items()
                                     if k.startswith("qf.")},
            d["y2_coded"], d["has_nonzero"], d["ymode"], d["uvmode"],
            d["bmode"], d["ref_sel"], d["sub_mv"], d["uv_mv"], refs,
            tuple(d["lf%d" % i] for i in range(6)))
    return Raster(state.width, state.height, y, u, v)
