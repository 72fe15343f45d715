"""The fast rt interframe encode (the Salsify sender's path,
salsify-sender.cc:160-170, 33 ms a frame): the serial part of an interframe
cut down to the decisions, everything else dense over the frame.

Per interframe, on the encoder's device, one function of tensors
(``fast_frame``), at one or several quantizers:

1. intra screening of every macroblock against its SOURCE neighbours
   (ops/enc_batch.intra_screen_source), one cost per macroblock;
2. K9 (ops/enc_decide_cuda.py): census, ZERO / NEAREST / NEAR / NEWMV
   against that cost, one launch per anti-diagonal r + c;
3. the whole-macroblock six-tap prediction of every macroblock at its
   vector (K3, ops/sixtap_cuda.predict_mb_tiles: the three planes of LAST
   under every quantizer's vectors in one call);
4. dense fDCT, WHT and quantization of every macroblock
   (ops/enc_batch.py), the decoder's residuals
   (ops/transforms.residuals_from_coeffs) and the clamped reconstruction,
   intra macroblocks masked out;
5. K10 (ops/enc_intra_fixup_cuda.py): the intra macroblocks get a
   whole-mode intra encode against their neighbours' final reconstruction,
   one launch per anti-diagonal;
6. the mode words of K8's layout (ops/enc_inter.MODE_WORDS).

Then one device-to-host copy brings the coefficients and mode words back.
A steady frame reuses the persisted loop-filter level: one K5 call filters
the device reconstruction, whose planes become ``references.last`` on the
device, and the frame reuses the last SSIM.  The first fast frame, every
``_LF_RECLIMB_PERIOD``-th one, and any frame with segmentation re-climb the
level through encode_inter.finish_interframe.

The host-patch variant (the encoder's ``fast_bpred=True``) leaves step 5
out of a single frame: the intra macroblocks stay zero on the device (a
pair runs K10 and patches over it, as the JAX package's does).  The copy
brings the reconstruction back too, and the host intra encoder
(encode_intra_np.encode_intra_mb) encodes the intra macroblocks in raster
order, each against the patched reconstruction of the earlier ones,
B_PRED tried; the patched tiles then go back into the device
reconstruction before its loop filter.

Port of alfalfa_tpu/encoder/encode_inter_fast.py, byte for byte (its
``ALFALFA_FAST_FIXUP=0`` with ``ALFALFA_FAST_BPRED=1`` is the encoder's
``fast_bpred`` here; its host patch without B_PRED makes K10's bytes, so
the port has no such variant).  Like it, it is not the serial encoder's
frame: the intra screening reads source pixels, and in the fixup variant
intra macroblocks never take B_PRED.  Not ported: the sparse coefficient fetch
(device_fetch.py), the packed device references (``_lf_filter_and_pack_fn``,
``_cache_device_refs``: here the references are device tensors already),
and the capacity buckets of ``_scatter_patches``, which only spare XLA a
compile per intra count.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.bitstream.header import ModeRefLFDeltaUpdate
from alfalfa_tpu_torch.encoder.encode_inter import (_outputs_to_frame,
                                                    finish_interframe,
                                                    kernel_inputs,
                                                    make_inter_header,
                                                    scalars_for)
from alfalfa_tpu_torch.encoder.costs import rd_multipliers
from alfalfa_tpu_torch.encoder.encode_intra_np import encode_intra_mb
from alfalfa_tpu_torch.encoder.serializer import (count_token_branches,
                                                  optimize_token_probs,
                                                  serialize_frame)
from alfalfa_tpu_torch.ops import enc_batch as EB
from alfalfa_tpu_torch.ops.enc_decide_cuda import decide_inter_frame
from alfalfa_tpu_torch.ops.enc_inter import MODE_WORDS
from alfalfa_tpu_torch.ops.enc_intra import _from_blocks, _to_blocks
from alfalfa_tpu_torch.ops.enc_intra_fixup_cuda import intra_fixup_frame
from alfalfa_tpu_torch.ops.sixtap_cuda import predict_mb_tiles
from alfalfa_tpu_torch.ops.transforms import residuals_from_coeffs
from alfalfa_tpu_torch.ops.wavefront import tile, untile
from alfalfa_tpu_torch.state.decoder_state import (DecoderState,
                                                   FilterAdjustments, Raster)
from alfalfa_tpu_torch.util import tracing

# steady frames reuse the previous loop-filter level (the reference
# persists it under REALTIME_QUALITY, encoder.cc:164-166); every Nth fast
# frame re-climbs it +-1 to follow the content
_LF_RECLIMB_PERIOD = 16

QUANT = ("y_dc", "y_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac")


def _mc(ly, lu, lv, mvx, mvy, cmx, cmy):
    """Whole-macroblock six-tap predictions of the three planes of LAST
    ((H, W) each) at one luma and one chroma vector per macroblock and
    quantizer ((Q, R, C) each): K3 once, the vectors as expanded views;
    (Q, R, C, 16, 16), (Q, R, C, 8, 8), (Q, R, C, 8, 8) int32."""
    def blocks(x, y, n):
        v = torch.stack([x, y], -1).to(torch.int32)
        return v[:, :, :, None, None, :].expand(v.shape[:3] + (n, n, 2))
    preds = predict_mb_tiles({"y": (ly,), "u": (lu,), "v": (lv,)}, None,
                             blocks(mvx, mvy, 4), blocks(cmx, cmy, 2))
    return [p.to(torch.int32) for p in preds]


def _blocks(t, n):
    """(..., 4n, 4n) tiles -> (..., n*n, 4, 4) 4x4 blocks, raster order."""
    return _to_blocks(t, n).unflatten(-1, (4, 4))


def frame_inputs(encoder, yuv, quant_list):
    """fast_frame's arguments for the frame ``yuv`` at the quantizers
    ``quant_list``: K8's first eight (encode_inter.kernel_inputs) and the
    RD multipliers of each quantizer on the host."""
    return kernel_inputs(encoder, yuv, quant_list)[:8] + (
        [scalars_for(qi)[6:8] for qi in quant_list],)


def fast_frame(oy, ou, ov, ly, lu, lv, scalars, tables, rd, fixup=True):
    """The fast interframe of the padded original planes against the LAST
    planes (ops/enc_inter.encode_inter_frame_plain's shapes) at each
    quantizer of ``scalars`` ((Q, N_SCALARS) int32; ``tables``: K8's six
    cost tables; ``rd``: [(rate, distortion multiplier)] of each quantizer,
    scalars' columns 6 and 7 on the host).

    Returns coeffs (Q, R, C, 25, 16) int16, modes (Q, R, C, MODE_WORDS)
    int32 = [ymode, uvmode, is_inter, has_nonzero, mvx, mvy, chroma mvx,
    mvy, 24 zero], and the unfiltered reconstruction (Q, 16R, 16C),
    (Q, 8R, 8C), (Q, 8R, 8C) uint8.  Without ``fixup`` K10 does not run:
    the intra macroblocks' coefficients, words and pixels are zero."""
    dev = oy.device
    R, C = oy.shape[0] // 16, oy.shape[1] // 16
    mbc, _ibc, mvc2p, pcost, sadcost, mvcost = tables
    oy_t = tile(oy[None], 16)[0]
    icost = torch.stack([EB.intra_screen_source(oy_t, mbc, rm, dm)
                         for rm, dm in rd])
    md = decide_inter_frame(oy, ly, scalars, icost,
                            (mvc2p, pcost, sadcost, mvcost))

    is_inter = md[..., 0] != 0                                # (Q, R, C)
    mvx = torch.where(is_inter, md[..., 2], 0)
    mvy = torch.where(is_inter, md[..., 3], 0)
    cmx, cmy = EB.chroma_mv(mvx), EB.chroma_mv(mvy)
    preds = _mc(ly, lu, lv, mvx, mvy, cmx, cmy)

    # per-quantizer factors, (Q, R, C); [..., None] broadcasts over blocks
    f = {k: scalars[:, i].reshape(-1, 1, 1).expand(-1, R, C)
         for i, k in enumerate(QUANT)}
    ydct = EB.fdct_blocks(_blocks(oy_t - preds[0], 4))   # (Q, R, C, 16, 16)
    qy = EB.quantize_blocks(torch.cat([torch.zeros_like(ydct[..., :1]),
                                       ydct[..., 1:]], -1),
                            f["y_dc"][..., None], f["y_ac"][..., None])
    y2 = EB.quantize_blocks(EB.fwht_blocks(ydct[..., 0]), f["y2_dc"],
                            f["y2_ac"])
    quv = [EB.quantize_blocks(EB.fdct_blocks(_blocks(tile(o[None], 8)[0]
                                                     - p, 2)),
                              f["uv_dc"][..., None], f["uv_ac"][..., None])
           for o, p in ((ou, preds[1]), (ov, preds[2]))]
    coeffs = torch.cat([qy, *quv, y2[..., None, :]], dim=3)
    coeffs = torch.where(is_inter[..., None, None], coeffs, 0)
    nz = (coeffs != 0).flatten(3).any(dim=3)

    res = residuals_from_coeffs(coeffs, f, is_inter)     # (Q, R, C, 24, 4, 4)
    res = torch.where(nz[..., None, None, None], res, 0).flatten(-2)
    m = is_inter[..., None, None]
    recon = [untile(torch.where(m, torch.clamp(p + _from_blocks(r, n), 0,
                                               255), 0))
             for p, r, n in ((preds[0], res[..., 0:16, :], 4),
                             (preds[1], res[..., 16:20, :], 2),
                             (preds[2], res[..., 20:24, :], 2))]

    coeffs = coeffs.to(torch.int16)
    inter = is_inter.to(torch.int32)
    ymode, uvmode, nz = md[..., 1] * inter, torch.zeros_like(inter), \
        nz.to(torch.int32)
    if fixup:
        co_fix, md2, *recon = intra_fixup_frame(oy, ou, ov, md, *recon,
                                                scalars, mbc)
        coeffs = torch.where(is_inter[..., None, None], coeffs, co_fix)
        ymode, uvmode, nz = (torch.where(is_inter, w, md2[..., k])
                             for k, w in enumerate((ymode, uvmode, nz)))
    words = [ymode, uvmode, inter, nz, mvx, mvy, cmx, cmy]
    modes = torch.cat([torch.stack(words, -1).to(torch.int32),
                       torch.zeros(md.shape[:3] + (MODE_WORDS - 8,),
                                   dtype=torch.int32, device=dev)], -1)
    return (coeffs, modes, *recon)


_IMPLIED_B = np.array((0, 2, 3, 1), np.int8)   # DC/V/H/TM -> implied bmode


def _implied_bmodes(arrays):
    """Whole-mode intra macroblocks carry the b-modes their mode implies
    (B_DC/B_VE/B_HE/B_TM) in arrays.bmode, as the serializer's contexts
    read them."""
    intra = arrays.ref == T.CURRENT_FRAME
    if intra.any():
        imp = _IMPLIED_B[np.clip(arrays.ymode, 0, 3).astype(np.int64)]
        arrays.bmode[intra] = imp[intra][:, None, None]


def _patch_intra_host(arrays, recon, orig, quant_indices):
    """The host-patch variant: the macroblocks K9 scored intra encoded by
    the host intra encoder in raster order, B_PRED tried, each against the
    patched reconstruction of the earlier ones (inter neighbours are final
    already); ``recon`` and ``arrays`` are written in place.  Returns the
    patched (row, col) list."""
    q = {k: int(v) for k, v in quant_indices.quantizer().items()}
    rate_mult, dist_mult = rd_multipliers(q["y_ac"])
    planes = (orig.y, orig.u, orig.v)
    patched = []
    for r, c in zip(*np.nonzero(arrays.ref == T.CURRENT_FRAME)):
        encode_intra_mb(planes, recon, arrays, int(r), int(c), q, rate_mult,
                        dist_mult, interframe=True)
        patched.append((int(r), int(c)))
    return patched


def _scatter_patches(host, patched, recon):
    """The patched macroblocks of the host reconstruction ``host`` written
    into the device reconstruction ``recon`` in place (one indexed
    assignment a plane, the indices unique), so that the loop filter and
    the next reference see decode-exact pixels."""
    rc = torch.tensor(patched, dtype=torch.int64)
    for src, dst, n in ((host.y, recon.y, 16), (host.u, recon.u, 8),
                        (host.v, recon.v, 8)):
        R, C = dst.shape[0] // n, dst.shape[1] // n
        tiles = torch.from_numpy(src).view(R, n, C, n)[rc[:, 0], :, rc[:, 1]]
        dst.view(R, n, C, n)[rc[:, 0].to(dst.device), :,
                             rc[:, 1].to(dst.device)] = tiles.to(dst.device)


def _take_reclimb(encoder):
    """Advance the encoder's fast-frame counter (every fast encode does, a
    search's trial encodes too) and say whether this frame re-climbs the
    loop-filter level: the first one, every _LF_RECLIMB_PERIOD-th, or under
    segmentation."""
    n = encoder._fast_frame_no
    encoder._fast_frame_no = n + 1
    return (encoder.last_loop_filter_level is None
            or n % _LF_RECLIMB_PERIOD == 0
            or encoder.state.segmentation is not None)


def _finish_fast(encoder, header, arrays, recon, oy, update, reclimb):
    """The frame-level tail.  A re-climb frame is finish_interframe's; a
    steady frame filters the reconstruction once at the persisted level
    (one K5 call) and keeps the planes on the device as the next LAST, and
    reports the last SSIM.  Returns (payload, SSIM)."""
    if reclimb:
        return finish_interframe(encoder, header, arrays, recon, oy, update)
    from .encoder import calc_prob, worker_pool
    W, H = encoder.width, encoder.height
    refs = encoder.references
    header.prob_skip_false = calc_prob(int(arrays.has_nonzero.sum()),
                                       arrays.has_nonzero.size)
    arrays.skip_coeff[:] = ~arrays.has_nonzero
    n_intra = int((arrays.ref == T.CURRENT_FRAME).sum())
    n_last = int((arrays.ref == T.LAST_FRAME).sum())
    p = calc_prob(n_intra, arrays.ref.size)
    if p > 0:
        header.prob_inter = p
    p = calc_prob(n_last, n_last)
    if p > 0:
        header.prob_references_last = p

    counts_f = worker_pool().submit(count_token_branches, arrays)
    header.mode_lf_adjustments_enabled = True
    header.mode_lf_adjustments = ModeRefLFDeltaUpdate([0] * 4, [0] * 4)
    lf_level = encoder.last_loop_filter_level
    header.loop_filter_level = lf_level
    with tracing.stage("enc.fast_lf_device", sync=True):
        view = DecoderState(W, H, encoder.state.probability_tables, None,
                            FilterAdjustments.create(header))
        Y, U, V = encoder._filter_levels(header, arrays, view, recon,
                                         [lf_level], False)
    filtered = Raster(W, H, Y[0], U[0], V[0])
    with tracing.stage("enc.if_counts_join"):
        counts = counts_f.result()
    header.token_prob_update = optimize_token_probs(
        counts, encoder.state.probability_tables.coeff_probs)
    frame_probs = encoder.state.probability_tables.copy()
    frame_probs.update(header)
    with tracing.stage("enc.if_serialize"):
        payload = serialize_frame(header, arrays, frame_probs, False, W, H)
    if update:
        encoder.state.probability_tables = frame_probs.copy()
        encoder.state.filter_adjustments = FilterAdjustments.create(header)
        if header.update_segmentation is None:
            encoder.state.segmentation = None
        refs.last = filtered
        if header.refresh_golden_frame:
            refs.golden = filtered
        if header.refresh_alternate_frame:
            refs.alternative = filtered
        encoder.last_loop_filter_level = lf_level
    return payload, encoder.last_ssim


def _encode(encoders, yuv, quant_list, update):
    """Encode ``yuv`` once per (encoder, quantizer) pair in one fast_frame
    call; the encoders are in the same state, and each one's advances by
    its own frame when ``update``.  Returns [(payload, SSIM)]."""
    enc0 = encoders[0]
    if any(e.quality != "rt" for e in encoders):
        raise ValueError("the fast interframe encode is the rt design point")
    patch = enc0.fast_bpred
    if any(e.fast_bpred != patch for e in encoders):
        raise ValueError("the encoders of one fast call take one variant")
    # The JAX package's pair runs K10 under the host patch too and patches
    # over its output: a macroblock that then takes B_PRED keeps K10's Y2
    # block among its coefficients (not coded, but counted in
    # has_nonzero, so its skip flag and tokens differ).  The pair does the
    # same, to stay byte-identical; a single frame runs no K10.
    fixup = not patch or len(encoders) > 1
    W, H = enc0.width, enc0.height
    R, C = enc0.mb_rows, enc0.mb_cols
    with tracing.stage("enc.fast_inputs"):
        args = frame_inputs(enc0, yuv, quant_list)
        oy = args[0]
    with tracing.stage("enc.fast_kernel", sync=True):
        coeffs, modes, *recon = fast_frame(*args, fixup=fixup)
    reclimbs = [_take_reclimb(e) for e in encoders]
    with tracing.stage("enc.fast_fetch"):
        # one copy: the coefficients' bytes, the mode words' and, for the
        # host patch, the reconstruction's
        parts = [coeffs, modes] + (recon if patch else [])
        packed = torch.cat([t.reshape(-1).view(torch.uint8)
                            for t in parts]).cpu().numpy()
    host, off = [], 0
    for t, dt in zip(parts, (np.int16, np.int32) + (np.uint8,) * 3):
        n = t.numel() * t.element_size()
        host.append(packed[off:off + n].view(dt).reshape(t.shape))
        off += n
    co_h, md_h = host[0], host[1]
    if patch:
        from .encoder import _pad_raster
        orig = _pad_raster(*yuv, W, H)
    out = []
    with tracing.stage("enc.fast_host"):
        for i, (enc, qi) in enumerate(zip(encoders, quant_list)):
            header = make_inter_header(qi)
            arrays = _outputs_to_frame(co_h[i], md_h[i], R, C)
            frame = Raster(W, H, *(p[i] for p in recon))
            if not patch:
                _implied_bmodes(arrays)
            else:
                with tracing.stage("enc.fast_patch_host"):
                    patched_host = Raster(W, H, *(p[i] for p in host[2:]))
                    patched = _patch_intra_host(arrays, patched_host, orig,
                                                qi)
                    if patched:
                        _scatter_patches(patched_host, patched, frame)
                enc.patched_mbs = len(patched)
            out.append(_finish_fast(enc, header, arrays, frame, oy, update,
                                    reclimbs[i]))
    return out


def encode_interframe_fast(encoder, yuv, quant_indices, update):
    """Encode one rt interframe through the fast path (the encoder's
    variant: K10's fixup, or the host patch); returns (payload, SSIM) and
    advances the state when ``update``."""
    return _encode([encoder], yuv, [quant_indices], update)[0]


def encode_interframe_fast_multiqp(encoders, yuv, quant_list, update=True):
    """The Salsify speculative pair through the fast path
    (salsify-sender.cc:490-518): one fast_frame call over the quantizers,
    one K9 and one K10 call for all of them (the quantizer on the grid's
    second axis; in the host-patch variant too, as in the JAX package).  encoders: one rt Encoder fork
    per quantizer, all in the same state and variant.  Returns [(payload,
    SSIM)] in ``quant_list`` order."""
    return _encode(list(encoders), yuv, list(quant_list), update)
