"""Frame rebasing: the ExCamera core (reference encoder/reencode.cc), on
the encoder's device.

- ``reencode_as_interframe``: a chunk's leading key frame re-encoded as an
  interframe against inherited references (K8's full motion search).
- ``update_residues``: a prediction frame's modes and vectors reused
  verbatim, only the residues recomputed and requantized against the
  (drifted) references: every inter macroblock at once on the device
  (encoder/reencode_device.py: K3 and the residue kernel), then the intra
  macroblocks in raster order on the host, on host copies of the
  reconstruction planes (one copy each way, only in a frame that has one),
  their transforms and quantization in C (native/enckernel.cc).
- ``finish_frame``: the loop filter at the prediction's level (K5), the
  serializer, the state and reference update.
- ``reencode``: the chunk loop (kf_q_weight blending, extra-frame
  chunks, the last frame refreshing every reference).

Frames are byte-identical to the JAX package's encoder/reencode.py, whose
host and device paths agree (tests/test_rebase_device.py); the port has
one path, with the kernels' plain versions on a CPU device.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.bitstream.header import (InterFrameHeader,
                                                QuantIndices,
                                                UncompressedChunk)
from alfalfa_tpu_torch.decoder import reconstruct_np as RNP
from alfalfa_tpu_torch.decoder import reconstruct_torch
from alfalfa_tpu_torch.decoder.decoder import Decoder
from alfalfa_tpu_torch.decoder.parse import FrameArrays, FrameParser
from alfalfa_tpu_torch.state.decoder_state import (DecoderState,
                                                   FilterAdjustments,
                                                   ProbabilityTables, Raster)
from alfalfa_tpu_torch.util import tracing
from . import encode_inter, encode_intra_np, transforms_np as FX
from .reencode_device import apply_inter_residues_device
from .serializer import (count_token_branches, optimize_token_probs,
                         serialize_frame)


def _apply_intra_mb(orig, recon, arrays, r, c, q):
    """Re-apply the prediction's intra modes and requantize the residues
    (update_macroblock's intra paths, reencode.cc:131-160, 215-230).
    ``orig`` and ``recon``'s planes are host arrays."""
    oy, ou, ov = orig
    ymode = int(arrays.ymode[r, c])
    o16 = oy[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16]

    if ymode == T.B_PRED:
        for sr in range(4):
            for sc in range(4):
                col4, row4 = c * 4 + sc, r * 4 + sr
                osb = oy[row4 * 4:row4 * 4 + 4, col4 * 4:col4 * 4 + 4]
                pred = encode_intra_np._predict_b(
                    recon.y, col4, row4, int(arrays.bmode[r, c, sr, sc]))
                coeffs = FX.subtract_fdct(osb, pred)
                qc = FX.quantize(coeffs, q["y_dc"], q["y_ac"])
                arrays.coeffs[r, c, sr * 4 + sc] = qc
                dq = RNP.dequantize(qc, q["y_dc"], q["y_ac"])
                blk = recon.y[row4 * 4:row4 * 4 + 4, col4 * 4:col4 * 4 + 4]
                blk[:] = pred
                RNP.idct_add(dq, blk)
        arrays.y2_coded[r, c] = False
    else:
        pred = encode_intra_np._predict_whole(recon.y, c, r, 16, ymode)
        walsh_input = np.zeros(16, np.int16)
        for sr in range(4):
            for sc in range(4):
                osb = o16[sr * 4:sr * 4 + 4, sc * 4:sc * 4 + 4]
                psb = pred[sr * 4:sr * 4 + 4, sc * 4:sc * 4 + 4]
                coeffs = FX.subtract_fdct(osb, psb)
                walsh_input[sr * 4 + sc] = coeffs[0]
                coeffs[0] = 0
                arrays.coeffs[r, c, sr * 4 + sc] = FX.quantize(
                    coeffs, q["y_dc"], q["y_ac"])
        arrays.coeffs[r, c, 24] = FX.quantize(FX.fwht(walsh_input),
                                              q["y2_dc"], q["y2_ac"])
        arrays.y2_coded[r, c] = True
        recon.y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = pred
        RNP._apply_walsh(arrays, recon, r, c,
                         {k: np.int32(v) for k, v in q.items()})

    # chroma: the prediction's uv mode
    uvmode = int(arrays.uvmode[r, c])
    pu = encode_intra_np._predict_whole(recon.u, c, r, 8, uvmode)
    pv = encode_intra_np._predict_whole(recon.v, c, r, 8, uvmode)
    _requant_chroma(orig, recon, arrays, r, c, q, pu, pv)


def _requant_chroma(orig, recon, arrays, r, c, q, pu, pv):
    _, ou, ov = orig
    for plane, opl, ppl, base in ((recon.u, ou, pu, 16),
                                  (recon.v, ov, pv, 20)):
        for sr in range(2):
            for sc in range(2):
                osb = opl[r * 8 + sr * 4:r * 8 + sr * 4 + 4,
                          c * 8 + sc * 4:c * 8 + sc * 4 + 4]
                psb = ppl[sr * 4:sr * 4 + 4, sc * 4:sc * 4 + 4]
                qc = FX.quantize(FX.subtract_fdct(osb, psb), q["uv_dc"],
                                 q["uv_ac"])
                arrays.coeffs[r, c, base + sr * 2 + sc] = qc
                dq = RNP.dequantize(qc, q["uv_dc"], q["uv_ac"])
                blk = plane[r * 8 + sr * 4:r * 8 + sr * 4 + 4,
                            c * 8 + sc * 4:c * 8 + sc * 4 + 4]
                blk[:] = psb
                RNP.idct_add(dq, blk)


def _zero_raster(width, height, device):
    """A Raster of zeroed planes on ``device``: views of one buffer."""
    r = Raster(width, height)
    sizes = [p.size for p in (r.y, r.u, r.v)]
    buf = torch.zeros(sum(sizes), dtype=torch.uint8, device=device)
    planes = [t.view(p.shape) for t, p in zip(buf.split(sizes),
                                                (r.y, r.u, r.v))]
    return Raster(width, height, *planes)


def update_residues(encoder, orig_yuv, pred_header, pred_arrays,
                    quant_indices, last_frame):
    """Rebuild an interframe with the prediction frame's modes and vectors
    but fresh residues against the encoder's current references
    (reencode.cc:236-303).  Returns (header, arrays, frame probabilities,
    the unfiltered reconstruction as a Raster of device planes)."""
    from .encoder import _pad_raster, calc_prob

    W, H = encoder.width, encoder.height
    R_, C_ = encoder.mb_rows, encoder.mb_cols

    oh = pred_header
    header = InterFrameHeader()
    for field in ("update_segmentation", "filter_type", "loop_filter_level",
                  "sharpness_level", "mode_lf_adjustments",
                  "mode_lf_adjustments_enabled", "sign_bias_golden",
                  "sign_bias_alternate", "refresh_entropy_probs",
                  "prob_references_last", "prob_references_golden",
                  "prob_inter"):
        setattr(header, field, getattr(oh, field))
    if last_frame:
        header.refresh_last = True
        header.refresh_golden_frame = True
        header.refresh_alternate_frame = True
        header.copy_buffer_to_golden = None
        header.copy_buffer_to_alternate = None
    else:
        for field in ("refresh_last", "refresh_golden_frame",
                      "refresh_alternate_frame", "copy_buffer_to_golden",
                      "copy_buffer_to_alternate"):
            setattr(header, field, getattr(oh, field))
    header.quant_indices = quant_indices

    # the prediction frame's modes and vectors
    arrays = FrameArrays(R_, C_)
    for field in ("ymode", "uvmode", "ref", "bmode", "sub_mv", "uv_mv",
                  "splitmv_pid", "segment_update"):
        getattr(arrays, field)[:] = getattr(pred_arrays, field)

    q = {k: int(v) for k, v in quant_indices.quantizer().items()}
    with tracing.stage("rebase.inputs"):
        orig = _pad_raster(*orig_yuv, W, H)
        orig_dev = encoder._upload(orig)
        recon = _zero_raster(W, H, encoder.device)
    # every inter macroblock at once on the device; the intra ones in
    # raster order on the host, which reads what the inter ones left
    inter = apply_inter_residues_device(orig_dev, recon, arrays, q,
                                        encoder.references)
    intra = np.argwhere(~inter)
    if len(intra):
        with tracing.stage("rebase.intra_host"):
            planes = (recon.y, recon.u, recon.v)
            host = torch.cat([p.reshape(-1) for p in planes]).cpu().numpy()
            sizes = np.cumsum([p.numel() for p in planes])[:-1]
            host_recon = Raster(W, H, *(h.reshape(p.shape) for h, p in zip(
                np.split(host, sizes), planes)))
            oplanes = (orig.y, orig.u, orig.v)
            for r, c in intra:
                _apply_intra_mb(oplanes, host_recon, arrays, r, c, q)
                arrays.has_nonzero[r, c] = bool(arrays.coeffs[r, c].any())
            recon = Raster(W, H, *encoder._upload(host_recon))

    header.prob_skip_false = calc_prob(int(arrays.has_nonzero.sum()),
                                       arrays.has_nonzero.size)
    arrays.skip_coeff[:] = ~arrays.has_nonzero

    _optimize_ref_probs(header, arrays)
    counts = count_token_branches(arrays)
    header.token_prob_update = optimize_token_probs(
        counts, encoder.state.probability_tables.coeff_probs)
    frame_probs = encoder.state.probability_tables.copy()
    frame_probs.update(header)
    return header, arrays, frame_probs, recon


def _optimize_ref_probs(header, arrays):
    from .encoder import calc_prob
    n_intra, n_last, n_golden, n_alt = (
        int((arrays.ref == k).sum()) for k in (
            T.CURRENT_FRAME, T.LAST_FRAME, T.GOLDEN_FRAME, T.ALTREF_FRAME))
    p = calc_prob(n_intra, arrays.ref.size)
    if p > 0:
        header.prob_inter = p
    p = calc_prob(n_last, n_last + n_golden + n_alt)
    if p > 0:
        header.prob_references_last = p
    p = calc_prob(n_golden, n_golden + n_alt)
    if p > 0:
        header.prob_references_golden = p


def finish_frame(encoder, header, arrays, frame_probs, recon, orig_yuv):
    """write_frame's equivalent (encoder.cc:146-176): loop-filter the
    reconstruction at the header's level (one K5 call through
    ``Encoder._filter_levels``, the segmentation off, the header's
    adjustments), serialize, update the encoder's state and its
    references by the header's flags (the alternate's copy before the
    golden's, then the refreshes).  Returns the frame's bytes."""
    W, H = encoder.width, encoder.height
    lf_state = DecoderState(W, H, frame_probs, None,
                            FilterAdjustments.create(header)
                            if header.mode_lf_adjustments_enabled else None)
    with tracing.stage("rebase.lf", sync=True):
        Y, U, V = encoder._filter_levels(header, arrays, lf_state, recon,
                                         [header.loop_filter_level], False)
        filtered = Raster(W, H, Y[0], U[0], V[0])

    with tracing.stage("rebase.serialize"):
        payload = serialize_frame(header, arrays, frame_probs, False, W, H)

    # update_decoder_state + reference refresh
    if header.refresh_entropy_probs:
        encoder.state.probability_tables = frame_probs.copy()
    if header.mode_lf_adjustments_enabled:
        encoder.state.filter_adjustments = FilterAdjustments.create(header)
    else:
        encoder.state.filter_adjustments = None

    refs = encoder.references
    if header.copy_buffer_to_alternate == 1:
        refs.alternative = refs.last
    elif header.copy_buffer_to_alternate == 2:
        refs.alternative = refs.golden
    if header.copy_buffer_to_golden == 1:
        refs.golden = refs.last
    elif header.copy_buffer_to_golden == 2:
        refs.golden = refs.alternative
    if header.refresh_golden_frame:
        refs.golden = filtered
    if header.refresh_alternate_frame:
        refs.alternative = filtered
    if header.refresh_last:
        refs.last = filtered
    return payload


def reencode_as_interframe(encoder, orig_yuv, kf_header, quant_indices):
    """A key frame re-encoded as an interframe against the encoder's
    current (inherited) references (reencode.cc:37-129): K8's full inter
    encode with the key frame's sharpness and every reference refreshed."""
    payload, _ = encode_inter.encode_interframe(
        encoder, orig_yuv, quant_indices, update=True,
        rebase_kf_header=kf_header)
    return payload


def _keep_keyframe(encoder, header, arrays):
    """An interior key frame kept as it is: re-serialized against the
    default tables and the header's updates (parse and serialize are
    inverses), then decoded to advance the encoder's state and
    references like any decoder's.  Returns the frame's bytes."""
    fp = ProbabilityTables()
    fp.coeff_prob_update(header)
    payload = serialize_frame(header, arrays, fp, True, encoder.width,
                              encoder.height)
    d = Decoder(encoder.width, encoder.height, state=encoder.state,
                references=encoder.references, device=encoder.device)
    d.decode_frame(payload)
    encoder.state = d.state
    encoder.references = d.references
    return payload


def parse_prediction(payloads, decoder):
    """The prediction stream's frames as ``reencode`` takes them, [(key
    frame, header, FrameArrays)], decoded along by ``decoder`` (a
    Decoder in the stream's entry state), as the reference's xc-enc -r
    does."""
    out = []
    for payload in payloads:
        chunk = UncompressedChunk(payload, decoder.width, decoder.height)
        header, arrays, _ = FrameParser(decoder.state).parse(chunk)
        raster = reconstruct_torch.reconstruct(
            header, arrays, decoder.state, decoder.references,
            chunk.key_frame, device=decoder.device,
            staging=decoder._staging)
        decoder._update_references(chunk.key_frame, header, raster)
        out.append((chunk.key_frame, header, arrays))
    return out


def reencode(encoder, original_rasters, prediction_frames, kf_q_weight,
             extra_frame_chunk, ivf_writer):
    """The chunk rebase loop (reencode.cc:305-381).

    original_rasters: [(y, u, v)]; prediction_frames: [(key_frame, header,
    arrays)] parsed from the prediction stream (``parse_prediction``)."""
    if not original_rasters:
        raise ValueError("no rasters to re-encode")
    if len(original_rasters) != len(prediction_frames):
        raise ValueError("prediction/original_rasters mismatch")

    start = 1 if extra_frame_chunk else 0
    n = len(original_rasters)

    for i in range(start, n):
        target = original_rasters[i]
        last_frame = i == n - 1
        kf, header, arrays = prediction_frames[i]

        if i == start and kf:
            new_q = QuantIndices(**vars(header.quant_indices))
            if i + 1 < n and not prediction_frames[i + 1][0]:
                next_q = prediction_frames[i + 1][1].quant_indices.y_ac_qi
                new_q.y_ac_qi = int(round(
                    kf_q_weight * header.quant_indices.y_ac_qi
                    + (1 - kf_q_weight) * next_q))
            payload = reencode_as_interframe(encoder, target, header, new_q)
        elif i == start and extra_frame_chunk:
            if not prediction_frames[0][0]:
                raise ValueError("extra-frame chunks must start with a "
                                 "keyframe")
            new_q = QuantIndices(**vars(header.quant_indices))
            new_q.y_ac_qi = int(round(
                kf_q_weight * prediction_frames[0][1].quant_indices.y_ac_qi
                + (1 - kf_q_weight) * header.quant_indices.y_ac_qi))
            h, a, fp, recon = update_residues(encoder, target, header, arrays,
                                              new_q, last_frame)
            payload = finish_frame(encoder, h, a, fp, recon, target)
        elif kf:
            payload = _keep_keyframe(encoder, header, arrays)
        else:
            h, a, fp, recon = update_residues(encoder, target, header, arrays,
                                              header.quant_indices, last_frame)
            payload = finish_frame(encoder, h, a, fp, recon, target)

        ivf_writer.append_frame(payload)
