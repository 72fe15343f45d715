"""Interframe encoding on the encoder's device: the host side of the K8
kernel (ops/enc_inter_cuda.py), and the frame-level tail it shares with
every interframe.

Per interframe: one upload of the padded original planes; the LAST
reference's planes are read where they lie, on the device (the encoder
installs the loop-filter search's winning planes there); the per-state cost
tables are built once per distinct set of mv probabilities and kept on the
device; K8 encodes every macroblock (motion search, mode decision,
residues, the unfiltered reconstruction); one device-to-host copy brings
the coefficients and mode words back for the token counts and the
serializer, and the reconstruction stays on the device for the loop-filter
search.  ``encode_interframe_multiqp`` encodes one raster at several
quantizers in one K8 call (the quantizer is a batch axis of the kernel):
the Salsify sender's speculative pair.

Host pieces taken from the JAX package's host encoder
(encoder/encode_inter_np.py): the SAD-per-bit and SAD mv-cost tables, the
mv component costs, the interframe header and the frame-level tail
(skip and reference probabilities, token counts overlapping the loop-filter
search, token probabilities, serializer, state update).  The JAX package's
device path (encode_inter_device.py) also keeps its references packed on
the TPU between frames (_lf_pack_fn, _cache_device_refs) and fetches the
coefficients sparsely (device_fetch.py); here the references are device
tensors already and the fetch is one dense copy, so neither has a
counterpart.
"""
import functools

import numpy as np
import torch

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.bitstream.header import InterFrameHeader
from alfalfa_tpu_torch.decoder.parse import FrameArrays
from alfalfa_tpu_torch.encoder.costs import (Costs, PROB_COST, cost_bit,
                                             rd_multipliers)
from alfalfa_tpu_torch.encoder.encode_intra import QUANT_KEYS
from alfalfa_tpu_torch.encoder.serializer import (count_token_branches,
                                                  optimize_token_probs,
                                                  serialize_frame)
from alfalfa_tpu_torch.encoder.trellis import token_costs_pm
from alfalfa_tpu_torch.ops.enc_inter import MODE_WORDS
from alfalfa_tpu_torch.ops.enc_inter_cuda import encode_inter_frame
from alfalfa_tpu_torch.state.decoder_state import (DecoderState,
                                                   FilterAdjustments, Raster)
from alfalfa_tpu_torch.util import tracing

_COSTS = Costs()

# libvpx:vp8/encoder/rdopt.c:135
SAD_PER_BIT16 = np.array([
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9,
    9, 9, 9, 9, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11,
    11, 11, 12, 12, 12, 12, 12, 12, 13, 13, 13, 13, 14, 14], np.int32)

# mv SAD costs (libvpx onyx_if.c:1698): index |v >> 2| clamped to 255; the
# float32 log2 gives the reference's integers
_MV_SAD_COST = np.zeros(256, np.int64)
_MV_SAD_COST[0] = 300
_i = np.arange(1, 256, dtype=np.float32)
_MV_SAD_COST[1:] = (256 * (2 * np.log2(8 * _i) + np.float32(0.6))).astype(np.int64)


def mv_component_costs(mv_probs):
    """mv_component_costs over persistent MV probabilities
    (costs.cc:113-132): ``[component, sign, |v|]``, (2, 2, 1024) uint32.
    K8 prices a NEWMV vector v as (costs[0, vy < 0, |vy|] + costs[1, vx < 0,
    |vx|]) * 96 // 128 (motion_vector_cost, costs.cc:222-226)."""
    table = np.zeros((2, 2, 1024), np.uint32)
    for comp in range(2):
        probs = mv_probs[comp]
        table[comp, :, 0] = _COSTS.mv_component_cost(0, probs)
        sign_cost0 = cost_bit(int(probs[1]), 0)
        sign_cost1 = cost_bit(int(probs[1]), 1)
        for i in range(1, 1024):
            # mv_component_cost already adds a sign-0 bit for nonzero
            c = _COSTS.mv_component_cost(i << 1, probs) - sign_cost0
            table[comp, 0, i] = c + sign_cost0
            table[comp, 1, i] = c + sign_cost1
    return table


def make_inter_header(quant_indices, rebase_kf_header=None):
    """The interframe header skeleton (reference encode_inter.cc:88-110).
    With ``rebase_kf_header`` it is a rebased chunk-leading frame: every
    reference refreshed, explicit default intra-mode probabilities
    (reencode.cc:50-72)."""
    header = InterFrameHeader()
    header.quant_indices = quant_indices
    header.refresh_entropy_probs = True
    header.refresh_last = True
    header.copy_buffer_to_golden = 0
    header.copy_buffer_to_alternate = 0
    header.prob_inter = 128
    header.prob_references_last = 128
    header.prob_references_golden = 128
    if rebase_kf_header is not None:
        header.refresh_golden_frame = True
        header.refresh_alternate_frame = True
        header.copy_buffer_to_golden = None
        header.copy_buffer_to_alternate = None
        header.sharpness_level = rebase_kf_header.sharpness_level
        header.intra_16x16_prob = [int(v) for v in T.DEFAULT_Y_MODE_PROBS]
        header.intra_chroma_prob = [int(v) for v in T.DEFAULT_UV_MODE_PROBS]
    return header


def finish_interframe(encoder, header, arrays, recon, oy, update):
    """Frame-level probability optimisation, loop-filter search,
    serialization and state update (encode_inter.cc:88-170).  ``recon``:
    the unfiltered reconstruction (device planes); ``oy``: the padded
    original luma on the device.  Returns (payload, SSIM)."""
    from .encoder import calc_prob, worker_pool
    W, H = encoder.width, encoder.height
    refs = encoder.references

    header.prob_skip_false = calc_prob(int(arrays.has_nonzero.sum()),
                                       arrays.has_nonzero.size)
    arrays.skip_coeff[:] = ~arrays.has_nonzero

    # reference probabilities (optimize_interframe_probs)
    n = [int((arrays.ref == k).sum()) for k in (T.CURRENT_FRAME, T.LAST_FRAME,
                                                 T.GOLDEN_FRAME,
                                                 T.ALTREF_FRAME)]
    p = calc_prob(n[0], arrays.ref.size)
    if p > 0:
        header.prob_inter = p
    p = calc_prob(n[1], n[1] + n[2] + n[3])
    if p > 0:
        header.prob_references_last = p
    p = calc_prob(n[2], n[2] + n[3])
    if p > 0:
        header.prob_references_golden = p

    # the native token counts overlap the loop-filter search, which reads
    # segmentation and adjustments only, never the probability tables
    counts_f = worker_pool().submit(count_token_branches, arrays)
    lf_state = DecoderState(W, H, encoder.state.probability_tables,
                            encoder.state.segmentation, None)
    with tracing.stage("enc.if_lf_search", sync=True):
        lf_level, filtered, lf_ssim = encoder._search_loopfilter(
            header, arrays, lf_state, recon, oy, False)
    header.loop_filter_level = lf_level
    with tracing.stage("enc.if_counts_join"):
        counts = counts_f.result()
    header.token_prob_update = optimize_token_probs(
        counts, encoder.state.probability_tables.coeff_probs)
    frame_probs = encoder.state.probability_tables.copy()
    frame_probs.update(header)

    with tracing.stage("enc.if_serialize"):
        payload = serialize_frame(header, arrays, frame_probs, False, W, H)

    if update:
        # update_decoder_state (encode_inter.cc:154-170)
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
    return payload, lf_ssim     # the search already scored the winner


@functools.lru_cache(maxsize=None)
def _tables(mv_probs_bytes, device):
    """The per-state cost tables on ``device``, int32: interframe macroblock
    mode costs, b-mode costs, MV_COUNTS_TO_PROBS, PROB_COST, the SAD mv
    costs and the (4, 1024) mv component costs [component * 2 + sign].
    Only the last depends on the state (its mv probabilities); entries are
    a few KB and kept for the life of the process."""
    mv_probs = np.frombuffer(mv_probs_bytes, np.uint8).reshape(2, -1)
    host = (np.asarray(_COSTS.mbmode_costs[1][:5]),
            np.asarray(_COSTS.inter_bmode_costs[:10]),
            np.asarray(T.MV_COUNTS_TO_PROBS), np.asarray(PROB_COST),
            _MV_SAD_COST, mv_component_costs(mv_probs).reshape(4, 1024))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
                 for a in host)


def inter_tables(encoder):
    mvp = np.ascontiguousarray(encoder.state.probability_tables.mv_probs,
                               np.uint8)
    return _tables(mvp.tobytes(), encoder.device)


def scalars_for(quant_indices):
    """One row of K8's scalars: the six quantizer factors, the RD
    multipliers and the SAD per bit of the quantizer index."""
    q = {k: int(v) for k, v in quant_indices.quantizer().items()}
    rate_mult, dist_mult = rd_multipliers(q["y_ac"])
    return [q[k] for k in QUANT_KEYS] + [
        rate_mult, dist_mult, int(SAD_PER_BIT16[int(quant_indices.y_ac_qi)])]


def _outputs_to_frame(coeffs, md, R, C):
    """K8's coefficients and mode words (host arrays) -> FrameArrays."""
    arrays = FrameArrays(R, C)
    arrays.coeffs[:] = coeffs
    ymode, is_inter = md[:, :, 0], md[:, :, 2] != 0
    arrays.ymode[:] = ymode
    arrays.uvmode[:] = md[:, :, 1]
    arrays.y2_coded[:] = is_inter | (ymode != T.B_PRED)
    arrays.has_nonzero[:] = md[:, :, 3] != 0
    arrays.bmode[:] = md[:, :, 8:24].reshape(R, C, 4, 4)
    arrays.ref[:] = np.where(is_inter, T.LAST_FRAME, T.CURRENT_FRAME)
    arrays.sub_mv[:] = md[:, :, None, None, 4:6]
    arrays.uv_mv[:] = md[:, :, None, None, 6:8]
    return arrays


def kernel_inputs(encoder, yuv, quant_list):
    """K8's arguments for the frame ``yuv`` against ``encoder``'s state at
    the quantizers ``quant_list``: the padded original planes (one upload),
    the LAST reference's planes on the device, the scalars, the cost
    tables, the realtime flag and, two-pass, the token costs."""
    from .encoder import _pad_raster
    W, H = encoder.width, encoder.height
    dev = encoder.device
    oy, ou, ov = encoder._upload(_pad_raster(*yuv, W, H))
    last = encoder.references.last.on_device(dev)
    scalars = torch.tensor([scalars_for(qi) for qi in quant_list],
                           dtype=torch.int32).to(dev)
    # two-pass: trellis-quantize intra macroblocks (the reference's
    # interframe path is first-pass only, encode_inter.cc:614-622; the JAX
    # package applies the trellis there as a documented superset)
    tc = None
    if encoder.two_pass:
        tc = torch.from_numpy(token_costs_pm(
            encoder.state.probability_tables.coeff_probs)).to(dev)
    return (oy, ou, ov, last.y, last.u, last.v, scalars,
            inter_tables(encoder), encoder.quality == "rt", tc)


def _encode(encoders, yuv, quant_list, update, rebase_kf_header=None):
    """Encode ``yuv`` once per (encoder, quantizer) pair in one K8 call.
    The encoders are in the same state; each one's state advances by its
    own frame when ``update``.  Returns [(payload, SSIM)]."""
    enc0 = encoders[0]
    W, H = enc0.width, enc0.height
    R, C = enc0.mb_rows, enc0.mb_cols
    with tracing.stage("enc.inter_inputs"):
        args = kernel_inputs(enc0, yuv, quant_list)
        oy = args[0]
    with tracing.stage("enc.inter_kernel", sync=True):
        coeffs, modes, y, u, v = encode_inter_frame(*args)
    with tracing.stage("enc.inter_fetch"):
        # one copy: the coefficients' bytes, then the mode words'
        packed = torch.cat([coeffs.reshape(-1).view(torch.uint8),
                            modes.reshape(-1).view(torch.uint8)]).cpu().numpy()
    n = coeffs.numel() * 2
    co_h = packed[:n].view(np.int16).reshape(-1, R, C, 25, 16)
    md_h = packed[n:].view(np.int32).reshape(-1, R, C, MODE_WORDS)
    out = []
    with tracing.stage("enc.inter_host"):
        for i, (enc, qi) in enumerate(zip(encoders, quant_list)):
            header = make_inter_header(qi, rebase_kf_header)
            arrays = _outputs_to_frame(co_h[i], md_h[i], R, C)
            out.append(finish_interframe(enc, header, arrays,
                                         Raster(W, H, y[i], u[i], v[i]), oy,
                                         update))
    return out


def encode_interframe(encoder, yuv, quant_indices, update,
                      rebase_kf_header=None):
    """Encode one interframe against ``encoder``'s state; returns
    (payload, SSIM) and advances the state when ``update``."""
    return _encode([encoder], yuv, [quant_indices], update,
                   rebase_kf_header)[0]


def encode_interframe_multiqp(encoders, yuv, quant_list, update=True):
    """Encode the same raster at several quantizers in one K8 call (the
    Salsify speculative pair, salsify-sender.cc:490-518): motion search and
    mode decision of every quantizer share the launches and the uploads.

    encoders: one Encoder fork per quantizer, all in the same state, all
    one-pass (as the JAX package's fused pair, which runs no trellis).
    Returns [(payload, SSIM)] in ``quant_list`` order; each fork's state
    advances by its own frame when ``update``."""
    if any(e.two_pass for e in encoders):
        raise ValueError("the fused quantizer pair is one-pass: its encoders "
                         "must not be two-pass")
    return _encode(list(encoders), yuv, list(quant_list), update)
