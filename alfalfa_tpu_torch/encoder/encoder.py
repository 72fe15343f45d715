"""Encoder: explicit-state VP8 encoder, every frame on the device.

Like the reference Encoder (encoder/encoder.hh:95-383), this carries
(DecoderState, References) and encodes each frame against them, inlining a
full decode so the references match what any decoder reconstructs.  Its
frames and minihashes are byte-identical to the JAX package's
``Encoder(device_encode=False)``.

Per frame: the padded planes go to ``device`` (default CUDA) in one
copy; the macroblock loop runs there (key frames: K7,
encoder/encode_intra.py; interframes: K8, encoder/encode_inter.py, against
the LAST reference where it lies on the device); the coefficients and
modes come back in one copy for the host's token counts and serializer;
the loop-filter search filters each chunk of candidate levels as one
batched K5 call and scores them with the SSIM on the device, and the
winning planes become the references without leaving it.

Modes: constant quantizer, minimum-SSIM search, target-size search;
quality "best" or "rt" (realtime: NEWMV searched on one macroblock in 16,
the loop-filter search a window around the last level), one-pass or
two-pass (the trellis).  ``fast=True`` with quality "rt" encodes
interframes through the fast path instead (encoder/encode_inter_fast.py:
K9 decisions, dense math, K10 intra fixup, the loop filter at the persisted
level), the Salsify sender's; it is byte-identical to the JAX package's
fast path (``ALFALFA_FAST_INTER=1``), not to the serial encoder.
``fast_bpred=True`` takes the fast path's host-patch variant instead of
K10 (the JAX package's ``ALFALFA_FAST_FIXUP=0`` with
``ALFALFA_FAST_BPRED=1``): the intra macroblocks are encoded by the host
intra encoder, which may take B_PRED.  Without B_PRED the JAX package's
host patch makes the same bytes as K10's fixup, so that variant is K10's.
"""
import copy as _copy

import numpy as np
import torch

from alfalfa_tpu_torch.bitstream.header import (KeyFrameHeader,
                                                ModeRefLFDeltaUpdate,
                                                QuantIndices)
from alfalfa_tpu_torch.decoder.lf_params import frame_lf_params
from alfalfa_tpu_torch.ops.lf_cuda import loop_filter
from alfalfa_tpu_torch.state import hashing
from alfalfa_tpu_torch.state.decoder_state import (DecoderState,
                                                   FilterAdjustments, Raster,
                                                   References)
from alfalfa_tpu_torch.util import tracing
from alfalfa_tpu_torch.util.ssim import ssim
from .costs import rd_multipliers
from .encode_inter import encode_interframe
from .encode_inter_fast import encode_interframe_fast
from .encode_intra import encode_keyframe
from .serializer import (count_token_branches, optimize_token_probs,
                         serialize_frame)

# candidate loop-filter levels filtered per batched K5 call; the level the
# search picks does not depend on it (break-on-first-drop runs over the
# results in order)
LF_CHUNK = 8


def _pad_raster(y, u, v, width, height):
    """(y, u, v) uint8 display planes -> a host Raster padded to whole
    macroblocks with zeros."""
    r = Raster(width, height)
    r.y[:y.shape[0], :y.shape[1]] = y
    r.u[:u.shape[0], :u.shape[1]] = u
    r.v[:v.shape[0], :v.shape[1]] = v
    return r


def calc_prob(false_count, total):
    """encoder.cc:48-55"""
    if false_count == 0:
        return 0
    return max(1, min(255, 256 * false_count // total))


_POOL = None


def worker_pool():
    """The thread that counts a frame's tokens while the loop-filter search
    runs (created once, not per frame)."""
    global _POOL
    if _POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _POOL = ThreadPoolExecutor(1)
    return _POOL


class Encoder:
    def __init__(self, width, height, quality="best", two_pass=False,
                 device=None, fast=False, fast_bpred=False):
        self.device = torch.device("cuda" if device is None else device)
        self.width, self.height = width, height
        self.mb_cols = (width + 15) // 16
        self.mb_rows = (height + 15) // 16
        with tracing.stage("enc.new"):
            self.state = DecoderState.initial(width, height)
            self.references = References.create(width, height).on_device(
                self.device)
        self.frame_no = 0
        self.quality = quality
        self.two_pass = two_pass
        self.last_loop_filter_level = None
        self.last_y_ac_qi = None  # seeds the target-size search window
        self.last_ssim = None     # reference encode_stats_.ssim parity
        self.fast = bool(fast)    # rt interframes through the fast path
        self._fast_frame_no = 0   # fast encodes so far (re-climb period)
        # the fast path's variant: K10's intra fixup, or the host patch
        # with B_PRED; patched_mbs counts the host-patched macroblocks of
        # the last host-patch frame
        self.fast_bpred = bool(fast_bpred)
        self.patched_mbs = 0

    # -- public API -----------------------------------------------------------

    def encode_with_quantizer(self, yuv, y_ac_qi, key_frame=None):
        """Encode one frame at a fixed quantizer index; returns the frame
        bytes and advances the encoder state."""
        if key_frame is None:
            key_frame = self.frame_no == 0
        qi = QuantIndices(y_ac_qi=int(y_ac_qi))
        with tracing.stage("enc.frame"):
            payload, quality = self._encode_frame(yuv, qi, key_frame,
                                                  update=True)
        self.frame_no += 1
        self.last_y_ac_qi = int(y_ac_qi)
        self.last_ssim = quality
        return payload

    def encode_with_target_size(self, yuv, target_size, key_frame=None):
        """Binary search on y_ac_qi for the largest frame <= target_size,
        using a 1/4 x 1/4 subsampled trial encode as the size estimator
        (encoder.cc:592-629). The search window is +-16 around the last
        frame's quantizer when known."""
        if key_frame is None:
            key_frame = self.frame_no == 0
        y_qi_min, y_qi_max = 4, 127
        if self.last_y_ac_qi is not None:
            radius = 16
            if self.last_y_ac_qi - radius >= y_qi_min:
                y_qi_min = self.last_y_ac_qi - radius
            y_qi_max = min(y_qi_max, self.last_y_ac_qi + radius)

        best_y_qi = None
        while y_qi_min <= y_qi_max:
            y_qi = (y_qi_min + y_qi_max) // 2
            estimated = self.estimate_frame_size(yuv, y_qi, key_frame)
            if estimated <= target_size or \
                    (y_qi_min == y_qi_max and best_y_qi is None):
                best_y_qi = y_qi
                y_qi_max = y_qi - 1
            else:
                y_qi_min = y_qi + 1
        return self.encode_with_quantizer(yuv, best_y_qi, key_frame=key_frame)

    # subsample factor per axis (encoder.hh:114-115): the trial encode sees
    # 1/16 of the macroblocks, so its size scales back by x16
    SAMPLE_FACTOR = 4

    def _mosaic(self, y, u, v, sub_rows, sub_cols):
        """Pack every SAMPLE_FACTOR-th macroblock tile into a small raster —
        our equivalent of the reference's macroblock_mapper subsampled frame
        (size_estimation.cc:37-42).  Numpy planes give numpy planes; tensor
        planes are cut by indexing where they lie."""
        f = self.SAMPLE_FACTOR

        def cut(plane, S):
            rows = (np.arange(sub_rows)[:, None] * f * S + np.arange(S)).ravel()
            cols = (np.arange(sub_cols)[:, None] * f * S + np.arange(S)).ravel()
            if isinstance(plane, torch.Tensor):
                rows, cols = (torch.from_numpy(i).to(plane.device)
                              for i in (rows, cols))
            return plane[rows[:, None], cols[None, :]]

        return cut(y, 16), cut(u, 8), cut(v, 8)

    def estimate_frame_size(self, yuv, y_ac_qi, key_frame=None):
        """Estimated compressed size at y_ac_qi from a subsampled trial
        encode (size_estimation.cc:35-181): encode a mosaic of every 4th
        macroblock (same references, subsampled the same way), scale x16."""
        if key_frame is None:
            key_frame = self.frame_no == 0
        sub, mosaic = self.trial_encoder(yuv, key_frame)
        qi = QuantIndices(y_ac_qi=int(y_ac_qi))
        payload, _ = sub._encode_frame(mosaic, qi, key_frame, update=False)
        return len(payload) * self.SAMPLE_FACTOR ** 2

    def trial_encoder(self, yuv, key_frame):
        """The size estimator's trial encoder and the mosaic planes it
        encodes: a fresh encoder of the mosaic's size on this encoder's
        device, and for an interframe this encoder's LAST cut the same way
        as its LAST, GOLDEN and ALTREF."""
        f = self.SAMPLE_FACTOR
        sub_rows = max(1, self.mb_rows // f)
        sub_cols = max(1, self.mb_cols // f)

        padded = _pad_raster(*yuv, self.width, self.height)
        my, mu, mv = self._mosaic(padded.y, padded.u, padded.v,
                                  sub_rows, sub_cols)
        # the trial encoder runs on this encoder's device, one pass
        sub = Encoder(sub_cols * 16, sub_rows * 16, quality=self.quality,
                      device=self.device, fast=self.fast,
                      fast_bpred=self.fast_bpred)
        if not key_frame:
            # the current state against mosaic references, cut where the
            # reference lies (on the card: no copy to the host)
            last = self.references.last
            ry, ru, rv = self._mosaic(last.y, last.u, last.v, sub_rows,
                                      sub_cols)
            sub.references.last = Raster(sub.width, sub.height, ry, ru, rv)
            sub.references.golden = sub.references.last
            sub.references.alternative = sub.references.last
            sub.frame_no = 1  # force interframe
        return sub, (my, mu, mv)

    def encode_with_minimum_ssim(self, yuv, minimum_ssim, key_frame=None):
        """Binary search on y_ac_qi for the target SSIM
        (encoder.cc:518-557)."""
        if key_frame is None:
            key_frame = self.frame_no == 0
        lo, hi = 0, 127
        found = False
        best_qi = 0
        while lo <= hi:
            qi = (lo + hi) // 2
            _, cur = self._encode_frame(yuv, QuantIndices(y_ac_qi=qi),
                                        key_frame, update=False)
            if cur >= minimum_ssim or (lo == hi and not found):
                found = True
                best_qi = qi
            if lo == hi:
                break
            if cur < minimum_ssim:
                hi = qi - 1
            else:
                lo = qi + 1
        payload, quality = self._encode_frame(
            yuv, QuantIndices(y_ac_qi=best_qi), key_frame, update=True)
        self.frame_no += 1
        self.last_y_ac_qi = best_qi
        self.last_ssim = quality
        return payload

    def fork(self):
        """Value-copy of the encoder. Salsify copies the encoder per
        speculative job and keeps a minihash-addressed map of past encoders
        (salsify-sender.cc:490-518, 357-379); references are immutable once
        installed, so a container-level copy suffices."""
        e = Encoder.__new__(Encoder)
        e.__dict__.update(self.__dict__)
        e.state = self.state.copy()
        e.references = self.references.copy()
        return e

    def minihash(self):
        return hashing.minihash(hashing.decoder_hash(
            self.state.hash(), self.references.last.hash(),
            self.references.golden.hash(), self.references.alternative.hash()))

    # -- core -----------------------------------------------------------------

    def _encode_frame(self, yuv, quant_indices, key_frame, update):
        if key_frame:
            return self._encode_keyframe(yuv, quant_indices, update)
        return self._encode_interframe(yuv, quant_indices, update)

    def _upload(self, raster):
        """The padded host planes on the device, in one copy."""
        planes = (raster.y, raster.u, raster.v)
        buf = torch.from_numpy(np.concatenate([p.reshape(-1) for p in planes]))
        buf = buf.to(self.device)
        out, off = [], 0
        for p in planes:
            out.append(buf[off:off + p.size].view(p.shape))
            off += p.size
        return tuple(out)

    def _encode_keyframe(self, yuv, quant_indices, update):
        header = KeyFrameHeader()
        header.quant_indices = quant_indices
        header.refresh_entropy_probs = True
        q = {k: int(v) for k, v in quant_indices.quantizer().items()}
        rate_mult, dist_mult = rd_multipliers(q["y_ac"])

        orig = self._upload(_pad_raster(*yuv, self.width, self.height))
        # two-pass: the host's first pass is recomputed from scratch by the
        # second, so one trellis-quantizing pass under the persisted
        # probabilities gives the same frame
        tp = (self.state.probability_tables.coeff_probs
              if self.two_pass else None)
        arrays, recon = encode_keyframe(orig, self.width, self.height, q,
                                        rate_mult, dist_mult,
                                        trellis_probs=tp)

        # skip flags + prob (encoder.cc:441-457, 657)
        no_skip = int(arrays.has_nonzero.sum())
        total = arrays.has_nonzero.size
        header.prob_skip_false = calc_prob(no_skip, total)
        arrays.skip_coeff[:] = ~arrays.has_nonzero

        # keyframes reset decoder state (update_decoder_state,
        # encode_intra.cc:36-46)
        new_state = DecoderState.from_keyframe_header(header, self.width,
                                                      self.height)

        # per-frame coefficient probability optimization
        # (encoder.cc:418-439): the native counting overlaps the loop-filter
        # search, which never reads the probability tables
        counts_f = worker_pool().submit(count_token_branches, arrays)
        with tracing.stage("enc.lf_search", sync=True):
            lf_level, filtered, lf_ssim = self._search_loopfilter(
                header, arrays, new_state, recon, orig[0], True)
        header.loop_filter_level = lf_level
        with tracing.stage("enc.token_counts_join"):
            counts = counts_f.result()
        header.token_prob_update = optimize_token_probs(
            counts, new_state.probability_tables.coeff_probs)
        frame_probs = new_state.probability_tables.copy()
        frame_probs.coeff_prob_update(header)

        with tracing.stage("enc.serialize"):
            payload = serialize_frame(header, arrays, frame_probs,
                                      True, self.width, self.height)
        quality = lf_ssim    # the search already scored the winner

        if update:
            self.state = new_state
            # refresh_entropy_probs=True persists the per-frame tables
            self.state.probability_tables = frame_probs.copy()
            self.references = References(filtered, filtered, filtered)
            self.last_loop_filter_level = lf_level
        return payload, quality

    def _encode_interframe(self, yuv, quant_indices, update):
        if self.fast and self.quality == "rt":
            # decisions (K9), dense math, intra fixup (K10) or the host
            # patch: the Salsify design point; a best-quality encoder
            # keeps K8
            return encode_interframe_fast(self, yuv, quant_indices, update)
        # the macroblock loop (census, motion search, mode decision,
        # residues, reconstruction) on the device, K8 with realtime=True in
        # "rt"; two-pass trellis-quantizes intra macroblocks
        return encode_interframe(self, yuv, quant_indices, update)

    # -- loop filter search (encoder.cc:459-516) -------------------------------

    def _filter_levels(self, header, arrays, state, recon, levels,
                       key_frame):
        """The unfiltered reconstruction loop-filtered at each of
        ``levels``: one batched K5 call, one batch entry per level (level
        0: the planes unfiltered), the frame broadcast over them, not
        copied.  Returns (G, H, W), (G, H/2, W/2), (G, H/2, W/2) uint8
        planes."""
        tracing.count("enc.lf_levels_filtered", len(levels))
        with tracing.stage("enc.lf_params"):
            per_level = []
            for level in levels:
                h = _copy.copy(header)
                h.loop_filter_level = level
                per_level.append(frame_lf_params(h, arrays, state, key_frame))
            lf = [torch.from_numpy(np.stack(x)).to(self.device)
                  for x in zip(*per_level)]
        G = len(levels)
        with tracing.stage("enc.lf_filter"):
            planes = [p.expand((G,) + p.shape)
                      for p in (recon.y, recon.u, recon.v)]
            return loop_filter(*planes, tuple(lf))

    def _search_loopfilter(self, header, arrays, state, recon, oy,
                           key_frame):
        """Hill-climb the loop filter level by SSIM vs the original; returns
        (level, filtered_raster, ssim). Starts near the last frame's level
        in realtime mode; full climb from 0 otherwise."""
        # the reference emits mode_lf_adjustments with explicit zero updates
        header.mode_lf_adjustments_enabled = True
        header.mode_lf_adjustments = ModeRefLFDeltaUpdate([0] * 4, [0] * 4)
        state.filter_adjustments = FilterAdjustments.create(header)

        # +-1 window around the previous level in realtime mode only: the
        # reference persists loop_filter_level_ solely under
        # REALTIME_QUALITY (encoder.cc:164-166, 477-487); best quality
        # re-climbs from 0 with break-on-first-drop every frame
        min_lf, max_lf = 0, 63
        if self.quality == "rt" and self.last_loop_filter_level is not None:
            min_lf = max(0, self.last_loop_filter_level - 1)
            max_lf = min(63, self.last_loop_filter_level + 1)

        dh, dw = self.height, self.width
        levels = list(range(min_lf, max_lf + 1))
        best = (-1.0, 0, None)
        climbed = 0     # levels compared, the first that did not improve too
        for base in range(0, len(levels), LF_CHUNK):
            chunk = levels[base:base + LF_CHUNK]
            Y, U, V = self._filter_levels(header, arrays, state, recon, chunk,
                                          key_frame)
            with tracing.stage("enc.lf_score"):
                scores = ssim(Y[:, :dh, :dw], oy[:dh, :dw]).tolist()
            stop = False
            # the reference's break-on-first-SSIM-drop, in level order: the
            # picked level is the serial climb's (encoder.cc:488)
            for g, (level, s) in enumerate(zip(chunk, scores)):
                climbed += 1
                if s > best[0]:
                    best = (s, level, (Y[g], U[g], V[g]))
                else:
                    stop = True
                    break
            if stop:
                break
        tracing.count("enc.lf_levels_climbed", climbed)
        s, level, planes = best
        filtered = Raster(self.width, self.height,
                          *(p.clone() for p in planes))
        return level, filtered, s
