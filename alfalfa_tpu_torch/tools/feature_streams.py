"""VP8 streams that exercise decoder features the port's encoder never
emits, authored macroblock by macroblock: SPLITMV (every partition scheme
and sub-vector mode), segmentation with persistent maps and per-segment
deltas, golden/altref prediction with sign biases and the copy/refresh
semantics, several token partitions, and persistent probability updates.

    python -m alfalfa_tpu_torch.tools.feature_streams OUTDIR [--device cpu]

Four streams (4, 4, 6 and 5 frames, all shown): ``gen_splitmv``,
``gen_segmentation``, ``gen_goldalt`` and ``gen_probs``, each from its
seed, at 176x144 by default or at any ``size=(width, height)`` given
to the generators or ``write_all``; at a size off the 16-pixel grid the
macroblock grid is rounded up, as the parser rounds it, and the partial
macroblocks at the right and the bottom are authored like any other.  Each starts with a
key frame from the port's ``Encoder`` (on ``device``); every later frame
is built as parsed arrays, deriving each motion vector with the parser's
own census, clamp and sub-vector context rules (``decoder/parse.py``),
and serialized by ``encoder/serializer.py``, so parsing the bytes gives
back exactly the arrays set.  At 176x144 the bytes are the JAX package's
test generator's (``tests/gen_feature_streams.py``), which
``tests/test_torch_xc_tools.py`` checks.
"""
import os

import numpy as np

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.bitstream.header import (InterFrameHeader,
                                                QuantIndices,
                                                UpdateSegmentation,
                                                SegmentFeatureData,
                                                ModeRefLFDeltaUpdate,
                                                UncompressedChunk)
from alfalfa_tpu_torch.decoder.parse import (FrameArrays, FrameParser,
                                             mv_census, clamp_mv,
                                             luma_to_chroma)
from alfalfa_tpu_torch.encoder.encoder import Encoder
from alfalfa_tpu_torch.encoder.serializer import serialize_frame
from alfalfa_tpu_torch.state.decoder_state import DecoderState
from alfalfa_tpu_torch.util.ivf import IVFWriter

W, H = 176, 144
# the off-grid size: partial macroblocks at the right and the bottom (11 x
# 9 macroblocks, the last column 10 pixels wide, the last row 10 high)
OFFGRID_SIZE = (170, 138)


def _grid(width, height):
    """Macroblock rows and columns, rounded up as the parser rounds them."""
    return (height + 15) // 16, (width + 15) // 16


def _random_planes(seed, width, height):
    """Blocky seeded planes over the whole macroblock grid, cut to the
    display size."""
    rng = np.random.RandomState(seed)
    base = rng.randint(60, 196, _grid(width, height) + (3,)).astype(np.uint8)
    y = np.kron(base[:, :, 0], np.ones((16, 16), np.uint8))
    u = np.kron(base[:, :, 1], np.ones((8, 8), np.uint8))
    v = np.kron(base[:, :, 2], np.ones((8, 8), np.uint8))
    y = (y + rng.randint(-8, 8, y.shape)).clip(0, 255).astype(np.uint8)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    return (np.ascontiguousarray(y[:height, :width]),
            np.ascontiguousarray(u[:ch, :cw]),
            np.ascontiguousarray(v[:ch, :cw]))


class InterFrameBuilder:
    """Fills FrameArrays mode-by-mode, deriving MVs exactly as the parser
    would reconstruct them, so serialize(parse(x)) == x by construction."""

    def __init__(self, header, rng, rows, cols):
        self.h = header
        self.rng = rng
        self.R, self.C = rows, cols
        self.a = FrameArrays(rows, cols)
        self.flipped = np.zeros((rows, cols), bool)

    # -- helpers ---------------------------------------------------------

    def _flip_of(self, ref):
        return ((ref == T.GOLDEN_FRAME and self.h.sign_bias_golden)
                or (ref == T.ALTREF_FRAME and self.h.sign_bias_alternate))

    def _coeffs(self, r, c, scale=12, zero=False):
        a = self.a
        if zero:
            a.skip_coeff[r, c] = self.h.prob_skip_false is not None
            a.has_nonzero[r, c] = False
            return
        co = self.rng.randint(-scale, scale + 1, (25, 16)).astype(np.int16)
        if not a.y2_coded[r, c]:
            co[24] = 0      # no Y2 block
        else:
            co[0:16, 0] = 0  # Y blocks are parsed from coefficient 1
        # keep it sparse-ish so EOBs appear at many positions
        mask = self.rng.rand(25, 16) < 0.25
        co = np.where(mask, co, 0).astype(np.int16)
        a.coeffs[r, c] = co
        a.has_nonzero[r, c] = bool(co.any())

    def set_intra(self, r, c, ymode, uvmode, bmodes=None):
        a = self.a
        a.ref[r, c] = T.CURRENT_FRAME
        a.ymode[r, c] = ymode
        a.uvmode[r, c] = uvmode
        a.y2_coded[r, c] = ymode != T.B_PRED
        if ymode == T.B_PRED:
            a.bmode[r, c] = bmodes if bmodes is not None else \
                self.rng.randint(0, 10, (4, 4))
        a.sub_mv[r, c] = 0
        self._coeffs(r, c)

    def set_inter(self, r, c, ref, mode, delta=(0, 0), zero_coeffs=False):
        a = self.a
        a.ref[r, c] = ref
        flip = self._flip_of(ref)
        self.flipped[r, c] = flip
        best, nearest, near, _ = mv_census(a, self.flipped, r, c, flip)
        a.ymode[r, c] = mode
        a.y2_coded[r, c] = True
        if mode == T.NEARESTMV:
            base = clamp_mv(nearest, c, r, self.C, self.R)
        elif mode == T.NEARMV:
            base = clamp_mv(near, c, r, self.C, self.R)
        elif mode == T.ZEROMV:
            base = (0, 0)
        elif mode == T.NEWMV:
            cb = clamp_mv(best, c, r, self.C, self.R)
            base = (cb[0] + delta[0], cb[1] + delta[1])
        else:
            raise ValueError(mode)
        a.sub_mv[r, c, :, :, 0] = base[0]
        a.sub_mv[r, c, :, :, 1] = base[1]
        a.bmode[r, c] = 0
        self._uv(r, c)
        self._coeffs(r, c, zero=zero_coeffs)

    def set_splitmv(self, r, c, ref, pid, plan):
        """plan: list (one per partition) of (submode, delta) — submode in
        {LEFT4X4, ABOVE4X4, ZERO4X4, NEW4X4}; delta used for NEW4X4."""
        a = self.a
        a.ref[r, c] = ref
        flip = self._flip_of(ref)
        self.flipped[r, c] = flip
        best, _, _, _ = mv_census(a, self.flipped, r, c, flip)
        cb = clamp_mv(best, c, r, self.C, self.R)
        a.ymode[r, c] = T.SPLITMV
        a.y2_coded[r, c] = False
        a.splitmv_pid[r, c] = pid
        a.bmode[r, c] = 0

        parts = T.MV_PARTITIONS[pid]
        assert len(plan) == len(parts)
        for partition, (submode, delta) in zip(parts, plan):
            first_c, first_r = partition[0]
            sr, sc = first_r, first_c
            if sc > 0:
                left = tuple(a.sub_mv[r, c, sr, sc - 1])
            elif c > 0:
                left = tuple(a.sub_mv[r, c - 1, sr, 3])
            else:
                left = (0, 0)
            if sr > 0:
                above = tuple(a.sub_mv[r, c, sr - 1, sc])
            elif r > 0:
                above = tuple(a.sub_mv[r - 1, c, 3, sc])
            else:
                above = (0, 0)
            if submode == T.LEFT4X4:
                mv = left
            elif submode == T.ABOVE4X4:
                mv = above
            elif submode == T.ZERO4X4:
                mv = (0, 0)
            else:
                mv = (cb[0] + delta[0], cb[1] + delta[1])
            for pc, pr in partition:
                a.sub_mv[r, c, pr, pc] = mv
                a.bmode[r, c, pr, pc] = submode
        self._uv(r, c)
        self._coeffs(r, c)

    def _uv(self, r, c):
        a = self.a
        for ur in range(2):
            for uc in range(2):
                a.uv_mv[r, c, ur, uc] = luma_to_chroma(
                    tuple(a.sub_mv[r, c, ur * 2, uc * 2]),
                    tuple(a.sub_mv[r, c, ur * 2, uc * 2 + 1]),
                    tuple(a.sub_mv[r, c, ur * 2 + 1, uc * 2]),
                    tuple(a.sub_mv[r, c, ur * 2 + 1, uc * 2 + 1]))


def _advance(state, payload, size):
    """Parse the authored frame against the live state (advances probs /
    segmentation) and sanity-check parse(serialize) succeeded."""
    chunk = UncompressedChunk(payload, *size)
    FrameParser(state).parse(chunk)


def _base_header(**kw):
    h = InterFrameHeader(
        quant_indices=QuantIndices(y_ac_qi=40),
        loop_filter_level=24, sharpness_level=0,
        refresh_last=True,
        copy_buffer_to_golden=0, copy_buffer_to_alternate=0,
        prob_skip_false=160, prob_inter=160,
        prob_references_last=128, prob_references_golden=128)
    for k, v in kw.items():
        setattr(h, k, v)
    return h


def _start(seed, device, size):
    """Common start: keyframe via the real encoder, then a live state."""
    enc = Encoder(*size, device=device)
    kf = enc.encode_with_quantizer(_random_planes(seed, *size), 40,
                                   key_frame=True)
    state = DecoderState.initial(*size)
    _advance(state, kf, size)
    return kf, state


def _serialize(state, header, arrays, size):
    frame_probs = state.probability_tables.copy()
    frame_probs.update(header)
    return serialize_frame(header, arrays, frame_probs, False, *size)


def gen_splitmv(path, seed=11, device=None, size=(W, H)):
    """SPLITMV: all four partition schemes, all four sub-MV modes, mixed
    with NEW/NEAREST/NEAR/ZERO whole-MB modes and 2..8 token partitions."""
    rng = np.random.RandomState(seed)
    kf, state = _start(seed, device, size)
    R, C = _grid(*size)
    frames = [kf]

    for fno, log2parts in ((0, 1), (1, 2), (2, 3)):
        h = _base_header(log2_number_of_dct_partitions=log2parts)
        b = InterFrameBuilder(h, rng, R, C)
        modes = [T.ZEROMV, T.NEARESTMV, T.NEARMV, T.NEWMV]
        sub = [T.LEFT4X4, T.ABOVE4X4, T.ZERO4X4, T.NEW4X4]
        for r in range(R):
            for c in range(C):
                k = (r * C + c + fno) % 8
                if k < 3:
                    b.set_inter(r, c, T.LAST_FRAME, modes[k % 4],
                                delta=(rng.randint(-48, 48),
                                       rng.randint(-32, 32)))
                elif k == 3:
                    b.set_intra(r, c, rng.randint(0, 4), rng.randint(0, 4))
                else:
                    pid = (r + c + fno) % 4
                    nparts = len(T.MV_PARTITIONS[pid])
                    plan = [(sub[rng.randint(0, 4)],
                             (rng.randint(-40, 40), rng.randint(-24, 24)))
                            for _ in range(nparts)]
                    b.set_splitmv(r, c, T.LAST_FRAME, pid, plan)
        payload = _serialize(state, h, b.a, size)
        _advance(state, payload, size)
        frames.append(payload)
    _write_ivf(path, frames, size)


def gen_segmentation(path, seed=13, device=None, size=(W, H)):
    """Segmentation: map coded on frame 1 (persisting), absolute and
    relative per-segment quantizer + loop-filter deltas, map reuse on
    frame 2, map update on frame 3."""
    rng = np.random.RandomState(seed)
    kf, state = _start(seed, device, size)
    R, C = _grid(*size)
    frames = [kf]

    for fno in range(3):
        update_map = fno != 1
        seg = UpdateSegmentation(
            update_mb_segmentation_map=update_map,
            segment_feature_data=SegmentFeatureData(
                segment_feature_mode=(fno == 0),  # absolute on frame 0
                quantizer_update=[36, 52, 20, None][:4] if fno == 0
                else [4, -6, None, 8],
                loop_filter_update=[12, 40, None, 25] if fno == 0
                else [-8, 6, 2, None]),
            mb_segmentation_map=[200, 160, 140] if update_map else None)
        h = _base_header(update_segmentation=seg,
                         mode_lf_adjustments_enabled=True,
                         mode_lf_adjustments=ModeRefLFDeltaUpdate(
                             ref_update=[2, -2, None, 4],
                             mode_update=[1, None, -3, None])
                         if fno == 0 else None)
        b = InterFrameBuilder(h, rng, R, C)
        for r in range(R):
            for c in range(C):
                if update_map:
                    b.a.segment_update[r, c] = (r + c + fno) % 4
                k = (r + 2 * c) % 5
                if k == 0:
                    b.set_intra(r, c, rng.randint(0, 4), rng.randint(0, 4))
                else:
                    b.set_inter(r, c, T.LAST_FRAME,
                                [T.ZEROMV, T.NEARESTMV, T.NEWMV, T.NEARMV][k - 1],
                                delta=(rng.randint(-32, 32),
                                       rng.randint(-24, 24)),
                                zero_coeffs=(k == 4))
        payload = _serialize(state, h, b.a, size)
        _advance(state, payload, size)
        frames.append(payload)
    _write_ivf(path, frames, size)


def gen_goldalt(path, seed=17, device=None, size=(W, H)):
    """Golden/alternate prediction with sign-bias flips and the full
    refresh/copy semantics (frame.cc:271-307)."""
    rng = np.random.RandomState(seed)
    kf, state = _start(seed, device, size)
    R, C = _grid(*size)
    frames = [kf]

    configs = [
        dict(refresh_golden_frame=True, copy_buffer_to_golden=None),
        dict(sign_bias_golden=True, copy_buffer_to_alternate=1),
        dict(sign_bias_alternate=True, copy_buffer_to_golden=2),
        dict(refresh_alternate_frame=True, copy_buffer_to_alternate=None,
             sign_bias_golden=True, sign_bias_alternate=True),
        dict(refresh_last=False),
    ]
    for fno, cfg in enumerate(configs):
        h = _base_header(**cfg)
        b = InterFrameBuilder(h, rng, R, C)
        refs = [T.LAST_FRAME, T.GOLDEN_FRAME, T.ALTREF_FRAME]
        for r in range(R):
            for c in range(C):
                k = (3 * r + c + fno) % 6
                if k == 5:
                    b.set_intra(r, c, rng.randint(0, 4), rng.randint(0, 4))
                else:
                    b.set_inter(r, c, refs[k % 3],
                                [T.ZEROMV, T.NEWMV][k % 2],
                                delta=(rng.randint(-40, 40),
                                       rng.randint(-24, 24)))
        payload = _serialize(state, h, b.a, size)
        _advance(state, payload, size)
        frames.append(payload)
    _write_ivf(path, frames, size)


def gen_probs(path, seed=19, device=None, size=(W, H)):
    """Entropy-probability persistence: refresh_entropy_probs on/off with
    token, MV, and intra-mode probability updates."""
    rng = np.random.RandomState(seed)
    kf, state = _start(seed, device, size)
    R, C = _grid(*size)
    frames = [kf]

    for fno in range(4):
        token_up = {}
        for _ in range(20):
            key = (rng.randint(0, 4), rng.randint(0, 8), rng.randint(0, 3),
                   rng.randint(0, 11))
            token_up[key] = int(rng.randint(1, 255))
        mv_up = {(rng.randint(0, 2), rng.randint(0, 19)):
                 int(rng.randint(1, 127)) * 2 for _ in range(6)}
        h = _base_header(
            refresh_entropy_probs=fno % 2 == 0,
            token_prob_update=token_up,
            mv_prob_update=mv_up,
            intra_16x16_prob=[int(rng.randint(1, 255)) for _ in range(4)]
            if fno == 1 else None,
            intra_chroma_prob=[int(rng.randint(1, 255)) for _ in range(3)]
            if fno == 1 else None)
        b = InterFrameBuilder(h, rng, R, C)
        for r in range(R):
            for c in range(C):
                k = (r + c + fno) % 4
                if k == 0:
                    b.set_intra(r, c, rng.randint(0, 5), rng.randint(0, 4),
                                bmodes=rng.randint(0, 10, (4, 4)))
                else:
                    b.set_inter(r, c, T.LAST_FRAME,
                                [T.ZEROMV, T.NEARESTMV, T.NEWMV][k - 1],
                                delta=(rng.randint(-16, 16),
                                       rng.randint(-16, 16)))
        payload = _serialize(state, h, b.a, size)
        _advance(state, payload, size)
        frames.append(payload)
    _write_ivf(path, frames, size)


def _write_ivf(path, frames, size):
    w = IVFWriter(str(path), width=size[0], height=size[1], frame_rate=30,
                  time_scale=1)
    for f in frames:
        w.append_frame(f)
    w.close()


GENERATORS = {
    "feat_splitmv.ivf": gen_splitmv,
    "feat_segmentation.ivf": gen_segmentation,
    "feat_goldalt.ivf": gen_goldalt,
    "feat_probs.ivf": gen_probs,
}


def write_all(outdir, device=None, size=(W, H)):
    """Write the four streams at ``size`` into ``outdir``; returns {name:
    path}."""
    out = {}
    for name, gen in GENERATORS.items():
        out[name] = os.path.join(outdir, name)
        gen(out[name], device=device, size=size)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default=".")
    ap.add_argument("--device", default=None,
                    help="the key frames' encoder (default: CUDA)")
    args = ap.parse_args()
    for name in write_all(args.outdir, args.device):
        print("wrote", name)
