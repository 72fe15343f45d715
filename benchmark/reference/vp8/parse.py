"""Frame parsing: VP8 bitstream -> dense per-frame arrays.

The entropy layer is inherently bit-serial, so it runs on the host; its
output is a ``FrameArrays`` bundle of dense tensors that the (numpy or JAX)
reconstruction consumes.  This is the TPU-first analogue of the reference's
``Frame``/``Macroblock`` object graph (frame.cc, macroblock.cc): identical
bitstream semantics, array-of-structs replaced by dense structure-of-arrays.

Reference call-stack parity: SURVEY.md section 3.1;
DecoderState::parse_and_apply (decoder_state.hh:72-167),
Macroblock ctor + decode_prediction_modes (macroblock.cc:43-456),
Block::parse_tokens (tokens.cc:50-135).
"""
from dataclasses import dataclass

import numpy as np

from . import tables as T
from .boolcoder import BoolDecoder
from .tokens import parse_tokens
from .header import (KeyFrameHeader, InterFrameHeader,
                                          UncompressedChunk,
                                          CORRUPTED_FIRST_PARTITION,
                                          CORRUPTED_RESIDUES)

# coefficient-plane block indices within an MB: 16 Y blocks in raster order,
# then 4 U, 4 V, then Y2 last
Y_BASE, U_BASE, V_BASE, Y2_IDX = 0, 16, 20, 24


@dataclass
class FrameArrays:
    """Dense per-frame parse output (structure-of-arrays over macroblocks)."""
    mb_rows: int
    mb_cols: int
    # per macroblock
    ymode: np.ndarray = None        # i8 (r, c): mbmode
    uvmode: np.ndarray = None       # i8 (r, c)
    ref: np.ndarray = None          # i8 (r, c): 0 intra, 1 last, 2 golden, 3 alt
    segment: np.ndarray = None      # u8 (r, c)
    skip_coeff: np.ndarray = None   # bool (r, c): mb_skip_coeff flag
    has_nonzero: np.ndarray = None  # bool (r, c)
    y2_coded: np.ndarray = None     # bool (r, c)
    # per subblock
    bmode: np.ndarray = None        # i8 (r, c, 4, 4): bmode / inter submv mode
    sub_mv: np.ndarray = None       # i16 (r, c, 4, 4, 2): (x, y) per Y subblock
    uv_mv: np.ndarray = None        # i16 (r, c, 2, 2, 2): (x, y) per chroma subblock
    coeffs: np.ndarray = None       # i16 (r, c, 25, 16) raster (de-zigzagged) order
    splitmv_pid: np.ndarray = None  # i8 (r, c): SPLITMV partition scheme, -1 if n/a
    segment_update: np.ndarray = None  # i16 (r, c): coded segment id, -1 if none

    def __post_init__(self):
        r, c = self.mb_rows, self.mb_cols
        if self.ymode is None:
            self.ymode = np.zeros((r, c), np.int8)
            self.uvmode = np.zeros((r, c), np.int8)
            self.ref = np.zeros((r, c), np.int8)
            self.segment = np.zeros((r, c), np.uint8)
            self.skip_coeff = np.zeros((r, c), bool)
            self.has_nonzero = np.zeros((r, c), bool)
            self.y2_coded = np.zeros((r, c), bool)
            self.bmode = np.zeros((r, c, 4, 4), np.int8)
            self.sub_mv = np.zeros((r, c, 4, 4, 2), np.int16)
            self.uv_mv = np.zeros((r, c, 2, 2, 2), np.int16)
            self.splitmv_pid = np.full((r, c), -1, np.int8)
            self.segment_update = np.full((r, c), -1, np.int16)


def _read_mv_component(bd, probs):
    """One MV component in quarter-pel units x2 (libvpx dixie semantics;
    reference macroblock.cc:197-229)."""
    IS_SHORT, SIGN, SHORT, BITS = 0, 1, 2, 9
    if bd.get(probs[IS_SHORT]):
        x = 0
        for i in range(3):
            x += bd.get(probs[BITS + i]) << i
        for i in range(9, 3, -1):
            x += bd.get(probs[BITS + i]) << i
        if not (x & 0xFFF0) or bd.get(probs[BITS + 3]):
            x += 8
    else:
        x = bd.tree(T.SMALL_MV_TREE, probs[SHORT:SHORT + 7])
    x <<= 1
    if x and bd.get(probs[SIGN]):
        x = -x
    return x


def read_mv(bd, mv_probs):
    """(x, y); y is coded first."""
    y = _read_mv_component(bd, mv_probs[0])
    x = _read_mv_component(bd, mv_probs[1])
    return x, y


def clamp_mv(mv, col, row, mb_cols, mb_rows):
    """Clamp an MV so the predicted block stays within 1 MB + margin of the
    frame (reference macroblock.cc:176-195)."""
    x, y = mv
    to_left = -(col * 16 << 3) - 128
    to_right = ((mb_cols - 1 - col) * 16 << 3) + 128
    to_top = -(row * 16 << 3) - 128
    to_bottom = ((mb_rows - 1 - row) * 16 << 3) + 128
    return (min(max(x, to_left), to_right), min(max(y, to_top), to_bottom))


def luma_to_chroma(mv1, mv2, mv3, mv4):
    x = mv1[0] + mv2[0] + mv3[0] + mv4[0]
    y = mv1[1] + mv2[1] + mv3[1] + mv4[1]
    cx = (x + 4) >> 3 if x >= 0 else -((-x + 4) >> 3)
    cy = (y + 4) >> 3 if y >= 0 else -((-y + 4) >> 3)
    return cx, cy


_IMPLIED_BMODE = {T.DC_PRED: T.B_DC_PRED, T.V_PRED: T.B_VE_PRED,
                  T.H_PRED: T.B_HE_PRED, T.TM_PRED: T.B_TM_PRED}


def mv_census(arrays, flipped_map, r, c, flipped):
    """Motion-vector census over above/left/above-left neighbors
    (scorer.hh:36-79, macroblock.cc:144-172, 301-312).

    Returns (best, nearest, near, mode_context[4])."""
    scores = [0, 0, 0, 0]
    mvs = [(0, 0), (0, 0), (0, 0), (0, 0)]
    splitmv_score = 0
    index = 0

    def add(score, rr, cc):
        nonlocal index, splitmv_score
        if rr < 0 or cc < 0:
            return
        if arrays.ref[rr, cc] == T.CURRENT_FRAME:
            return
        mv = (int(arrays.sub_mv[rr, cc, 3, 3, 0]), int(arrays.sub_mv[rr, cc, 3, 3, 1]))
        if bool(flipped_map[rr, cc]) != flipped:
            mv = (-mv[0], -mv[1])
        if mv == (0, 0):
            scores[0] += score
        else:
            if mv != mvs[index]:
                index += 1
                mvs[index] = mv
            scores[index] += score
        if arrays.ymode[rr, cc] == T.SPLITMV:
            splitmv_score += score

    add(2, r - 1, c)
    add(2, r, c - 1)
    add(1, r - 1, c - 1)

    # Scorer::calculate (macroblock.cc:156-172)
    if scores[3]:
        if mvs[index] == mvs[1]:
            scores[1] += scores[3]
    if scores[2] > scores[1]:
        scores[1], scores[2] = scores[2], scores[1]
        mvs[1], mvs[2] = mvs[2], mvs[1]
    if scores[1] >= scores[0]:
        mvs[0] = mvs[1]

    return mvs[0], mvs[1], mvs[2], (scores[0], scores[1], scores[2], splitmv_score)


def flipped_map_for(arrays, header):
    """Per-MB motion_vectors_flipped_ flags from reference + sign biases."""
    return (((arrays.ref == T.GOLDEN_FRAME) & header.sign_bias_golden)
            | ((arrays.ref == T.ALTREF_FRAME) & header.sign_bias_alternate))


class FrameParser:
    """Parses one frame against a DecoderState; mutates the state exactly as
    DecoderState::parse_and_apply does (prob persistence, segmentation map)."""

    def __init__(self, state):
        self.state = state
        self.mb_cols = (state.width + 15) // 16
        self.mb_rows = (state.height + 15) // 16

    # -- top level ---------------------------------------------------------

    def parse(self, chunk: UncompressedChunk):
        """Returns (header, FrameArrays, frame_probability_tables)."""
        header, frame_probs, bd = self.parse_header_phase(chunk)
        if chunk.key_frame:
            arrays = self._parse_macroblock_headers(bd, header, frame_probs,
                                                    key_frame=True,
                                                    error_concealment=False)
        else:
            arrays = self._parse_macroblock_headers(
                bd, header, frame_probs, key_frame=False,
                error_concealment=(chunk.corruption_level
                                   > CORRUPTED_RESIDUES))
        self._apply_segmentation_map(arrays)
        self._parse_tokens(chunk, header, arrays, frame_probs)
        return header, arrays, frame_probs

    def _parse_header_fields(self, chunk, key_frame):
        """Frame-header grammar walk: one native C call on clean chunks
        (bitwork.vp8_parse_frame_header), the declarative Python parse
        otherwise.  Returns (header, bd) with bd at the MB headers."""
        complete = chunk.corruption_level < CORRUPTED_FIRST_PARTITION
        bd = BoolDecoder(chunk.first_partition, complete)
        cls = KeyFrameHeader if key_frame else InterFrameHeader
        return cls.parse(bd), bd

    def parse_header_phase(self, chunk):
        """Frame header + persistent-state updates only; returns (header,
        frame_probs, bd) with ``bd`` positioned at the MB headers.  The
        GOP-batched decoder uses this split to run the MB-header parse of
        G frames interleaved in one native call."""
        if chunk.key_frame:
            if chunk.experimental:
                raise ValueError("experimental key frame")
            header, bd = self._parse_header_fields(chunk, key_frame=True)

            # keyframe resets all persistent state
            from .decoder_state import DecoderState
            st = DecoderState.from_keyframe_header(header, self.state.width,
                                                   self.state.height)
            self.state.probability_tables = st.probability_tables
            self.state.segmentation = st.segmentation
            self.state.filter_adjustments = st.filter_adjustments

            frame_probs = self.state.probability_tables.copy()
            frame_probs.coeff_prob_update(header)
            if header.refresh_entropy_probs:
                self.state.probability_tables = frame_probs.copy()
            return header, frame_probs, bd

        header, bd = self._parse_header_fields(chunk, key_frame=False)

        frame_probs = self.state.probability_tables.copy()
        frame_probs.update(header)
        if header.refresh_entropy_probs:
            self.state.probability_tables = frame_probs.copy()

        # filter adjustments persistence (decoder_state.hh:135-144)
        from .decoder_state import FilterAdjustments, Segmentation
        if header.mode_lf_adjustments_enabled:
            if self.state.filter_adjustments is not None:
                self.state.filter_adjustments.update(header)
            else:
                self.state.filter_adjustments = FilterAdjustments.create(header)
        else:
            self.state.filter_adjustments = None

        # segmentation persistence (decoder_state.hh:146-156)
        if header.update_segmentation is not None:
            if self.state.segmentation is not None:
                self.state.segmentation.update(header)
            else:
                self.state.segmentation = Segmentation.create(
                    self.state.width, self.state.height, header)
        else:
            self.state.segmentation = None
        return header, frame_probs, bd

    # -- macroblock headers --------------------------------------------------

    def _parse_macroblock_headers(self, bd, header, frame_probs, key_frame,
                                  error_concealment):
        arrays = FrameArrays(self.mb_rows, self.mb_cols)
        # segment-id updates are only remembered in the arrays; the persistent
        # map is applied afterwards (two-phase update, frame.cc:115-119)
        self._segment_updates = arrays.segment_update

        seg_tree_probs = ([255, 255, 255] if header.update_segmentation is None
                          else header.update_segmentation.segment_tree_probs())
        read_segment_id = (header.update_segmentation is not None
                           and header.update_segmentation.update_mb_segmentation_map)

        # per-subblock intra-mode context for keyframe B_PRED parsing
        self._bmode_above = np.full((self.mb_cols * 4,), T.B_DC_PRED, np.int8)

        for r in range(self.mb_rows):
            self._bmode_left = np.full(4, T.B_DC_PRED, np.int8)
            for c in range(self.mb_cols):
                self._parse_one_mb_header(bd, header, frame_probs, arrays,
                                          r, c, key_frame, read_segment_id,
                                          seg_tree_probs, error_concealment)
        return arrays

    def _parse_one_mb_header(self, bd, header, frame_probs, arrays, r, c,
                             key_frame, read_segment_id, seg_tree_probs,
                             error_concealment):
        concealed = error_concealment and not bd.valid

        if read_segment_id and not concealed:
            self._segment_updates[r, c] = bd.tree(T.SEGMENT_ID_TREE, seg_tree_probs)

        if header.prob_skip_false is not None and not concealed:
            arrays.skip_coeff[r, c] = bool(bd.get(header.prob_skip_false))

        if key_frame:
            self._parse_kf_modes(bd, arrays, r, c)
            return

        # inter MB header (macroblock.cc:456-476)
        if concealed:
            is_inter, ref = True, T.LAST_FRAME
            flipped = False
        else:
            is_inter = bool(bd.get(header.prob_inter))
            ref = T.CURRENT_FRAME
            if is_inter:
                if bd.get(header.prob_references_last):
                    ref = (T.ALTREF_FRAME if bd.get(header.prob_references_golden)
                           else T.GOLDEN_FRAME)
                else:
                    ref = T.LAST_FRAME
            flipped = ((ref == T.GOLDEN_FRAME and header.sign_bias_golden)
                       or (ref == T.ALTREF_FRAME and header.sign_bias_alternate))
        arrays.ref[r, c] = ref

        if not is_inter:
            self._parse_inter_intra_modes(bd, frame_probs, arrays, r, c)
            return

        self._parse_inter_modes(bd, header, frame_probs, arrays, r, c,
                                flipped, concealed)

    def _parse_kf_modes(self, bd, arrays, r, c):
        ymode = bd.tree(T.KF_Y_MODE_TREE, T.KF_Y_MODE_PROBS)
        arrays.ymode[r, c] = ymode
        if ymode == T.B_PRED:
            for sr in range(4):
                for sc in range(4):
                    # contexts: neighbor subblocks in the frame subblock grid
                    if sr > 0:
                        above = arrays.bmode[r, c, sr - 1, sc]
                    else:
                        above = self._bmode_above[c * 4 + sc]
                    if sc > 0:
                        left = arrays.bmode[r, c, sr, sc - 1]
                    elif c > 0:
                        left = arrays.bmode[r, c - 1, sr, 3]
                    else:
                        left = self._bmode_left[sr]
                    b = bd.tree(T.B_MODE_TREE, T.KF_B_MODE_PROBS[above][left])
                    arrays.bmode[r, c, sr, sc] = b
        else:
            arrays.bmode[r, c, :, :] = _IMPLIED_BMODE[ymode]
        self._bmode_above[c * 4:c * 4 + 4] = arrays.bmode[r, c, 3, :]
        self._bmode_left[:] = arrays.bmode[r, c, :, 3]
        arrays.uvmode[r, c] = bd.tree(T.UV_MODE_TREE, T.KF_UV_MODE_PROBS)
        arrays.y2_coded[r, c] = arrays.ymode[r, c] != T.B_PRED

    def _parse_inter_intra_modes(self, bd, frame_probs, arrays, r, c):
        """Intra MB inside an interframe (macroblock.cc:349-371)."""
        ymode = bd.tree(T.Y_MODE_TREE, frame_probs.y_mode_probs)
        arrays.ymode[r, c] = ymode
        if ymode == T.B_PRED:
            for sr in range(4):
                for sc in range(4):
                    arrays.bmode[r, c, sr, sc] = bd.tree(T.B_MODE_TREE,
                                                         T.INVARIANT_B_MODE_PROBS)
        else:
            arrays.bmode[r, c, :, :] = _IMPLIED_BMODE[ymode]
        # maintain keyframe-style contexts (harmless for interframes)
        self._bmode_above[c * 4:c * 4 + 4] = arrays.bmode[r, c, 3, :]
        self._bmode_left[:] = arrays.bmode[r, c, :, 3]
        arrays.uvmode[r, c] = bd.tree(T.UV_MODE_TREE, frame_probs.uv_mode_probs)
        arrays.y2_coded[r, c] = ymode != T.B_PRED

    # -- inter modes ---------------------------------------------------------

    def _census(self, arrays, r, c, flipped):
        return mv_census(arrays, self._flipped, r, c, flipped)

    def _parse_inter_modes(self, bd, header, frame_probs, arrays, r, c,
                           flipped, concealed):
        self._flipped[r, c] = flipped
        best, nearest, near, counts = self._census(arrays, r, c, flipped)

        mv_ref_probs = [T.MV_COUNTS_TO_PROBS[counts[0]][0],
                        T.MV_COUNTS_TO_PROBS[counts[1]][1],
                        T.MV_COUNTS_TO_PROBS[counts[2]][2],
                        T.MV_COUNTS_TO_PROBS[counts[3]][3]]

        if concealed:
            ymode = T.ZEROMV
        else:
            ymode = bd.tree(T.MV_REF_TREE, mv_ref_probs)
        arrays.ymode[r, c] = ymode
        arrays.y2_coded[r, c] = ymode != T.SPLITMV

        if ymode == T.NEARESTMV:
            base = clamp_mv(nearest, c, r, self.mb_cols, self.mb_rows)
        elif ymode == T.NEARMV:
            base = clamp_mv(near, c, r, self.mb_cols, self.mb_rows)
        elif ymode == T.ZEROMV:
            base = (0, 0)
        elif ymode == T.NEWMV:
            dx, dy = read_mv(bd, frame_probs.mv_probs)
            cb = clamp_mv(best, c, r, self.mb_cols, self.mb_rows)
            base = (dx + cb[0], dy + cb[1])
        elif ymode == T.SPLITMV:
            self._parse_splitmv(bd, frame_probs, arrays, r, c,
                                clamp_mv(best, c, r, self.mb_cols, self.mb_rows))
            base = None
        else:
            raise ValueError("bad mv_ref mode")

        if base is not None:
            arrays.sub_mv[r, c, :, :, 0] = base[0]
            arrays.sub_mv[r, c, :, :, 1] = base[1]
            arrays.bmode[r, c, :, :] = 0

        # chroma MVs from the average of 2x2 luma subblocks
        for ur in range(2):
            for uc in range(2):
                arrays.uv_mv[r, c, ur, uc] = luma_to_chroma(
                    tuple(arrays.sub_mv[r, c, ur * 2, uc * 2]),
                    tuple(arrays.sub_mv[r, c, ur * 2, uc * 2 + 1]),
                    tuple(arrays.sub_mv[r, c, ur * 2 + 1, uc * 2]),
                    tuple(arrays.sub_mv[r, c, ur * 2 + 1, uc * 2 + 1]))

    def _parse_splitmv(self, bd, frame_probs, arrays, r, c, best):
        partition_id = bd.tree(T.SPLIT_MV_TREE, T.SPLIT_MV_PROBS)
        arrays.bmode[r, c, :, :] = 0
        arrays.splitmv_pid[r, c] = partition_id

        for partition in T.MV_PARTITIONS[partition_id]:
            first_c, first_r = partition[0]

            # sub-MV context from neighboring subblocks (macroblock.cc:230-280)
            sr, sc = first_r, first_c
            if sc > 0:
                left = tuple(arrays.sub_mv[r, c, sr, sc - 1])
            elif c > 0:
                left = tuple(arrays.sub_mv[r, c - 1, sr, 3])
            else:
                left = (0, 0)
            if sr > 0:
                above = tuple(arrays.sub_mv[r, c, sr - 1, sc])
            elif r > 0:
                above = tuple(arrays.sub_mv[r - 1, c, 3, sc])
            else:
                above = (0, 0)

            left_zero, above_zero = left == (0, 0), above == (0, 0)
            if left == above and left_zero:
                ctx = 4
            elif left == above:
                ctx = 3
            elif above_zero:
                ctx = 2
            elif left_zero:
                ctx = 1
            else:
                ctx = 0

            submode = bd.tree(T.SUBMV_REF_TREE, T.SUBMV_REF_PROBS2[ctx])
            if submode == T.LEFT4X4:
                mv = left
            elif submode == T.ABOVE4X4:
                mv = above
            elif submode == T.ZERO4X4:
                mv = (0, 0)
            else:  # NEW4X4
                dx, dy = read_mv(bd, frame_probs.mv_probs)
                mv = (dx + best[0], dy + best[1])

            for pc, pr in partition:
                arrays.bmode[r, c, pr, pc] = submode
                arrays.sub_mv[r, c, pr, pc] = mv

    # -- segmentation map ------------------------------------------------------

    def _apply_segmentation_map(self, arrays):
        seg = self.state.segmentation
        if seg is None:
            return
        upd = self._segment_updates
        for r in range(self.mb_rows):
            for c in range(self.mb_cols):
                if upd[r, c] >= 0:
                    seg.map[r, c] = upd[r, c]
                arrays.segment[r, c] = seg.map[r, c]

    # -- tokens -----------------------------------------------------------------

    def _parse_tokens(self, chunk, header, arrays, frame_probs):
        parts = chunk.dct_partitions(1 << header.log2_number_of_dct_partitions)
        arrays.coeffs, arrays.has_nonzero = parse_tokens(
            parts, self.mb_rows, self.mb_cols, frame_probs.coeff_probs,
            arrays.skip_coeff, arrays.y2_coded)


    # storage initialized lazily per parse
    @property
    def _flipped(self):
        if not hasattr(self, "_flipped_arr"):
            self._flipped_arr = np.zeros((self.mb_rows, self.mb_cols), bool)
        return self._flipped_arr

    @property
    def _splitmv_partition_id(self):
        if not hasattr(self, "_splitmv_pid"):
            self._splitmv_pid = np.full((self.mb_rows, self.mb_cols), -1, np.int8)
        return self._splitmv_pid


def _extra_bits(bd, probs):
    v = 0
    for p in probs:
        v = (v << 1) + bd.get(p)
    return v
