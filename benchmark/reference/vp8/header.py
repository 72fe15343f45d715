"""VP8 frame headers: declarative parse/serialize over the bool coder.

Mirrors the self-parsing header structures of RFC 6386 section 9 (reference:
decoder/frame_header.hh:37-325, decoder/vp8_header_structures.hh).  Each
struct parses from a BoolDecoder and serializes back through a BoolEncoder;
``parse`` and ``write`` are written as mirrored walks over the same field
order, so parse-then-write is the identity on the bitstream.

Conventions: optional ("Flagged") fields hold None when the flag bit was 0.
"""
from dataclasses import dataclass, field
from typing import List, Optional

from . import tables


# ---------------------------------------------------------------------------
# primitive helpers (Flag / Unsigned<w> / Signed<w> / Flagged<T>)
# ---------------------------------------------------------------------------

def get_flagged_uint(bd, width, prob=128):
    return bd.get_uint(width) if bd.get(prob) else None


def get_flagged_sint(bd, width):
    return bd.get_sint(width) if bd.get() else None






# ---------------------------------------------------------------------------
# header substructures
# ---------------------------------------------------------------------------

@dataclass
class SegmentFeatureData:
    # True: absolute segment values; False: deltas against frame values
    segment_feature_mode: bool = False
    quantizer_update: List[Optional[int]] = field(default_factory=lambda: [None] * 4)
    loop_filter_update: List[Optional[int]] = field(default_factory=lambda: [None] * 4)

    @classmethod
    def parse(cls, bd):
        mode = bool(bd.get())
        q = [get_flagged_sint(bd, 7) for _ in range(4)]
        lf = [get_flagged_sint(bd, 6) for _ in range(4)]
        return cls(mode, q, lf)



@dataclass
class UpdateSegmentation:
    update_mb_segmentation_map: bool = False
    segment_feature_data: Optional[SegmentFeatureData] = None
    # present iff update_mb_segmentation_map: 3 optional tree probabilities
    mb_segmentation_map: Optional[List[Optional[int]]] = None

    @classmethod
    def parse(cls, bd):
        update_map = bool(bd.get())
        feature_data = SegmentFeatureData.parse(bd) if bd.get() else None
        map_probs = None
        if update_map:
            map_probs = [get_flagged_uint(bd, 8) for _ in range(3)]
        return cls(update_map, feature_data, map_probs)


    def segment_tree_probs(self):
        """Effective segment_id tree probabilities for this frame (255 default)."""
        if self.mb_segmentation_map is None:
            return [255, 255, 255]
        return [255 if p is None else p for p in self.mb_segmentation_map]


@dataclass
class ModeRefLFDeltaUpdate:
    ref_update: List[Optional[int]] = field(default_factory=lambda: [None] * 4)
    mode_update: List[Optional[int]] = field(default_factory=lambda: [None] * 4)

    @classmethod
    def parse(cls, bd):
        ref = [get_flagged_sint(bd, 6) for _ in range(4)]
        mode = [get_flagged_sint(bd, 6) for _ in range(4)]
        return cls(ref, mode)



@dataclass
class QuantIndices:
    y_ac_qi: int = 0
    y_dc: Optional[int] = None
    y2_dc: Optional[int] = None
    y2_ac: Optional[int] = None
    uv_dc: Optional[int] = None
    uv_ac: Optional[int] = None

    @classmethod
    def parse(cls, bd):
        return cls(bd.get_uint(7),
                   get_flagged_sint(bd, 4), get_flagged_sint(bd, 4),
                   get_flagged_sint(bd, 4), get_flagged_sint(bd, 4),
                   get_flagged_sint(bd, 4))


    def quantizer(self, segment_adjustment=None, absolute=False):
        """The six dequantization factors (optionally segment-adjusted)."""
        qi = self.y_ac_qi
        if segment_adjustment is not None:
            # the reference stores the adjusted index in a uint8 before
            # clamping (frame.cc:192-197 + quantization.cc clamp_q), so a
            # negative sum wraps mod 256 rather than clamping to zero
            qi = (segment_adjustment + (0 if absolute else qi)) & 0xFF
        return tables.quantizer_values(
            qi, self.y_dc or 0, self.y2_dc or 0, self.y2_ac or 0,
            self.uv_dc or 0, self.uv_ac or 0)








def parse_token_prob_update(bd):
    """Sparse coefficient-probability updates: {(blocktype, band, ctx, node): prob}."""
    up = tables.COEFF_UPDATE_PROBS
    updates = {}
    for i in range(tables.BLOCK_TYPES):
        for j in range(tables.COEF_BANDS):
            for k in range(tables.PREV_COEF_CONTEXTS):
                for l in range(tables.ENTROPY_NODES):
                    if bd.get(up[i, j, k, l]):
                        updates[(i, j, k, l)] = bd.get_uint(8)
    return updates




def parse_mv_prob_update(bd):
    """Sparse MV-probability updates: {(axis, node): effective prob}.

    The bitstream carries 7-bit "half probs"; effective = raw<<1, or 1 if 0.
    """
    up = tables.MV_UPDATE_PROBS
    updates = {}
    for i in range(2):
        for j in range(tables.MV_PROB_CNT):
            if bd.get(up[i, j]):
                raw = bd.get_uint(7)
                updates[(i, j)] = (raw << 1) if raw else 1
    return updates




# ---------------------------------------------------------------------------
# frame headers
# ---------------------------------------------------------------------------

@dataclass
class KeyFrameHeader:
    color_space: bool = False
    clamping_type: bool = False
    update_segmentation: Optional[UpdateSegmentation] = None
    filter_type: bool = False
    loop_filter_level: int = 0
    sharpness_level: int = 0
    # None: adjustments disabled; (False, None): enabled, no update;
    # (True, update): enabled with an update
    mode_lf_adjustments: Optional[Optional[ModeRefLFDeltaUpdate]] = None
    mode_lf_adjustments_enabled: bool = False
    log2_number_of_dct_partitions: int = 0
    quant_indices: QuantIndices = field(default_factory=QuantIndices)
    refresh_entropy_probs: bool = False
    token_prob_update: dict = field(default_factory=dict)
    prob_skip_false: Optional[int] = None

    key_frame = True

    @classmethod
    def parse(cls, bd):
        h = cls()
        h.color_space = bool(bd.get())
        h.clamping_type = bool(bd.get())
        if h.color_space or h.clamping_type:
            raise ValueError("unsupported VP8 color_space/clamping_type")
        h.update_segmentation = UpdateSegmentation.parse(bd) if bd.get() else None
        h.filter_type = bool(bd.get())
        if h.filter_type:
            raise ValueError("unsupported VP8 'simple' loop filter")
        h.loop_filter_level = bd.get_uint(6)
        h.sharpness_level = bd.get_uint(3)
        h.mode_lf_adjustments_enabled = bool(bd.get())
        h.mode_lf_adjustments = None
        if h.mode_lf_adjustments_enabled and bd.get():
            h.mode_lf_adjustments = ModeRefLFDeltaUpdate.parse(bd)
        h.log2_number_of_dct_partitions = bd.get_uint(2)
        h.quant_indices = QuantIndices.parse(bd)
        h.refresh_entropy_probs = bool(bd.get())
        h.token_prob_update = parse_token_prob_update(bd)
        h.prob_skip_false = get_flagged_uint(bd, 8)
        return h



@dataclass
class InterFrameHeader:
    update_segmentation: Optional[UpdateSegmentation] = None
    filter_type: bool = False
    loop_filter_level: int = 0
    sharpness_level: int = 0
    mode_lf_adjustments: Optional[ModeRefLFDeltaUpdate] = None
    mode_lf_adjustments_enabled: bool = False
    log2_number_of_dct_partitions: int = 0
    quant_indices: QuantIndices = field(default_factory=QuantIndices)
    refresh_golden_frame: bool = False
    refresh_alternate_frame: bool = False
    copy_buffer_to_golden: Optional[int] = None     # present iff not refresh_golden
    copy_buffer_to_alternate: Optional[int] = None  # present iff not refresh_alt
    sign_bias_golden: bool = False
    sign_bias_alternate: bool = False
    refresh_entropy_probs: bool = False
    refresh_last: bool = False
    token_prob_update: dict = field(default_factory=dict)
    prob_skip_false: Optional[int] = None
    prob_inter: int = 0
    prob_references_last: int = 0
    prob_references_golden: int = 0
    intra_16x16_prob: Optional[List[int]] = None  # 4 y-mode probs
    intra_chroma_prob: Optional[List[int]] = None  # 3 uv-mode probs
    mv_prob_update: dict = field(default_factory=dict)

    key_frame = False

    @classmethod
    def parse(cls, bd):
        h = cls()
        h.update_segmentation = UpdateSegmentation.parse(bd) if bd.get() else None
        h.filter_type = bool(bd.get())
        if h.filter_type:
            raise ValueError("unsupported VP8 'simple' loop filter")
        h.loop_filter_level = bd.get_uint(6)
        h.sharpness_level = bd.get_uint(3)
        h.mode_lf_adjustments_enabled = bool(bd.get())
        h.mode_lf_adjustments = None
        if h.mode_lf_adjustments_enabled and bd.get():
            h.mode_lf_adjustments = ModeRefLFDeltaUpdate.parse(bd)
        h.log2_number_of_dct_partitions = bd.get_uint(2)
        h.quant_indices = QuantIndices.parse(bd)
        h.refresh_golden_frame = bool(bd.get())
        h.refresh_alternate_frame = bool(bd.get())
        if not h.refresh_golden_frame:
            h.copy_buffer_to_golden = bd.get_uint(2)
        if not h.refresh_alternate_frame:
            h.copy_buffer_to_alternate = bd.get_uint(2)
        h.sign_bias_golden = bool(bd.get())
        h.sign_bias_alternate = bool(bd.get())
        h.refresh_entropy_probs = bool(bd.get())
        h.refresh_last = bool(bd.get())
        h.token_prob_update = parse_token_prob_update(bd)
        h.prob_skip_false = get_flagged_uint(bd, 8)
        h.prob_inter = bd.get_uint(8)
        h.prob_references_last = bd.get_uint(8)
        h.prob_references_golden = bd.get_uint(8)
        h.intra_16x16_prob = [bd.get_uint(8) for _ in range(4)] if bd.get() else None
        h.intra_chroma_prob = [bd.get_uint(8) for _ in range(3)] if bd.get() else None
        h.mv_prob_update = parse_mv_prob_update(bd)
        return h





# ---------------------------------------------------------------------------
# uncompressed chunk (frame tag + partition split)
# ---------------------------------------------------------------------------

KEYFRAME_START_CODE = b"\x9d\x01\x2a"

# corruption levels (for error concealment)
NO_CORRUPTION = 0
CORRUPTED_RESIDUES = 1
CORRUPTED_FIRST_PARTITION = 2
CORRUPTED_FRAME = 3


class UncompressedChunk:
    """The unencoded frame tag: keyframe bit, version, show_frame, and the
    split into first partition + DCT token partitions
    (reference decoder/uncompressed_chunk.cc:33-160)."""

    def __init__(self, data, width, height, accept_partial=False):
        self.corruption_level = NO_CORRUPTION
        self.key_frame = False
        self.show_frame = False
        self.experimental = False
        self.loop_filter_enabled = True
        self.first_partition = b""
        self.rest = b""

        try:
            if len(data) < 3:
                raise IndexError("frame tag truncated")
            tag = data[0] | (data[1] << 8) | (data[2] << 16)
            self.key_frame = not (tag & 1)
            version = (tag >> 1) & 7
            self.show_frame = bool((tag >> 4) & 1)
            if version == 0:
                self.experimental = False
            elif version == 4:  # alfalfa experimental extension
                self.experimental = True
            elif version == 6:  # experimental, loop filter disabled
                self.experimental = True
                self.loop_filter_enabled = False
            else:
                raise ValueError(f"unsupported VP8 version {version}")

            first_partition_length = (tag >> 5) & 0x7FFFF
            offset = 10 if self.key_frame else 3

            if len(data) <= offset + first_partition_length:
                if accept_partial:
                    self.corruption_level = CORRUPTED_FIRST_PARTITION
                    self.first_partition = data[offset:]
                    return
                raise ValueError("invalid VP8 first partition length")

            self.first_partition = data[offset:offset + first_partition_length]
            self.rest = data[offset + first_partition_length:]

            if self.key_frame:
                if data[3:6] != KEYFRAME_START_CODE:
                    raise ValueError("missing keyframe start code")
                size_bits = int.from_bytes(data[6:10], "little")
                frame_width = size_bits & 0x3FFF
                horizontal_scale = (size_bits >> 14) & 3
                frame_height = (size_bits >> 16) & 0x3FFF
                vertical_scale = (size_bits >> 30) & 3
                if (frame_width != width or frame_height != height
                        or horizontal_scale or vertical_scale):
                    raise ValueError("VP8 upscaling not supported")
        except IndexError:
            if accept_partial:
                self.corruption_level = CORRUPTED_FRAME
                self.key_frame = False
                self.experimental = False
            else:
                raise ValueError("VP8 frame truncated")

    def dct_partitions(self, count):
        """Split ``rest`` into `count` token partitions (3-byte LE lengths
        for all but the last)."""
        rest = self.rest
        lengths = []
        for _ in range(count - 1):
            lengths.append(int.from_bytes(rest[:3], "little"))
            rest = rest[3:]
        parts = []
        for length in lengths:
            parts.append(rest[:length])
            rest = rest[length:]
        parts.append(rest)
        return parts


