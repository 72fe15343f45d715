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

import numpy as np

from . import tables


# ---------------------------------------------------------------------------
# primitive helpers (Flag / Unsigned<w> / Signed<w> / Flagged<T>)
# ---------------------------------------------------------------------------

def get_flagged_uint(bd, width, prob=128):
    return bd.get_uint(width) if bd.get(prob) else None


def get_flagged_sint(bd, width):
    return bd.get_sint(width) if bd.get() else None


def put_flagged_uint(be, value, width, prob=128):
    be.put(value is not None, prob)
    if value is not None:
        be.put_uint(value, width)


def put_flagged_sint(be, value, width):
    be.put(value is not None)
    if value is not None:
        be.put_sint(value, width)


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

    def write(self, be):
        be.put(self.segment_feature_mode)
        for v in self.quantizer_update:
            put_flagged_sint(be, v, 7)
        for v in self.loop_filter_update:
            put_flagged_sint(be, v, 6)


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

    def write(self, be):
        be.put(self.update_mb_segmentation_map)
        be.put(self.segment_feature_data is not None)
        if self.segment_feature_data is not None:
            self.segment_feature_data.write(be)
        if self.update_mb_segmentation_map:
            for v in self.mb_segmentation_map:
                put_flagged_uint(be, v, 8)

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

    def write(self, be):
        for v in self.ref_update:
            put_flagged_sint(be, v, 6)
        for v in self.mode_update:
            put_flagged_sint(be, v, 6)


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

    def write(self, be):
        be.put_uint(self.y_ac_qi, 7)
        for v in (self.y_dc, self.y2_dc, self.y2_ac, self.uv_dc, self.uv_ac):
            put_flagged_sint(be, v, 4)

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


def _token_update_dict(flags, vals):
    """{(blocktype, band, ctx, node): prob} from flat flag/value runs
    (shared by the incremental and whole-header native parse paths)."""
    idx = np.flatnonzero(flags)
    if not len(idx):
        return {}
    shape = tables.COEFF_UPDATE_PROBS.shape
    keys = np.stack(np.unravel_index(idx, shape), axis=1).tolist()
    return dict(zip(map(tuple, keys), np.asarray(vals)[idx].tolist()))


class _LazyTokenUpdates(dict):
    """Parsed coefficient-prob updates, materialized into {(i,j,k,l): v}
    only when a consumer actually touches the dict.  The hot decode path
    (ProbabilityTables.coeff_prob_update, GOP-batched header parse) uses
    the flat ``(flags, vals)`` arrays directly — building 200+ tuple keys
    per frame header is measurable host time at 720p.

    Caveat: C-level dict fast paths that bypass the overridden methods
    (e.g. comparing two *unfilled* instances) see the unmaterialized
    storage; every consumer in-tree goes through items()/[]/in, which
    all materialize first."""
    __slots__ = ("flat", "_filled")

    def __init__(self, flags, vals):
        super().__init__()
        self.flat = (np.asarray(flags, np.uint8), np.asarray(vals, np.uint8))
        self._filled = False

    def _fill(self):
        if not self._filled:
            self._filled = True
            super().update(_token_update_dict(*self.flat))

    def __getitem__(self, k):
        self._fill()
        return super().__getitem__(k)

    def __contains__(self, k):
        self._fill()
        return super().__contains__(k)

    def __iter__(self):
        self._fill()
        return super().__iter__()

    def __len__(self):
        self._fill()
        return super().__len__()

    def __eq__(self, other):
        self._fill()
        if isinstance(other, _LazyTokenUpdates):
            other._fill()
        return super().__eq__(other)

    __hash__ = None

    def items(self):
        self._fill()
        return super().items()

    def keys(self):
        self._fill()
        return super().keys()

    def values(self):
        self._fill()
        return super().values()

    def get(self, k, default=None):
        self._fill()
        return super().get(k, default)

    # mutation drops the flat fast path so dict and arrays never diverge
    def __setitem__(self, k, v):
        self._fill()
        self.flat = None
        super().__setitem__(k, v)

    def update(self, *a, **kw):
        self._fill()
        self.flat = None
        super().update(*a, **kw)

    def pop(self, *a):
        self._fill()
        self.flat = None
        return super().pop(*a)

    def clear(self):
        self._filled = True
        self.flat = None
        super().clear()


def _mv_update_dict(flags, vals):
    """{(axis, node): effective prob} with the raw<<1-or-1 half-prob rule
    (shared by the incremental and whole-header native parse paths)."""
    n = tables.MV_UPDATE_PROBS.shape[1]
    return {(int(i) // n, int(i) % n):
            ((int(vals[i]) << 1) if vals[i] else 1)
            for i in np.flatnonzero(flags)}


def parse_token_prob_update(bd):
    """Sparse coefficient-probability updates: {(blocktype, band, ctx, node): prob}."""
    up = tables.COEFF_UPDATE_PROBS
    if getattr(bd, "complete", False):
        # 1056 flag reads dominate header-parse time; run them natively
        try:
            from alfalfa_tpu_torch.native import bitwork
            flags, vals = bitwork.parse_flagged_literals(
                bd, up.reshape(-1), up.size, 8)
            return _LazyTokenUpdates(flags, vals)
        except (ImportError, AttributeError, OSError, RuntimeError):
            pass  # no native toolchain: fall through to the Python loop
    updates = {}
    for i in range(tables.BLOCK_TYPES):
        for j in range(tables.COEF_BANDS):
            for k in range(tables.PREV_COEF_CONTEXTS):
                for l in range(tables.ENTROPY_NODES):
                    if bd.get(up[i, j, k, l]):
                        updates[(i, j, k, l)] = bd.get_uint(8)
    return updates


def write_token_prob_update(be, updates):
    from alfalfa_tpu_torch.native import bitwork
    import numpy as _np
    up = tables.COEFF_UPDATE_PROBS
    flat = getattr(updates, "flat", None)
    if flat is not None:
        flags = _np.ascontiguousarray(flat[0]).reshape(up.shape)
        vals = _np.ascontiguousarray(flat[1]).reshape(up.shape)
    else:
        flags = _np.zeros(up.shape, _np.uint8)
        vals = _np.zeros(up.shape, _np.uint8)
        for key, v in updates.items():
            flags[key] = 1
            vals[key] = v
    bitwork.write_flagged_literals(be, up.reshape(-1), flags.reshape(-1),
                                   vals.reshape(-1), 8)


def parse_mv_prob_update(bd):
    """Sparse MV-probability updates: {(axis, node): effective prob}.

    The bitstream carries 7-bit "half probs"; effective = raw<<1, or 1 if 0.
    """
    up = tables.MV_UPDATE_PROBS
    if getattr(bd, "complete", False):
        try:
            from alfalfa_tpu_torch.native import bitwork
            flags, vals = bitwork.parse_flagged_literals(
                bd, up.reshape(-1), up.size, 7)
            return _mv_update_dict(flags, vals)
        except (ImportError, AttributeError, OSError, RuntimeError):
            pass  # no native toolchain: fall through to the Python loop
    updates = {}
    for i in range(2):
        for j in range(tables.MV_PROB_CNT):
            if bd.get(up[i, j]):
                raw = bd.get_uint(7)
                updates[(i, j)] = (raw << 1) if raw else 1
    return updates


def write_mv_prob_update(be, updates):
    from alfalfa_tpu_torch.native import bitwork
    import numpy as _np
    up = tables.MV_UPDATE_PROBS
    flags = _np.zeros(up.shape, _np.uint8)
    vals = _np.zeros(up.shape, _np.uint8)
    for key, v in updates.items():
        flags[key] = 1
        vals[key] = v >> 1
    bitwork.write_flagged_literals(be, up.reshape(-1), flags.reshape(-1),
                                   vals.reshape(-1), 7)


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

    def write(self, be):
        be.put(self.color_space)
        be.put(self.clamping_type)
        be.put(self.update_segmentation is not None)
        if self.update_segmentation is not None:
            self.update_segmentation.write(be)
        be.put(self.filter_type)
        be.put_uint(self.loop_filter_level, 6)
        be.put_uint(self.sharpness_level, 3)
        be.put(self.mode_lf_adjustments_enabled)
        if self.mode_lf_adjustments_enabled:
            be.put(self.mode_lf_adjustments is not None)
            if self.mode_lf_adjustments is not None:
                self.mode_lf_adjustments.write(be)
        be.put_uint(self.log2_number_of_dct_partitions, 2)
        self.quant_indices.write(be)
        be.put(self.refresh_entropy_probs)
        write_token_prob_update(be, self.token_prob_update)
        put_flagged_uint(be, self.prob_skip_false, 8)


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

    def write(self, be):
        be.put(self.update_segmentation is not None)
        if self.update_segmentation is not None:
            self.update_segmentation.write(be)
        be.put(self.filter_type)
        be.put_uint(self.loop_filter_level, 6)
        be.put_uint(self.sharpness_level, 3)
        be.put(self.mode_lf_adjustments_enabled)
        if self.mode_lf_adjustments_enabled:
            be.put(self.mode_lf_adjustments is not None)
            if self.mode_lf_adjustments is not None:
                self.mode_lf_adjustments.write(be)
        be.put_uint(self.log2_number_of_dct_partitions, 2)
        self.quant_indices.write(be)
        be.put(self.refresh_golden_frame)
        be.put(self.refresh_alternate_frame)
        if not self.refresh_golden_frame:
            be.put_uint(self.copy_buffer_to_golden, 2)
        if not self.refresh_alternate_frame:
            be.put_uint(self.copy_buffer_to_alternate, 2)
        be.put(self.sign_bias_golden)
        be.put(self.sign_bias_alternate)
        be.put(self.refresh_entropy_probs)
        be.put(self.refresh_last)
        write_token_prob_update(be, self.token_prob_update)
        put_flagged_uint(be, self.prob_skip_false, 8)
        be.put_uint(self.prob_inter, 8)
        be.put_uint(self.prob_references_last, 8)
        be.put_uint(self.prob_references_golden, 8)
        be.put(self.intra_16x16_prob is not None)
        if self.intra_16x16_prob is not None:
            for v in self.intra_16x16_prob:
                be.put_uint(v, 8)
        be.put(self.intra_chroma_prob is not None)
        if self.intra_chroma_prob is not None:
            for v in self.intra_chroma_prob:
                be.put_uint(v, 8)
        write_mv_prob_update(be, self.mv_prob_update)


def parse_frame_header_fast(first_partition, key_frame):
    """Whole frame header via the native scalar parser (one C call instead
    of ~60 Python bool reads + two native runs).  Returns (header,
    (pos, range, value, bit_count)) with the decoder state positioned at
    the MB headers, or None — no native library, or a stream feature the
    Python parser reports precisely (color_space, simple filter)."""
    try:
        from alfalfa_tpu_torch.native import bitwork
        res = bitwork.parse_frame_header(first_partition, key_frame)
    except (ImportError, AttributeError, OSError):
        return None
    if res is None:
        return None
    out, tf, tv, mf, mvv, state = res
    SENT = -(1 << 31)
    o = out.tolist()

    def v(i):
        return None if o[i] == SENT else o[i]

    seg = None
    if o[0]:
        fd = None
        if o[2]:
            fd = SegmentFeatureData(bool(o[3]),
                                    [v(4 + i) for i in range(4)],
                                    [v(8 + i) for i in range(4)])
        mp = [v(12 + i) for i in range(3)] if o[1] else None
        seg = UpdateSegmentation(bool(o[1]), fd, mp)
    lfu = None
    if o[19]:
        lfu = ModeRefLFDeltaUpdate([v(20 + i) for i in range(4)],
                                   [v(24 + i) for i in range(4)])
    qi = QuantIndices(o[29], v(30), v(31), v(32), v(33), v(34))
    tok = _LazyTokenUpdates(tf, tv)

    if key_frame:
        h = KeyFrameHeader()
        h.color_space = bool(o[56])
        h.clamping_type = bool(o[57])
    else:
        h = InterFrameHeader()
        h.refresh_golden_frame = bool(o[37])
        h.refresh_alternate_frame = bool(o[38])
        h.copy_buffer_to_golden = v(39)
        h.copy_buffer_to_alternate = v(40)
        h.sign_bias_golden = bool(o[41])
        h.sign_bias_alternate = bool(o[42])
        h.refresh_last = bool(o[43])
        h.prob_inter = o[44]
        h.prob_references_last = o[45]
        h.prob_references_golden = o[46]
        h.intra_16x16_prob = ([o[48 + i] for i in range(4)] if o[47]
                              else None)
        h.intra_chroma_prob = ([o[53 + i] for i in range(3)] if o[52]
                               else None)
        h.mv_prob_update = _mv_update_dict(mf, mvv)
    h.update_segmentation = seg
    h.filter_type = bool(o[15])
    h.loop_filter_level = o[16]
    h.sharpness_level = o[17]
    h.mode_lf_adjustments_enabled = bool(o[18])
    h.mode_lf_adjustments = lfu
    h.log2_number_of_dct_partitions = o[28]
    h.quant_indices = qi
    h.refresh_entropy_probs = bool(o[35])
    h.token_prob_update = tok
    h.prob_skip_false = v(36)
    return h, tuple(int(x) for x in state)


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


def make_frame_tag(key_frame, show_frame, first_partition_length,
                   width=None, height=None, experimental=False,
                   loop_filter_enabled=True):
    """Assemble the 3-byte frame tag (+ 7-byte keyframe preamble)."""
    version = 0 if not experimental else (4 if loop_filter_enabled else 6)
    tag = ((0 if key_frame else 1)
           | (version << 1)
           | ((1 if show_frame else 0) << 4)
           | (first_partition_length << 5))
    out = bytes([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
    if key_frame:
        out += KEYFRAME_START_CODE
        out += int(width | (height << 16)).to_bytes(4, "little")
    return out
