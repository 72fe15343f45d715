"""Explicit codec state as plain-data values (numpy-backed, pytree-friendly).

The identity of this framework, inherited from the reference design: all
persistent decoder/encoder state is a first-class value that can be copied,
compared, hashed, and serialized (reference decoder/decoder.hh:57-300).

- ProbabilityTables: entropy-coder probabilities persisted across frames
- Segmentation / FilterAdjustments: optional per-segment / per-mode deltas
- References: the three reference rasters (last/golden/alternative)
- DecoderState: everything except the rasters
"""
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import tables


def mb_dim(pixels):
    return (pixels + 15) // 16


@dataclass
class ProbabilityTables:
    coeff_probs: np.ndarray = field(
        default_factory=lambda: tables.DEFAULT_COEFF_PROBS.copy())
    y_mode_probs: np.ndarray = field(
        default_factory=lambda: tables.DEFAULT_Y_MODE_PROBS.copy())
    uv_mode_probs: np.ndarray = field(
        default_factory=lambda: tables.DEFAULT_UV_MODE_PROBS.copy())
    mv_probs: np.ndarray = field(
        default_factory=lambda: tables.DEFAULT_MV_PROBS.copy())

    def copy(self):
        return ProbabilityTables(self.coeff_probs.copy(), self.y_mode_probs.copy(),
                                 self.uv_mode_probs.copy(), self.mv_probs.copy())

    def coeff_prob_update(self, header):
        upd = header.token_prob_update
        flat = getattr(upd, "flat", None)
        if flat is not None:
            # fast-parse path: one vectorized masked store instead of a
            # python dict walk (flags/vals in COEFF_UPDATE_PROBS order)
            flags, vals = flat
            np.copyto(self.coeff_probs.reshape(-1), vals,
                      where=flags.astype(bool))
            return
        for (i, j, k, l), v in upd.items():
            self.coeff_probs[i, j, k, l] = v

    def update(self, header):
        """Full interframe update: coeff + mode + mv probabilities."""
        self.coeff_prob_update(header)
        if header.intra_16x16_prob is not None:
            self.y_mode_probs[:] = header.intra_16x16_prob
        if header.intra_chroma_prob is not None:
            self.uv_mode_probs[:] = header.intra_chroma_prob
        for (i, j), v in header.mv_prob_update.items():
            self.mv_probs[i, j] = v


    def __eq__(self, other):
        return (np.array_equal(self.coeff_probs, other.coeff_probs)
                and np.array_equal(self.y_mode_probs, other.y_mode_probs)
                and np.array_equal(self.uv_mode_probs, other.uv_mode_probs)
                and np.array_equal(self.mv_probs, other.mv_probs))


@dataclass
class Segmentation:
    absolute: bool = False
    quantizer_adjustments: np.ndarray = field(
        default_factory=lambda: np.zeros(4, np.int8))
    filter_adjustments: np.ndarray = field(
        default_factory=lambda: np.zeros(4, np.int8))
    # Per-macroblock segment ids. Sized (height, width) in *pixels* with
    # default value 3 to stay hash/serdes-compatible with the reference
    # (its map is constructed over pixel dimensions; decoder.cc:454-455),
    # though only [:mb_rows, :mb_cols] entries are ever used.
    map: np.ndarray = None

    @classmethod
    def create(cls, width, height, header=None):
        seg = cls(map=np.full((height, width), 3, np.uint8))
        if header is not None:
            seg.update(header)
        return seg

    def update(self, header):
        """Apply an UpdateSegmentation header block (decoder_state.hh:35-51)."""
        us = header.update_segmentation
        if us.segment_feature_data is not None:
            fd = us.segment_feature_data
            self.absolute = bool(fd.segment_feature_mode)
            for i in range(4):
                self.quantizer_adjustments[i] = fd.quantizer_update[i] or 0
                self.filter_adjustments[i] = fd.loop_filter_update[i] or 0

    def copy(self):
        return Segmentation(self.absolute, self.quantizer_adjustments.copy(),
                            self.filter_adjustments.copy(), self.map.copy())


    def __eq__(self, other):
        if other is None:
            return False
        return (self.absolute == other.absolute
                and np.array_equal(self.quantizer_adjustments, other.quantizer_adjustments)
                and np.array_equal(self.filter_adjustments, other.filter_adjustments)
                and np.array_equal(self.map, other.map))


@dataclass
class FilterAdjustments:
    ref_adjustments: np.ndarray = field(default_factory=lambda: np.zeros(4, np.int8))
    mode_adjustments: np.ndarray = field(default_factory=lambda: np.zeros(4, np.int8))

    @classmethod
    def create(cls, header=None):
        fa = cls()
        if header is not None:
            fa.update(header)
        return fa

    def update(self, header):
        if header.mode_lf_adjustments is not None:
            u = header.mode_lf_adjustments
            for i in range(4):
                self.ref_adjustments[i] = u.ref_update[i] or 0
                self.mode_adjustments[i] = u.mode_update[i] or 0

    def copy(self):
        return FilterAdjustments(self.ref_adjustments.copy(),
                                 self.mode_adjustments.copy())


    def __eq__(self, other):
        if other is None:
            return False
        return (np.array_equal(self.ref_adjustments, other.ref_adjustments)
                and np.array_equal(self.mode_adjustments, other.mode_adjustments))


@dataclass
class DecoderState:
    width: int
    height: int
    probability_tables: ProbabilityTables = field(default_factory=ProbabilityTables)
    segmentation: Optional[Segmentation] = None
    filter_adjustments: Optional[FilterAdjustments] = None

    @classmethod
    def initial(cls, width, height):
        return cls(width, height)

    @classmethod
    def from_keyframe_header(cls, header, width, height):
        """Keyframes reset all persistent state (decoder_state.hh:89-90)."""
        st = cls(width, height)
        if header.update_segmentation is not None:
            st.segmentation = Segmentation.create(width, height, header)
        if header.mode_lf_adjustments_enabled:
            st.filter_adjustments = FilterAdjustments.create(header)
        return st

    def copy(self):
        return DecoderState(self.width, self.height, self.probability_tables.copy(),
                            self.segmentation.copy() if self.segmentation else None,
                            self.filter_adjustments.copy() if self.filter_adjustments else None)


    def __eq__(self, other):
        return (self.width == other.width and self.height == other.height
                and self.probability_tables == other.probability_tables
                and ((self.segmentation is None) == (other.segmentation is None))
                and (self.segmentation is None or self.segmentation == other.segmentation)
                and ((self.filter_adjustments is None) == (other.filter_adjustments is None))
                and (self.filter_adjustments is None
                     or self.filter_adjustments == other.filter_adjustments))

