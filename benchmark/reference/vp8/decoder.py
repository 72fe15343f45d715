"""The plain reference VP8 decoder: the bitstream parse in pure Python
(``parse.py``, ``header.py``, ``boolcoder.py``), the reconstruction in
numpy (``recon.py``).  It imports no part of the program under test.

``Decoder.decode_frame(payload)`` returns (show, (y, u, v), header) with
uint8 planes of macroblock-aligned size; references are refreshed as
RFC 6386 section 9.7 says (golden / altref copies before the refreshes).
"""
import copy

import numpy as np

from . import recon
from .decoder_state import DecoderState
from .header import UncompressedChunk
from .parse import FrameParser

REFS = ("last", "golden", "alternative")


class Decoder:
    def __init__(self, width, height, exact=True):
        self.width, self.height = width, height
        self.state = DecoderState.initial(width, height)
        R, C = (height + 15) // 16, (width + 15) // 16
        blank = (np.zeros((R * 16, C * 16), np.uint8),
                 np.zeros((R * 8, C * 8), np.uint8),
                 np.zeros((R * 8, C * 8), np.uint8))
        self.refs = {k: blank for k in REFS}
        # False: the control, a decode whose inverse transform drops its
        # rounding (no longer bit-exact)
        self.exact = exact

    def copy(self):
        d = Decoder.__new__(Decoder)
        d.width, d.height, d.exact = self.width, self.height, self.exact
        d.state = self.state.copy()
        d.refs = dict(self.refs)
        return d

    def decode_frame(self, payload, filter_levels=None):
        """(show, planes, header); with ``filter_levels`` (a function of the
        frame's header giving a list of levels), also the luma plane of the
        frame loop-filtered at each of those levels instead of the one its
        header gives, {level: (H, W) uint8}, as a fourth item."""
        chunk = UncompressedChunk(payload, self.width, self.height)
        header, arrays, _ = FrameParser(self.state).parse(chunk)
        if filter_levels is not None:
            filter_levels = filter_levels(header)
        kept = [] if filter_levels is not None else None
        planes = recon.reconstruct(header, arrays, self.state, self.refs,
                                   chunk.key_frame, self.exact, kept)
        self._update_references(chunk.key_frame, header, planes)
        if filter_levels is None:
            return chunk.show_frame, planes, header
        others = {}
        for level in filter_levels:
            Y = kept[0][0].copy()
            h = copy.copy(header)
            h.loop_filter_level = level
            recon.loop_filter(h, arrays, self.state, chunk.key_frame, Y,
                              kept[0][1], luma_only=True)
            others[level] = Y.astype(np.uint8)
        return chunk.show_frame, planes, header, others

    def _update_references(self, key_frame, header, planes):
        refs = self.refs
        if key_frame:
            for k in REFS:
                refs[k] = planes
            return
        if header.copy_buffer_to_alternate == 1:
            refs["alternative"] = refs["last"]
        elif header.copy_buffer_to_alternate == 2:
            refs["alternative"] = refs["golden"]
        if header.copy_buffer_to_golden == 1:
            refs["golden"] = refs["last"]
        elif header.copy_buffer_to_golden == 2:
            refs["golden"] = refs["alternative"]
        if header.refresh_golden_frame:
            refs["golden"] = planes
        if header.refresh_alternate_frame:
            refs["alternative"] = planes
        if header.refresh_last:
            refs["last"] = planes
