"""Tagged binary state serialization, format-compatible with the reference's
`.state` files (decoder/enc_state_serializer.hh:43-55; xc-dump / xc-enc -I/-O
/ vp8decode -s produce and consume these).

All integers little-endian; rasters stored as full padded planes. Only the
`last` reference is stored; golden/alternative alias it on load
(decoder.cc:171-192) — chunk boundaries are normalized by terminate-chunk.
The files are byte-identical to the JAX package's.  Reference planes are
read from the host copy of a raster (``Raster.to_host``) and loaded onto
the decoder's device.
"""
import struct

import numpy as np
import torch

from alfalfa_tpu_torch.util import tracing
from .decoder_state import (DecoderState, ProbabilityTables, Segmentation,
                            FilterAdjustments, References, Raster)

# EncoderSerDesTag values
(PROB_TABLE, FILT_ADJ, SEGM_ABS, SEGM_REL, DECODER_STATE, OPT_EMPTY,
 OPT_FULL, REFERENCES, REF_LAST, REF_GOLD, REF_ALT, DECODER) = range(12)


class Writer:
    def __init__(self):
        self.buf = bytearray()

    def tag(self, t):
        self.buf.append(t)

    def u8(self, v):
        self.buf.append(v & 0xFF)

    def u16(self, v):
        self.buf += struct.pack("<H", v & 0xFFFF)

    def u32(self, v):
        self.buf += struct.pack("<I", v & 0xFFFFFFFF)

    def u32_at(self, offset, v):
        self.buf[offset:offset + 4] = struct.pack("<I", v & 0xFFFFFFFF)

    def raw(self, b):
        self.buf += b


class Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def tag(self):
        t = self.data[self.pos]
        self.pos += 1
        return t

    def peek_tag(self):
        return self.data[self.pos]

    def u8(self):
        return self.tag()

    def u16(self):
        v = struct.unpack_from("<H", self.data, self.pos)[0]
        self.pos += 2
        return v

    def u32(self):
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def i8(self):
        v = struct.unpack_from("<b", self.data, self.pos)[0]
        self.pos += 1
        return v

    def raw(self, n):
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def remaining(self):
        return len(self.data) - self.pos


# ---- probability tables ----

def write_prob_tables(w, pt):
    payload = (pt.coeff_probs.tobytes() + pt.y_mode_probs.tobytes()
               + pt.uv_mode_probs.tobytes() + pt.mv_probs.tobytes())
    w.tag(PROB_TABLE)
    w.u32(len(payload))
    w.raw(payload)


def read_prob_tables(r):
    assert r.tag() == PROB_TABLE
    r.u32()
    pt = ProbabilityTables()
    pt.coeff_probs = np.frombuffer(r.raw(4 * 8 * 3 * 11), np.uint8).reshape(4, 8, 3, 11).copy()
    pt.y_mode_probs = np.frombuffer(r.raw(4), np.uint8).copy()
    pt.uv_mode_probs = np.frombuffer(r.raw(3), np.uint8).copy()
    pt.mv_probs = np.frombuffer(r.raw(2 * 19), np.uint8).reshape(2, 19).copy()
    return pt


# ---- segmentation / filter adjustments ----

def write_segmentation(w, seg):
    mh, mw = seg.map.shape
    w.tag(SEGM_ABS if seg.absolute else SEGM_REL)
    w.u32(4 + 4 + 4 + mh * mw)
    w.u16(mw)
    w.u16(mh)
    w.raw(seg.quantizer_adjustments.tobytes())
    w.raw(seg.filter_adjustments.tobytes())
    w.raw(seg.map.tobytes())


def read_segmentation(r):
    t = r.tag()
    assert t in (SEGM_ABS, SEGM_REL)
    r.u32()
    mw = r.u16()
    mh = r.u16()
    seg = Segmentation(absolute=(t == SEGM_ABS))
    seg.quantizer_adjustments = np.frombuffer(r.raw(4), np.int8).copy()
    seg.filter_adjustments = np.frombuffer(r.raw(4), np.int8).copy()
    seg.map = np.frombuffer(r.raw(mh * mw), np.uint8).reshape(mh, mw).copy()
    return seg


def write_filter_adjustments(w, fa):
    w.tag(FILT_ADJ)
    w.u32(8)
    w.raw(fa.ref_adjustments.tobytes())
    w.raw(fa.mode_adjustments.tobytes())


def read_filter_adjustments(r):
    assert r.tag() == FILT_ADJ
    r.u32()
    fa = FilterAdjustments()
    fa.ref_adjustments = np.frombuffer(r.raw(4), np.int8).copy()
    fa.mode_adjustments = np.frombuffer(r.raw(4), np.int8).copy()
    return fa


# ---- decoder state ----

def write_decoder_state(w, state):
    w.tag(DECODER_STATE)
    ph = len(w.buf)
    w.u32(0)
    w.u16(state.width)
    w.u16(state.height)
    start = len(w.buf)
    write_prob_tables(w, state.probability_tables)
    if state.segmentation is not None:
        w.tag(OPT_FULL)
        write_segmentation(w, state.segmentation)
    else:
        w.tag(OPT_EMPTY)
    if state.filter_adjustments is not None:
        w.tag(OPT_FULL)
        write_filter_adjustments(w, state.filter_adjustments)
    else:
        w.tag(OPT_EMPTY)
    w.u32_at(ph, 4 + len(w.buf) - start)


def read_decoder_state(r):
    assert r.tag() == DECODER_STATE
    r.u32()
    width = r.u16()
    height = r.u16()
    state = DecoderState(width, height)
    state.probability_tables = read_prob_tables(r)
    if r.tag() == OPT_FULL:
        state.segmentation = read_segmentation(r)
    if r.tag() == OPT_FULL:
        state.filter_adjustments = read_filter_adjustments(r)
    return state


# ---- references (only `last` is stored) ----

def write_references(w, refs):
    w.tag(REFERENCES)
    ph = len(w.buf)
    w.u32(0)
    start = len(w.buf)
    last = refs.last
    if tracing.enabled() and isinstance(last.y, torch.Tensor) \
            and last._host is None:
        # the planes' one copy to the host, which the raster then keeps
        tracing.count("d2h.state_save", sum(
            p.numel() * p.element_size() for p in (last.y, last.u, last.v)))
    y, u, v = last.to_host()
    w.u16(last.display_width)
    w.u16(last.display_height)
    payload = y.tobytes() + u.tobytes() + v.tobytes()
    w.tag(REF_LAST)
    w.u32(len(payload))
    w.raw(payload)
    w.u32_at(ph, len(w.buf) - start)


def read_references(r, width, height):
    assert r.tag() == REFERENCES
    r.u32()
    r.u16()  # display width (redundant with decoder state)
    r.u16()
    last = Raster(width, height)
    if r.remaining() and r.peek_tag() == REF_LAST:
        r.tag()
        r.u32()
        h, w_ = last.y.shape
        last.y = np.frombuffer(r.raw(h * w_), np.uint8).reshape(h, w_).copy()
        last.u = np.frombuffer(r.raw(h * w_ // 4), np.uint8).reshape(h // 2, w_ // 2).copy()
        last.v = np.frombuffer(r.raw(h * w_ // 4), np.uint8).reshape(h // 2, w_ // 2).copy()
    return References(last, last, last)


# ---- top-level decoder (the .state file format) ----

def save_decoder(state, references, path=None):
    """Serializes (DecoderState, References) to `.state` bytes."""
    with tracing.stage("state.save"):
        w = Writer()
        w.tag(DECODER)
        ph = len(w.buf)
        w.u32(0)
        start = len(w.buf)
        write_decoder_state(w, state)
        write_references(w, references)
        w.u32_at(ph, len(w.buf) - start)
        data = bytes(w.buf)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def load_decoder(path_or_bytes, device=None):
    """Returns (DecoderState, References) from a `.state` file, the
    references' planes as tensors on ``device`` (default CUDA)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    r = Reader(data)
    assert r.tag() == DECODER
    r.u32()
    state = read_decoder_state(r)
    refs = read_references(r, state.width, state.height)
    return state, refs.on_device(torch.device("cuda" if device is None
                                              else device))
