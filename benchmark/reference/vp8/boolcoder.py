"""VP8 boolean (range) entropy coder.

Pure-Python reference implementation of the RFC 6386 section 7 arithmetic
coder, with the same truncation tolerance and libvpx-compatible flush the
reference codec uses (alfalfa decoder/bool_decoder.hh:45-120,
encoder/bool_encoder.hh:60-152).  The hot decode loops have a C++ fast path
in alfalfa_tpu/native (see bitwork.cc); this module is the semantic oracle
and fallback.
"""
import numpy as np

# number of left-shifts needed to renormalize a range value into [128, 255]
VP8_NORM = np.zeros(256, dtype=np.uint8)
for _r in range(1, 256):
    _s = 0
    _v = _r
    while _v < 128:
        _v <<= 1
        _s += 1
    VP8_NORM[_r] = _s


class BoolDecoder:
    """Arithmetic decoder over one bitstream partition.

    If the partition may be truncated (error concealment), pass
    ``complete=False``: reading past the end then marks the decoder invalid
    instead of silently zero-extending.
    """

    __slots__ = ("data", "pos", "size", "range", "value", "bit_count",
                 "valid", "complete")

    def __init__(self, data, complete=True):
        self.data = data
        self.pos = 0
        self.size = len(data)
        self.range = 255
        self.value = 0
        self.bit_count = 0
        self.valid = True
        self.complete = complete
        self._load_octet()
        self.value <<= 8
        self._load_octet()

    def _load_octet(self):
        if self.pos < self.size:
            self.value |= self.data[self.pos]
            self.pos += 1
        elif not self.complete:
            self.valid = False

    def get(self, probability=128):
        split = 1 + (((self.range - 1) * int(probability)) >> 8)
        big_split = split << 8
        if self.value >= big_split:
            ret = 1
            self.range -= split
            self.value -= big_split
        else:
            ret = 0
            self.range = split

        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                self._load_octet()
        return ret

    def get_uint(self, width):
        """MSB-first fixed-width unsigned literal (prob 128 per bit)."""
        v = 0
        for _ in range(width):
            v = (v << 1) | self.get()
        return v

    def get_sint(self, width):
        """Magnitude (MSB-first) then sign bit; sign set means negative."""
        v = self.get_uint(width)
        return -v if self.get() else v

    def tree(self, nodes, probabilities):
        """Walk a VP8 coding tree; returns the (non-negative) leaf value."""
        i = 0
        while True:
            i = nodes[i + self.get(probabilities[i >> 1])]
            if i <= 0:
                return -i




def tree_path(nodes, leaf):
    """Bit path from the root of a VP8 coding tree to the given leaf."""
    # depth-first search; trees are tiny (<= 18 entries) so this is cheap
    target = -int(leaf)

    def walk(i, acc):
        for bit in (0, 1):
            nxt = nodes[i + bit]
            if nxt == target and nxt <= 0:
                return acc + [bit]
            if nxt > 0:
                r = walk(nxt, acc + [bit])
                if r is not None:
                    return r
        return None

    path = walk(0, [])
    if path is None:
        raise ValueError(f"leaf {leaf} not in tree")
    return path
