"""Frame serialization: (header, FrameArrays) -> VP8 bitstream bytes.

Exact mirror of the parser, so parse-then-serialize is the identity on every
well-formed frame (the reference's roundtrip invariant, tests/roundtrip.cc).
Semantics follow encoder/serializer.cc:165-829.
"""
import numpy as np

from alfalfa_tpu_torch.bitstream import tables as T
from alfalfa_tpu_torch.bitstream.boolcoder import BoolEncoder, tree_path
from alfalfa_tpu_torch.bitstream.header import UncompressedChunk
from alfalfa_tpu_torch.decoder.parse import FrameParser, flipped_map_for
from alfalfa_tpu_torch.native import bitwork
from alfalfa_tpu_torch.util import tracing

# precomputed tree paths: leaf -> [(bit, node_index), ...]
_PATH_CACHE = {}


def _paths(tree_arr_id, tree_arr):
    if tree_arr_id not in _PATH_CACHE:
        leaves = sorted({-int(v) for v in tree_arr if v <= 0})
        table = {}
        for leaf in leaves:
            bits = tree_path(tree_arr, leaf)
            idx = []
            i = 0
            for b in bits:
                idx.append((b, i >> 1))
                i = int(tree_arr[i + b])
            table[leaf] = idx
        _PATH_CACHE[tree_arr_id] = table
    return _PATH_CACHE[tree_arr_id]


def write_tree(be, tree_arr, probs, leaf, tree_id):
    for bit, prob_idx in _paths(tree_id, tree_arr)[int(leaf)]:
        be.put(bit, probs[prob_idx])


class FrameSerializer:
    """Serializes one frame from its dense arrays."""

    def __init__(self, header, arrays, frame_probs, key_frame, width, height,
                 show=True):
        self.h = header
        self.a = arrays
        self.probs = frame_probs
        self.key_frame = key_frame
        self.width, self.height = width, height
        self.show = show

    # -- first partition -----------------------------------------------------

    def _serialize_kf_mb_header(self, be, r, c, seg_tree_probs):
        h, a = self.h, self.a
        if h.update_segmentation.update_mb_segmentation_map:
            write_tree(be, T.SEGMENT_ID_TREE, seg_tree_probs,
                       int(a.segment_update[r, c]), "segment_id")
        if h.prob_skip_false is not None:
            be.put(bool(a.skip_coeff[r, c]), h.prob_skip_false)
        self._serialize_kf_modes(be, r, c)

    def _serialize_kf_modes(self, be, r, c):
        a = self.a
        ymode = int(a.ymode[r, c])
        write_tree(be, T.KF_Y_MODE_TREE, T.KF_Y_MODE_PROBS, ymode, "kf_y")
        if ymode == T.B_PRED:
            for sr in range(4):
                for sc in range(4):
                    if sr > 0:
                        above = a.bmode[r, c, sr - 1, sc]
                    elif r > 0:
                        above = a.bmode[r - 1, c, 3, sc]
                    else:
                        above = T.B_DC_PRED
                    if sc > 0:
                        left = a.bmode[r, c, sr, sc - 1]
                    elif c > 0:
                        left = a.bmode[r, c - 1, sr, 3]
                    else:
                        left = T.B_DC_PRED
                    write_tree(be, T.B_MODE_TREE,
                               T.KF_B_MODE_PROBS[above][left],
                               int(a.bmode[r, c, sr, sc]), "bmode")
        write_tree(be, T.UV_MODE_TREE, T.KF_UV_MODE_PROBS,
                   int(a.uvmode[r, c]), "uv")

    def serialize_first_partition(self):
        be = BoolEncoder()
        self.h.write(be)
        if not self.key_frame:
            bitwork.write_inter_modes(be, self.a, self.h, self.probs,
                                      np.asarray(flipped_map_for(self.a,
                                                                 self.h)))
        elif self.h.update_segmentation is None:
            bitwork.write_kf_modes(be, self.a, self.h.prob_skip_false)
        else:
            # the native key-frame writer takes no segment ids
            seg_tree_probs = self.h.update_segmentation.segment_tree_probs()
            for r in range(self.a.mb_rows):
                for c in range(self.a.mb_cols):
                    self._serialize_kf_mb_header(be, r, c, seg_tree_probs)
        return be.finish()

    # -- token partitions ------------------------------------------------------

    def serialize_tokens(self):
        return bitwork.serialize_tokens(
            self.a, self.probs.coeff_probs,
            1 << self.h.log2_number_of_dct_partitions)

    # -- full frame --------------------------------------------------------------

    def serialize(self):
        """Assembles the complete frame (make_frame, serializer.cc:741-800)."""
        first = self.serialize_first_partition()
        parts = self.serialize_tokens()
        if self.width > 16383 or self.height > 16383:
            raise ValueError("VP8 frame dimensions too large")

        fpl = len(first)
        tag = ((0 if self.key_frame else 1)
               | ((1 if self.show else 0) << 4)
               | ((fpl & 0x7FFFF) << 5))
        out = bytearray([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
        if self.key_frame:
            out += b"\x9d\x01\x2a"
            out += bytes([self.width & 0xFF, (self.width >> 8) & 0x3F])
            out += bytes([self.height & 0xFF, (self.height >> 8) & 0x3F])
        out += first
        for p in parts[:-1]:
            n = len(p)
            out += bytes([n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF])
        for p in parts:
            out += p
        return bytes(out)


def serialize_frame(header, arrays, frame_probs, key_frame, width, height,
                    show=True):
    return FrameSerializer(header, arrays, frame_probs, key_frame, width,
                           height, show).serialize()


def refresh_all_references(payload, state, width, height, show=None):
    """``payload`` re-serialized so that it refreshes all three
    references, nothing copied (xc-terminate-chunk.cc:82-106): how a chunk
    is terminated, so that its exit state is its last frame.  A key frame
    refreshes them all already and comes back as it is.  ``state``: the
    DecoderState the frame parses against (the parse advances it).
    ``show``: the frame tag's show bit (None: the payload's own)."""
    with tracing.stage("enc.terminate"):
        chunk = UncompressedChunk(payload, width, height)
        header, arrays, frame_probs = FrameParser(state).parse(chunk)
        if chunk.key_frame:
            return payload
        header.refresh_last = True
        header.refresh_golden_frame = True
        header.refresh_alternate_frame = True
        header.copy_buffer_to_golden = None
        header.copy_buffer_to_alternate = None
        return serialize_frame(header, arrays, frame_probs, False, width,
                               height,
                               chunk.show_frame if show is None else show)


def count_token_branches(arrays, counts=None):
    """Branch-outcome counts per coefficient-tree node
    (accumulate_token_branches, serializer.cc:456-594).

    Returns counts (4, 8, 3, 11, 2) int64: [..., 0]=false, [..., 1]=true."""
    return bitwork.count_token_branches(arrays, counts)


def optimize_token_probs(counts, baseline_probs):
    """Per-frame coefficient-probability updates that beat the baseline.

    The reference updates whenever the measured probability differs
    (optimize_probability_tables, encoder.cc:418-439); but an update
    costs ~9 bits (the flag's true/false cost delta at
    coeff_update_probs + an 8-bit literal), which LOSES bytes on
    rarely-visited contexts.  Following libvpx's update decision
    (onyx_int.h / tokenize), emit an update only when the counts-weighted
    entropy saving exceeds that cost — strictly smaller output than the
    reference rule under the same cost model."""
    from .costs import PROB_COST
    updates = {}
    up = T.COEFF_UPDATE_PROBS
    for i in range(4):
        for j in range(8):
            for k in range(3):
                for l in range(11):
                    fc = int(counts[i, j, k, l, 0])
                    tc = int(counts[i, j, k, l, 1])
                    if fc == 0:
                        continue
                    prob = max(1, min(255, 256 * fc // (fc + tc)))
                    old = int(baseline_probs[i, j, k, l])
                    if prob == old:
                        continue
                    savings = (fc * (int(PROB_COST[old])
                                     - int(PROB_COST[prob]))
                               + tc * (int(PROB_COST[255 - old])
                                       - int(PROB_COST[255 - prob])))
                    u = int(up[i, j, k, l])
                    update_cost = (int(PROB_COST[255 - u])
                                   - int(PROB_COST[u]) + 8 * 256)
                    if savings > update_cost:
                        updates[(i, j, k, l)] = prob
    return updates
