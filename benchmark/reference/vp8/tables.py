"""VP8 spec constant tables (RFC 6386).

Loaded from ``vp8_tables.json``, which is mechanically generated from the
RFC 6386 constants (see oracle/dump_tables.cc).  Every VP8 implementation
shares these values; reference locations for cross-checking:
decoder/vp8_prob_data.cc, decoder/modemv_data.cc, decoder/tokens.hh,
decoder/quantization.cc in excamera/alfalfa.
"""
import json
import os

import numpy as np

_HERE = os.path.dirname(__file__)

with open(os.path.join(_HERE, "vp8_tables.json")) as _f:
    _T = json.load(_f)


def _u8(key):
    return np.array(_T[key], dtype=np.uint8)


def _i16(key):
    return np.array(_T[key], dtype=np.int16)


# ---- quantizer lookups (RFC 6386 section 14.1) ----
DC_QLOOKUP = np.array(_T["dc_qlookup"], dtype=np.uint16)
AC_QLOOKUP = np.array(_T["ac_qlookup"], dtype=np.uint16)

# ---- coefficient scan order / band mapping ----
ZIGZAG = _u8("zigzag")                          # position i of scan -> raster index
COEFF_TO_BAND = _u8("coefficient_to_band")

# ---- coefficient token probabilities [block_type][band][context][node] ----
DEFAULT_COEFF_PROBS = _u8("default_coeff_probs")     # (4, 8, 3, 11)
COEFF_UPDATE_PROBS = _u8("coeff_update_probs")       # (4, 8, 3, 11)

# ---- motion vector probabilities [axis: 0=y 1=x][19 nodes] ----
DEFAULT_MV_PROBS = _u8("default_mv_probs")           # (2, 19)
MV_UPDATE_PROBS = _u8("mv_update_probs")             # (2, 19)

# ---- prediction-mode probabilities ----
DEFAULT_Y_MODE_PROBS = _u8("default_y_mode_probs")   # interframe 16x16 modes
DEFAULT_UV_MODE_PROBS = _u8("default_uv_mode_probs")
KF_Y_MODE_PROBS = _u8("kf_y_mode_probs")
KF_UV_MODE_PROBS = _u8("kf_uv_mode_probs")
KF_B_MODE_PROBS = _u8("kf_b_mode_probs")             # (10, 10, 9) [above][left]
INVARIANT_B_MODE_PROBS = _u8("invariant_b_mode_probs")

# ---- coding trees (flat arrays: node pairs; negative entries are leaves) ----
KF_Y_MODE_TREE = _i16("kf_y_mode_tree")
Y_MODE_TREE = _i16("y_mode_tree")
UV_MODE_TREE = _i16("uv_mode_tree")
B_MODE_TREE = _i16("b_mode_tree")
SMALL_MV_TREE = _i16("small_mv_tree")
MV_REF_TREE = _i16("mv_ref_tree")
SUBMV_REF_TREE = _i16("submv_ref_tree")
SPLIT_MV_TREE = _i16("split_mv_tree")
SEGMENT_ID_TREE = _i16("segment_id_tree")

# ---- inter mode probability derivation ----
MV_COUNTS_TO_PROBS = _u8("mv_counts_to_probs")       # (6, 4)
SPLIT_MV_PROBS = _u8("split_mv_probs")               # (3,)
SUBMV_REF_PROBS2 = _u8("submv_ref_probs2")           # (5, 3)

# SPLITMV partition layouts: for each of the 4 partition schemes, a list of
# partitions, each a list of (column, row) subblock coordinates.
MV_PARTITIONS = _T["mv_partitions"]

# ---- coefficient token extra-bit decoders (DCT_VAL_CATEGORY1..6) ----
# list of (base_value, [bit probabilities...])
TOKEN_DECODERS = [(base, np.array(probs, dtype=np.uint8))
                  for base, probs in _T["token_decoders"]]

# ---- mode enums (shared numbering with the bitstream trees) ----
# 16x16 / MB-level prediction modes
DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED = range(5)
NEARESTMV, NEARMV, ZEROMV, NEWMV, SPLITMV = range(5, 10)
NUM_UV_MODES = B_PRED          # 4
NUM_Y_MODES = B_PRED + 1       # 5
NUM_MV_REFS = SPLITMV - B_PRED  # 5

# 4x4 b-modes (intra), then inter subblock modes
(B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_LD_PRED,
 B_RD_PRED, B_VR_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
 LEFT4X4, ABOVE4X4, ZERO4X4, NEW4X4) = range(14)
NUM_INTRA_B_MODES = B_HU_PRED + 1  # 10

# reference frame selector
CURRENT_FRAME, LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME = range(4)

# coefficient block types (prob-table axis 0)
BLOCK_Y_AFTER_Y2, BLOCK_Y2, BLOCK_UV, BLOCK_Y_WITHOUT_Y2 = range(4)

BLOCK_TYPES = 4
COEF_BANDS = 8
PREV_COEF_CONTEXTS = 3
ENTROPY_NODES = 11
MV_PROB_CNT = 19
NUM_SEGMENTS = 4


def quantizer_values(y_ac_qi, y_dc_delta=0, y2_dc_delta=0, y2_ac_delta=0,
                     uv_dc_delta=0, uv_ac_delta=0):
    """Derive the six quantizer step sizes from a quantizer index + deltas.

    Matches RFC 6386 section 14.1 (reference decoder/quantization.cc:83-101):
    y2_ac scaled by 155/100 with floor 8, y2_dc doubled, uv_dc capped at 132.
    Works elementwise on numpy arrays as well as scalars.
    """
    def q(table, idx):
        return table[np.clip(idx, 0, 127)]

    y_ac = q(AC_QLOOKUP, y_ac_qi).astype(np.int32)
    y_dc = q(DC_QLOOKUP, np.asarray(y_ac_qi) + y_dc_delta).astype(np.int32)
    y2_dc = q(DC_QLOOKUP, np.asarray(y_ac_qi) + y2_dc_delta).astype(np.int32) * 2
    y2_ac = q(AC_QLOOKUP, np.asarray(y_ac_qi) + y2_ac_delta).astype(np.int32) * 155 // 100
    uv_dc = q(DC_QLOOKUP, np.asarray(y_ac_qi) + uv_dc_delta).astype(np.int32)
    uv_ac = q(AC_QLOOKUP, np.asarray(y_ac_qi) + uv_ac_delta).astype(np.int32)
    y2_ac = np.maximum(y2_ac, 8)
    uv_dc = np.minimum(uv_dc, 132)
    return {"y_dc": y_dc, "y_ac": y_ac, "y2_dc": y2_dc, "y2_ac": y2_ac,
            "uv_dc": uv_dc, "uv_ac": uv_ac}

