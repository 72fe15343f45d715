"""Per-MB loop-filter parameter derivation — pure numpy, jax-free.

Lives in its own module so the scalar decode path (reconstruct_np +
native lfkernel) can run in processes where jax must not load — e.g.
the ASAN/UBSAN fuzz driver (tools/sanitize_fuzz.py): the sanitizer
runtime is preloaded process-wide and jaxlib's statically linked C++
runtime throws before ASAN's interceptors are bound.

Reference: loopfilter.cc:82-128 (limit derivation), macroblock.cc:603-650
(per-MB level adjustments).
"""
import numpy as np

from . import tables as T


def loopfilter_params(filter_level, sharpness, key_frame):
    """Vectorized limit derivation (loopfilter.cc:82-128).

    filter_level: int array (pre-adjustment sum, may be out of range).
    Returns dict of int32 arrays: level, interior, mb_limit, sb_limit, hev.
    """
    fl = np.clip(filter_level, 0, 63).astype(np.int32)
    interior = fl.copy()
    if sharpness:
        interior >>= 2 if sharpness > 4 else 1
        interior = np.minimum(interior, 9 - sharpness)
    interior = np.maximum(interior, 1)
    return {
        "level": fl,
        "interior": interior,
        "mb_limit": (fl + 2) * 2 + interior,
        "sb_limit": fl * 2 + interior,
        "hev": ((fl >= 15).astype(np.int32)
                + (fl >= 40).astype(np.int32)
                + ((fl >= 20) & (not key_frame)).astype(np.int32)),
    }


def frame_lf_params(header, arrays, state, key_frame):
    """Per-MB loop filter parameters (host-side table math)."""
    seg = state.segmentation
    fa = state.filter_adjustments
    R, C = arrays.mb_rows, arrays.mb_cols

    if not header.loop_filter_level:
        z = np.zeros((R, C), np.int32)
        return (z, z, z, z, z, np.zeros((R, C), bool))

    if seg is not None:
        base = seg.filter_adjustments[arrays.segment].astype(np.int32) + \
            (0 if seg.absolute else header.loop_filter_level)
    else:
        base = np.full((R, C), header.loop_filter_level, np.int32)

    if fa is not None:
        ref = arrays.ref.astype(np.int32)
        ymode = arrays.ymode.astype(np.int32)
        base = base + fa.ref_adjustments[ref].astype(np.int32)
        mode_adj = np.where(
            ref == T.CURRENT_FRAME,
            np.where(ymode == T.B_PRED, fa.mode_adjustments[0], 0),
            np.where(ymode == T.ZEROMV, fa.mode_adjustments[1],
                     np.where(ymode == T.SPLITMV, fa.mode_adjustments[3],
                              fa.mode_adjustments[2]))).astype(np.int32)
        base = base + mode_adj

    # MBs with level <= 0 are skipped entirely (macroblock.cc:632-634)
    apply = base > 0
    p = loopfilter_params(base, header.sharpness_level, key_frame)
    level = np.where(apply, p["level"], 0).astype(np.int32)
    skip_sb = arrays.y2_coded & ~arrays.has_nonzero
    return (level, p["interior"].astype(np.int32),
            p["mb_limit"].astype(np.int32), p["sb_limit"].astype(np.int32),
            p["hev"].astype(np.int32), skip_sb)
