"""Carrying codec state between the JAX package and this one.

The system has no weights; what persists from frame to frame is the codec
state: per-GOP header state (probability tables, segmentation, filter
adjustments) and the three reference rasters.  These functions move both
through plain numpy, so a stream can be decoded part-way by one package
and continued by the other.  Neither package is imported by the other:
``decoder_state_to_dict`` reads attributes only and accepts either
package's ``DecoderState``.
"""
import numpy as np
import torch

from alfalfa_tpu_torch.state import decoder_state as _DS

PLANES = ("y", "u", "v")


def refs_from_numpy(last, golden, alt, device=None):
    """One plane's references, three (G, H, W) uint8 numpy arrays
    (macroblock-padded), as the decoder's (G, 3, H, W) uint8 tensor."""
    device = torch.device("cuda" if device is None else device)
    stack = np.stack([np.asarray(last, np.uint8), np.asarray(golden, np.uint8),
                      np.asarray(alt, np.uint8)], axis=1)
    return torch.from_numpy(np.ascontiguousarray(stack)).to(device)


def refs_to_numpy(refs):
    """Inverse of refs_from_numpy: (last, golden, alt) numpy arrays."""
    a = refs.cpu().numpy()
    return a[:, 0], a[:, 1], a[:, 2]


def decoder_state_to_dict(state):
    """The fields of a DecoderState as plain numpy / Python values."""
    pt = state.probability_tables
    seg, fa = state.segmentation, state.filter_adjustments
    return {
        "width": int(state.width), "height": int(state.height),
        "probability_tables": {
            k: np.array(getattr(pt, k))
            for k in ("coeff_probs", "y_mode_probs", "uv_mode_probs",
                      "mv_probs")},
        "segmentation": None if seg is None else {
            "absolute": bool(seg.absolute),
            "quantizer_adjustments": np.array(seg.quantizer_adjustments),
            "filter_adjustments": np.array(seg.filter_adjustments),
            "map": np.array(seg.map)},
        "filter_adjustments": None if fa is None else {
            "ref_adjustments": np.array(fa.ref_adjustments),
            "mode_adjustments": np.array(fa.mode_adjustments)},
    }


def decoder_state_from_dict(d, classes=_DS):
    """A DecoderState from decoder_state_to_dict's output.  ``classes`` is
    the module that provides DecoderState, ProbabilityTables, Segmentation
    and FilterAdjustments: this package's by default."""
    pt = classes.ProbabilityTables(
        **{k: np.array(v) for k, v in d["probability_tables"].items()})
    seg = d["segmentation"]
    if seg is not None:
        seg = classes.Segmentation(
            bool(seg["absolute"]), np.array(seg["quantizer_adjustments"]),
            np.array(seg["filter_adjustments"]), np.array(seg["map"]))
    fa = d["filter_adjustments"]
    if fa is not None:
        fa = classes.FilterAdjustments(np.array(fa["ref_adjustments"]),
                                       np.array(fa["mode_adjustments"]))
    return classes.DecoderState(d["width"], d["height"], pt, seg, fa)
